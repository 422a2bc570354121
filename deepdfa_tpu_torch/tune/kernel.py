"""Measured layout search for the GGNN kernels on the card (the port's
`deepdfa_tpu/tune/kernel.py`).

1. **Enumerate** (block_n, block_e, scatter, accum, unroll) candidates
   per GGNN batch signature, with the card's legality rules in place of
   the TPU's VMEM estimate and sublane rule. Every pruned layout keeps a
   row naming its reason:
   - block_e must divide the edge budget (the reference's reshape
     contract; the mxu scatter's edge blocks tile the edge array);
   - the CUDA kernels' node tile is fixed (`nn/ggnn_kernel.py:NODE_TILE`,
     64 nodes): any other block_n is pruned;
   - under fold, block_e does not enter the launch (the CUDA fold walks
     each node's CSR run and has no edge blocks): one fold row per
     (accum, unroll) is kept, at the default block_e
     (`nn/ggnn_kernel.py:edge_block`), the rest are pruned as duplicates;
   - a fused candidate is pruned when `resolve_unroll` refuses it against
     the device's L2 (`fused_residency_bytes`, which counts the int8 mxu
     instance's per-step column maxima).
   Explicit `candidates` bypass the enumeration, as in the reference.
2. **Time** each survivor: its first call (the kernel library's build at
   first use, then the first run) is `compile_seconds`; then
   interleaved best-of-reps, candidates alternating within each round.
   Each call is timed from a synchronized device to its result on the
   host (`.cpu()`), as the reference times `device_get`.
3. **Hold every candidate to the numerics contract**: the relative max
   error against the port's plain fp32 fold path on the same device (the
   oracle, the reference's lax path; timed as `lax_step_us`, never a
   candidate or a winner) within the (scatter, accum) tolerance. A
   candidate outside it never wins.
4. **Pick by measured step time**, with `mfu_vs_measured_ceiling`
   against the measured fp32 matmul ceiling (tune/driver.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.nn import ggnn_kernel as gk

#: accum="int8"'s admission bound (nn/ggnn_kernel.py:INT8_DRIFT_BOUND)
INT8_TOLERANCE = gk.INT8_DRIFT_BOUND

#: the numerics contract: max relative error against the oracle, keyed
#: by (scatter, accum); the reference's values except fold/fp32. The
#: reference held that row to 0.0 because its fold repeats XLA's update
#: order bit for bit; the CUDA fold sums each node's rows before applying
#: Wm_t (linearity, csrc/ggnn_step.cu), a reassociation, so the row holds
#: the port's fp32 contract, 1e-5.
DEFAULT_TOLERANCES: dict[tuple[str, str], float] = {
    ("fold", "fp32"): 1e-5,
    ("mxu", "fp32"): 1e-5,
    ("fold", "bf16"): 5e-2,
    ("mxu", "bf16"): 5e-2,
    ("fold", "int8"): INT8_TOLERANCE,
    ("mxu", "int8"): INT8_TOLERANCE,
}

#: the reference's default grids
DEFAULT_BLOCK_NODES = (64, 128, 256, 512)
DEFAULT_BLOCK_EDGES = (128, 256, 512, 1024)
DEFAULT_ACCUMS = ("fp32", "bf16", "int8")
DEFAULT_UNROLLS = ("per_step", "fused")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One kernel layout (hashable, JSON-able; the reference's labels)."""

    block_n: int
    block_e: int
    scatter: str = "fold"  # fold | mxu
    accum: str = "fp32"  # fp32 | bf16 | int8
    unroll: str = "per_step"  # per_step | fused

    @property
    def label(self) -> str:
        suffix = "" if self.unroll == "per_step" else f"-{self.unroll}"
        return f"bn{self.block_n}-be{self.block_e}-{self.scatter}-{self.accum}{suffix}"

    def as_dict(self) -> dict:
        return {"candidate": self.label, "block_n": self.block_n, "block_e": self.block_e,
                "scatter": self.scatter, "accum": self.accum, "unroll": self.unroll}


def prune_reason(n: int, e: int, d: int, cand: Candidate, *, n_etypes: int = 1,
                 n_steps: int = 1, budget_bytes: int = gk.CPU_BUDGET_BYTES) -> str | None:
    """Why `cand` cannot run on the card at (n, e, d), or None."""
    if e % cand.block_e:
        return f"block_e {cand.block_e} does not divide edge budget {e}"
    if cand.block_n != gk.NODE_TILE:
        return (f"block_n {cand.block_n}: the CUDA kernels tile {gk.NODE_TILE} nodes "
                f"(nn/ggnn_kernel.py:NODE_TILE)")
    default_be = gk.edge_block(e)
    if cand.scatter == "fold" and cand.block_e != default_be:
        return (f"duplicate: under fold block_e does not enter the launch (the CUDA fold "
                f"walks CSR runs); kept at block_e {default_be}")
    if cand.unroll == "fused":
        mode, why = gk.resolve_unroll(
            "fused", n=n, d=d, n_steps=n_steps, accum=cand.accum, scan_steps=False,
            budget_bytes=budget_bytes, scatter=cand.scatter, n_eb=e // cand.block_e,
            n_etypes=n_etypes)
        if mode != "fused":
            return f"fused unroll residency: {why} (state chain resident across {n_steps} steps)"
    return None


def enumerate_candidates(
    n: int,
    e: int,
    d: int,
    n_etypes: int = 1,
    block_nodes: Sequence[int] = DEFAULT_BLOCK_NODES,
    block_edges: Sequence[int] = DEFAULT_BLOCK_EDGES,
    scatters: Sequence[str] = ("fold", "mxu"),
    accums: Sequence[str] = DEFAULT_ACCUMS,
    unrolls: Sequence[str] = DEFAULT_UNROLLS,
    n_steps: int = 1,
    budget_bytes: int = gk.CPU_BUDGET_BYTES,
) -> tuple[list[Candidate], list[dict]]:
    """(survivors, pruned rows with their reasons) for one signature,
    under the card's rules (`prune_reason`)."""
    survivors: list[Candidate] = []
    pruned: list[dict] = []
    seen: set[Candidate] = set()
    for bn in block_nodes:
        for be in block_edges:
            for scatter in scatters:
                for accum in accums:
                    for unroll in unrolls:
                        cand = Candidate(int(bn), int(be), scatter, accum, unroll)
                        if cand in seen:
                            continue
                        seen.add(cand)
                        reason = prune_reason(n, e, d, cand, n_etypes=n_etypes,
                                              n_steps=n_steps, budget_bytes=budget_bytes)
                        if reason is None:
                            survivors.append(cand)
                        else:
                            pruned.append({**cand.as_dict(), "reason": reason})
    return survivors, pruned


def numerics_verdict(got: np.ndarray, ref: np.ndarray, cand: Candidate,
                     tolerances: dict[tuple[str, str], float] | None = None) -> dict:
    """The verdict every candidate row carries: relative max error
    against the oracle, within the candidate's (scatter, accum)
    tolerance."""
    tol_table = tolerances if tolerances is not None else DEFAULT_TOLERANCES
    tol = tol_table.get((cand.scatter, cand.accum), 0.0)
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    rel = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))
    return {"ok": bool(rel <= tol), "rel_err": round(rel, 10), "tolerance": tol,
            "mode": f"{cand.scatter}/{cand.accum}"}


def _workload(n: int, e: int, d: int, device, seed: int = 0):
    """The reference's workload: one padded graph of CFG degree (dst-
    sorted edges, a padding tail), as a batch on `device`, and a feature
    table [n, d]."""
    from deepdfa_tpu_torch.graphs.batch import GraphBatch

    rng = np.random.default_rng(seed)
    n_real = int(min(e * 0.9, n * 2.0))
    dst = np.sort(rng.integers(0, n - 1, n_real)).astype(np.int32)
    src = rng.integers(0, n - 1, n_real).astype(np.int32)
    edge_src = np.full((e,), n - 1, np.int32)
    edge_dst = np.full((e,), n - 1, np.int32)
    edge_src[:n_real] = src
    edge_dst[:n_real] = dst
    edge_mask = np.zeros((e,), bool)
    edge_mask[:n_real] = True
    feat = rng.standard_normal((n, d)).astype(np.float32)
    batch = GraphBatch(
        node_feats=np.zeros((n, 4), np.int32), node_vuln=np.zeros((n,), np.int32),
        node_graph=np.zeros((n,), np.int32), node_mask=np.ones((n,), bool),
        edge_src=edge_src, edge_dst=edge_dst, edge_mask=edge_mask,
        graph_label=np.ones((1,), np.float32), graph_mask=np.ones((1,), bool),
        graph_ids=np.zeros((1,), np.int32), num_graphs=1,
    )
    return batch.to(device), torch.from_numpy(feat).to(device)


def step_flops(n: int, e_live: int, d: int, n_etypes: int) -> float:
    """fp32 operations of one step as the reference's function counts
    them: the per-edge messages, the GRU's two products and the sums."""
    return 2.0 * e_live * d * d * n_etypes + 12.0 * n * d * d + 2.0 * e_live * d


def _plain_oracle(conv, batch, feat) -> torch.Tensor:
    """The port's plain fp32 fold path on the batch's device: every step
    of `ggnn_step_plain`, whatever device (the kernels never run here)."""
    edges = gk.prepare_edges(batch.edge_src, batch.edge_dst, batch.edge_mask, batch.edge_type,
                             feat.shape[0], conv.n_etypes)
    gru = conv.gru
    return gk.ggnn_fused_plain(
        feat, edges, conv.etype_kernel, conv.etype_bias, gru.input_kernel, gru.hidden_kernel,
        gru.input_bias, gru.hidden_bias, n_steps=conv.n_steps)[0]


def _timed(fn, device) -> tuple[float, np.ndarray]:
    """(seconds from a synchronized device to the result on the host,
    the result)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn().cpu().numpy()
    return time.perf_counter() - t0, out


def search_kernel(
    signatures: Sequence[tuple[int, int, int]],
    n_steps: int = 5,
    n_etypes: int = 1,
    candidates: Sequence[Candidate] | None = None,
    reps: int = 3,
    device: str | torch.device | None = None,
    compile_budget_s: float = 0.0,
    ceiling_flops_per_sec: float = 0.0,
    tolerances: dict[tuple[str, str], float] | None = None,
    **enumerate_kw,
) -> dict:
    """Measured search over kernel layouts on `device` (None: the card);
    {"NxExD": record} per signature. Each record carries the oracle's
    time, every candidate row (first-call seconds, best-of-reps step
    time, numerics verdict), the pruned rows and the winner."""
    from deepdfa_tpu_torch.core.device import resolve_device
    from deepdfa_tpu_torch.nn.gnn import GatedGraphConv

    dev = resolve_device(device)
    out: dict[str, dict] = {}
    budget_left = float(compile_budget_s) if compile_budget_s else None
    for n, e, d in signatures:
        sig = f"{n}x{e}x{d}"
        batch, feat = _workload(n, e, d, dev)
        e_live = int(batch.edge_mask.sum())
        oracle = GatedGraphConv(d, n_steps, n_etypes)
        oracle.reset_parameters(torch.Generator().manual_seed(0))
        oracle = oracle.to(dev)
        weights = oracle.state_dict()
        with torch.inference_mode():
            lax_compile_s, ref = _timed(lambda: _plain_oracle(oracle, batch, feat), dev)
        flops = step_flops(n, e_live, d, n_etypes)
        if candidates is None:
            cands, pruned = enumerate_candidates(
                n, e, d, n_etypes=n_etypes, n_steps=n_steps,
                budget_bytes=gk.fused_budget_bytes(dev), **enumerate_kw)
        else:
            cands, pruned = list(candidates), []

        rows: list[dict] = []
        runnable: list[tuple[Candidate, object, dict]] = []
        for cand in cands:
            if budget_left is not None and budget_left <= 0:
                rows.append({**cand.as_dict(), "skipped": "compile-seconds budget exhausted"})
                continue
            conv = GatedGraphConv(d, n_steps, n_etypes, use_kernel=True, accum=cand.accum,
                                  scatter=cand.scatter, block_edges=cand.block_e,
                                  unroll=cand.unroll).to(dev)
            conv.load_state_dict(weights)
            row = cand.as_dict()
            if cand.unroll == "fused":
                row["residency_bytes"] = gk.fused_residency_bytes(
                    n, d, cand.accum, n_steps, scatter=cand.scatter,
                    n_eb=e // cand.block_e, n_etypes=n_etypes)

            def fn(conv=conv):
                return conv(batch, feat)

            t0 = time.perf_counter()
            try:
                with torch.inference_mode():
                    _, got = _timed(fn, dev)
            except Exception as exc:  # a failing candidate costs one row, never the search
                if budget_left is not None:
                    budget_left -= time.perf_counter() - t0
                row["error"] = f"{type(exc).__name__}: {exc}"[:200]
                rows.append(row)
                continue
            dt = time.perf_counter() - t0
            if budget_left is not None:
                budget_left -= dt
            row["compile_seconds"] = round(dt, 3)
            # looked up on the module: tests replace the verdict to show that
            # a candidate failing it never wins
            row["numerics"] = numerics_verdict(got, ref, cand, tolerances=tolerances)
            rows.append(row)
            runnable.append((cand, fn, row))

        # interleaved best-of-reps: every candidate and the oracle once a
        # round, so drift hits all alike; the fastest window is kept
        best: dict[str, float] = {}
        lax_best = None
        with torch.inference_mode():
            for _ in range(max(1, int(reps))):
                dt, _ = _timed(lambda: _plain_oracle(oracle, batch, feat), dev)
                lax_best = dt if lax_best is None else min(lax_best, dt)
                for cand, fn, _row in runnable:
                    dt, _ = _timed(fn, dev)
                    best[cand.label] = min(best.get(cand.label, dt), dt)

        for cand, _fn, row in runnable:
            step_s = best[cand.label] / max(1, n_steps)
            row["step_us"] = round(step_s * 1e6, 2)
            if ceiling_flops_per_sec > 0:
                row["mfu_vs_measured_ceiling"] = round(flops / step_s / ceiling_flops_per_sec, 6)

        ok_rows = [r for r in rows if r.get("numerics", {}).get("ok") and "step_us" in r]
        winner = min(ok_rows, key=lambda r: r["step_us"]) if ok_rows else None
        rec: dict = {
            "signature": sig,
            "n_steps": int(n_steps),
            "n_etypes": int(n_etypes),
            "device": str(dev),
            "lax_step_us": round(lax_best / max(1, n_steps) * 1e6, 2),
            "lax_compile_seconds": round(lax_compile_s, 3),
            "flops_per_step": flops,
            "candidates": rows,
            "pruned": pruned,
            "winner": winner["candidate"] if winner else None,
        }
        if winner:
            rec.update({
                "winner_step_us": winner["step_us"], "winner_block_n": winner["block_n"],
                "winner_block_e": winner["block_e"], "winner_scatter": winner["scatter"],
                "winner_accum": winner["accum"], "winner_unroll": winner["unroll"],
            })
            if "mfu_vs_measured_ceiling" in winner:
                rec["winner_mfu_vs_measured_ceiling"] = winner["mfu_vs_measured_ceiling"]
        else:
            rec["error"] = ("no candidate passed the numerics contract — defaults stay in "
                            "force for this signature")
        out[sig] = rec
    return out
