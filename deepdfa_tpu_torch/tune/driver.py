"""`cli tune`: one offline search writes one hardware-keyed tuned.json
record (the port's `deepdfa_tpu/tune/driver.py`).

`run_tune` searches the kernel layouts at the configured serving budgets
on the card (every legal fold and mxu instance of kernels 1 and 2 under
each policy, each with its numerics verdict), fits the serve rungs to
replayed serve logs and the seq-bucket edges to a manifest, and writes a
record only when it validates. `run_tune_smoke` is the reference's
acceptance drive: the reference's reduced candidates at its smoke
budgets, synthetic skewed distributions, a valid tuned.json.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from deepdfa_tpu_torch.tune import cache as tune_cache
from deepdfa_tpu_torch.tune import kernel as tune_kernel
from deepdfa_tpu_torch.tune import ladder as tune_ladder

logger = logging.getLogger(__name__)

#: the reference's smoke search: tiny budgets, fold and mxu rows, one
#: fused and one int8 row per scatter. Explicit candidates run as given,
#: as in the reference; on the card block_n is inert (the node tile is
#: fixed), so its rows time the same launch.
SMOKE_BUDGETS = (256, 512, 32)
SMOKE_CANDIDATES = (
    tune_kernel.Candidate(64, 128),
    tune_kernel.Candidate(64, 512),
    tune_kernel.Candidate(256, 128),
    tune_kernel.Candidate(256, 512),
    tune_kernel.Candidate(256, 512, "mxu"),
    tune_kernel.Candidate(256, 512, "fold", "fp32", "fused"),
    tune_kernel.Candidate(256, 512, "fold", "int8"),
    tune_kernel.Candidate(256, 512, "mxu", "int8"),
)


def measure_matmul_ceiling(n: int = 4096, chain: int = 8, reps: int = 3,
                           device: str | torch.device | None = None) -> dict:
    """The measured fp32 matmul rate on `device` (the reference's
    `eval/profiling.py:measure_matmul_ceiling`, in the GGNN's type): a
    chain of [n, n] @ [n, n] products, best of `reps` windows, each from
    a synchronized device to the result on the host. TF32 is off, as
    everywhere in the port."""
    from deepdfa_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    a = torch.ones((n, n), device=dev)
    b = torch.ones((n, n), device=dev)
    inv = 1.0 / n

    def chained():
        x = a
        for _ in range(chain):
            x = (x @ b) * inv
        return x

    chained().cpu()
    best = 0.0
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        chained().cpu()
        best = max(best, chain * 2 * n**3 / (time.perf_counter() - t0))
    return {"matmul_tflops_measured": round(best / 1e12, 3),
            "matmul_probe": f"{chain}x({n}x{n}@{n}x{n}) float32", "device": str(dev)}


def _ceiling_flops(smoke: bool, device) -> float:
    """The measured ceiling in FLOP/s (the smoke's probe is tiny; the
    full search's is the probe's default, ~1.1 TFLOP a window, so the
    host round trip is a small share of it); 0.0 (the MFU fields left
    out) when the probe fails."""
    try:
        m = (measure_matmul_ceiling(n=256, chain=2, reps=1, device=device) if smoke
             else measure_matmul_ceiling(device=device))
        return float(m["matmul_tflops_measured"]) * 1e12
    except Exception as e:  # the probe must never cost the search
        logger.warning("matmul ceiling probe failed: %s", e)
        return 0.0


def skewed_smoke_sizes(seed: int = 0) -> list[int]:
    """The reference's pow2 blind-spot distribution: sizes just above a
    pow2 rung (5 over 4, 9 over 8, 3 over 2)."""
    sizes = [5] * 40 + [9] * 25 + [3] * 10 + [16] * 5
    np.random.default_rng(seed).shuffle(sizes)
    return sizes


def lognormal_smoke_lengths(n: int = 400, max_length: int = 64, seed: int = 0) -> list[int]:
    """The reference's Big-Vul-shaped token lengths (lognormal), clipped
    to the smoke capacity."""
    draws = np.random.default_rng(seed).lognormal(mean=2.8, sigma=0.6, size=n)
    return [int(min(max(x, 2), max_length)) for x in draws]


def run_tune_smoke(out_path: str | Path | None = None, reps: int = 2, n_steps: int = 2,
                   kernel_candidates=SMOKE_CANDIDATES, seed: int = 0,
                   device: str | torch.device | None = None) -> dict:
    """The reference's smoke search on `device` (None: the card):
    reduced candidates, synthetic distributions, a valid tuned.json."""
    from deepdfa_tpu_torch.core.paths import storage_root

    t0 = time.perf_counter()
    n, e, d = SMOKE_BUDGETS
    kernel = tune_kernel.search_kernel(
        [(n, e, d)], n_steps=n_steps, candidates=list(kernel_candidates), reps=reps,
        device=device, ceiling_flops_per_sec=_ceiling_flops(True, device))
    serve_fit = tune_ladder.fit_serve_ladder(skewed_smoke_sizes(seed), capacity=16, max_rungs=4)
    seq_fit = tune_ladder.fit_seq_buckets(lognormal_smoke_lengths(seed=seed), max_length=64,
                                          max_edges=4)
    search_seconds = time.perf_counter() - t0
    record = tune_cache.make_record(
        tune_cache.hardware_key(n, e, device), kernel=kernel,
        ladders={"serve": serve_fit, "seq_buckets": seq_fit}, search_seconds=search_seconds)
    path = Path(out_path) if out_path else storage_root() / "tuned.json"
    doc = tune_cache.upsert_record(tune_cache.load_tuned(path) or tune_cache.empty_doc(), record)
    tune_cache.save_tuned(path, doc)
    # the verdict judges this search's record, not older ones in the file
    verdict = tune_cache.validate_tuned({"version": tune_cache.TUNED_VERSION, "records": [record]})
    sig = f"{n}x{e}x{d}"
    srec = kernel[sig]
    return {
        "tuned_path": str(path),
        "valid": verdict["ok"],
        "problems": verdict["problems"],
        "device": srec["device"],
        "signature": sig,
        "winner": srec.get("winner"),
        "winner_blocks": [srec.get("winner_block_n"), srec.get("winner_block_e")],
        "candidates_timed": sum(1 for r in srec["candidates"] if "step_us" in r),
        "candidates_rejected": sum(1 for r in srec["candidates"]
                                   if r.get("numerics", {}).get("ok") is False),
        "tuned_ggnn_step_us": srec.get("winner_step_us"),
        "lax_step_us": srec.get("lax_step_us"),
        "serve_rungs": serve_fit["rungs"],
        "tuned_ladder_padding_waste": serve_fit["padding_waste"],
        "pow2_ladder_padding_waste": serve_fit["pow2_padding_waste"],
        "seq_bucket_edges": seq_fit["edges"],
        "seq_bucket_padding_waste": seq_fit["padding_waste"],
        "seq_bucket_pow2_padding_waste": seq_fit["pow2_padding_waste"],
        "tune_search_seconds": round(search_seconds, 3),
    }


def run_tune(cfg, serve_logs: list[str] | None = None, manifest: str | None = None,
             out_path: str | Path | None = None, skip_kernel: bool = False,
             device: str | torch.device | None = None) -> dict:
    """The full offline search at the configured serving budgets on
    `device` (None: the card): every card-legal kernel candidate, the
    serve-ladder fit from the given logs, the seq-bucket fit from a
    manifest. Sections without evidence are skipped with a note. The new
    record is validated alone before it touches the file, so a failed
    search never replaces a good record."""
    t0 = time.perf_counter()
    node_budget = cfg.serve.node_budget or cfg.data.batch.node_budget
    edge_budget = cfg.serve.edge_budget or cfg.data.batch.edge_budget
    d = tune_cache.ggnn_feature_width(cfg.model)
    notes: list[str] = []
    kernel = None
    per_compile_s = 0.0
    if skip_kernel:
        notes.append("kernel search skipped (--skip-kernel)")
    else:
        kernel = tune_kernel.search_kernel(
            [(node_budget, edge_budget, d)], n_steps=cfg.model.n_steps,
            n_etypes=cfg.model.n_etypes, reps=cfg.tune.reps, device=device,
            compile_budget_s=cfg.tune.compile_budget_s,
            ceiling_flops_per_sec=_ceiling_flops(False, device))
        sig = kernel.get(f"{node_budget}x{edge_budget}x{d}") or {}
        per_compile_s = float(sig.get("lax_compile_seconds") or 0.0)
    ladders: dict = {}
    sizes: list[int] = []
    for log in serve_logs or []:
        sizes.extend(tune_ladder.batch_sizes_from_log(log))
    if sizes:
        ladders["serve"] = tune_ladder.fit_serve_ladder(
            sizes, capacity=cfg.serve.max_batch_graphs, max_rungs=cfg.tune.max_rungs,
            compile_budget_s=cfg.tune.compile_budget_s, per_compile_s=per_compile_s)
    else:
        notes.append("serve ladder fit skipped: no observed batch sizes (pass --serve-log "
                     "with a log of request entries carrying batch_size)")
    if manifest:
        lengths = tune_ladder.lengths_from_manifest(manifest)
        if lengths and cfg.data.seq_buckets:
            ladders["seq_buckets"] = tune_ladder.fit_seq_buckets(
                lengths, max_length=int(cfg.data.seq_buckets[-1]),
                max_edges=cfg.tune.max_seq_buckets, compile_budget_s=cfg.tune.compile_budget_s,
                per_compile_s=per_compile_s)
        else:
            notes.append("seq-bucket fit skipped: empty manifest or no data.seq_buckets to "
                         "anchor the max edge")
    else:
        notes.append("seq-bucket fit skipped: no --manifest")
    search_seconds = time.perf_counter() - t0
    record = tune_cache.make_record(tune_cache.hardware_key(node_budget, edge_budget, device),
                                    kernel=kernel, ladders=ladders or None,
                                    search_seconds=search_seconds)
    path = Path(out_path) if out_path else tune_cache.tuned_path(cfg)
    verdict = tune_cache.validate_tuned({"version": tune_cache.TUNED_VERSION, "records": [record]})
    if verdict["ok"]:
        doc = tune_cache.upsert_record(tune_cache.load_tuned(path) or tune_cache.empty_doc(),
                                       record)
        tune_cache.save_tuned(path, doc)
    else:
        notes.append("search produced an invalid record — tuned.json left untouched (fix the "
                     "inputs and re-run)")
        logger.warning("not persisting invalid tuned record: %s", verdict["problems"])
    report = {
        "tuned_path": str(path),
        "valid": verdict["ok"],
        "problems": verdict["problems"],
        "hardware": record["hardware"],
        "notes": notes,
        "tune_search_seconds": round(search_seconds, 3),
    }
    if kernel:
        sig_label = f"{node_budget}x{edge_budget}x{d}"
        srec = kernel.get(sig_label) or {}
        report["kernel"] = {
            "signature": sig_label,
            "winner": srec.get("winner"),
            "winner_step_us": srec.get("winner_step_us"),
            "lax_step_us": srec.get("lax_step_us"),
            "candidates": len(srec.get("candidates") or []),
            "pruned": len(srec.get("pruned") or []),
        }
    if "serve" in ladders:
        report["serve_ladder"] = ladders["serve"]
    if "seq_buckets" in ladders:
        report["seq_buckets"] = ladders["seq_buckets"]
    print(json.dumps(report), flush=True)
    return report
