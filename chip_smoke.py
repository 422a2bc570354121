#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`deepdfa_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 and
the CUDA toolkit; it needs no install, no network and no JAX. Each phase
prints one JSON line; any failure exits non-zero before the last line.

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel source of the package from csrc/,
   one nvcc each, all started together;
3. kernel ggnn_step — the forward kernel against its plain PyTorch
   version on the card (fp32, rtol 1e-4, atol 1e-5) at the flagship
   batch (N 16384, E 65536, d 128, T 1), a T = 3 batch and the
   all-padding batch; median times over 20 CUDA-event runs and the
   card's bound;
4. kernel ggnn_gru_bwd, kernel ggnn_dmsg — the two backward kernels
   (B3, B4) against their plain versions at the same three batches, the
   same way (the parameter cotangents, sums over every node, are held
   with atol 1e-5 times their largest magnitude);
5. serve   — a flagship-width DeepDFA (hidden 32, 5 steps, input_dim
   1002, random weights from a seeded generator) behind a started
   DynamicBatcher answers seeded synthetic requests; every probability
   is finite and in (0, 1), matches the same model on the CPU (plain
   path, rtol 1e-4, atol 1e-5), and the kernel ran n_steps times per
   executed batch;
6. profile — where one full serving batch's time goes: host stages,
   device time by kernel (torch.profiler) and the device's idle share;
7. train   — GraphTrainer.fit of a flagship-width DeepDFA (AdamW, lr
   1e-3, wd 1e-2) on seeded labelled graphs of 10-400 nodes, packed by
   the bucket planner at 256 graphs / 16384 nodes / 65536 edges: 20
   steps over 4 fixed batches. Every loss is finite and the last epoch's
   mean is below the first's; each of the three kernels launched
   steps x 5 times (plus 5 forward launches per evaluated batch); two
   backward passes on one batch give bit-equal gradients; the first 3
   steps on the CPU plain path match the card's losses (rtol 1e-4) and
   step-1 gradients (1e-4 of each leaf's scale); median ms per step
   split into host pack, forward, backward and optimiser, and graphs/s;
8. kernels — every kernel with its launches on the main paths (serve
   and train, each counted from 0), error, time, plain time and bound.

The line before the last is nvidia-smi's "name, power.limit"; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP_CONFIG = ROOT / "configs" / "bigvul_deepdfa.json"
RTOL, ATOL = 1e-4, 1e-5
# published H100 SXM peaks (dense): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TIMED_RUNS = 20
N_REQUESTS = 96
TRAIN_BATCHES, TRAIN_EPOCHS = 4, 5
CPU_STEPS = 3


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def synthetic_graph(rng, gid: int, n: int, input_dim: int, n_etypes: int = 1,
                    signal: bool = False):
    """A CFG-like graph: a fall-through chain plus random jumps, about
    1.5 edges per node. With `signal`, every other graph carries token 7
    on one node, which is its vulnerable node and makes its label 1 (a
    learnable signal, as in tests/test_train.py)."""
    import numpy as np

    from deepdfa_tpu_torch.graphs import GraphSpec

    extra = max(0, int(round(1.5 * n)) - (n - 1))
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, extra)]).astype(np.int32)
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, extra)]).astype(np.int32)
    feats = rng.integers(0 if not signal else 8, input_dim, (n, 4)).astype(np.int32)
    vuln = np.zeros((n,), np.int32)
    if signal and gid % 2 == 0:
        k = int(rng.integers(0, n))
        feats[k, 0] = 7
        vuln[k] = 1
    return GraphSpec(
        graph_id=gid,
        node_feats=feats,
        node_vuln=vuln,
        edge_src=src,
        edge_dst=dst,
        label=float(vuln.max()) if signal else float(gid % 2),
        edge_type=(
            rng.integers(0, n_etypes, src.shape[0]).astype(np.int32)
            if n_etypes > 1 else None
        ),
    )


def full_batch(rng, node_budget: int, edge_budget: int, n_etypes: int):
    """As many seeded graphs of 10-400 nodes as the budgets hold."""
    from deepdfa_tpu_torch.graphs import pack

    graphs, nodes, edges = [], 0, 0
    while True:
        g = synthetic_graph(rng, len(graphs), int(rng.integers(10, 401)), 1002, n_etypes)
        if nodes + g.num_nodes > node_budget or edges + g.num_edges + g.num_nodes > edge_budget:
            break
        graphs.append(g)
        nodes += g.num_nodes
        edges += g.num_edges + g.num_nodes
    return pack(graphs, 256, node_budget, edge_budget)


def median_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of `fn` over `runs` CUDA-event windows. A spin
    kernel queued ahead of each window keeps the card busy while the
    host enqueues, so host-side wrapper time is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def roofline(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the fp32 operations over the
    card's fp32 peak and the bytes over its HBM rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def step_bound(n: int, e_live: int, d: int, t: int, with_aggregate: bool):
    """(bound_ms, bound_by) of one GGNN step: the larger of the fp32
    operations over the card's fp32 peak and the bytes over its HBM
    rate. Operations: 2*d per live edge (the run sums), 2*N*d^2*T (the
    per-type transform), 12*N*d^2 (the two GRU products); the gate
    arithmetic (~30 per node and column, under 2%) is not counted.
    Bytes: h read and h' (and a) written once, the live edges' src and
    weights, the row pointer, the weights."""
    flops = 2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d
    weights = t * d * d + t * d + 2 * (3 * d * d + 3 * d)
    nbytes = 4 * (
        n * d * (3 if with_aggregate else 2) + e_live * (1 + t) + (n + 1) + weights
    )
    return roofline(flops, nbytes)


def kernel_phase(torch, rng):
    from deepdfa_tpu_torch.graphs import pack
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    d = 128
    gen = torch.Generator().manual_seed(1)
    cases = {
        "flagship": full_batch(rng, 16384, 65536, 1),
        "etypes3": full_batch(rng, 16384, 65536, 3),
        "all_padding": pack([], 16, 16384, 65536),
    }
    report, worst = {}, 0.0
    timing = None
    for name, batch in cases.items():
        t = 3 if name == "etypes3" else 1
        b = batch.to("cuda")
        n, e = b.node_budget, b.edge_budget
        scale = d ** -0.5
        h = torch.randn(n, d, generator=gen).cuda()
        wm = (torch.randn(t, d, d, generator=gen) * scale).cuda()
        bm = (torch.randn(t, d, generator=gen) * 0.1).cuda()
        wih = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        whh = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        bih = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        bhh = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        params = (wm, bm, wih, whh, bih, bhh)
        edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, t)
        e_live = int(b.edge_mask.sum())
        if int(edges.rowptr[-1]) != e_live:
            fail(f"{name}: rowptr[N] {int(edges.rowptr[-1])} != live edges {e_live}")
        with torch.inference_mode():
            h_k, a_k = gk.ggnn_step(h, edges, *params, with_aggregate=True)
            h_k2, a_none = gk.ggnn_step(h, edges, *params)
            h_p, a_p = gk.ggnn_step_plain(h, edges, *params)
        torch.cuda.synchronize()
        if a_none is not None:
            fail(f"{name}: aggregate returned without being asked for")
        for what, got, want in (("h", h_k, h_p), ("a", a_k, a_p), ("h_no_a", h_k2, h_p)):
            if not torch.isfinite(got).all():
                fail(f"{name}: kernel {what} has non-finite values")
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                fail(f"{name}: kernel {what} differs from the plain version, max abs err {err}")
            report[f"{name}_{what}_max_abs_err"] = err
        if name == "flagship":
            with torch.inference_mode():
                ms = median_ms(torch, lambda: gk.ggnn_step(h, edges, *params))
                plain_ms = median_ms(torch, lambda: gk.ggnn_step_plain(h, edges, *params))
            bound_ms, bound_by = step_bound(n, e_live, d, t, with_aggregate=False)
            timing = {
                "n": n, "e": e, "e_live": e_live, "d": d, "n_etypes": t,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "blocks": gk.block_sizes(n)[1],
            }
    emit({"phase": "kernel ggnn_step", "ok": True, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report, **timing})
    return worst, timing


def serve_phase(torch, rng):
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import DynamicBatcher, GgnnExecutor, score_graphs

    cfg = load(FLAGSHIP_CONFIG)
    input_dim = cfg.data.feat.input_dim
    model = DeepDFA.from_config(
        cfg.model, input_dim, generator=torch.Generator().manual_seed(0)
    )
    model_cpu = copy.deepcopy(model)
    specs = [
        synthetic_graph(rng, i, int(rng.integers(10, 401)), input_dim)
        for i in range(N_REQUESTS)
    ]
    gk.LAUNCHES = 0
    summary = score_graphs(model, specs, cfg, device="cuda")
    launches = gk.LAUNCHES
    probs = np.asarray(summary.pop("probs"), dtype=np.float64)
    if summary["serve_scored"] != len(specs) or not np.all(np.isfinite(probs)):
        fail(f"serve: {summary['serve_failed_requests']} requests failed or non-finite")
    if not np.all((probs > 0.0) & (probs < 1.0)):
        fail("serve: a probability outside (0, 1)")
    want = summary["serve_batches"] * cfg.model.n_steps
    if summary["ggnn_step_launches"] != want:
        fail(f"serve: {summary['ggnn_step_launches']} kernel launches, "
             f"expected batches x n_steps = {want}")
    # the same model on the CPU, plain path, offline drive
    node_budget = cfg.serve.node_budget or cfg.data.batch.node_budget
    edge_budget = cfg.serve.edge_budget or cfg.data.batch.edge_budget
    cpu = GgnnExecutor(model_cpu, node_budget, edge_budget,
                       cfg.serve.max_batch_graphs, device="cpu")
    ref = np.asarray([r.wait(600) for r in DynamicBatcher(cpu).score_all(specs)])
    err = float(np.abs(probs - ref).max())
    if not np.allclose(probs, ref, rtol=RTOL, atol=ATOL):
        fail(f"serve: probabilities differ from the CPU plain path, max abs err {err}")
    emit({"phase": "serve", "ok": True, "requests": len(specs),
          "kernel_launches": launches, "cpu_max_abs_err": err,
          "node_budget": node_budget, "edge_budget": edge_budget,
          "max_batch_graphs": cfg.serve.max_batch_graphs, **summary})
    return launches, model, specs[: cfg.serve.max_batch_graphs], (node_budget, edge_budget)


def profile_phase(torch, model, specs, budgets) -> None:
    """Where one full serving batch's time goes: host stages timed with
    synchronize (median of 10), then one batch under torch.profiler for
    device time by kernel and the device's idle share of the batch."""
    from torch.profiler import ProfilerActivity, profile

    from deepdfa_tpu_torch.serve import GgnnExecutor

    ex = GgnnExecutor(model, *budgets, len(specs), device="cuda")
    ex.warmup()
    stages = {"pack_ms": [], "to_device_ms": [], "forward_ms": [], "fetch_ms": [], "batch_ms": []}
    for _ in range(10):
        t0 = time.perf_counter()
        _, (_, batch) = ex.pack_chunk("graph", specs)
        t1 = time.perf_counter()
        b = batch.to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            probs = torch.sigmoid(ex.model(b))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ex.fetch(probs, len(specs))
        t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0)):
            stages[k].append(1e3 * v)
    _, packed = ex.pack_chunk("graph", specs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.fetch(ex.dispatch("graph", packed), len(specs))
        profiled_ms = 1e3 * (time.perf_counter() - t0)

    emit({"phase": "profile", "graphs": len(specs),
          **{k: statistics.median(v) for k, v in stages.items()},
          **device_profile(prof, profiled_ms)})


def device_profile(prof, window_ms: float) -> dict:
    """Device busy time, idle share of the window and the top kernels
    by device time, from a torch.profiler run over that window."""

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernels and copies only: an operator's own row and a user-annotated
    # range (the optimizer's step) repeat their kernels' time
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and device_us(e) > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:8]
    return {"profiled_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / window_ms) if window_ms > 0 else None,
            "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top},
            "top_device_calls": {e.key[:60]: e.count for e in top}}


def gru_bwd_bound(n: int, d: int):
    """(bound_ms, bound_by) of B3: 36*N*d^2 operations (the two
    recomputed gate products, da, dh_gru and the two weight products, 6*N*d^2
    each), the gate chain not counted; bytes: h, a, g read and da, dh
    written once, the weights read and their cotangents written once."""
    flops = 36 * n * d * d
    nbytes = 4 * (5 * n * d + 2 * (2 * 3 * d * d + 2 * 3 * d))
    return roofline(flops, nbytes)


def dmsg_bound(n: int, e_live: int, d: int, t: int):
    """(bound_ms, bound_by) of B4: 2*N*d^2*T (q_t = da @ Wm_t^T per node)
    plus 2*d per live edge (each live edge has one type); bytes: da read
    and dh_msg written once, the live edges' dst and T weights, the src
    row pointer, Wm."""
    flops = 2 * n * d * d * t + 2 * e_live * d
    nbytes = 4 * (2 * n * d + e_live * (1 + t) + (n + 1) + t * d * d)
    return roofline(flops, nbytes)


def bwd_kernel_phase(torch, rng):
    """B3 and B4 against their plain versions at the flagship, T = 3
    and all-padding batches; timings at the flagship batch."""
    from deepdfa_tpu_torch.graphs import pack
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    d = 128
    gen = torch.Generator().manual_seed(2)
    cases = {
        "flagship": full_batch(rng, 16384, 65536, 1),
        "etypes3": full_batch(rng, 16384, 65536, 3),
        "all_padding": pack([], 16, 16384, 65536),
    }
    names = ("da", "dh", "dwih", "dwhh", "dbih", "dbhh")
    reports = {"ggnn_gru_bwd": {}, "ggnn_dmsg": {}}
    worst = {"ggnn_gru_bwd": 0.0, "ggnn_dmsg": 0.0}
    timing = {}
    for name, batch in cases.items():
        t = 3 if name == "etypes3" else 1
        b = batch.to("cuda")
        n = b.node_budget
        scale = d ** -0.5
        h, a = (torch.randn(n, d, generator=gen).cuda() for _ in range(2))
        g = (torch.randn(n, d, generator=gen) * 1e-2).cuda()
        wm = (torch.randn(t, d, d, generator=gen) * scale).cuda()
        wih = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        whh = (torch.randn(d, 3 * d, generator=gen) * scale).cuda()
        bih = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        bhh = (torch.randn(3 * d, generator=gen) * 0.1).cuda()
        gru = (wih, whh, bih, bhh)
        edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, t,
                                 transpose=True)
        e_live = int(b.edge_mask.sum())
        if int(edges.srcptr[-1]) != e_live:
            fail(f"{name}: srcptr[N] {int(edges.srcptr[-1])} != live edges {e_live}")
        with torch.inference_mode():
            got = gk.gru_bwd(h, a, *gru, g)
            want = gk.gru_bwd_plain(h, a, *gru, g)
            got_msg = gk.dmsg(a, edges, wm)
            want_msg = gk.dmsg_plain(a, edges, wm)
            again = gk.gru_bwd(h, a, *gru, g), gk.dmsg(a, edges, wm)
        torch.cuda.synchronize()
        checks = [("ggnn_gru_bwd", k, x, y) for k, x, y in zip(names, got, want)]
        checks.append(("ggnn_dmsg", "dh_msg", got_msg, want_msg))
        for kernel, what, x, y in checks:
            if not torch.isfinite(x).all():
                fail(f"{name}: {kernel} {what} has non-finite values")
            err = (x - y).abs().max().item()
            # parameter cotangents sum over every node: atol scales with them
            atol = ATOL * max(1.0, y.abs().max().item()) if what.startswith("dw") or \
                what.startswith("db") else ATOL
            if not torch.allclose(x, y, rtol=RTOL, atol=atol):
                fail(f"{name}: {kernel} {what} differs from the plain version, max abs err {err}")
            worst[kernel] = max(worst[kernel], err)
            reports[kernel][f"{name}_{what}_max_abs_err"] = err
        if not (all(torch.equal(x, y) for x, y in zip(got, again[0]))
                and torch.equal(got_msg, again[1])):
            fail(f"{name}: a backward kernel gave other bits on a rerun")
        if name == "flagship":
            with torch.inference_mode():
                # the wrapper's two weight transposes are timed with it
                timing["ggnn_gru_bwd"] = {
                    "ms": median_ms(torch, lambda: gk.gru_bwd(h, a, *gru, g)),
                    "plain_ms": median_ms(torch, lambda: gk.gru_bwd_plain(h, a, *gru, g)),
                    **dict(zip(("bound_ms", "bound_by"), gru_bwd_bound(n, d))),
                }
                timing["ggnn_dmsg"] = {
                    "ms": median_ms(torch, lambda: gk.dmsg(a, edges, wm)),
                    "plain_ms": median_ms(torch, lambda: gk.dmsg_plain(a, edges, wm)),
                    **dict(zip(("bound_ms", "bound_by"), dmsg_bound(n, e_live, d, t))),
                }
            shape = {"n": n, "e": b.edge_budget, "e_live": e_live, "d": d, "n_etypes": t}
    for kernel in reports:
        emit({"phase": f"kernel {kernel}", "ok": True, "rtol": RTOL, "atol": ATOL,
              "max_abs_err": worst[kernel], **reports[kernel], **shape, **timing[kernel],
              **({"weight_pass_splits": gk._library("ggnn_bwd").ggnn_gru_bwd_splits(shape["n"])}
                 if kernel == "ggnn_gru_bwd" else {})})
    return worst, timing


def train_batches(cfg, rng):
    """TRAIN_BATCHES fixed batches packed by the bucket planner from
    seeded labelled graphs of 10-400 nodes."""
    from deepdfa_tpu_torch.graphs import shard_bucket_batches

    bcfg = cfg.data.batch
    specs, nodes = [], 0
    while nodes < TRAIN_BATCHES * bcfg.node_budget * 0.97:
        g = synthetic_graph(rng, len(specs), int(rng.integers(10, 401)),
                            cfg.data.feat.input_dim, signal=True)
        specs.append(g)
        nodes += g.num_nodes
    batches = list(shard_bucket_batches(specs, bcfg.graphs_per_batch, bcfg.node_budget,
                                        bcfg.edge_budget))[:TRAIN_BATCHES]
    if len(batches) < TRAIN_BATCHES:
        fail(f"train: packed {len(batches)} batches, need {TRAIN_BATCHES}")
    return specs, batches


def leaf_errors(got: dict, want: dict) -> dict:
    """max |got - want| / max |want| per parameter; each scale floored at
    1e-3 of the largest gradient (the gate's bias gradient vanishes)."""
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    return {k: (got[k] - w).abs().max().item() / max(w.abs().max().item(), floor)
            for k, w in want.items()}


def train_phase(torch, rng):
    """The training main path through GraphTrainer.fit on the card, its
    checks, a CPU cross-check and a per-step time split."""
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = load(FLAGSHIP_CONFIG)
    input_dim = cfg.data.feat.input_dim
    n_steps = cfg.model.n_steps
    specs, batches = train_batches(cfg, rng)
    graphs = [int(b.graph_mask.sum()) for b in batches]
    model = DeepDFA.from_config(cfg.model, input_dim)
    trainer = GraphTrainer(model, cfg, device="cuda")
    state = trainer.init_state(seed=0)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    records = []

    gk.LAUNCHES = gk.GRU_BWD_LAUNCHES = gk.DMSG_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                max_epochs=TRAIN_EPOCHS, log_fn=records.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"ggnn_step": gk.LAUNCHES, "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES,
                "ggnn_dmsg": gk.DMSG_LAUNCHES}
    epochs = [r for r in records if "epoch" in r]
    want = {"ggnn_step": (steps + TRAIN_EPOCHS) * n_steps,  # + one eval batch an epoch
            "ggnn_gru_bwd": steps * n_steps, "ggnn_dmsg": steps * n_steps}
    if launches != want:
        fail(f"train: kernel launches {launches}, expected {want}")
    losses = [r["train_loss"] for r in epochs]
    if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
        fail(f"train: a non-finite loss in {epochs}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: epoch means {losses}")

    # two backward passes on one batch: the same bits
    b0 = batches[0].to(trainer.device)

    def grads():
        trainer.forward_loss(state, b0).backward()
        return {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail("train: two backward passes on one batch gave other gradients")

    # the first CPU_STEPS steps on the CPU plain path against the card
    cpu_model = DeepDFA.from_config(cfg.model, input_dim)
    cpu = GraphTrainer(cpu_model, cfg, device="cpu")
    cpu_state = cpu.init_state(params=init)
    card = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device="cuda")
    card_state = card.init_state(params=init)
    loss_pairs, grad_err = [], None
    for i in range(CPU_STEPS):
        pair = []
        for tr, st in ((card, card_state), (cpu, cpu_state)):
            loss = tr.forward_loss(st, batches[i].to(tr.device))
            loss.backward()
            pair.append((loss.item(), {k: p.grad.detach().cpu() for k, p in tr.model.named_parameters()}))
            st.apply_gradients()
        loss_pairs.append((pair[0][0], pair[1][0]))
        if i == 0:
            grad_err = max(leaf_errors(pair[0][1], pair[1][1]).values())
    loss_err = max(abs(a - b) / abs(b) for a, b in loss_pairs)
    if loss_err > 1e-4 or grad_err > 1e-4:
        fail(f"train: card vs CPU losses {loss_pairs} (rel {loss_err}), step-1 "
             f"gradient rel err {grad_err}")

    # where a step's time goes: median of 10, synchronized at each stage
    from deepdfa_tpu_torch.graphs import shard_bucket_batches

    bcfg = cfg.data.batch
    split = {"host_pack_ms": [], "to_device_ms": [], "forward_ms": [], "backward_ms": [],
             "optimizer_ms": [], "step_ms": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(10):
        t_a = time.perf_counter()
        batch = next(iter(shard_bucket_batches(specs, bcfg.graphs_per_batch,
                                               bcfg.node_budget, bcfg.edge_budget)))
        t_b = time.perf_counter()
        batch = batch.to(trainer.device)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        loss = trainer.forward_loss(state, batch)
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t_f = time.perf_counter()
        for k, v in zip(split, (t_b - t_a, t_c - t_b, t_d - t_c, t_e - t_d, t_f - t_e, t_f - t_a)):
            split[k].append(1e3 * v)
    med = {k: statistics.median(v) for k, v in split.items()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    emit({"phase": "train", "ok": True, "steps": steps, "epochs": TRAIN_EPOCHS,
          "graphs_per_batch": graphs, "node_budget": bcfg.node_budget,
          "edge_budget": bcfg.edge_budget, "epoch_train_loss": losses,
          "epoch_val_loss": [r["val_loss"] for r in epochs],
          "kernel_launches": launches, "grads_bit_equal": True,
          "cpu_losses": loss_pairs, "cpu_loss_rel_err": loss_err,
          "cpu_step1_grad_rel_err": grad_err, "fit_seconds": fit_s,
          "fit_graphs_per_sec": sum(graphs) * TRAIN_EPOCHS / fit_s, **med,
          "graphs_per_sec": graphs[0] / (med["step_ms"] / 1e3),
          "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
          "profiled_step": device_profile(prof, profiled_ms)})
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script runs on a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import deepdfa_tpu_torch
    except ImportError as e:
        fail(f"the deepdfa_tpu_torch package is not beside this script ({e})")
    if Path(deepdfa_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"imported deepdfa_tpu_torch from {deepdfa_tpu_torch.__file__}, not {ROOT}")
    if not FLAGSHIP_CONFIG.exists():
        fail(f"{FLAGSHIP_CONFIG} is missing")
    import numpy as np

    from deepdfa_tpu_torch.nn import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": {
        name: {"cached": r["cached"], "seconds": r["seconds"],
               "ptxas": [ln.strip() for ln in r["log"].splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, r in built.items()}})

    rng = np.random.default_rng(0)
    kernel_err, timing = kernel_phase(torch, rng)
    bwd_err, bwd_timing = bwd_kernel_phase(torch, rng)
    launches, model, batch_specs, budgets = serve_phase(torch, rng)
    if launches <= 0:
        fail("the serve run launched the ggnn_step kernel no time")
    profile_phase(torch, model, batch_specs, budgets)
    train_launches = train_phase(torch, rng)
    if min(train_launches.values()) <= 0:
        fail(f"the train run launched a kernel no time: {train_launches}")
    kernels = [
        {"name": "ggnn_step", "source": "deepdfa_tpu_torch/csrc/ggnn_step.cu",
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:555",
         "launches": launches + train_launches["ggnn_step"], "max_abs_err": kernel_err,
         **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "ggnn_gru_bwd", "source": "deepdfa_tpu_torch/csrc/ggnn_bwd.cu",
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:852",
         "launches": train_launches["ggnn_gru_bwd"], "max_abs_err": bwd_err["ggnn_gru_bwd"],
         **bwd_timing["ggnn_gru_bwd"]},
        {"name": "ggnn_dmsg", "source": "deepdfa_tpu_torch/csrc/ggnn_bwd.cu",
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:907",
         "launches": train_launches["ggnn_dmsg"], "max_abs_err": bwd_err["ggnn_dmsg"],
         **bwd_timing["ggnn_dmsg"]},
    ]
    emit({"kernels": [{"name": k["name"], "route": "cuda", "source": k["source"],
                       "replaces": k["replaces"], "launches": k["launches"],
                       "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                       "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                       "bound_by": k["bound_by"], "library_ms": None} for k in kernels]})
    if not all(math.isfinite(k[f]) for k in kernels for f in ("ms", "plain_ms", "bound_ms")):
        fail("a kernel time is not finite")
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
