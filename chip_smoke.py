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
   with atol 1e-5 times their largest magnitude); B3's time beside its
   first design's (GRU_BWD_BASELINE_MS), and on a line before the
   phase's, one B3 call's device time split by launch (torch.profiler);
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
7a. kernel ggnn_step_policy — kernel 1's bf16 and int8 instances
   against the plain version of the same policy on the card (the same
   rounded or quantized rows: rtol 1e-4, atol 1e-5) at the three
   batches of phase 3, the same bits on a rerun, the aggregate moved off
   fp32's; times, plain times and bounds at the flagship batch;
7b. kernel ggnn_fused — kernel 2 (5 steps in one cooperative launch)
   under fp32, bf16 and int8 at the same three batches: h_out, with and
   without the chain, and every chain plane the bits of 5 launches of
   kernel 1 of the policy, the same bits on a repeat, and each of its
   steps within rtol 1e-4 / atol 1e-5 of the plain step from that step's
   input (five plain steps from the first input are not compared: a
   rounding or a quantum can flip between two fp32 summation orders and
   spread); times with and without the chain beside the 5 step
   launches', one step in one launch beside one step launch, the plain
   version's and the bounds; the residency against the card's L2;
7c. serve_bf16, serve_fused, serve_int8, serve_int8_fused — phase 5's
   model and requests through score_graphs with model.ggnn_kernel=true
   under (bf16, per_step), (fp32, fused), (int8, per_step), (int8,
   fused), each counted from 0: every request scored, no fused fallback,
   the variant's kernel n_steps times (fused: once) a batch and no other,
   scores within 5e-2 of scale of phase 5's fp32 scores and, for a
   policy, not equal to them; requests/s and p50/p99; then
   serve_variants: on fixed batches (the offline drive) the fused scores
   are the bits of the per-step scores of the same policy;
7d. train_fused, train_bf16 — phase 7's fit with model.ggnn_kernel=true
   under (fp32, fused) and (bf16, per_step), 20 AdamW steps, counted from
   0: losses finite and falling, the launches the unroll implies (fused:
   one launch with the chain a step and one without an eval batch, then
   5 kernel-1 recomputes, 5 B3 and 5 B4 a step), step-1 gradients of the
   fused unroll the bits of the per-step one, median step ms;
7e. kernel ggnn_step_mxu — kernel 1's mxu instances (fp32, bf16, int8;
   edge block 512) against the plain mxu version of the same policy on
   the card (rtol 1e-4, atol 1e-5) at the three batches of phase 3, int8
   also at edge blocks 128 and 1024 on the flagship batch (each against
   its own plain version, and not block 512's aggregate), the same bits
   on a rerun, the int8 mxu aggregate not the int8 fold one; times, the
   fold instance's times, plain times and bounds at the flagship batch;
7f. kernel ggnn_fused_mxu — kernel 2's mxu instances (5 steps) under each
   policy at the same batches: h_out, with and without the chain, and
   every chain plane the bits of 5 launches of kernel 1's mxu instance,
   the same bits on a repeat, each step within rtol 1e-4 / atol 1e-5 of
   the plain mxu step from that step's input; times, bounds and the
   residency against the card's L2;
7g. serve_mxu, serve_mxu_int8, serve_mxu_int8_fused — phase 5's model and
   requests through score_graphs under (fp32, mxu, per_step), (int8,
   mxu, per_step), (int8, mxu, fused), each counted from 0: every request
   scored, no fused fallback, only the variant's kernel, n_steps times
   (fused: once) a batch; scores within 5e-2 of scale of phase 5's fp32
   fold scores, the int8 mxu scores not serve_int8's;
7h. train_mxu — phase 7's fit under (int8, mxu, per_step), 20 AdamW
   steps counted from 0: losses finite and falling, the instance's, B3's
   and B4's launches and no other, two backward passes the same bits,
   each of the first 3 losses of a fresh run within rtol 1e-4 of the CPU
   plain path's loss from that step's parameters (the free CPU
   trajectory beside it is reported: an int8 quantum that flips between
   two fp32 summation orders spreads through AdamW), median step ms;
7i. tune — `cli tune` at the flagship serving budgets (16384 x 65536,
   d 128, 5 steps) over the card-legal grid, counted from 0, under a
   temporary storage root: every candidate timed with its numerics
   verdict, a winner, a valid tuned.json (its candidate table on the
   line tune_candidates); then `cli train` (flagship model,
   ggnn_kernel=true, tune.enabled=true, 2 epochs on 120 seeded graphs in
   a graph store there) prints the overrides it applied, saves them in
   its config and launches the winner's kernel;
8. kernel flash_fwd — the flash-attention forward kernel against its
   plain version on the card: the flagship serving shape (B 16, H 12,
   T 512, D 64) in bf16, the T = 256 and T = 128 bucket shapes, an fp32
   case and a bf16 batch with ragged masks and one all-padding row
   (o within 2e-2 in bf16 and 1e-5 in fp32, lse within 1e-5, o == 0 on
   the padding row); median times of 20 CUDA-event runs, the plain
   version's, one scaled_dot_product_attention call's (the yardstick,
   never called by the port) and the card's bound; then the flagship
   call at dropout 0.1 against the plain version with the seed's Philox
   bits, and the keep fraction of its 50 M bits within 0.9 +- 0.002,
   with one scaled_dot_product_attention call's time at that rate and
   the backend that ran it;
9. serve_combined — score_combined on the combined DeepDFA+LineVul
   model at codebert-base width (768 wide, 12 layers, bf16 activations,
   vocab 50265) with the flagship graph encoder (d 128, 5 steps), random
   weights from a seeded generator, buckets 128/256/512 at token budget
   8192 (64/32/16 rows), answering 64 seeded requests spread over the
   three buckets, each with a seeded graph. Every probability is finite
   and in (0, 1); the flash kernel ran 12 times and the GGNN step 5
   times per batch; 3 requests re-scored alone match their batched
   scores (text-only: the same bits; with graphs within 1e-5); 4
   requests through a 2-layer model of the same width and seed give
   logits within 5e-3 between the card and the CPU plain path; then a
   load window of 768 such requests (256 a bucket, so every bucket runs
   several full batches, arriving at once) gives requests/s, p50/p99
   and the tokenizing time, which precedes the batcher's window;
10. profile_combined — one full 512-token batch split into host
   collate, copies, forward to sync and fetch; device time by kernel
   (flash, GGNN step, matmuls, the rest) and the idle share;
11. kernel flash_bwd — the backward kernels dq and dk/dv against the
   plain backward on the card, at dropout 0 and 0.1 (one seed, the same
   mask in both), at the flagship training call, the T = 256 and 128
   buckets, fp32, and a ragged bf16 batch with an all-padding row (its
   gradients exactly 0); each gradient within 2e-2 of its largest
   magnitude in bf16 (1e-4 in fp32), the same bits on a rerun; times of
   both kernels at both rates, the plain backward's, the backward of one
   scaled_dot_product_attention call, and the bounds;
12. train_combined — CombinedTrainer.fit of the combined model at
   codebert-base width (bf16 activations, dropout 0.1, remat "full")
   with the flagship graph encoder, random weights from seed 0, AdamW
   at lr 1e-4 without warmup, clip 1.0: 20 steps over 4 fixed bucketed
   batches (512, 512, 256, 128 tokens at token budget 8192) of seeded
   labelled texts with graphs, 5 epochs. Every loss finite and the last
   epoch's mean below the first's; per step 24 flash forward launches
   (12 layers and their 12 replays under remat), 12 dq, 12 dk/dv and 5
   each of the GGNN step, B3 and B4 (the warm-up runs one step per
   bucket, an eval batch 12 flash and 5 GGNN launches); two backward
   passes with one seed give the same bits; a 2-layer model of the same
   width with dropout 0 gives the same first two losses (5e-3) and
   step-1 gradients (2e-2 of each leaf's scale) on the card and on the
   CPU plain path; a step split (host collate, copies, forward,
   backward, optimiser), tokens/s, examples/s, peak memory with remat
   on and off, and one profiled step;
13. kernel flash_bias — kernels 5-7 with T5's additive [H, T, T] bias
   and kernel 8 (dbias) against the plain versions at the T5 flagship
   call (B 16, H 12, T 512, D 64, bf16, scale 1.0), at dropout 0 and 0.1:
   every key live, ragged keys with an all-padding row, and ragged keys
   with the training path's strided operands; o within 2e-2, lse within
   1e-5 + 1e-5 |lse|, each gradient and dbias within 2e-2 of its largest
   magnitude, the same bits on a repeat; the four kernels' times with the
   bias, the plain versions', one scaled_dot_product_attention call with
   the bias as a float attn_mask (forward, and backward with the mask
   requiring grad; the backward at dropout 0.1 too, with its backend)
   and the bounds;
14. serve_t5 — phase 9 for the CodeT5+DeepDFA defect model at
   codet5-base width (768 wide, 12 layers of 12 x 64 heads, FFN 3072,
   32 relative buckets, vocab 32100, bf16 activations) with the flagship
   graph encoder and the T5-framed hash tokenizer (pad 0, eos 2): the
   biased flash kernel 12 times and the GGNN step 5 times a batch, the
   same alone-vs-batched and 2-layer card-vs-CPU checks, the 768-request
   load window;
15. profile_t5 — phase 10 for the defect model;
16. train_t5 — phase 12 for the defect model (remat "full", hidden
   dropout 0.1; T5 has no attention-probs dropout): per step 24 biased
   flash forward launches, 12 dq, 12 dk/dv, 12 dbias and 5 of each GGNN
   kernel;
17. kernel flash_causal — kernels 5-8 with the causal mask (the causal
   build of the flash source) against the plain versions: bf16 (D 64)
   and fp32, with and without the bias, ragged T = 200 with padded keys
   at the end and at the start (queries without a live key: o = 0, dq =
   0), dbias exactly 0 above the diagonal, the same bits on a repeat,
   and the clone path's two fp32 biased calls (B 32, T 256: the encoder
   with ragged rows, the causal decoder), where the fp32 dbias cuts the
   batch into runs of more than one row;
   times, plain and library times (scaled_dot_product_attention with
   is_causal, or a float attn_mask holding bias and -inf) and bounds
   over the live pairs at the flagship call (B 16, H 12, T 512, bf16,
   with and without the bias) and at the gen path's fp32 calls (decoder
   T 128 causal with the bias, cross 128 x 256, encoder 256 with the
   bias); this run's unbiased non-causal flagship times beside the ones
   PERF.md records from before the causal build, its fp32 dq and dk/dv
   times at the gen calls beside the first FMA version's
   (FP32_BWD_BASELINE_MS), and its forward times at the gen calls and
   the flagship call (plain, bias, causal, causal + bias, dropout 0.1)
   beside the first design's (FWD_BASELINE_MS), its fp32 dbias times
   at the decoder and encoder calls beside the first FMA dbias's
   (FP32_DBIAS_BASELINE_MS), the batch cut of every fp32 biased case
   (slices, rows a slice), with the
   registers and spills from the build of every forward instance at D
   64, the register-tiled fp32 dq, dk/dv and dbias, the bf16 FMA dbias
   and every width's B3 passes (none may spill);
18. train_gen — `train-gen`'s path (the CLI's hash tokenizer at vocab
   32100, reader and codet5-base-width model in fp32, 12 + 12 layers)
   through GenTrainer.fit: 4 batches of 16 summarize rows (256 -> 128
   tokens), 5 epochs with a dev batch, AdamW lr 1e-4, dropout 0.1. Every
   loss finite, the last epoch's mean below the first's; per step 72
   flash forward launches (encoder, decoder self- and cross-attention,
   each with its remat replay), 36 dq, 36 dk/dv, 24 dbias; two backward
   passes with one seed give the same bits; a 2+2-layer model (dropout
   0) gives the same two losses (5e-3) and step-1 gradients (2e-2 of each
   leaf's scale) on the card and the CPU plain path; a step split,
   tokens/s, peak memory and a profiled step; 6 bf16 steps;
19. decode_gen — GenTrainer.decode (beam 5, max length 128) of the
   trained model over 2 batches of 16 sources: sequences/s, 12 encoder
   flash launches a batch; a 2+2-layer fp32 model's _decode_step logits
   at every step within 1e-3 of scale card vs CPU, and its beam ids equal
   where every step's top-K margin exceeds 1e-4;
20. train_clone — `train-clone`'s path: the reference's clone files,
   CloneTrainer at codet5-base width (fp32), 8 steps on 16 pairs of 256
   tokens; every loss finite; the gen step's launches per step; one
   profiled step (device busy time, idle share, device ms by group);
21. kernels — every kernel with its launches on the twenty-one main
   paths (serve, train, serve_combined, train_combined, serve_t5,
   train_t5, train_gen, decode_gen, train_clone, the six of 7c-7d, the
   four of 7g-7h, tune and tune_train, each counted from 0, and by path),
   error, time, plain time, bound and library time; the flash rows add
   their biased times as bias_* and their causal and gen-path times under
   by_call; ggnn_step_bf16, ggnn_step_int8 and ggnn_step_mxu* are kernel
   1's instances (the mxu rows add their fold instance's fold_ms),
   ggnn_fused and ggnn_fused_mxu kernel 2's (fp32 without the chain,
   by_policy and chain the rest).

The line before the last is nvidia-smi's "name, power.limit"; the last
line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --phase train_clone [--phase ...]

runs only the named training phases (train, train_gen, train_clone) on
a fresh seed after phases 1-2, and prints their lines and no last line:
set beside another checkout's package (copy this script into that
checkout and run it there), it gives both trees' profiled steps from one
script.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP_CONFIG = ROOT / "configs" / "bigvul_deepdfa.json"
COMBINED_CONFIG = ROOT / "configs" / "bigvul_combined.json"
RTOL, ATOL = 1e-4, 1e-5
# published H100 SXM peaks (dense): fp32 outside the tensor cores, bf16
# on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
COMBINED_BUCKETS = [128, 256, 512]
COMBINED_REQUESTS = 64
COMBINED_LOAD_REQUESTS = 768  # 256 a bucket: 4-16 full batches each
# card vs CPU logits of the 2-layer bf16 check (its probabilities agree
# to ~5e-4 on an H100, where the logits are ~0.3 in size)
COMBINED_LOGIT_TOL = 5e-3
# 2-layer combined training, card vs CPU plain path (bf16 activations):
# the first two losses (absolute) and step-1 gradients (of each leaf's scale)
COMBINED_TRAIN_LOSS_TOL, COMBINED_TRAIN_GRAD_TOL = 5e-3, 2e-2
C_WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
           "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n",
           "size_t", "->", "next", "while", "<", "for", "i", "++", "NULL", "&", "ptr")
TIMED_RUNS = 20
# attention-probs dropout of the training path (TransformerConfig's rate)
DROPOUT_RATE, DROPOUT_SEED = 0.1, 20241017
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


def roofline(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of the operations over the
    card's peak for their type (fp32 unless given) and the bytes over
    its HBM rate."""
    t_ops = flops / peak_flops * 1e3
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
    return (launches, model, specs, probs, (node_budget, edge_budget),
            cfg.serve.max_batch_graphs)


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


def launch_split(torch, fn, calls: int = 10) -> dict:
    """{kernel: {"ms", "launches"}} a call of `fn`: the device time and
    launches of each kernel it runs (copies too), from torch.profiler over
    `calls` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA") and us > 0 and \
                not getattr(e, "is_user_annotation", False):
            out[e.key[:70]] = {"ms": us / 1e3 / calls, "launches": e.count / calls}
    return out


def bwd_kernel_phase(torch, rng):
    """B3 and B4 against their plain versions at the flagship, T = 3
    and all-padding batches; timings at the flagship batch, B3's beside
    its first design's (GRU_BWD_BASELINE_MS), and B3's device time split
    by launch on a line of its own before the phase's lines."""
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
                timing["ggnn_gru_bwd"] = {
                    "ms": median_ms(torch, lambda: gk.gru_bwd(h, a, *gru, g)),
                    "plain_ms": median_ms(torch, lambda: gk.gru_bwd_plain(h, a, *gru, g)),
                    **dict(zip(("bound_ms", "bound_by"), gru_bwd_bound(n, d))),
                }
                base = GRU_BWD_BASELINE_MS["ggnn_gru_bwd"]
                timing["ggnn_gru_bwd"].update(
                    baseline_ms=base, baseline_over_ms=base / timing["ggnn_gru_bwd"]["ms"])
                split = launch_split(torch, lambda: gk.gru_bwd(h, a, *gru, g))
                timing["ggnn_dmsg"] = {
                    "ms": median_ms(torch, lambda: gk.dmsg(a, edges, wm)),
                    "plain_ms": median_ms(torch, lambda: gk.dmsg_plain(a, edges, wm)),
                    **dict(zip(("bound_ms", "bound_by"), dmsg_bound(n, e_live, d, t))),
                }
            shape = {"n": n, "e": b.edge_budget, "e_live": e_live, "d": d, "n_etypes": t}
    emit({"phase": "kernel ggnn_gru_bwd launches", **shape, "device_ms_by_launch": split,
          "device_ms": sum(x["ms"] for x in split.values())})
    for kernel in reports:
        emit({"phase": f"kernel {kernel}", "ok": True, "rtol": RTOL, "atol": ATOL,
              "max_abs_err": worst[kernel], **reports[kernel], **shape, **timing[kernel],
              **({"weight_pass_splits": gk._library("ggnn_bwd").ggnn_gru_bwd_splits(
                  shape["n"], shape["d"])} if kernel == "ggnn_gru_bwd" else {})})
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
          "profiled_step": {**device_profile(prof, profiled_ms),
                            "device_ms_by_group": device_groups(prof)}})
    return launches


# ---------------------------------------------------------------------------
# kernel 1's bf16/int8 instances, kernel 2 (the whole unroll) and the
# GGNN paths under the message policies and the fused unroll

#: the serving and training paths under ggnn_kernel=true: (accum, unroll)
SERVE_VARIANTS = {"serve_bf16": ("bf16", "per_step"), "serve_fused": ("fp32", "fused"),
                  "serve_int8": ("int8", "per_step"), "serve_int8_fused": ("int8", "fused")}
TRAIN_VARIANTS = {"train_fused": ("fp32", "fused"), "train_bf16": ("bf16", "per_step")}
#: the step counter of each policy and the kernels-line row it feeds
POLICY_ROWS = {"fp32": ("LAUNCHES", "ggnn_step"), "bf16": ("BF16_LAUNCHES", "ggnn_step_bf16"),
               "int8": ("INT8_LAUNCHES", "ggnn_step_int8")}
#: bf16/int8 scores against the fp32 scores, of their scale (the
#: reference's INT8_DRIFT_BOUND, and its bf16 rung)
POLICY_SCORE_TOL = 5e-2
FUSED_STEPS = 5


def variant_config(cfg, accum: str, unroll: str, scatter: str = "auto"):
    from deepdfa_tpu_torch.core import apply_overrides

    return apply_overrides(cfg, ["model.ggnn_kernel=true", f'model.ggnn_kernel_accum="{accum}"',
                                 f'model.ggnn_kernel_unroll="{unroll}"',
                                 f'model.ggnn_kernel_scatter="{scatter}"'])


def ggnn_case(torch, gen, batch, t: int, d: int = 128):
    """(batch on the card, edges, h, the six step weights) from seeded
    normal draws, as kernel_phase draws them."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    b = batch.to(CARD)
    n = b.node_budget
    scale = d ** -0.5
    h = torch.randn(n, d, generator=gen).to(CARD)
    params = [(torch.randn(*shape, generator=gen) * sc).to(CARD) for shape, sc in (
        ((t, d, d), scale), ((t, d), 0.1), ((d, 3 * d), scale), ((d, 3 * d), scale),
        ((3 * d,), 0.1), ((3 * d,), 0.1))]
    edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, t)
    return b, edges, h, params


def ggnn_cases(rng) -> dict:
    from deepdfa_tpu_torch.graphs import pack

    return {"flagship": (full_batch(rng, 16384, 65536, 1), 1),
            "etypes3": (full_batch(rng, 16384, 65536, 3), 3),
            "all_padding": (pack([], 16, 16384, 65536), 1)}


def policy_step_bound(n: int, e_live: int, d: int, t: int, accum: str):
    """step_bound without the aggregate, with Wm read in the policy's
    type (int8 adds its [T, d] scales); the per-row quantization (~4
    operations an element) is not counted. The message-side table is an
    intermediate and moves no counted bytes."""
    flops = 2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[accum]
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d) + (t * d if accum == "int8" else 0))
    nbytes = 4 * (2 * n * d + e_live * (1 + t) + (n + 1)) + weights + itemsize * t * d * d
    return roofline(flops, nbytes)


def fused_bound(n: int, e_live: int, d: int, t: int, accum: str, n_steps: int, chain: bool):
    """(bound_ms, bound_by) of kernel 2: n_steps steps' operations
    (step_bound's count); bytes: feat read and h_out written once, the
    chain written once when asked for, the edges and weights once."""
    flops = n_steps * (2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d)
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[accum]
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d)) + itemsize * t * d * d
    nbytes = 4 * ((2 + (n_steps if chain else 0)) * n * d + e_live * (1 + t) + (n + 1)) + weights
    return roofline(flops, nbytes)


def step_check(torch, what: str, got, want) -> float:
    """got vs want at rtol/atol; the max abs error."""
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"{what}: differs from the plain version, max abs err {err}")
    return err


def policy_kernel_phase(torch, rng):
    """Kernel 1's bf16 and int8 instances against the plain version of
    the same policy on the card, at the flagship, T = 3 and all-padding
    batches; the same bits on a rerun; times at the flagship batch."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(3)
    report, worst, timing = {}, {"bf16": 0.0, "int8": 0.0}, {}
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        for accum in ("bf16", "int8"):
            with torch.inference_mode():
                h_k, a_k = gk.ggnn_step(h, edges, *params, accum=accum, with_aggregate=True)
                h_p, a_p = gk.ggnn_step_plain(h, edges, *params, accum)
                again, _ = gk.ggnn_step(h, edges, *params, accum=accum)
                _, a32 = gk.ggnn_step(h, edges, *params, with_aggregate=True)
            torch.cuda.synchronize()
            for what, got, want in (("h", h_k, h_p), ("a", a_k, a_p)):
                err = step_check(torch, f"{name} {accum} step {what}", got, want)
                worst[accum] = max(worst[accum], err)
                report[f"{accum}_{name}_{what}_max_abs_err"] = err
            if not torch.equal(again, h_k):
                fail(f"{name}: the {accum} step gave other bits on a rerun")
            if name != "all_padding" and torch.equal(a_k, a32):
                fail(f"{name}: the {accum} aggregate equals the fp32 one (policy not engaged)")
            report[f"{accum}_{name}_a_vs_fp32_max_abs"] = (a_k - a32).abs().max().item()
            if name == "flagship":
                with torch.inference_mode():
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_step(h, edges, *params, accum=accum)),
                        "plain_ms": median_ms(
                            torch, lambda: gk.ggnn_step_plain(h, edges, *params, accum)),
                        **dict(zip(("bound_ms", "bound_by"),
                                   policy_step_bound(n, e_live, d, t, accum))),
                        "shape": {"n": n, "e": b.edge_budget, "e_live": e_live, "d": d,
                                  "n_etypes": t},
                    }
    emit({"phase": "kernel ggnn_step_policy", "ok": True, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report, "timing": timing})
    return worst, timing


def fused_kernel_phase(torch, rng):
    """Kernel 2 at the flagship, T = 3 and all-padding batches under each
    policy: h_out, with and without the chain, and every chain plane the
    bits of FUSED_STEPS launches of kernel 1, the same bits on a repeat;
    each of its steps against the plain step of the same policy from that
    step's input (its chain plane) at rtol/atol. Five plain steps from
    the first input are not compared: a bf16 rounding or an int8 quantum
    of a state element near its boundary can flip between two fp32
    summation orders and spread. Times at the flagship batch beside the
    FUSED_STEPS step launches, one step in one launch, and the bound."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(4)
    report, worst, timing = {}, 0.0, {}
    S = FUSED_STEPS
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        for accum in ("fp32", "bf16", "int8"):
            with torch.inference_mode():
                states = [h]
                for _ in range(S):
                    states.append(gk.ggnn_step(states[-1], edges, *params, accum=accum)[0])
                h_f, chain = gk.ggnn_fused(h, edges, *params, n_steps=S, accum=accum,
                                           with_chain=True)
                h_nc, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, accum=accum)
                h_again, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, accum=accum)
                # the plain step from each of the kernel's own step inputs
                plain = [gk.ggnn_step_plain(chain[s], edges, *params, accum)[0]
                         for s in range(S)]
            torch.cuda.synchronize()
            if not (torch.equal(h_f, states[-1]) and torch.equal(h_nc, h_f)):
                fail(f"{name} {accum}: the fused kernel's h_out differs from {S} step launches")
            if not all(torch.equal(chain[s], states[s]) for s in range(S)):
                fail(f"{name} {accum}: the fused kernel's chain differs from the step inputs")
            if not torch.equal(h_again, h_f):
                fail(f"{name} {accum}: the fused kernel gave other bits on a repeat")
            outs = [*chain[1:], h_f]
            err = max(step_check(torch, f"{name} {accum} fused step {s}", outs[s], plain[s])
                      for s in range(S))
            worst = max(worst, err)
            report[f"{accum}_{name}_max_abs_err"] = err
            if name == "flagship":
                def steps(accum=accum):
                    x = h
                    for _ in range(S):
                        x = gk.ggnn_step(x, edges, *params, accum=accum)[0]

                with torch.inference_mode():
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, accum=accum)),
                        "chain_ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, accum=accum, with_chain=True)),
                        "step_launches_ms": median_ms(torch, steps),
                        "plain_ms": median_ms(torch, lambda: gk.ggnn_fused_plain(
                            h, edges, *params, n_steps=S, accum=accum)),
                        # one step in one cooperative launch, beside one launch of kernel 1
                        "one_step_ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=1, accum=accum)),
                        "one_step_launch_ms": median_ms(torch, lambda: gk.ggnn_step(
                            h, edges, *params, accum=accum)),
                        **dict(zip(("bound_ms", "bound_by"),
                                   fused_bound(n, e_live, d, t, accum, S, False))),
                        "chain_bound_ms": fused_bound(n, e_live, d, t, accum, S, True)[0],
                        "residency_bytes": gk.fused_residency_bytes(n, d, accum, S),
                    }
    emit({"phase": "kernel ggnn_fused", "ok": True, "n_steps": S, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report,
          "l2_budget_bytes": gk.fused_budget_bytes(torch.device(CARD)), "timing": timing})
    return worst, timing


def serve_variants_phase(torch, model, specs, fp32_probs):
    """score_graphs of the serve phase's model and requests under each
    SERVE_VARIANTS entry (ggnn_kernel=true), each path's launches counted
    from 0: every request scored, no fused fallback, the variant's kernel
    n_steps times (or once, fused) per batch, scores within
    POLICY_SCORE_TOL of scale of the fp32 scores; then the same requests
    offline (fixed batches): fused scores the bits of per-step scores of
    the same policy."""
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import DynamicBatcher, GgnnExecutor, score_graphs
    from deepdfa_tpu_torch.serve.driver import SUMMARY_KEYS

    cfg = load(FLAGSHIP_CONFIG)
    node_budget = cfg.serve.node_budget or cfg.data.batch.node_budget
    edge_budget = cfg.serve.edge_budget or cfg.data.batch.edge_budget
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def offline(m):
        ex = GgnnExecutor(m, node_budget, edge_budget, cfg.serve.max_batch_graphs, device=CARD)
        return np.asarray([r.wait(600) for r in DynamicBatcher(ex).score_all(specs)])

    fixed = {("fp32", "per_step"): offline(model)}
    paths, online = {}, {}
    for path, (accum, unroll) in SERVE_VARIANTS.items():
        vcfg = variant_config(cfg, accum, unroll)
        vmodel = DeepDFA.from_config(vcfg.model, cfg.data.feat.input_dim)
        vmodel.load_state_dict(weights)
        gk.reset_launch_counts()
        summary = score_graphs(vmodel, specs, vcfg, device=CARD)
        counts = gk.launch_counts()
        probs = np.asarray(summary.pop("probs"), dtype=np.float64)
        if summary["serve_scored"] != len(specs) or not np.all(np.isfinite(probs)):
            fail(f"{path}: {summary['serve_failed_requests']} requests failed or non-finite")
        if counts["FUSED_FALLBACKS"]:
            fail(f"{path}: {counts['FUSED_FALLBACKS']} fused unrolls fell back to per step")
        # the summary counts the scoring window, `counts` the warm-up too
        scored = {k: v for k, v in summary.items() if k.startswith("ggnn_")}
        counter, row = ("FUSED_LAUNCHES", "ggnn_fused") if unroll == "fused" else \
            POLICY_ROWS[accum]
        key = SUMMARY_KEYS[counter]
        want = summary["serve_batches"] * (1 if unroll == "fused" else cfg.model.n_steps)
        if scored[key] != want or any(v for k, v in scored.items() if k != key):
            fail(f"{path}: launches {scored}, expected {key} = {want} and no other")
        drift = float(np.abs(probs - fp32_probs).max()) / float(np.abs(fp32_probs).max())
        if drift > POLICY_SCORE_TOL or (accum != "fp32" and drift == 0.0):
            fail(f"{path}: scores {drift} of scale from the fp32 scores (limit "
                 f"{POLICY_SCORE_TOL}, and a policy must move them)")
        fixed[accum, unroll] = offline(vmodel)
        online[accum, unroll] = probs
        paths[path] = {row: counts[counter]}
        emit({"phase": path, "ok": True, "accum": accum, "unroll": unroll,
              "requests": len(specs), "launches": counts, "score_drift_vs_fp32": drift,
              **summary})
    for accum in ("fp32", "int8"):
        if not np.array_equal(fixed[accum, "fused"], fixed[accum, "per_step"]):
            fail(f"serve {accum}: fused scores differ from per-step scores on fixed batches")
    emit({"phase": "serve_variants", "ok": True, "fused_bit_equal_per_step": ["fp32", "int8"],
          "offline_drift_vs_fp32": {f"{a}_{u}": float(np.abs(p - fixed["fp32", "per_step"]).max())
                                    for (a, u), p in fixed.items()}})
    return paths, online


def train_variants_phase(torch, rng):
    """GraphTrainer.fit under each TRAIN_VARIANTS entry (ggnn_kernel=true)
    on the train phase's kind of batches, 20 AdamW steps, launches
    counted from 0: losses finite and falling, each kernel's launches as
    the unroll implies; step-1 gradients of the fused unroll the bits of
    the per-step one of the same policy on one batch; median step ms of
    train_step on batches already on the card, and of the fp32 per-step
    model the same way (the train phase's step_ms counts host packing
    and copies too)."""
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = load(FLAGSHIP_CONFIG)
    input_dim, n_steps = cfg.data.feat.input_dim, cfg.model.n_steps
    _, batches = train_batches(cfg, rng)
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    on_card = [b.to(CARD) for b in batches]

    def step_ms(trainer, state) -> float:
        times = []
        for i in range(10):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            trainer.train_step(state, on_card[i % TRAIN_BATCHES])
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t_a))
        return statistics.median(times)

    base = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device=CARD)
    base_ms = step_ms(base, base.init_state(seed=0))
    del base
    paths = {}
    for path, (accum, unroll) in TRAIN_VARIANTS.items():
        vcfg = variant_config(cfg, accum, unroll)
        model = DeepDFA.from_config(vcfg.model, input_dim)
        trainer = GraphTrainer(model, vcfg, device=CARD)
        state = trainer.init_state(seed=0)
        init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        records = []
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                    max_epochs=TRAIN_EPOCHS, log_fn=records.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = gk.launch_counts()
        step_counter, step_row = POLICY_ROWS[accum]
        evals = TRAIN_EPOCHS  # one eval batch an epoch
        if unroll == "fused":
            # the forward: one launch with the chain a step, one without an
            # eval batch; the backward recomputes each step's aggregate
            want = {"FUSED_LAUNCHES": steps + evals, "FUSED_CHAIN_LAUNCHES": steps,
                    step_counter: steps * n_steps}
            launched = {"ggnn_fused": counts["FUSED_LAUNCHES"], step_row: counts[step_counter]}
        else:
            want = {step_counter: (steps + evals) * n_steps}
            launched = {step_row: counts[step_counter]}
        want |= {"GRU_BWD_LAUNCHES": steps * n_steps, "DMSG_LAUNCHES": steps * n_steps}
        if any(counts[k] != v for k, v in want.items()) or counts["FUSED_FALLBACKS"]:
            fail(f"{path}: kernel launches {counts}, expected {want}")
        launched |= {"ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"],
                     "ggnn_dmsg": counts["DMSG_LAUNCHES"]}
        epochs = [r for r in records if "epoch" in r]
        losses = [r["train_loss"] for r in epochs]
        if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
            fail(f"{path}: a non-finite loss in {epochs}")
        if not losses[-1] < losses[0]:
            fail(f"{path}: the loss did not fall: epoch means {losses}")
        report = {}
        if unroll == "fused":
            b0 = batches[0].to(CARD)
            grads = {}
            for u in ("per_step", "fused"):
                m = DeepDFA.from_config(variant_config(cfg, accum, u).model, input_dim)
                tr = GraphTrainer(m, variant_config(cfg, accum, u), device=CARD)
                st = tr.init_state(params=init)
                loss = tr.forward_loss(st, b0)
                loss.backward()
                grads[u] = {"loss": loss.detach()} | {
                    k: p.grad.detach().clone() for k, p in m.named_parameters()}
            if not all(torch.equal(grads["fused"][k], g) for k, g in grads["per_step"].items()):
                fail(f"{path}: step-1 gradients of the fused unroll differ from per-step")
            report["step1_grads_bit_equal_per_step"] = True
        paths[path] = launched
        emit({"phase": path, "ok": True, "accum": accum, "unroll": unroll, "steps": steps,
              "epoch_train_loss": losses, "epoch_val_loss": [r["val_loss"] for r in epochs],
              "launches": counts, "fit_seconds": fit_s, "step_ms": step_ms(trainer, state),
              "fp32_per_step_step_ms": base_ms, **report})
    return paths


# ---------------------------------------------------------------------------
# the mxu scatter of kernels 1 and 2, and the tune entry point

#: kernel 1's mxu instances: the counter of each policy and its row
MXU_ROWS = {"fp32": ("MXU_LAUNCHES", "ggnn_step_mxu"),
            "bf16": ("MXU_BF16_LAUNCHES", "ggnn_step_mxu_bf16"),
            "int8": ("MXU_INT8_LAUNCHES", "ggnn_step_mxu_int8")}
#: every GGNN kernel row of the kernels line and its counter
GGNN_ROWS = {"ggnn_step": "LAUNCHES", "ggnn_step_bf16": "BF16_LAUNCHES",
             "ggnn_step_int8": "INT8_LAUNCHES", **{r: c for c, r in MXU_ROWS.values()},
             "ggnn_fused": "FUSED_LAUNCHES", "ggnn_fused_mxu": "FUSED_MXU_LAUNCHES",
             "ggnn_gru_bwd": "GRU_BWD_LAUNCHES", "ggnn_dmsg": "DMSG_LAUNCHES"}
SERVE_MXU = {"serve_mxu": ("fp32", "per_step"), "serve_mxu_int8": ("int8", "per_step"),
             "serve_mxu_int8_fused": ("int8", "fused")}
MXU_BLOCK = 512  # the reference's default edge block
MXU_INT8_BLOCKS = (128, 1024)  # int8 at other blocks: other numbers
#: the card's peak for the message products of each policy (fp32 FMA,
#: bf16 and int8 on the tensor cores); the GRU stays fp32
MSG_PEAK = {"fp32": PEAK_FP32_FLOPS, "bf16": PEAK_BF16_FLOPS, "int8": 1979e12}


def mxu_bound(n: int, e_live: int, d: int, t: int, accum: str, n_steps: int = 1,
              chain: bool = False):
    """(bound_ms, bound_by) of n_steps mxu steps: the per-edge messages'
    2*E_live*d^2*T products at the policy's peak (MSG_PEAK) plus the
    GRU's 12*N*d^2 and the sums' 2*E_live*d at the fp32 peak, against
    policy_step_bound's bytes (kernel 2's: fused_bound's)."""
    t_ops = n_steps * (2 * e_live * d * d * t / MSG_PEAK[accum]
                       + (12 * n * d * d + 2 * e_live * d) / PEAK_FP32_FLOPS) * 1e3
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[accum]
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d) + (t * d if accum == "int8" else 0))
    nbytes = (4 * ((2 + (n_steps if chain else 0)) * n * d + e_live * (1 + t) + (n + 1))
              + weights + itemsize * t * d * d)
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mxu_kernel_phase(torch, rng):
    """Kernel 1's mxu instances against the plain mxu of the same policy
    on the card at the three batches of phase 3 (fp32 rtol/atol: the
    plain matmuls sum the message products in another order; int8's
    products and quanta are exact), int8 also at edge blocks 128 and 1024
    on the flagship batch, each against its own plain version and not
    equal to block 512's; the same bits on a rerun; int8 mxu not equal to
    int8 fold; times at the flagship batch."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(5)
    report, worst, timing = {}, dict.fromkeys(MXU_ROWS, 0.0), {}
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        aggs = {}
        for accum in MXU_ROWS:
            blocks = (MXU_BLOCK, *MXU_INT8_BLOCKS) if accum == "int8" and name == "flagship" \
                else (MXU_BLOCK,)
            for be in blocks:
                kw = dict(accum=accum, scatter="mxu", block_e=be)
                with torch.inference_mode():
                    h_k, a_k = gk.ggnn_step(h, edges, *params, with_aggregate=True, **kw)
                    h_p, a_p = gk.ggnn_step_plain(h, edges, *params, accum, "mxu", be)
                    again, _ = gk.ggnn_step(h, edges, *params, **kw)
                torch.cuda.synchronize()
                for what, got, want in (("h", h_k, h_p), ("a", a_k, a_p)):
                    err = step_check(torch, f"{name} mxu {accum} be{be} step {what}", got, want)
                    worst[accum] = max(worst[accum], err)
                    report[f"{accum}_be{be}_{name}_{what}_max_abs_err"] = err
                if not torch.equal(again, h_k):
                    fail(f"{name}: the mxu {accum} step gave other bits on a rerun")
                aggs[accum, be] = a_k
            if accum == "int8" and name != "all_padding":
                with torch.inference_mode():
                    _, a_fold = gk.ggnn_step(h, edges, *params, accum="int8", with_aggregate=True)
                if torch.equal(a_fold, aggs["int8", MXU_BLOCK]):
                    fail(f"{name}: the int8 mxu aggregate equals the int8 fold one")
                report[f"int8_{name}_mxu_vs_fold_max_abs"] = \
                    (a_fold - aggs["int8", MXU_BLOCK]).abs().max().item()
            if name == "flagship":
                with torch.inference_mode():
                    kw = dict(accum=accum, scatter="mxu", block_e=MXU_BLOCK)
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_step(h, edges, *params, **kw)),
                        "plain_ms": median_ms(torch, lambda: gk.ggnn_step_plain(
                            h, edges, *params, accum, "mxu", MXU_BLOCK)),
                        "fold_ms": median_ms(torch, lambda: gk.ggnn_step(
                            h, edges, *params, accum=accum)),
                        **dict(zip(("bound_ms", "bound_by"), mxu_bound(n, e_live, d, t, accum))),
                        "shape": {"n": n, "e": b.edge_budget, "e_live": e_live, "d": d,
                                  "n_etypes": t, "block_e": MXU_BLOCK},
                    }
        if name == "flagship":
            for be in MXU_INT8_BLOCKS:
                if torch.equal(aggs["int8", be], aggs["int8", MXU_BLOCK]):
                    fail(f"flagship: the int8 mxu aggregate at block {be} equals block "
                         f"{MXU_BLOCK}'s")
                report[f"int8_be{be}_vs_be{MXU_BLOCK}_max_abs"] = \
                    (aggs["int8", be] - aggs["int8", MXU_BLOCK]).abs().max().item()
    emit({"phase": "kernel ggnn_step_mxu", "ok": True, "rtol": RTOL, "atol": ATOL,
          "max_abs_err": worst, **report, "timing": timing})
    return worst, timing


def mxu_fused_kernel_phase(torch, rng):
    """Kernel 2's mxu instances at the three batches under each policy:
    h_out, with and without the chain, and every chain plane the bits of
    FUSED_STEPS launches of kernel 1's mxu instance, the same bits on a
    repeat; each step against the plain mxu step from that step's input
    (fused_kernel_phase's rule); times at the flagship batch and
    the residency against the card's L2."""
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    gen = torch.Generator().manual_seed(6)
    report, worst, timing = {}, 0.0, {}
    S = FUSED_STEPS
    for name, (batch, t) in ggnn_cases(rng).items():
        b, edges, h, params = ggnn_case(torch, gen, batch, t)
        n, e_live, d = b.node_budget, int(b.edge_mask.sum()), h.shape[1]
        for accum in MXU_ROWS:
            kw = dict(accum=accum, scatter="mxu", block_e=MXU_BLOCK)
            with torch.inference_mode():
                states = [h]
                for _ in range(S):
                    states.append(gk.ggnn_step(states[-1], edges, *params, **kw)[0])
                h_f, chain = gk.ggnn_fused(h, edges, *params, n_steps=S, with_chain=True, **kw)
                h_nc, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, **kw)
                h_again, _ = gk.ggnn_fused(h, edges, *params, n_steps=S, **kw)
                plain = [gk.ggnn_step_plain(chain[s], edges, *params, accum, "mxu", MXU_BLOCK)[0]
                         for s in range(S)]
            torch.cuda.synchronize()
            if not (torch.equal(h_f, states[-1]) and torch.equal(h_nc, h_f)):
                fail(f"{name} mxu {accum}: kernel 2's h_out differs from {S} step launches")
            if not all(torch.equal(chain[s], states[s]) for s in range(S)):
                fail(f"{name} mxu {accum}: kernel 2's chain differs from the step inputs")
            if not torch.equal(h_again, h_f):
                fail(f"{name} mxu {accum}: kernel 2 gave other bits on a repeat")
            outs = [*chain[1:], h_f]
            err = max(step_check(torch, f"{name} mxu {accum} fused step {s}", outs[s], plain[s])
                      for s in range(S))
            worst = max(worst, err)
            report[f"{accum}_{name}_max_abs_err"] = err
            if name == "flagship":
                def steps(kw=kw):
                    x = h
                    for _ in range(S):
                        x = gk.ggnn_step(x, edges, *params, **kw)[0]

                with torch.inference_mode():
                    timing[accum] = {
                        "ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, **kw)),
                        "chain_ms": median_ms(torch, lambda: gk.ggnn_fused(
                            h, edges, *params, n_steps=S, with_chain=True, **kw)),
                        "step_launches_ms": median_ms(torch, steps),
                        "plain_ms": median_ms(torch, lambda: gk.ggnn_fused_plain(
                            h, edges, *params, n_steps=S, **kw)),
                        **dict(zip(("bound_ms", "bound_by"),
                                   mxu_bound(n, e_live, d, t, accum, S))),
                        "chain_bound_ms": mxu_bound(n, e_live, d, t, accum, S, True)[0],
                        "residency_bytes": gk.fused_residency_bytes(
                            n, d, accum, S, scatter="mxu", n_eb=b.edge_budget // MXU_BLOCK,
                            n_etypes=t),
                    }
    emit({"phase": "kernel ggnn_fused_mxu", "ok": True, "n_steps": S, "rtol": RTOL,
          "atol": ATOL, "max_abs_err": worst, **report,
          "l2_budget_bytes": gk.fused_budget_bytes(torch.device(CARD)), "timing": timing})
    return worst, timing


def serve_mxu_phase(torch, model, specs, fp32_probs, int8_fold_probs):
    """score_graphs of the serve phase's model and requests under each
    SERVE_MXU entry, launches counted from 0: every request scored, no
    fused fallback, the variant's kernel n_steps times (fused: once) a
    batch and no other, scores within POLICY_SCORE_TOL of scale of the
    fp32 fold scores, and the int8 mxu scores not the int8 fold ones."""
    import numpy as np

    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import score_graphs
    from deepdfa_tpu_torch.serve.driver import SUMMARY_KEYS

    cfg = load(FLAGSHIP_CONFIG)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    paths = {}
    for path, (accum, unroll) in SERVE_MXU.items():
        vcfg = variant_config(cfg, accum, unroll, "mxu")
        vmodel = DeepDFA.from_config(vcfg.model, cfg.data.feat.input_dim)
        vmodel.load_state_dict(weights)
        gk.reset_launch_counts()
        summary = score_graphs(vmodel, specs, vcfg, device=CARD)
        counts = gk.launch_counts()
        probs = np.asarray(summary.pop("probs"), dtype=np.float64)
        if summary["serve_scored"] != len(specs) or not np.all(np.isfinite(probs)):
            fail(f"{path}: {summary['serve_failed_requests']} requests failed or non-finite")
        if counts["FUSED_FALLBACKS"]:
            fail(f"{path}: {counts['FUSED_FALLBACKS']} fused unrolls fell back to per step")
        counter, row = ("FUSED_MXU_LAUNCHES", "ggnn_fused_mxu") if unroll == "fused" \
            else MXU_ROWS[accum]
        key = SUMMARY_KEYS[counter]
        scored = {k: v for k, v in summary.items() if k.startswith("ggnn_")}
        want = summary["serve_batches"] * (1 if unroll == "fused" else cfg.model.n_steps)
        if scored[key] != want or any(v for k, v in scored.items() if k != key):
            fail(f"{path}: launches {scored}, expected {key} = {want} and no other")
        drift = float(np.abs(probs - fp32_probs).max()) / float(np.abs(fp32_probs).max())
        if drift > POLICY_SCORE_TOL:
            fail(f"{path}: scores {drift} of scale from the fp32 fold scores (limit "
                 f"{POLICY_SCORE_TOL})")
        vs_fold = None
        if accum == "int8":
            vs_fold = float(np.abs(probs - int8_fold_probs).max())
            if vs_fold == 0.0:
                fail(f"{path}: the int8 mxu scores equal the int8 fold scores")
        paths[path] = {row: counts[counter]}
        emit({"phase": path, "ok": True, "accum": accum, "scatter": "mxu", "unroll": unroll,
              "requests": len(specs), "launches": counts, "score_drift_vs_fp32_fold": drift,
              "int8_mxu_vs_int8_fold_max_abs": vs_fold, **summary})
    return paths


def train_mxu_phase(torch, rng):
    """GraphTrainer.fit under (int8, mxu, per_step), TRAIN_BATCHES x
    TRAIN_EPOCHS AdamW steps, launches counted from 0: losses finite and
    falling, kernel 1's int8 mxu instance (steps + evals) x n_steps
    times, B3 and B4 steps x n_steps; two backward passes on one batch
    the same bits; each of the first CPU_STEPS losses within rtol 1e-4 of
    the CPU plain path's from the same parameters (a free CPU trajectory
    from the same start is reported beside it); median step ms."""
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = variant_config(load(FLAGSHIP_CONFIG), "int8", "per_step", "mxu")
    input_dim, n_steps = cfg.data.feat.input_dim, cfg.model.n_steps
    _, batches = train_batches(cfg, rng)
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    model = DeepDFA.from_config(cfg.model, input_dim)
    trainer = GraphTrainer(model, cfg, device=CARD)
    state = trainer.init_state(seed=0)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    records = []
    gk.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                max_epochs=TRAIN_EPOCHS, log_fn=records.append)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = gk.launch_counts()
    want = {"MXU_INT8_LAUNCHES": (steps + TRAIN_EPOCHS) * n_steps,
            "GRU_BWD_LAUNCHES": steps * n_steps, "DMSG_LAUNCHES": steps * n_steps}
    others = {k: v for k, v in counts.items() if k not in want and v}
    if any(counts[k] != v for k, v in want.items()) or others:
        fail(f"train_mxu: kernel launches {counts}, expected {want} and no other")
    epochs = [r for r in records if "epoch" in r]
    losses = [r["train_loss"] for r in epochs]
    if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
        fail(f"train_mxu: a non-finite loss in {epochs}")
    if not losses[-1] < losses[0]:
        fail(f"train_mxu: the loss did not fall: epoch means {losses}")
    b0 = batches[0].to(CARD)

    def grads():
        trainer.forward_loss(state, b0).backward()
        return {k: p.grad.detach().clone() for k, p in model.named_parameters()}

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail("train_mxu: two backward passes on one batch gave other gradients")
    # the first CPU_STEPS steps: the card's trajectory against the CPU
    # plain path's loss from the card's parameters of that step (gated), and
    # against a free CPU trajectory from the same start (reported): under
    # int8 an element near a quantum's edge rounds the other way in the two
    # fp32 summation orders, and AdamW's normalized update spreads the flip
    cpu = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device="cpu")
    cpu_state = cpu.init_state(params=init)
    card = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device=CARD)
    card_state = card.init_state(params=init)
    synced = GraphTrainer(DeepDFA.from_config(cfg.model, input_dim), cfg, device="cpu")
    loss_pairs, free_pairs = [], []
    for i in range(CPU_STEPS):
        here = {k: v.detach().cpu().clone() for k, v in card.model.state_dict().items()}
        with torch.no_grad():
            want = synced.forward_loss(synced.init_state(params=here),
                                       batches[i].to("cpu")).item()
        pair = []
        for tr, st in ((card, card_state), (cpu, cpu_state)):
            loss = tr.forward_loss(st, batches[i].to(tr.device))
            loss.backward()
            pair.append(loss.item())
            st.apply_gradients()
        loss_pairs.append((pair[0], want))
        free_pairs.append(tuple(pair))
    loss_err = max(abs(a - b) / abs(b) for a, b in loss_pairs)
    free_err = max(abs(a - b) / abs(b) for a, b in free_pairs)
    if loss_err > 1e-4:
        fail(f"train_mxu: card vs CPU losses from the card's parameters {loss_pairs} "
             f"(rel {loss_err})")
    on_card = [b.to(CARD) for b in batches]
    times = []
    for i in range(10):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        trainer.train_step(state, on_card[i % TRAIN_BATCHES])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t_a))
    emit({"phase": "train_mxu", "ok": True, "accum": "int8", "scatter": "mxu", "steps": steps,
          "epoch_train_loss": losses, "epoch_val_loss": [r["val_loss"] for r in epochs],
          "launches": counts, "grads_bit_equal": True, "cpu_losses": loss_pairs,
          "cpu_loss_rel_err": loss_err, "free_cpu_losses": free_pairs,
          "free_cpu_loss_rel_err": free_err, "fit_seconds": fit_s,
          "step_ms": statistics.median(times)})
    return {"ggnn_step_mxu_int8": counts["MXU_INT8_LAUNCHES"],
            "ggnn_gru_bwd": counts["GRU_BWD_LAUNCHES"], "ggnn_dmsg": counts["DMSG_LAUNCHES"]}


def write_graph_store(directory: Path, graphs) -> None:
    """One npz shard in the reference's graph-store layout (the port
    reads stores; the reference's `extract` writes them)."""
    import numpy as np

    directory.mkdir(parents=True, exist_ok=True)
    cat = lambda f: np.concatenate([getattr(g, f) for g in graphs])  # noqa: E731
    np.savez(directory / "graphs-00000.npz", version=np.int64(1),
             graph_ids=np.array([g.graph_id for g in graphs], np.int64),
             labels=np.array([g.label for g in graphs], np.float32),
             node_offsets=np.concatenate([[0], np.cumsum([g.num_nodes for g in graphs])]),
             edge_offsets=np.concatenate([[0], np.cumsum([g.num_edges for g in graphs])]),
             node_feats=cat("node_feats"), node_vuln=cat("node_vuln"),
             edge_src=cat("edge_src"), edge_dst=cat("edge_dst"))


def tune_phase(torch, rng):
    """`cli tune` at the flagship serving budgets (16384 x 65536, d 128,
    5 steps) over the card-legal grid, counted from 0: every candidate
    timed with a verdict, a winner, a valid tuned.json under a temporary
    storage root (its candidate table on a line of its own); then `cli
    train` of the flagship model (ggnn_kernel=true) with
    tune.enabled=true on seeded graphs in a graph store there: the
    overrides it applied printed and in its saved config, the winner's
    kernel launched, finite losses."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.tune import cache as tune_cache

    def run_cli(argv) -> list[str]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        return out.getvalue().splitlines()

    saved_env = os.environ.get("DEEPDFA_TPU_STORAGE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["DEEPDFA_TPU_STORAGE"] = tmp
        try:
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            lines = run_cli(["tune", "--config", str(FLAGSHIP_CONFIG), "--device", CARD])
            tune_s = time.perf_counter() - t0
            tune_counts = gk.launch_counts()
            report = json.loads(lines[-1])
            path = Path(tmp) / "tuned.json"
            verdict = tune_cache.validate_tuned_file(path)
            if not (report["valid"] and verdict["ok"]):
                fail(f"tune: tuned.json invalid: {verdict['problems']}")
            rec = tune_cache.load_tuned(path)["records"][-1]
            sig = report["kernel"]["signature"]
            srec = rec["kernel"][sig]
            rows = srec["candidates"]
            untimed = [r["candidate"] for r in rows
                       if "step_us" not in r or not isinstance(r.get("numerics"), dict)]
            if untimed or not rows or srec.get("winner") is None:
                fail(f"tune: candidates without a time or verdict {untimed}, winner "
                     f"{srec.get('winner')}")
            emit({"phase": "tune_candidates", "signature": sig, "hardware": rec["hardware"],
                  "lax_step_us": srec["lax_step_us"], "winner": srec["winner"],
                  "candidates": [{k: r.get(k) for k in ("candidate", "step_us",
                                                        "mfu_vs_measured_ceiling")}
                                 | {"rel_err": r["numerics"]["rel_err"],
                                    "ok": r["numerics"]["ok"]} for r in rows],
                  "pruned": len(srec["pruned"])})
            # cli train on the tuned layout
            cfg = load(FLAGSHIP_CONFIG)
            graphs = [synthetic_graph(rng, i, int(rng.integers(10, 401)),
                                      cfg.data.feat.input_dim, signal=True) for i in range(120)]
            out = Path(tmp) / "processed" / cfg.data.dataset
            write_graph_store(out / cli.graphs_dirname(cfg), graphs)
            (out / "splits.json").write_text(json.dumps(
                {str(g.graph_id): "val" if g.graph_id % 4 == 3 else "train" for g in graphs}))
            tcfg = config_mod.apply_overrides(cfg, [
                'run_name="tune-train"', "model.ggnn_kernel=true", "train.max_epochs=2",
                "train.checkpoint_every_epochs=1", "tune.enabled=true"])
            cfg_path = Path(tmp) / "train.json"
            config_mod.to_json(tcfg, cfg_path)
            gk.reset_launch_counts()
            t0 = time.perf_counter()
            lines = run_cli(["train", "--config", str(cfg_path), "--device", CARD])
            train_s = time.perf_counter() - t0
            train_counts = gk.launch_counts()
            applied = json.loads(next(x for x in lines if x.startswith("[tune] "))[7:])
            saved = load(Path(tmp) / "runs" / "tune-train" / "config.json")
            layout = tune_cache.kernel_layout_from(rec, *map(int, sig.split("x")))
            m = saved.model
            if not applied["matched"] or not applied["overrides"] or (
                    m.ggnn_kernel_scatter, m.ggnn_kernel_accum, m.ggnn_kernel_unroll,
                    m.ggnn_kernel_block_edges) != (layout["scatter"], layout["accum"],
                                                   layout["unroll"], layout["block_e"]):
                fail(f"tune: cli train applied {applied}, saved {m}, winner {layout}")
            scatter, accum = layout["scatter"], layout["accum"]
            if layout["unroll"] == "fused":
                row = "ggnn_fused_mxu" if scatter == "mxu" else "ggnn_fused"
            else:
                row = (MXU_ROWS[accum][1] if scatter == "mxu"
                       else POLICY_ROWS[accum][1])
            log = (Path(tmp) / "runs" / "tune-train" / "train_log.jsonl").read_text()
            epochs = [json.loads(x) for x in log.splitlines() if '"epoch"' in x]
            losses = [r["train_loss"] for r in epochs]
            if train_counts[GGNN_ROWS[row]] <= 0 or not epochs or not all(
                    math.isfinite(x) for x in losses):
                fail(f"tune: cli train launched {train_counts}, winner row {row}, "
                     f"losses {losses}")
        finally:
            if saved_env is None:
                os.environ.pop("DEEPDFA_TPU_STORAGE", None)
            else:
                os.environ["DEEPDFA_TPU_STORAGE"] = saved_env
    forward_rows = [r for r in GGNN_ROWS if r not in ("ggnn_gru_bwd", "ggnn_dmsg")]
    emit({"phase": "tune", "ok": True, "tune_seconds": tune_s, "report": report,
          "launches": tune_counts, "train_applied": applied, "train_winner_row": row,
          "train_launches": train_counts, "train_epoch_loss": losses, "train_seconds": train_s})
    tune_paths = {"tune": {r: tune_counts[GGNN_ROWS[r]] for r in forward_rows},
                  "tune_train": {r: train_counts[GGNN_ROWS[r]]
                                 for r in (row, "ggnn_gru_bwd", "ggnn_dmsg")}}
    return tune_paths


def flash_bound(B: int, H: int, Tq: int, Tk_live: list, D: int, itemsize: int,
                extra_bytes: int = 0, pairs: int | None = None):
    """(bound_ms, bound_by) of one flash_fwd call: 4*H*D operations per
    live (query, key) pair (q.k and p.v; a padded key, or with causal a
    key after its query, needs none) at the bf16 tensor-core peak (fp32
    at the fp32 peak); `pairs` counts them over the batch (default
    Tq * sum(Tk_live)); bytes: q, k, v read and o written once, the mask
    and lse, and `extra_bytes` (a bias read once)."""
    flops = 4 * H * D * (Tq * sum(Tk_live) if pairs is None else pairs)
    Tk = max(Tk_live + [1])
    nbytes = (itemsize * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * Tk + 4 * B * H * Tq
              + extra_bytes)
    return roofline(flops, nbytes, PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)


def flash_kernel_phase(torch):
    """Kernel 5 against attention_plain at the serving bucket shapes;
    times at the flagship bucket (B 16, T 512, every key live)."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    H, D = 12, 64
    cases = {  # name: (B, T, dtype, real key counts per row)
        "flagship_t512": (16, 512, "bfloat16", [512] * 16),
        "t256": (32, 256, "bfloat16", [256 - 7 * i for i in range(32)]),
        "t128": (64, 128, "bfloat16", [128 - 2 * i for i in range(64)]),
        "fp32_t512": (16, 512, "float32", [512 - 31 * i for i in range(16)]),
        "ragged_all_padding": (16, 512, "bfloat16", [512, 300, 65, 1, 0] + [257] * 11),
    }
    gen = torch.Generator().manual_seed(3)
    report, worst, timing = {}, 0.0, None
    for name, (B, T, dtype, lens) in cases.items():
        td = getattr(torch, dtype)
        q, k, v = (torch.randn(B, H, T, D, generator=gen).to(td).cuda() for _ in range(3))
        mask = (torch.arange(T)[None, :] < torch.tensor(lens)[:, None]).cuda()
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, mask)
            po, plse = fa.attention_plain(q, k, v, mask)
            o2, lse2 = fa.flash_fwd(q, k, v, mask)
        torch.cuda.synchronize()
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
            fail(f"flash_fwd {name}: non-finite o or lse")
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        tol = FLASH_TOL[dtype]
        if err_o > tol or err_lse > 1e-5:
            fail(f"flash_fwd {name}: o err {err_o} (tol {tol}), lse err {err_lse} (tol 1e-5)")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"flash_fwd {name}: other bits on a rerun")
        for b, n in enumerate(lens):
            if n == 0 and not bool((o[b] == 0).all()):
                fail(f"flash_fwd {name}: row {b} has no key but o != 0")
        worst = max(worst, err_o, err_lse)
        report[f"{name}_o_max_abs_err"] = err_o
        report[f"{name}_lse_max_abs_err"] = err_lse
        if name == "flagship_t512":
            bias_mask = mask[:, None, None, :]
            with torch.inference_mode():
                ms = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask))
                plain_ms = median_ms(torch, lambda: fa.attention_plain(q, k, v, mask))
                library_ms = median_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias_mask))
            bound_ms, bound_by = flash_bound(B, H, T, lens, D, 2)
            timing = {"shape": [B, H, T, T, D], "dtype": dtype, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            timing["dropout"] = {**flash_fwd_dropout_case(torch, fa, q, k, v, mask),
                                 "bound_ms": bound_ms, "bound_by": bound_by}
            worst = max(worst, timing["dropout"]["o_max_abs_err"])
    emit({"phase": "kernel flash_fwd", "ok": True, "tolerance": FLASH_TOL, "lse_tolerance": 1e-5,
          "max_abs_err": worst, **report, **timing})
    return worst, timing


def flash_fwd_dropout_case(torch, fa, q, k, v, mask) -> dict:
    """Kernel 5 at dropout rate 0.1 on the flagship call against the plain
    version with the seed's Philox bits: o within the bf16 tolerance, lse
    within 1e-5; the keep fraction of the call's 50 M bits within 0.9 +-
    0.002; the kernel's and the plain version's times at that rate, and one scaled_dot_product_attention call's at
    that rate with the backend that ran it."""
    B, H, T, _ = q.shape
    seed = DROPOUT_SEED
    with torch.inference_mode():
        o, lse = fa.flash_fwd(q, k, v, mask, dropout_rate=DROPOUT_RATE, seed=seed)
        bits = fa.dropout_bits(seed, B, H, T, T, q.device)
        po, plse = fa.attention_plain(q, k, v, mask, dropout_rate=DROPOUT_RATE, bits=bits)
        keep = (bits < fa.keep_threshold(DROPOUT_RATE)).double().mean().item()
        del bits
        undropped, _ = fa.flash_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    if err_o > FLASH_TOL["bfloat16"] or err_lse > 1e-5:
        fail(f"flash_fwd dropout: o err {err_o}, lse err {err_lse}")
    if abs(keep - (1.0 - DROPOUT_RATE)) > 0.002:
        fail(f"flash_fwd dropout: keep fraction {keep} outside 0.9 +- 0.002")
    if torch.equal(o, undropped):
        fail("flash_fwd dropout: o is the undropped o")
    with torch.inference_mode():
        ms = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, dropout_rate=DROPOUT_RATE,
                                                   seed=seed))
        plain_ms = median_ms(torch, lambda: fa.attention_plain(
            q, k, v, mask, dropout_rate=DROPOUT_RATE,
            bits=fa.dropout_bits(seed, B, H, T, T, q.device)))

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None, None, :], dropout_p=DROPOUT_RATE)

        library_ms = median_ms(torch, library)
        backend, top = sdpa_backend(torch, library)
    return {"rate": DROPOUT_RATE, "seed": seed, "bits": B * H * T * T, "keep_fraction": keep,
            "o_max_abs_err": err_o, "lse_max_abs_err": err_lse, "ms": ms,
            "plain_ms_with_bits": plain_ms, "library_ms": library_ms,
            "library_call": "sdpa(bool attn_mask, dropout_p)", "library_backend": backend,
            "library_device_ms_by_kernel": top}


def flash_bwd_bound(B: int, H: int, Tq: int, Tk_live: list, D: int, itemsize: int,
                    products: int, out_tokens: int, extra_bytes: int = 0,
                    pairs: int | None = None):
    """(bound_ms, bound_by) of one backward kernel: `products` matrix
    products of 2*H*Tq*D operations per live key of each row (dq: s, dp,
    ds.k = 3; dk/dv: s, dp, p.do, ds.q = 4; dbias: s, dp = 2) at the bf16
    tensor-core peak (fp32 at the fp32 peak); bytes: q, k, v, do read and
    the gradients' `out_tokens` rows of [B, H, ., D] written once (dq: Tq;
    dk, dv: 2 Tk; dbias: 0), lse, delta and the mask, and `extra_bytes`
    (a bias read once, dbias written once); `pairs` as for `flash_bound`."""
    flops = 2 * products * H * D * (Tq * sum(Tk_live) if pairs is None else pairs)
    Tk = max(Tk_live + [1])
    nbytes = (itemsize * B * H * D * (2 * Tq + 2 * Tk + out_tokens) + 8 * B * H * Tq
              + 4 * B * Tk + extra_bytes)
    return roofline(flops, nbytes, PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS)


def flash_bwd_kernel_phase(torch):
    """Kernels 6 (dq) and 7 (dk/dv) against attention_bwd_plain on the
    card, each case at dropout 0 and 0.1 with a fixed seed (the same
    Philox mask in both versions), from the forward kernel's o and lse:
    the flagship training call (B 16, H 12, T 512, D 64, bf16, every key
    live), the T = 256 and T = 128 buckets, fp32, a bf16 batch with
    ragged masks and an all-padding row (whose gradients must be exactly
    0), and a ragged flagship-shape batch with the training path's
    strided q, k, v and do. Each gradient within 2e-2 of its largest magnitude in bf16, 1e-4
    in fp32; the same bits on a repeat. Times at the flagship call: both
    kernels at rate 0 and 0.1, the plain backward, and the backward of
    one scaled_dot_product_attention call (boolean mask) as the library
    yardstick, never called by the port, at rate 0 and at rate 0.1
    (`sdpa_dropout_yardstick`, with the backend that ran)."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    H, D = 12, 64
    cases = {  # name: (B, T, dtype, real key counts per row)
        "flagship_t512": (16, 512, "bfloat16", [512] * 16),
        "t256": (32, 256, "bfloat16", [256 - 7 * i for i in range(32)]),
        "t128": (64, 128, "bfloat16", [128 - 2 * i for i in range(64)]),
        "fp32_t512": (16, 512, "float32", [512 - 31 * i for i in range(16)]),
        "ragged_all_padding": (16, 512, "bfloat16", [512, 300, 65, 1, 0] + [257] * 11),
        # the training path's operands: q, k, v strided views of the fused
        # [B, T, 3, H, D] product, do a [B, H, T, D] view of [B, T, H, D]
        "strided_t512": (16, 512, "bfloat16", [512, 480, 300, 257, 129, 64, 33, 1] + [512] * 8),
    }
    gen = torch.Generator().manual_seed(4)
    report, worst, timing = {}, 0.0, {}
    for name, (B, T, dtype, lens) in cases.items():
        td = getattr(torch, dtype)
        if name.startswith("strided"):
            qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(td).cuda().view(B, T, 3, H, D)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            do = torch.randn(B, T, H, D, generator=gen).to(td).cuda().transpose(1, 2)
        else:
            q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(td).cuda()
                           for _ in range(4))
        mask = (torch.arange(T)[None, :] < torch.tensor(lens)[:, None]).cuda()
        for rate in (0.0, DROPOUT_RATE):
            kw = {"dropout_rate": rate, "seed": DROPOUT_SEED}
            with torch.inference_mode():
                o, lse = fa.flash_fwd(q, k, v, mask, **kw)
                delta = (do.float() * o.float()).sum(-1, keepdim=True)
                dq = fa.flash_dq(q, k, v, mask, lse, delta, do, **kw)
                dk, dv = fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw)
                again = (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                         *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
                bits = fa.dropout_bits(DROPOUT_SEED, B, H, T, T, q.device) if rate else None
                want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, dropout_rate=rate,
                                              bits=bits)
                del bits
            torch.cuda.synchronize()
            tag = f"{name}_rate{rate}"
            for what, got, ref, rerun in zip(("dq", "dk", "dv"), (dq, dk, dv), want, again):
                if not torch.isfinite(got.float()).all():
                    fail(f"flash_bwd {tag}: {what} has non-finite values")
                err = (got.float() - ref.float()).abs().max().item()
                scale = max(ref.float().abs().max().item(), 1e-6)
                tol = (FLASH_TOL["bfloat16"] if dtype == "bfloat16" else 1e-4) * scale
                if err > tol:
                    fail(f"flash_bwd {tag}: {what} err {err} > {tol}")
                if not torch.equal(got, rerun):
                    fail(f"flash_bwd {tag}: {what} other bits on a rerun")
                for b, n in enumerate(lens):
                    if n == 0 and not bool((got[b] == 0).all()):
                        fail(f"flash_bwd {tag}: row {b} has no key but d{what} != 0")
                worst = max(worst, err)
                report[f"{tag}_{what}_max_abs_err"] = err
                report[f"{tag}_{what}_scale"] = scale
            if name != "flagship_t512":
                continue
            with torch.inference_mode():
                timing[f"dq_ms_rate{rate}"] = median_ms(
                    torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do, **kw))
                timing[f"dkv_ms_rate{rate}"] = median_ms(
                    torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
            if rate:
                timing["dropout_library"] = sdpa_dropout_yardstick(
                    torch, q, k, v, do, mask[:, None, None, :], rate)
                continue
            with torch.inference_mode():
                timing["plain_ms"] = median_ms(
                    torch, lambda: fa.attention_bwd_plain(q, k, v, mask, o, lse, do))
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask[:, None, None, :])
            timing["library_ms"] = median_ms(
                torch, lambda: out.backward(do, retain_graph=True))
            del out, leaves
            for kernel, products, out_tokens in (("dq", 3, T), ("dkv", 4, 2 * T)):
                bound_ms, bound_by = flash_bwd_bound(B, H, T, lens, D, 2, products, out_tokens)
                timing[f"{kernel}_bound_ms"], timing[f"{kernel}_bound_by"] = bound_ms, bound_by
    emit({"phase": "kernel flash_bwd", "ok": True, "rates": [0.0, DROPOUT_RATE],
          "seed": DROPOUT_SEED, "tolerance": {"bfloat16": "2e-2 of scale", "float32": "1e-4 of scale"},
          "max_abs_err": worst, "shape": [16, H, 512, 512, D], **timing, **report})
    return worst, timing


def sdpa_backend(torch, fn) -> tuple[str, dict]:
    """(backend, top kernels): the SDPA backend whose card kernels one run
    of `fn` launched, from their names, and its 4 largest kernels by
    device ms."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if str(e.device_type).endswith("CUDA") and us > 0:
            kernels[e.key[:90]] = us / 1e3
    names = " ".join(kernels).lower()
    # cuDNN's kernel names hold "flash" too, so it is asked for first
    backend = next((b for b, frags in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                                       ("efficient", ("fmha", "efficient", "mem_eff")))
                    if any(f in names for f in frags)), "math")
    return backend, dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:4])


def sdpa_dropout_yardstick(torch, q, k, v, do, attn_mask, rate: float,
                           scale: float | None = None) -> dict:
    """The library yardstick of the backward kernels at dropout `rate`,
    never called by the port: one scaled_dot_product_attention call with
    `attn_mask` (a boolean key mask, or a float mask holding a bias,
    which then gets its gradient too) and dropout_p=rate; its backward
    (the mask replayed from the RNG state the call saved) timed as the
    kernels are, and the backend that ran one forward and backward."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    mask = attn_mask.detach().clone().requires_grad_(attn_mask.is_floating_point())

    def forward():
        return torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask, dropout_p=rate, scale=scale)

    out = forward()
    ms = median_ms(torch, lambda: out.backward(do, retain_graph=True))
    del out
    backend, top = sdpa_backend(torch, lambda: forward().backward(do))
    kind = "float attn_mask with the bias" if attn_mask.is_floating_point() else "bool attn_mask"
    return {"ms": ms, "rate": rate, "call": f"sdpa({kind}, dropout_p) backward",
            "backend": backend, "device_ms_by_kernel": top}


def flash_bias_kernel_phase(torch):
    """Kernels 5-7 with T5's additive [H, T, T] bias and kernel 8 (dbias)
    against the plain versions on the card at the T5 flagship call (B 16,
    H 12, T 512, D 64, bf16, scale 1.0), at dropout 0 and 0.1 (one seed,
    the same Philox mask in every version): every key live, ragged keys
    with an all-padding row (its o and gradients exactly 0), and ragged
    keys with the training path's operands (q, k, v views of the fused
    [B, T, 3, H, D] product, do a view of [B, T, H, D], the bias the
    contiguous [H, T, T] bf16 tensor the encoder builds). o within 2e-2
    (bf16), lse within 1e-5 + 1e-5 |lse|, dq, dk, dv and dbias within
    2e-2 of each one's largest magnitude; all four the same bits on a
    repeat. Times at the every-key-live call: the four kernels with the
    bias (dbias at 0.1 too), the plain forward and backward with the bias,
    one scaled_dot_product_attention call with bias and mask as a float
    attn_mask and its backward with that mask requiring grad (the
    library yardstick, never called by the port), and the bounds."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    B, H, T, D = 16, 12, 512, 64
    tol = FLASH_TOL["bfloat16"]
    cases = {  # name: (real key counts per row, the training path's strides)
        "t5_flagship": ([512] * 16, False),
        "ragged_all_padding": ([512, 300, 65, 1, 0] + [257] * 11, False),
        "training_strides": ([512, 480, 300, 257, 129, 64, 33, 1] + [512] * 8, True),
    }
    gen = torch.Generator().manual_seed(7)
    report, worst, timing = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "dbias": 0.0}, {}
    for name, (lens, strided) in cases.items():
        bf = torch.bfloat16
        if strided:
            qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(bf).cuda().view(B, T, 3, H, D)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            do = torch.randn(B, T, H, D, generator=gen).to(bf).cuda().transpose(1, 2)
        else:
            q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(bf).cuda() for _ in range(4))
        bias = (torch.randn(H, T, T, generator=gen) * 2.0).to(bf).cuda()
        mask = (torch.arange(T)[None, :] < torch.tensor(lens)[:, None]).cuda()
        for rate in (0.0, DROPOUT_RATE):
            kw = {"scale": 1.0, "dropout_rate": rate, "seed": DROPOUT_SEED, "bias": bias}
            with torch.inference_mode():
                o, lse = fa.flash_fwd(q, k, v, mask, **kw)
                delta = (do.float() * o.float()).sum(-1, keepdim=True)
                got = (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                       *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw),
                       fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0,
                                      dropout_rate=rate, seed=DROPOUT_SEED))
                o2, lse2 = fa.flash_fwd(q, k, v, mask, **kw)
                again = (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                         *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw),
                         fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0,
                                        dropout_rate=rate, seed=DROPOUT_SEED))
                bits = fa.dropout_bits(DROPOUT_SEED, B, H, T, T, q.device) if rate else None
                po, plse = fa.attention_plain(q, k, v, mask, 1.0, rate, bits, bias)
                want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, rate, bits, bias)
                del bits
            torch.cuda.synchronize()
            tag = f"{name}_rate{rate}"
            if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
                fail(f"flash_bias {tag}: non-finite o or lse")
            err_o = (o.float() - po.float()).abs().max().item()
            err_lse = ((lse - plse).abs() - 1e-5 * plse.abs()).max().item()
            if err_o > tol or err_lse > 1e-5:
                fail(f"flash_bias {tag}: o err {err_o} (tol {tol}), lse err {err_lse} beyond "
                     "1e-5 |lse| (tol 1e-5)")
            if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                fail(f"flash_bias {tag}: forward gave other bits on a rerun")
            worst["fwd"] = max(worst["fwd"], err_o)
            report[f"{tag}_o_max_abs_err"] = err_o
            for what, g, ref, rerun in zip(("dq", "dk", "dv", "dbias"), got, want, again):
                if not torch.isfinite(g.float()).all():
                    fail(f"flash_bias {tag}: {what} has non-finite values")
                err = (g.float() - ref.float()).abs().max().item()
                scale = max(ref.float().abs().max().item(), 1e-6)
                if err > tol * scale:
                    fail(f"flash_bias {tag}: {what} err {err} > {tol * scale}")
                if not torch.equal(g, rerun):
                    fail(f"flash_bias {tag}: {what} other bits on a rerun")
                key = {"dk": "dkv", "dv": "dkv"}.get(what, what)
                worst[key] = max(worst[key], err)
                report[f"{tag}_{what}_max_abs_err"] = err
                report[f"{tag}_{what}_scale"] = scale
            for b, n in enumerate(lens):
                if n == 0 and not (bool((o[b] == 0).all())
                                   and all(bool((g[b] == 0).all()) for g in got[:3])):
                    fail(f"flash_bias {tag}: row {b} has no key but o or a gradient != 0")
            if name != "t5_flagship":
                continue
            with torch.inference_mode():
                if rate:
                    timing["dbias_dropout_ms"] = median_ms(torch, lambda: fa.flash_dbias(
                        q, k, v, mask, lse, delta, do, bias, scale=1.0, dropout_rate=rate,
                        seed=DROPOUT_SEED))
            if rate:
                float_mask = bias[None] + torch.where(mask, 0.0, -1e9).to(bf)[:, None, None, :]
                timing["dbias_dropout_library"] = sdpa_dropout_yardstick(
                    torch, q, k, v, do, float_mask, rate, scale=1.0)
                del float_mask
                continue
            with torch.inference_mode():
                timing["fwd_ms"] = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, **kw))
                timing["dq_ms"] = median_ms(
                    torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do, **kw))
                timing["dkv_ms"] = median_ms(
                    torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
                timing["dbias_ms"] = median_ms(torch, lambda: fa.flash_dbias(
                    q, k, v, mask, lse, delta, do, bias, scale=1.0))
                timing["fwd_plain_ms"] = median_ms(
                    torch, lambda: fa.attention_plain(q, k, v, mask, 1.0, bias=bias))
                timing["bwd_plain_ms"] = median_ms(torch, lambda: fa.attention_bwd_plain(
                    q, k, v, mask, o, lse, do, 1.0, bias=bias))
                float_mask = bias[None] + torch.where(mask, 0.0, -1e9).to(bf)[:, None, None, :]
                timing["fwd_library_ms"] = median_ms(
                    torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, attn_mask=float_mask, scale=1.0))
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, float_mask)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves[:3], attn_mask=leaves[3], scale=1.0)
            timing["bwd_library_ms"] = median_ms(torch, lambda: out.backward(do, retain_graph=True))
            del out, leaves, float_mask
            bias_bytes = 2 * H * T * T
            timing["fwd_bound"] = flash_bound(B, H, T, lens, D, 2, bias_bytes)
            for kernel, products, out_tokens, extra in (
                    ("dq", 3, T, bias_bytes), ("dkv", 4, 2 * T, bias_bytes),
                    ("dbias", 2, 0, bias_bytes + 4 * H * T * T)):
                timing[f"{kernel}_bound"] = flash_bwd_bound(B, H, T, lens, D, 2, products,
                                                            out_tokens, extra)
    emit({"phase": "kernel flash_bias", "ok": True, "shape": [B, H, T, T, D], "scale": 1.0,
          "rates": [0.0, DROPOUT_RATE], "seed": DROPOUT_SEED,
          "tolerance": {"o": tol, "lse": "1e-5 + 1e-5 |lse|", "grads": "2e-2 of scale"},
          "max_abs_err": worst, **timing, **report})
    return worst, timing


def c_like_text(rng, n_tokens: int) -> str:
    """n_tokens C-like tokens (each one hash-tokenizer token), broken
    into lines after ; { and }."""
    lines, line = [], []
    for w in rng.choice(C_WORDS, n_tokens):
        line.append(str(w))
        if w in (";", "{", "}"):
            lines.append(" ".join(line))
            line = []
    lines.append(" ".join(line))
    return "\n".join(lines) + "\n"


def model_config(arch: str, layers: int | None = None, dropout: float | None = None):
    """The combined family's model config at full width (bf16
    activations) with the flagship graph encoder: DeepDFA+LineVul at
    codebert-base width ("roberta") or CodeT5+DeepDFA at codet5-base
    width ("t5"); `layers` cuts the depth, `dropout` sets every rate."""
    from deepdfa_tpu_torch.core import load
    from deepdfa_tpu_torch.models import CombinedConfig, DefectConfig, T5Config, TransformerConfig

    cfg = load(COMBINED_CONFIG)
    kw = {"dtype": "bfloat16", **({"num_layers": layers} if layers else {}),
          **({"dropout_rate": dropout} if dropout is not None else {})}
    graph = dict(graph_hidden_dim=cfg.model.hidden_dim, graph_n_steps=cfg.model.n_steps,
                 graph_input_dim=cfg.data.feat.input_dim)
    if arch == "t5":
        return DefectConfig(encoder=T5Config(**kw), **graph)
    head = {} if dropout is None else {"head_dropout": dropout}
    return CombinedConfig(encoder=TransformerConfig(**kw), **graph, **head)


def combined_model(torch, layers: int | None = None, arch: str = "roberta"):
    """The `arch` family's model (`model_config`), random weights from
    seed 0 on the CPU, in eval mode."""
    from deepdfa_tpu_torch.models import CombinedModel, DefectModel

    family = DefectModel if arch == "t5" else CombinedModel
    return family(model_config(arch, layers), generator=torch.Generator().manual_seed(0)).eval()


def tokenizer(arch: str):
    """The hash tokenizer (vocab 4096) in the family's frame: RoBERTa's
    (pad 1) or T5's (pad 0, eos 2)."""
    from deepdfa_tpu_torch.data import HashTokenizer

    return HashTokenizer(vocab_size=4096, t5_frame=arch == "t5")


def serve_combined_phase(torch, rng, arch: str = "roberta"):
    """The combined serving main path of the `arch` family through
    score_combined on the card, its launch counts, batched-vs-alone and
    card-vs-CPU checks."""
    import numpy as np

    from deepdfa_tpu_torch.core import apply_overrides, load
    from deepdfa_tpu_torch.core.config import serve_budgets
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.serve import CombinedExecutor, DynamicBatcher, score_combined

    phase = "serve_t5" if arch == "t5" else "serve_combined"
    override = f"data.seq_buckets={json.dumps(COMBINED_BUCKETS)}"
    cfg = apply_overrides(load(COMBINED_CONFIG), [override])
    tok = tokenizer(arch)
    t0 = time.perf_counter()
    model = combined_model(torch, arch=arch)
    n_params = sum(p.numel() for p in model.parameters())
    init_s = time.perf_counter() - t0
    spans = [(20, 126), (127, 254), (255, 510)]  # real tokens + <s> </s> per bucket
    payloads = []
    for i in range(COMBINED_REQUESTS):
        lo, hi = spans[i % 3]
        text = c_like_text(rng, int(rng.integers(lo, hi + 1)))
        payloads.append((text, synthetic_graph(rng, i, int(rng.integers(10, 151)),
                                               cfg.data.feat.input_dim)))
    n_layers, n_steps = model.cfg.encoder.num_layers, model.cfg.graph_n_steps

    gk.LAUNCHES = fa.LAUNCHES = 0
    summary = score_combined(model, payloads, cfg, tok, device="cuda")
    launches = {"flash_fwd": fa.LAUNCHES, "ggnn_step": gk.LAUNCHES}
    probs = np.asarray(summary.pop("probs"), dtype=np.float64)
    if summary["serve_scored"] != len(payloads) or not np.all(np.isfinite(probs)):
        fail(f"{phase}: {summary['serve_failed_requests']} failed or non-finite")
    if not np.all((probs > 0.0) & (probs < 1.0)):
        fail(f"{phase}: a probability outside (0, 1)")
    batches = summary["serve_batches"]
    warm = len(COMBINED_BUCKETS)
    want = {"flash_fwd": (batches + warm) * n_layers, "ggnn_step": (batches + warm) * n_steps}
    if (summary["flash_fwd_launches"], summary["ggnn_step_launches"]) != (
            batches * n_layers, batches * n_steps) or launches != want:
        fail(f"{phase}: launches {launches} (scoring {summary['flash_fwd_launches']}, "
             f"{summary['ggnn_step_launches']}), expected {want} for {batches} batches + "
             f"{warm} warmup batches")

    # three requests of one bucket re-scored alone on the same padded shape
    node_budget, edge_budget = serve_budgets(cfg)
    ex = CombinedExecutor(model, tok, cfg.data.seq_buckets, cfg.data.token_budget,
                          node_budget, edge_budget, device="cuda")
    enc = [(tok.encode(t, COMBINED_BUCKETS[-1]), g) for t, g in payloads]
    pick = [i for i in range(len(enc)) if ex.bucket_key(enc[i]) == 256][:3]
    alone = [DynamicBatcher(ex).score_all([enc[i]])[0].wait(600) for i in pick]
    graph_gap = float(max(abs(a - probs[i]) for a, i in zip(alone, pick)))
    if graph_gap > 1e-5:
        fail(f"{phase}: alone vs batched with graphs differ by {graph_gap}")
    text_only = [(enc[i][0], None) for i in pick]
    together = [r.wait(600) for r in DynamicBatcher(ex).score_all(text_only)]
    text_alone = [DynamicBatcher(ex).score_all([p])[0].wait(600) for p in text_only]
    if together != text_alone:
        fail(f"{phase}: text-only alone {text_alone} != batched {together}")

    # a 2-layer model of the same width and seed: card vs the CPU plain
    # path, compared on the logits (the probabilities squash their spread)
    small = [enc[i] for i in range(0, 12, 3)]  # 4 requests, T = 128 bucket
    two = {}
    for dev in ("cuda", "cpu"):
        small_ex = CombinedExecutor(combined_model(torch, 2, arch), tok, [128], 4 * 128,
                                    node_budget, edge_budget, device=dev)
        _, (_, batch) = small_ex.pack_chunk(128, small)
        b = batch.to(dev)
        with torch.inference_mode():
            logits = small_ex.model(b.input_ids, b.graphs, b.has_graph)
        two[dev] = logits[: len(small)].float().cpu().numpy().astype(np.float64)
    cpu_err = float(np.abs(two["cuda"] - two["cpu"]).max())
    margin = two["cpu"][:, 1] - two["cpu"][:, 0]
    if not cpu_err <= COMBINED_LOGIT_TOL:
        fail(f"{phase}: 2-layer card vs CPU logits differ by {cpu_err} "
             f"(tol {COMBINED_LOGIT_TOL})")

    # a load window: every bucket runs several full batches, so requests/s
    # and p99 rest on more than the handful of batches above
    load = []
    for i in range(COMBINED_LOAD_REQUESTS):
        lo, hi = spans[i % 3]
        load.append((c_like_text(rng, int(rng.integers(lo, hi + 1))),
                     synthetic_graph(rng, i, int(rng.integers(10, 151)), cfg.data.feat.input_dim)))
    load_summary = score_combined(model, load, cfg, tok, device="cuda")
    load_probs = np.asarray(load_summary.pop("probs"), dtype=np.float64)
    load_batches = load_summary["serve_batches"]
    if load_summary["serve_scored"] != len(load) or not np.all(
            (load_probs > 0.0) & (load_probs < 1.0)):
        fail(f"{phase} load: a failed request or a probability outside (0, 1)")
    load_launches = (load_summary["flash_fwd_launches"], load_summary["ggnn_step_launches"])
    if load_launches != (load_batches * n_layers, load_batches * n_steps):
        fail(f"{phase} load: launches {load_launches} for {load_batches} batches")
    load_summary.pop("buckets")
    emit({"phase": phase, "ok": True, "override": override,
          "seq_buckets": list(cfg.data.seq_buckets), "token_budget": cfg.data.token_budget,
          "node_budget": node_budget, "edge_budget": edge_budget, "params": n_params,
          "init_seconds": init_s, "requests": len(payloads), "kernel_launches": launches,
          "alone_vs_batched_with_graphs_max_abs": graph_gap,
          "alone_vs_batched_with_graphs_bit_equal": graph_gap == 0.0,
          "alone_vs_batched_text_only_bit_equal": True,
          "two_layer_cpu_logits_max_abs_err": cpu_err,
          "two_layer_logit_tolerance": COMBINED_LOGIT_TOL,
          "two_layer_cpu_logits": two["cpu"].tolist(),
          "two_layer_logit_margin_min": float(margin.min()),
          "two_layer_logit_margin_max": float(margin.max()),
          "probs_min": float(probs.min()), "probs_max": float(probs.max()), **summary,
          "load": {"requests": len(load), "probs_min": float(load_probs.min()),
                   "probs_max": float(load_probs.max()), **load_summary}})
    return launches, model, tok, cfg, enc


def profile_combined_phase(torch, model, tok, cfg, enc, phase: str = "profile_combined") -> None:
    """One full 512-token batch (16 rows): host collate, copies, forward
    to sync and fetch (median of 5, each stage synchronized), then one
    batch under torch.profiler (after a dropped warm-up batch) for device
    time by kernel group, the idle share, and whether the trace holds
    every flash and GGNN launch of the batch."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from deepdfa_tpu_torch.core.config import serve_budgets
    from deepdfa_tpu_torch.serve import CombinedExecutor

    ex = CombinedExecutor(model, tok, [512], cfg.data.token_budget, *serve_budgets(cfg),
                          device="cuda")
    rows = ex.capacity(512)
    chunk = [p for p in enc if ex.bucket_key(p) == 512][:rows]
    chunk += chunk[: rows - len(chunk)]
    ex.warmup()
    stages = {"collate_ms": [], "to_device_ms": [], "forward_ms": [], "fetch_ms": [], "batch_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        _, (_, batch) = ex.pack_chunk(512, chunk)
        t1 = time.perf_counter()
        b = batch.to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            probs = torch.softmax(ex.model(b.input_ids, b.graphs, b.has_graph), dim=-1)[:, 1]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ex.fetch(probs, rows)
        t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0)):
            stages[k].append(1e3 * v)
    _, packed = ex.pack_chunk(512, chunk)
    # the first batch warms the tracer up and is dropped: a trace that
    # starts cold can miss the window's first kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        ex.fetch(ex.dispatch(512, packed), rows)
        prof.step()  # the traced step ends where the context does
        t0 = time.perf_counter()
        ex.fetch(ex.dispatch(512, packed), rows)
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    dev = device_profile(prof, profiled_ms)
    groups = device_groups(prof)
    mcfg = model.cfg
    emit({"phase": phase, "rows": rows, "tokens": rows * 512,
          **{k: statistics.median(v) for k, v in stages.items()},
          "device_ms_by_group": groups,
          "trace_complete": (groups["flash_fwd"]["calls"], groups["ggnn_step"]["calls"]) == (
              mcfg.encoder.num_layers, mcfg.graph_n_steps), **dev})


def training_corpus(rng, input_dim: int, tok):
    """Seeded labelled texts with graphs, tokenized: 32 rows a bucket at
    T 512, 32 at 256 and 64 at 128, so the bucket planner emits 4 full
    batches (2 of them at 512). A label-1 text uses the second half of
    C_WORDS' one-token words, a label-0 text the first; a label-1 graph
    carries token 7 on one node (the GGNN smoke's signal). `tok` is the
    family's tokenizer."""
    vocab = [w for w in C_WORDS if w not in ("->", "++")]  # those two are 2 tokens each
    half = len(vocab) // 2
    spans = {512: (255, 510), 256: (127, 254), 128: (20, 126)}
    rows = [512] * 32 + [256] * 32 + [128] * 64
    token_ids, labels, graphs = {}, {}, {}
    for i, edge in enumerate(rows):
        label = i % 2
        words = vocab[half:] if label else vocab[:half]
        lo, hi = spans[edge]
        text = " ".join(str(w) for w in rng.choice(words, int(rng.integers(lo, hi + 1))))
        token_ids[i] = tok.encode(text, 512)
        labels[i] = label
        g = synthetic_graph(rng, 2 * (i // 2) + (1 - label), int(rng.integers(10, 151)),
                            input_dim, signal=True)
        graphs[i] = dataclasses.replace(g, graph_id=i)
    return token_ids, labels, graphs


def combined_train_setup(torch, layers: int | None = None, dropout: float = DROPOUT_RATE,
                         arch: str = "roberta"):
    """(config, model config) of the `arch` family's training path at full
    width (bf16 activations, remat "full") with the flagship graph
    encoder; AdamW at lr 1e-4, no warmup, clip 1.0."""
    from deepdfa_tpu_torch.core import apply_overrides, load

    cfg = apply_overrides(load(COMBINED_CONFIG), [
        f"data.seq_buckets={json.dumps(COMBINED_BUCKETS)}", "train.optim.learning_rate=1e-4",
        "train.optim.warmup_frac=0.0", "train.optim.grad_clip_norm=1.0"])
    return cfg, model_config(arch, layers, dropout)


def grads_of(state) -> dict:
    return {k: p.grad.detach().clone() for k, p in state.model.named_parameters()
            if p.grad is not None}


def train_combined_phase(torch, rng, arch: str = "roberta"):
    """The `arch` family's training main path through CombinedTrainer.fit
    on the card: launch counts, bit-equal gradients, a 2-layer CPU
    cross-check, and a step split with remat on and off."""
    import numpy as np

    from deepdfa_tpu_torch.data import collate_plan, lengths_for, plan_bucketed_batches
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.train import CombinedTrainer

    phase = "train_t5" if arch == "t5" else "train_combined"
    cfg, mcfg = combined_train_setup(torch, arch=arch)
    tok = tokenizer(arch)
    token_ids, labels, graphs = training_corpus(rng, cfg.data.feat.input_dim, tok)
    bcfg = cfg.data.batch
    order = sorted(token_ids)
    lengths = lengths_for(token_ids, order, tok.pad_id)

    plans = list(plan_bucketed_batches(lengths, order, COMBINED_BUCKETS, cfg.data.token_budget,
                                       1, bcfg.node_budget, bcfg.edge_budget))

    def collate(plan):
        return collate_plan(plan, token_ids, labels, graphs, pad_id=tok.pad_id)

    batches = [collate(p) for p in plans]
    shapes = [list(b.input_ids.shape) for b in batches]
    if len(batches) != TRAIN_BATCHES or sorted(s[1] for s in shapes) != [128, 256, 512, 512]:
        fail(f"{phase}: planned batches {shapes}, want 4 full ones over 128/256/512")
    steps = TRAIN_BATCHES * TRAIN_EPOCHS
    trainer = CombinedTrainer(cfg, mcfg, total_steps=steps, device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state(seed=0)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.model.parameters())
    records = []

    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = fa.DBIAS_LAUNCHES = 0
    gk.LAUNCHES = gk.GRU_BWD_LAUNCHES = gk.DMSG_LAUNCHES = 0
    t0 = time.perf_counter()
    trainer.fit(state, lambda epoch: batches, val_batches=lambda: batches[:1],
                max_epochs=TRAIN_EPOCHS, log_fn=records.append, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"flash_fwd": fa.LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
                "flash_dkv": fa.DKV_LAUNCHES, "flash_dbias": fa.DBIAS_LAUNCHES,
                "ggnn_step": gk.LAUNCHES, "ggnn_gru_bwd": gk.GRU_BWD_LAUNCHES,
                "ggnn_dmsg": gk.DMSG_LAUNCHES}
    L, S = mcfg.encoder.num_layers, mcfg.graph_n_steps
    # per step: each layer's forward, its replay under remat, its two
    # backward kernels (three with T5's bias: dbias); the warm-up runs one
    # step a bucket; eval batches run the forward alone
    trained = steps + len(COMBINED_BUCKETS)
    want = {"flash_fwd": trained * 2 * L + TRAIN_EPOCHS * L, "flash_dq": trained * L,
            "flash_dkv": trained * L, "flash_dbias": trained * L if arch == "t5" else 0,
            "ggnn_step": trained * S + TRAIN_EPOCHS * S,
            "ggnn_gru_bwd": trained * S, "ggnn_dmsg": trained * S}
    if launches != want:
        fail(f"{phase}: kernel launches {launches}, expected {want}")
    epochs = [r for r in records if "epoch" in r]
    losses = [r["train_loss"] for r in epochs]
    if not all(math.isfinite(x) for x in losses + [r["val_loss"] for r in epochs]):
        fail(f"{phase}: a non-finite loss in {epochs}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: the loss did not fall: epoch means {losses}")

    # two backward passes on one batch with one seed: the same bits
    b0 = batches[0].to(trainer.device)

    def grads():
        trainer.forward_loss(state, b0, fold_seed(0, 999)).backward()
        return grads_of(state)

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail(f"{phase}: two backward passes on one batch gave other gradients")
    del first, second

    if arch == "t5":
        # bf16 rounding flips T5's ReLU gates where a pre-activation is
        # near 0, and eos pooling feeds the last FFN one token a row, so
        # bf16 gradients of the FFN kernels differ by several percent
        # between any two bf16 runs (the card and the CPU here): the
        # gradients are held in fp32 (the fp32 kernel instances on the
        # card), the bf16 run's losses held and its gradients reported
        cpu = {"two_layer_fp32": combined_cpu_check(torch, [batches[2]] * 2, arch, "float32"),
               "two_layer_bf16": combined_cpu_check(torch, [batches[2]] * 2, arch,
                                                    gate_grads=False)}
    else:
        cpu = combined_cpu_check(torch, [batches[2], batches[2]], arch)
    split = combined_step_split(torch, trainer, state,
                                lambda: collate(next(p for p in plans if p.seq_len == 512)), tok)
    last = epochs[-1]
    emit({"phase": phase, "ok": True, "params": n_params, "init_seconds": init_s,
          "steps": steps, "epochs": TRAIN_EPOCHS, "batch_shapes": shapes,
          "seq_buckets": COMBINED_BUCKETS, "token_budget": cfg.data.token_budget,
          "node_budget": bcfg.node_budget, "edge_budget": bcfg.edge_budget,
          "dropout": DROPOUT_RATE, "remat": mcfg.encoder.remat_policy,
          "optim": dataclasses.asdict(cfg.train.optim), "epoch_train_loss": losses,
          "epoch_val_loss": [r["val_loss"] for r in epochs],
          "epoch_seconds": [r["epoch_seconds"] for r in epochs],
          "fit_seconds": fit_s, "warmup": [r for r in records if "warmup_signatures" in r],
          "last_epoch_tokens_per_sec": last["train_tokens_per_sec"],
          "last_epoch_examples_per_sec": last["train_examples_per_sec"],
          "padding_waste": last["padding_waste"], "kernel_launches": launches,
          "grads_bit_equal": True, **cpu, **split})
    return launches


def combined_cpu_check(torch, batches, arch: str = "roberta", dtype: str = "bfloat16",
                       gate_grads: bool = True) -> dict:
    """A 2-layer model of the same width with dropout 0 and `dtype`
    activations, the same weights on the card and on the CPU plain path:
    the first two steps' losses within COMBINED_TRAIN_LOSS_TOL, step-1
    gradients within COMBINED_TRAIN_GRAD_TOL of each leaf's scale (with
    `gate_grads`; else their error is only reported)."""
    from deepdfa_tpu_torch.train import CombinedTrainer

    cfg, mcfg = combined_train_setup(torch, layers=2, dropout=0.0, arch=arch)
    mcfg = dataclasses.replace(mcfg, encoder=dataclasses.replace(mcfg.encoder, dtype=dtype))
    pairs, grad_err = [], None
    runs = {dev: CombinedTrainer(cfg, mcfg, total_steps=2, device=dev) for dev in ("cuda", "cpu")}
    states = {dev: tr.init_state(seed=0) for dev, tr in runs.items()}
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        step = {}
        for dev, tr in runs.items():
            loss = tr.forward_loss(states[dev], batch.to(tr.device), None)
            loss.backward()
            step[dev] = (loss.item(), {k: g.cpu() for k, g in grads_of(states[dev]).items()})
            states[dev].apply_gradients()
        pairs.append((step["cuda"][0], step["cpu"][0]))
        if i == 0:
            errs = leaf_errors(step["cuda"][1], step["cpu"][1])
            grad_err = max(errs.values())
            worst_leaf = max(errs, key=errs.get)
    loss_err = max(abs(a - b) for a, b in pairs)
    if loss_err > COMBINED_TRAIN_LOSS_TOL or (gate_grads and grad_err > COMBINED_TRAIN_GRAD_TOL):
        fail(f"train ({arch}, {dtype}): 2-layer card vs CPU losses {pairs} (abs err {loss_err}, "
             f"tol {COMBINED_TRAIN_LOSS_TOL}), step-1 gradient err {grad_err} at {worst_leaf} "
             f"(tol {COMBINED_TRAIN_GRAD_TOL}{'' if gate_grads else ', reported only'})")
    return {"dtype": dtype, "two_layer_cpu_losses": pairs, "two_layer_cpu_loss_abs_err": loss_err,
            "two_layer_cpu_step1_grad_rel_err": grad_err, "grads_gated": gate_grads,
            "two_layer_worst_leaf": worst_leaf,
            "two_layer_cpu_seconds": time.perf_counter() - t0}


def combined_step_split(torch, trainer, state, collate_512, tok) -> dict:
    """Median of 10 steps on a full 512-token batch, each stage
    synchronized: host collate of its plan, copies, forward, backward,
    optimiser; tokens/s and examples/s; peak memory with remat on, and
    one step with it off; one step under torch.profiler."""
    import dataclasses as dc

    from deepdfa_tpu_torch.data import batch_token_counts
    from deepdfa_tpu_torch.nn.dropout import fold_seed

    split = {k: [] for k in ("host_collate_ms", "to_device_ms", "forward_ms", "backward_ms",
                             "optimizer_ms", "step_ms")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(10):
        t_a = time.perf_counter()
        batch = collate_512()
        t_b = time.perf_counter()
        dev = batch.to(trainer.device)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        loss = trainer.forward_loss(state, dev, fold_seed(1, i))
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t_f = time.perf_counter()
        for k, v in zip(split, (t_b - t_a, t_c - t_b, t_d - t_c, t_e - t_d, t_f - t_e,
                                t_f - t_a)):
            split[k].append(1e3 * v)
    peak_remat = torch.cuda.max_memory_allocated()
    med = {k: statistics.median(v) for k, v in split.items()}
    real, padded, rows = batch_token_counts(batch.input_ids, batch.row_mask, tok.pad_id)
    # remat off (the encoder reads its config at each encode): one
    # warm-up step, then the median of 5
    enc = state.model.encoder
    enc.cfg = dc.replace(enc.cfg, remat=False)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        no_remat = []
        for i in range(6):
            t_a = time.perf_counter()
            trainer.train_step(state, dev, fold_seed(2, i))
            torch.cuda.synchronize()
            no_remat.append(1e3 * (time.perf_counter() - t_a))
        no_remat_ms = statistics.median(no_remat[1:])
        peak_no_remat = torch.cuda.max_memory_allocated()
    finally:
        enc.cfg = dc.replace(enc.cfg, remat=True)
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        trainer.train_step(state, dev, fold_seed(3, 0))
        torch.cuda.synchronize()
        prof.step()
        t_a = time.perf_counter()
        trainer.train_step(state, dev, fold_seed(3, 1))
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    return {"step_batch": list(batch.input_ids.shape), "step_real_tokens": real,
            "step_padded_tokens": padded, "step_rows": rows, **med,
            "tokens_per_sec": real / (med["step_ms"] / 1e3),
            "padded_tokens_per_sec": padded / (med["step_ms"] / 1e3),
            "examples_per_sec": rows / (med["step_ms"] / 1e3),
            "peak_memory_mb_remat": peak_remat / 2**20, "no_remat_step_ms": no_remat_ms,
            "peak_memory_mb_no_remat": peak_no_remat / 2**20,
            "profiled_step": {**device_profile(prof, profiled_ms),
                              "device_ms_by_group": device_groups(prof)}}


# the causal flash phase and the generation family's phases

#: kernels 5-8 causal against their plain versions; name: (B, Tq, Tk, dtype,
#: biased, causal, real keys per row, padded leading keys of the last row).
#: The timed cases: the flagship training call with and without T5's bias,
#: and the gen path's three fp32 calls (decoder self-attention, causal and
#: biased; cross-attention, rectangular; the encoder, biased), every key live.
#: The clone path's two fp32 biased calls (B 32) are held to the gates only:
#: there the fp32 dbias cuts the batch into runs of several rows (4 x 8 for
#: the encoder, 8 x 4 for the causal decoder), where the gen calls give
#: 4 x 4 and 16 x 1
FLASH_CAUSAL_CASES = {
    "bf16_t200_biased_padded": (8, 200, 200, "bfloat16", True, True,
                                [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "fp32_t200_biased_padded": (8, 200, 200, "float32", True, True,
                                [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "bf16_t200_padded": (8, 200, 200, "bfloat16", False, True,
                         [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "fp32_t200_padded": (8, 200, 200, "float32", False, True,
                         [200, 150, 64, 1, 0, 200, 200, 199], 70),
    "t5_flagship_t512": (16, 512, 512, "bfloat16", True, True, [512] * 16, 0),
    "flagship_t512": (16, 512, 512, "bfloat16", False, True, [512] * 16, 0),
    "gen_decoder_t128": (16, 128, 128, "float32", True, True, [128] * 16, 0),
    "gen_cross_t128x256": (16, 128, 256, "float32", False, False, [256] * 16, 0),
    "gen_encoder_t256": (16, 256, 256, "float32", True, False, [256] * 16, 0),
    "clone_encoder_t256": (32, 256, 256, "float32", True, False,
                           [256, 255, 200, 129, 128, 64, 1, 0] * 4, 0),
    "clone_decoder_t256": (32, 256, 256, "float32", True, True, [256] * 32, 0),
}
FLASH_TIMED = ("t5_flagship_t512", "flagship_t512", "gen_decoder_t128", "gen_cross_t128x256",
               "gen_encoder_t256")
#: the unbiased non-causal times at the flagship call that PERF.md records
#: from before the causal build existed (NVIDIA H100 80GB HBM3, 700 W):
#: forward, dq, dk/dv
NONCAUSAL_BASELINE_MS = {"flash_fwd": 0.1350, "flash_dq": 0.2031, "flash_dkv": 0.3458}
#: the fp32 dq and dk/dv times at the gen path's calls that PERF.md records
#: for the first FMA instances (one key a lane; NVIDIA H100 80GB HBM3,
#: 700 W), before their register-tiled redesign
FP32_BWD_BASELINE_MS = {
    "gen_decoder_t128": {"flash_dq": 0.1313, "flash_dkv": 0.1740},
    "gen_cross_t128x256": {"flash_dq": 0.3138, "flash_dkv": 0.4026},
    "gen_encoder_t256": {"flash_dq": 0.6015, "flash_dkv": 0.8173},
}
#: the tensor-core dq and dk/dv times at the flagship call that PERF.md
#: records from before their redesign (NVIDIA H100 80GB HBM3, 700 W; each
#: tile's loads behind two barriers, p through expf, the bias read from
#: device memory an element at a time)
BF16_BWD_BASELINE_MS = {
    "plain": {"flash_dq": 0.2063, "flash_dkv": 0.3474},
    "dropout": {"flash_dq": 0.2705, "flash_dkv": 0.4562},
    "bias": {"flash_dq": 0.3307, "flash_dkv": 0.5947},
    "causal": {"flash_dq": 0.1511, "flash_dkv": 0.2008},
    "causal_bias": {"flash_dq": 0.2444, "flash_dkv": 0.3732},
}
#: kernel 5's times that PERF.md records from before its redesign (NVIDIA
#: H100 80GB HBM3, 700 W): the FMA instance at the gen path's calls (one
#: key a lane) and the tensor-core instance at the flagship call (B 16,
#: H 12, T 512, D 64, bf16; each tile's loads behind two barriers, the
#: bias read from device memory a pair at a time)
FWD_BASELINE_MS = {
    "gen_decoder_t128": 0.1019, "gen_cross_t128x256": 0.2465, "gen_encoder_t256": 0.4708,
    "flagship": 0.1360, "flagship_bias": 0.2334, "flagship_causal": 0.1118,
    "flagship_causal_bias": 0.1813, "flagship_dropout": 0.2133,
}


#: B3's time at the flagship batch (N 16384, d 128) that PERF.md records
#: for its first design (six launches: the gate pass reading its weights
#: a column a lane from device memory, the input pass, the split-K weight
#: pass, the reduce and two weight transposes; NVIDIA H100 80GB HBM3,
#: 700 W), before its register-tiled redesign
GRU_BWD_BASELINE_MS = {"ggnn_gru_bwd": 0.6196}
#: the fp32 dbias times at the gen path's biased calls that PERF.md records
#: for its first FMA instance (a lane one key of a 32-key tile for 4 rows;
#: NVIDIA H100 80GB HBM3, 700 W), before its register-tiled redesign
FP32_DBIAS_BASELINE_MS = {"gen_decoder_t128": 0.1674, "gen_encoder_t256": 0.4932}


def no_spill_report(ptxas: dict) -> dict:
    """{kernel: ptxas's registers and spills} of the instances that must
    not spill, in both flash libraries: every tensor-core forward, dq and
    dk/dv instance at D 64 (three of each: without a bias and with a bf16
    or fp32 bias), the fp32 and bf16 FMA forwards, the register-tiled
    fp32 dq, dk/dv and dbias that the gen path launches and the bf16 FMA
    dbias; and every width's instance of B3's three passes
    (`ggnn_bwd`); None for one the build did not report."""
    out = {}
    for lib, c in (("flash_attention", ""), ("flash_attention_causal", ", causal")):
        for kernel in ("flash_fwd_bf16_mma", "flash_dq_bf16_mma", "flash_dkv_bf16_mma"):
            mma = sorted(k for k in ptxas[lib] if k.startswith(f"{kernel}<64, "))
            out.update({k: ptxas[lib][k] for k in mma})
            if len(mma) != 3:
                out[f"{kernel}<64, ...{c}> x 3"] = None
        for k in (f"flash_fwd_scalar<float, 64{c}>", f"flash_fwd_scalar<bf16, 64{c}>",
                  f"flash_dq_scalar<float, 64{c}>", f"flash_dkv_scalar<float, 64{c}>",
                  f"flash_dbias_scalar<float, 64{c}>", f"flash_dbias_scalar<bf16, 64{c}>"):
            out[k] = ptxas[lib].get(k)
    for kernel in ("gru_bwd_gates_kernel", "gru_bwd_inputs_kernel", "gru_bwd_weights_kernel"):
        for d in range(32, 257, 32):
            out[f"{kernel}<{d}>"] = ptxas["ggnn_bwd"].get(f"{kernel}<{d}>")
    return out


def dbias_cut(fa, B: int, H: int, Tq: int, Tk: int, causal: bool) -> dict:
    """The batch cut of the fp32 dbias (kernel 8's FMA instance) at a
    call, from the workspace its library asks for: `slices` runs of `per`
    rows (per = ceil(B / slices) for the library's power-of-two cuts)."""
    floats = fa._library(causal).flash_dbias_workspace_floats(B, H, Tq, Tk)
    slices = max(1, floats // (H * Tq * Tk))
    return {"slices": slices, "per": -(-B // slices)}


def live_pairs(torch, mask, Tq: int, causal: bool) -> int:
    """(query, key) pairs that a call computes, over the batch: each real
    key j of a row pairs with every query, or with causal with queries
    j .. Tq-1."""
    m = mask.cpu().to(torch.int64)
    if not causal:
        return int(m.sum()) * Tq
    return int((m * torch.arange(m.shape[1], 0, -1)).sum())


def flash_causal_kernel_phase(torch, noncausal: dict, fwd_flagship: dict, bwd_flagship: dict,
                              ptxas: dict):
    """Kernels 5-8 with the causal mask (the causal build of the flash
    source) against the plain versions on the card, and the fp32 (FMA)
    instances at the generation path's shapes: o within 2e-2 (bf16) or
    1e-5 (fp32), lse within 1e-5 + 1e-5 |lse|, dq, dk, dv and dbias
    within 2e-2 (bf16) or 1e-4 (fp32) of their largest magnitude; queries
    without a live key get o = 0 and zero dq; causal dbias exactly 0
    above the diagonal; the same bits on a repeat. Times of the timed
    cases: each kernel, the plain forward and backward, one
    scaled_dot_product_attention call (is_causal, or a float attn_mask
    holding the bias and -inf; the yardstick, never called by the port)
    and its backward, and the bounds over the live pairs. `noncausal`
    holds this run's unbiased non-causal flagship times, set beside
    NONCAUSAL_BASELINE_MS; the gen calls' dq and dk/dv times are set
    beside FP32_BWD_BASELINE_MS, and the forward's times there and at the
    flagship call (`fwd_flagship`: this run's plain, bias and dropout
    times; the causal ones are this phase's) beside FWD_BASELINE_MS, and
    the tensor-core dq and dk/dv at the flagship call (`bwd_flagship`:
    this run's plain, dropout and bias times, {call: {kernel: ms}}; the
    causal ones are this phase's) beside BF16_BWD_BASELINE_MS.
    `ptxas` is the build's report by library: the instances of
    no_spill_report must not spill."""
    from deepdfa_tpu_torch.nn import flash_attention as fa

    rows = fa._library(False).flash_fwd_tile_rows(1)
    no_spill = no_spill_report(ptxas)
    if any(r is None or r["spill_bytes"] for r in no_spill.values()):
        fail(f"flash_causal: an instance that must not spill (a D 64 tensor-core instance, a "
             f"register-tiled FMA instance or a B3 pass) is missing or spills: {no_spill}")
    H, D = 12, 64
    gen = torch.Generator().manual_seed(11)
    report, worst, timing = {}, {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "dbias": 0.0}, {}
    cuts = {}
    for name, (B, Tq, Tk, dtype, biased, causal, lens, lead) in FLASH_CAUSAL_CASES.items():
        td = getattr(torch, dtype)
        q, do = (torch.randn(B, H, Tq, D, generator=gen).to(td).to(CARD) for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, generator=gen).to(td).to(CARD) for _ in range(2))
        bias = (torch.randn(H, Tq, Tk, generator=gen) * 2.0).to(td).to(CARD) if biased else None
        mask = torch.arange(Tk)[None, :] < torch.tensor(lens)[:, None]
        mask[-1, :lead] = False
        mask = mask.to(CARD)
        kw = {"scale": 1.0, "bias": bias, "causal": causal}
        with torch.inference_mode():
            o, lse = fa.flash_fwd(q, k, v, mask, **kw)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)

            def backward():
                return (fa.flash_dq(q, k, v, mask, lse, delta, do, **kw),
                        *fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw),
                        *((fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0,
                                          causal=causal),) if biased else ()))

            got, again = backward(), backward()
            o2, lse2 = fa.flash_fwd(q, k, v, mask, **kw)
            po, plse = fa.attention_plain(q, k, v, mask, 1.0, bias=bias, causal=causal)
            want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, bias=bias,
                                          causal=causal)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        gtol = FLASH_TOL["bfloat16"] if dtype == "bfloat16" else 1e-4
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = ((lse - plse).abs() - 1e-5 * plse.abs()).max().item()
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
            fail(f"flash_causal {name}: non-finite o or lse")
        if err_o > tol or err_lse > 1e-5:
            fail(f"flash_causal {name}: o err {err_o} (tol {tol}), lse err {err_lse}")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            fail(f"flash_causal {name}: the forward gave other bits on a rerun")
        worst["fwd"] = max(worst["fwd"], err_o)
        report[f"{name}_o_max_abs_err"] = err_o
        for what, g, ref, rerun in zip(("dq", "dk", "dv", "dbias"), got, want, again):
            err = (g.float() - ref.float()).abs().max().item()
            scale = max(ref.float().abs().max().item(), 1e-6)
            if not torch.isfinite(g.float()).all() or err > gtol * scale:
                fail(f"flash_causal {name}: {what} err {err} > {gtol * scale} (or non-finite)")
            if not torch.equal(g, rerun):
                fail(f"flash_causal {name}: {what} other bits on a rerun")
            key = {"dk": "dkv", "dv": "dkv"}.get(what, what)
            worst[key] = max(worst[key], err)
            report[f"{name}_{what}_max_abs_err"] = err
        if lead and not (bool((o[-1, :, :lead] == 0).all())
                         and bool((got[0][-1, :, :lead] == 0).all())):
            fail(f"flash_causal {name}: queries without a live key got o or dq != 0")
        if biased and dtype == "float32":
            cuts[name] = dbias_cut(fa, B, H, Tq, Tk, causal)
        if biased and causal:
            upper = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).triu(1)
            if not bool((got[3][:, upper] == 0).all()):
                fail(f"flash_causal {name}: dbias is not 0 above the diagonal")
        if name not in FLASH_TIMED:
            continue
        t = {"shape": [B, H, Tq, Tk, D], "dtype": dtype, "biased": biased, "causal": causal}
        with torch.inference_mode():
            t["fwd_ms"] = median_ms(torch, lambda: fa.flash_fwd(q, k, v, mask, **kw))
            t["dq_ms"] = median_ms(torch, lambda: fa.flash_dq(q, k, v, mask, lse, delta, do, **kw))
            t["dkv_ms"] = median_ms(
                torch, lambda: fa.flash_dkv(q, k, v, mask, lse, delta, do, **kw))
            if biased:
                t["dbias_ms"] = median_ms(torch, lambda: fa.flash_dbias(
                    q, k, v, mask, lse, delta, do, bias, scale=1.0, causal=causal))
            t["fwd_plain_ms"] = median_ms(torch, lambda: fa.attention_plain(
                q, k, v, mask, 1.0, bias=bias, causal=causal))
            t["bwd_plain_ms"] = median_ms(torch, lambda: fa.attention_bwd_plain(
                q, k, v, mask, o, lse, do, 1.0, bias=bias, causal=causal))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        if biased or not causal:
            live = mask[:, None, None, :]
            if causal:
                live = live & torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
            float_mask = torch.where(live, 0.0, float("-inf")).to(td)
            if biased:
                float_mask = float_mask + bias[None]
            lib = {"attn_mask": float_mask}
        else:
            lib = {"is_causal": True}
        with torch.inference_mode():
            t["fwd_library_ms"] = median_ms(torch, lambda: sdpa(q, k, v, scale=1.0, **lib))
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        if "attn_mask" in lib:
            lib = {"attn_mask": lib["attn_mask"].detach().clone().requires_grad_(biased)}
        out = sdpa(*leaves, scale=1.0, **lib)
        t["bwd_library_ms"] = median_ms(torch, lambda: out.backward(do, retain_graph=True))
        t["library_call"] = ("sdpa(is_causal=True)" if "is_causal" in lib else
                             "sdpa(float attn_mask" + (" with the bias" if biased else "") + ")")
        del out, leaves, lib
        pairs = live_pairs(torch, mask, Tq, causal)
        itemsize = 2 if dtype == "bfloat16" else 4
        bias_bytes = itemsize * H * Tq * Tk if biased else 0
        t["live_pairs"] = pairs
        t["fwd_bound"] = flash_bound(B, H, Tq, lens, D, itemsize, bias_bytes, pairs)
        t["dq_bound"] = flash_bwd_bound(B, H, Tq, lens, D, itemsize, 3, Tq, bias_bytes, pairs)
        t["dkv_bound"] = flash_bwd_bound(B, H, Tq, lens, D, itemsize, 4, 2 * Tk, bias_bytes,
                                         pairs)
        if biased:
            t["dbias_bound"] = flash_bwd_bound(B, H, Tq, lens, D, itemsize, 2, 0,
                                               bias_bytes + 4 * H * Tq * Tk, pairs)
        timing[name] = t
    ratio = {k: noncausal[k] / v for k, v in NONCAUSAL_BASELINE_MS.items()}
    fp32_bwd = {case: {kernel: {"ms": timing[case][f"{kernel[len('flash_'):]}_ms"],
                                "baseline_ms": base,
                                "baseline_over_ms": base / timing[case][
                                    f"{kernel[len('flash_'):]}_ms"]}
                       for kernel, base in by_kernel.items()}
                for case, by_kernel in FP32_BWD_BASELINE_MS.items()}
    fwd_now = {**fwd_flagship, "flagship_causal": timing["flagship_t512"]["fwd_ms"],
               "flagship_causal_bias": timing["t5_flagship_t512"]["fwd_ms"],
               **{case: timing[case]["fwd_ms"] for case in FP32_BWD_BASELINE_MS}}
    fwd = {case: {"ms": fwd_now[case], "baseline_ms": base,
                  "baseline_over_ms": base / fwd_now[case]}
           for case, base in FWD_BASELINE_MS.items()}
    bwd_now = {**bwd_flagship,
               **{call: {f"flash_{k}": timing[case][f"{k}_ms"] for k in ("dq", "dkv")}
                  for call, case in (("causal", "flagship_t512"),
                                     ("causal_bias", "t5_flagship_t512"))}}
    bf16_bwd = {call: {kernel: {"ms": bwd_now[call][kernel], "baseline_ms": base,
                                "baseline_over_ms": base / bwd_now[call][kernel]}
                       for kernel, base in by_kernel.items()}
                for call, by_kernel in BF16_BWD_BASELINE_MS.items()}
    fp32_dbias = {case: {"ms": timing[case]["dbias_ms"], "baseline_ms": base,
                         "baseline_over_ms": base / timing[case]["dbias_ms"],
                         "cut": cuts[case]}
                  for case, base in FP32_DBIAS_BASELINE_MS.items()}
    emit({"phase": "kernel flash_causal", "ok": True,
          "tolerance": {"o": FLASH_TOL, "lse": "1e-5 + 1e-5 |lse|",
                        "grads": {"bfloat16": "2e-2 of scale", "float32": "1e-4 of scale"}},
          "max_abs_err": worst, "timed": timing,
          "noncausal_flagship_ms": noncausal, "noncausal_over_baseline": ratio,
          "fp32_bwd_vs_baseline": fp32_bwd, "fwd_vs_baseline": fwd,
          "bf16_bwd_vs_baseline": bf16_bwd, "fp32_dbias_vs_baseline": fp32_dbias,
          "fp32_dbias_cut": cuts,
          "fwd_mma_rows": rows,
          "no_spill_ptxas": no_spill, **report})
    return worst, timing


#: the device of the causal and generation phases
CARD = "cuda"
GEN_VOCAB = 32100  # codet5-base's vocabulary, through --vocab-size
GEN_SRC, GEN_TGT, GEN_ROWS = 256, 128, 16  # the reference CLI's defaults
GEN_BATCHES, GEN_EPOCHS = 4, 5
GEN_DECODE_BATCHES = 2
#: 2+2-layer card vs CPU (fp32): the gates of the defect model's check
GEN_TRAIN_LOSS_TOL, GEN_TRAIN_GRAD_TOL = COMBINED_TRAIN_LOSS_TOL, COMBINED_TRAIN_GRAD_TOL
GEN_STEP_LOGIT_TOL = 1e-3


def gen_args(cmd: str = "train-gen"):
    """The command line a user gives the generation commands at
    codet5-base width (hash tokenizer at vocab 32100, the reference's
    lengths, batch and beam)."""
    from deepdfa_tpu_torch import cli

    task = ["--task", "summarize"] if cmd == "train-gen" else []
    return cli.build_parser().parse_args([cmd, *task, "--vocab-size", str(GEN_VOCAB)])


def gen_config(overrides=()):
    from deepdfa_tpu_torch.core import Config, apply_overrides

    return apply_overrides(Config(), ["train.optim.learning_rate=1e-4",
                                      "train.optim.warmup_frac=0.0",
                                      "train.optim.grad_clip_norm=1.0", *overrides])


def summarize_corpus(rng, n: int) -> Path:
    """A summarize-task jsonl of n seeded rows (code of 300-500 C-like
    words, truncated to 256 tokens; docstrings of 20-160 words, to 128)
    in the reference's format, under build/ (gitignored)."""
    vocab = [w for w in C_WORDS if w not in ("->", "++")]
    doc = ("returns", "the", "buffer", "length", "of", "a", "list", "node", "frees", "copies",
           "into", "checks", "if", "pointer", "is", "null", "size", "array", "index", "value")
    out = ROOT / "build" / "smoke_gen" / "summarize.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = [{"code_tokens": [str(w) for w in rng.choice(vocab, int(rng.integers(300, 501)))],
             "docstring_tokens": [str(w) for w in rng.choice(doc, int(rng.integers(20, 161)))],
             "idx": i} for i in range(n)]
    out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return out


def flash_counts(fa) -> dict:
    return {"flash_fwd": fa.LAUNCHES, "flash_dq": fa.DQ_LAUNCHES, "flash_dkv": fa.DKV_LAUNCHES,
            "flash_dbias": fa.DBIAS_LAUNCHES}


def reset_flash(fa) -> None:
    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = fa.DBIAS_LAUNCHES = 0


def train_gen_phase(torch, rng):
    """`train-gen`'s main path on the card: the CLI's tokenizer, reader
    and model (codet5-base width, fp32), GenTrainer.fit over 4 batches of
    16 summarize rows (256 -> 128 tokens) for 5 epochs with a dev batch,
    AdamW lr 1e-4, hidden dropout 0.1. Every loss finite and the last
    epoch's mean below the first's; launches per step: 6 forward per
    layer (encoder, decoder self-attention and cross-attention, each
    replayed under remat), 3 dq and 3 dk/dv, 2 dbias (encoder and decoder
    biases); two backward passes with one seed give the same bits; a
    2+2-layer model of the same width (dropout 0) gives the same first
    two losses and step-1 gradients on the card and on the CPU plain
    path; a step split, tokens/s and peak memory; bf16 steps beside the
    fp32 ones."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn.dropout import fold_seed

    args = gen_args()
    cfg = gen_config()
    path = summarize_corpus(rng, GEN_ROWS * (GEN_BATCHES + 1))
    steps = GEN_BATCHES * GEN_EPOCHS
    t0 = time.perf_counter()
    tok, gcfg, trainer, state, rows = cli._gen_setup(args, cfg, total_steps=steps)
    init_s = time.perf_counter() - t0
    _, src, tgt = cli._gen_encode_file(args, tok, "summarize", str(path))
    train_src, train_tgt = src[:GEN_ROWS * GEN_BATCHES], tgt[:GEN_ROWS * GEN_BATCHES]
    dev = gen_data.batches_of(src[-GEN_ROWS:], tgt[-GEN_ROWS:], 1, rows, pad_id=tok.pad_id)
    enc = gcfg.encoder
    if (enc.hidden_size, enc.num_layers, gcfg.n_dec_layers, enc.vocab_size, enc.dtype,
            src.shape[1], tgt.shape[1], rows) != (768, 12, 12, GEN_VOCAB, "float32", GEN_SRC,
                                                   GEN_TGT, GEN_ROWS):
        fail(f"train_gen: the CLI built {gcfg}, {src.shape}/{tgt.shape}, rows {rows}")

    def epoch_batches(epoch):
        return gen_data.batches_of(train_src, train_tgt, 1, rows, pad_id=tok.pad_id,
                                   shuffle_seed=cfg.train.seed + epoch)

    records = []
    reset_flash(fa)
    t0 = time.perf_counter()
    trainer.fit(state, epoch_batches, val_batches=lambda: dev, max_epochs=GEN_EPOCHS,
                log_fn=records.append, seed=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = flash_counts(fa)
    L = enc.num_layers
    want = {"flash_fwd": steps * 6 * L + GEN_EPOCHS * 3 * L, "flash_dq": steps * 3 * L,
            "flash_dkv": steps * 3 * L, "flash_dbias": steps * 2 * L}
    if launches != want:
        fail(f"train_gen: kernel launches {launches}, expected {want}")
    losses = [r["train_loss"] for r in records]
    if not all(math.isfinite(x) for x in losses + [r["val_ppl"] for r in records]):
        fail(f"train_gen: a non-finite loss or perplexity in {records}")
    if not losses[-1] < losses[0]:
        fail(f"train_gen: the loss did not fall: epoch means {losses}")

    b0 = epoch_batches(0)[0].to(trainer.device)

    def grads():
        trainer.forward_loss(state, b0, fold_seed(0, 999)).backward()
        return grads_of(state)

    first, second = grads(), grads()
    if not all(torch.equal(first[k], second[k]) for k in first):
        fail("train_gen: two backward passes on one batch gave other gradients")
    del first, second
    cpu = gen_cpu_check(torch, args, cfg, epoch_batches(0)[1])
    split = gen_step_split(torch, trainer, state, train_src, train_tgt, tok)
    bf16 = gen_bf16_steps(torch, args, cfg, epoch_batches(0)[:2])
    emit({"phase": "train_gen", "ok": True, "params": sum(p.numel() for p in
                                                          state.model.parameters()),
          "init_seconds": init_s, "steps": steps, "epochs": GEN_EPOCHS,
          "batch": [rows, GEN_SRC, GEN_TGT], "vocab": GEN_VOCAB, "dtype": enc.dtype,
          "dropout": enc.dropout_rate, "remat": enc.remat_policy,
          "optim": dataclasses.asdict(cfg.train.optim), "epoch_train_loss": losses,
          "epoch_val_ppl": [r["val_ppl"] for r in records],
          "epoch_seconds": [r["epoch_seconds"] for r in records], "fit_seconds": fit_s,
          "last_epoch_target_tokens_per_sec": records[-1]["train_target_tokens_per_sec"],
          "kernel_launches": launches,
          "launches_per_step": {"flash_fwd": 6 * L, "flash_dq": 3 * L, "flash_dkv": 3 * L,
                                "flash_dbias": 2 * L},
          "eval_launches_per_dev_batch": {"flash_fwd": 3 * L},
          "grads_bit_equal": True, **cpu, **split, "bf16": bf16})
    return launches, trainer, state, tok, src, tgt


def gen_cpu_check(torch, args, cfg, batch) -> dict:
    """A 2+2-layer GenTrainer of the same width (fp32, dropout 0), the
    same weights on the card and on the CPU plain path: two steps on one
    batch, losses within GEN_TRAIN_LOSS_TOL, step-1 gradients within
    GEN_TRAIN_GRAD_TOL of each leaf's scale."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.models import GenConfig
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    _, enc = cli._gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=dataclasses.replace(enc, num_layers=2, dropout_rate=0.0),
                     max_target_length=args.max_target_length, beam_size=args.beam_size)
    runs = {name: GenTrainer(cfg, gcfg, total_steps=2, device=dev)
            for name, dev in (("card", CARD), ("cpu", "cpu"))}
    states = {name: tr.init_state(seed=0) for name, tr in runs.items()}
    pairs, t0 = [], time.perf_counter()
    for i in range(2):
        step = {}
        for name, tr in runs.items():
            loss = tr.forward_loss(states[name], batch.to(tr.device), None)
            loss.backward()
            step[name] = (loss.item(), {k: g.cpu() for k, g in grads_of(states[name]).items()})
            states[name].apply_gradients()
        pairs.append((step["card"][0], step["cpu"][0]))
        if i == 0:
            errs = leaf_errors(step["card"][1], step["cpu"][1])
            grad_err = max(errs.values())
            worst_leaf = max(errs, key=errs.get)
    loss_err = max(abs(a - b) for a, b in pairs)
    if loss_err > GEN_TRAIN_LOSS_TOL or grad_err > GEN_TRAIN_GRAD_TOL:
        fail(f"train_gen: 2+2-layer card vs CPU losses {pairs} (abs err {loss_err}), step-1 "
             f"gradient err {grad_err} at {worst_leaf}")
    return {"two_layer_cpu_losses": pairs, "two_layer_cpu_loss_abs_err": loss_err,
            "two_layer_cpu_step1_grad_rel_err": grad_err, "two_layer_worst_leaf": worst_leaf,
            "two_layer_cpu_seconds": time.perf_counter() - t0}


def gen_step_split(torch, trainer, state, src, tgt, tok) -> dict:
    """Median of 8 steps on one full batch, each stage synchronized: host
    collate, copies, forward, backward, optimiser; source and target
    tokens/s (real tokens) and peak memory; one step under
    torch.profiler (device time by kernel group, idle share)."""
    from deepdfa_tpu_torch.data.gen_data import collate_gen
    from deepdfa_tpu_torch.nn.dropout import fold_seed

    split = {k: [] for k in ("host_collate_ms", "to_device_ms", "forward_ms", "backward_ms",
                             "optimizer_ms", "step_ms")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(8):
        t_a = time.perf_counter()
        batch = collate_gen(src[:GEN_ROWS], tgt[:GEN_ROWS], GEN_ROWS, tok.pad_id)
        t_b = time.perf_counter()
        dev = batch.to(trainer.device)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        loss = trainer.forward_loss(state, dev, fold_seed(1, i))
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t_e = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        t_f = time.perf_counter()
        for k, v in zip(split, (t_b - t_a, t_c - t_b, t_d - t_c, t_e - t_d, t_f - t_e,
                                t_f - t_a)):
            split[k].append(1e3 * v)
    med = {k: statistics.median(v) for k, v in split.items()}
    src_tok = int((batch.source_ids != tok.pad_id).sum())
    tgt_tok = int((batch.target_ids != tok.pad_id).sum())
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        trainer.train_step(state, dev, fold_seed(3, 0))
        torch.cuda.synchronize()
        prof.step()
        t_a = time.perf_counter()
        trainer.train_step(state, dev, fold_seed(3, 1))
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    return {"step_source_tokens": src_tok, "step_target_tokens": tgt_tok, **med,
            "source_tokens_per_sec": src_tok / (med["step_ms"] / 1e3),
            "target_tokens_per_sec": tgt_tok / (med["step_ms"] / 1e3),
            "sequences_per_sec": GEN_ROWS / (med["step_ms"] / 1e3),
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
            "profiled_step": {**device_profile(prof, profiled_ms),
                              "device_ms_by_group": device_groups(prof)}}


def gen_bf16_steps(torch, args, cfg, batches) -> dict:
    """A few steps of the same model with bf16 activations (a field of
    the reference's T5Config): the mma instances of the causal kernels
    on a path; launches per step as in fp32, losses finite, median step
    ms."""
    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.models import GenConfig
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    _, enc = cli._gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=dataclasses.replace(enc, dtype="bfloat16"))
    trainer = GenTrainer(cfg, gcfg, total_steps=6, device=CARD)
    state = trainer.init_state(seed=0)
    dev = [b.to(trainer.device) for b in batches]
    times, losses = [], []
    reset_flash(fa)
    for i in range(6):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        losses.append(trainer.train_step(state, dev[i % len(dev)], fold_seed(4, i)).item())
        times.append(1e3 * (time.perf_counter() - t_a))
    launches = flash_counts(fa)
    L = enc.num_layers
    if launches != {"flash_fwd": 6 * 6 * L, "flash_dq": 6 * 3 * L, "flash_dkv": 6 * 3 * L,
                    "flash_dbias": 6 * 2 * L}:
        fail(f"train_gen bf16: kernel launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_gen bf16: a non-finite loss in {losses}")
    del state, trainer
    return {"steps": 6, "losses": losses, "step_ms_median": statistics.median(times[1:]),
            "kernel_launches": launches}


def decode_gen_phase(torch, trainer, state, src, args):
    """Beam-search decoding (beam 5, max length 128) of the trained
    codet5-base-width model through GenTrainer.decode, 2 batches of 16
    sources: sequences/s; the encoder's flash forward 12 times a batch;
    then a 2+2-layer fp32 model on the card and on the CPU plain path:
    each _decode_step's logits within GEN_STEP_LOGIT_TOL of their scale,
    and the beam ids equal where every step's K-th and (K+1)-th
    candidates are more than 1e-4 apart."""
    from deepdfa_tpu_torch import cli
    import numpy as np

    from deepdfa_tpu_torch.models import GenConfig, T5Seq2Seq
    from deepdfa_tpu_torch.models import t5_gen as genm
    from deepdfa_tpu_torch.nn import flash_attention as fa

    n = GEN_ROWS * GEN_DECODE_BATCHES
    reset_flash(fa)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = trainer.decode(state, src[:n])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in flash_counts(fa).items() if v}
    if launches != {"flash_fwd": GEN_DECODE_BATCHES * trainer.gen_cfg.encoder.num_layers}:
        fail(f"decode_gen: kernel launches {launches}")
    lengths = [len(p) for p in preds]

    _, enc = cli._gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=dataclasses.replace(enc, num_layers=2, dropout_rate=0.0))
    models = {name: T5Seq2Seq(gcfg, generator=torch.Generator().manual_seed(5)).to(dev).eval()
              for name, dev in (("card", CARD), ("cpu", "cpu"))}
    small = torch.from_numpy(src[:4].astype(np.int64))
    Tmax, K = args.max_target_length, args.beam_size
    worst = 0.0
    with torch.no_grad():
        caches = {}
        for name, m in models.items():
            s = small.to(m.encoder.word.device)
            eh = m.encoder.encode(s)
            ck, cv = genm._precompute_cross_kv(m, eh)
            z = torch.zeros(2, 4, enc.num_heads, Tmax, enc.head_dim, device=s.device)
            caches[name] = [ck, cv, z, z.clone(), s != enc.pad_token_id]
        tokens = torch.zeros(4, dtype=torch.int64)
        for t in range(Tmax):
            out = {}
            for name, m in models.items():
                ck, cv, kc, vc, em = caches[name]
                out[name], _, _ = genm._decode_step(m, tokens.to(em.device), t, kc, vc, ck, cv,
                                                    em)
            scale = out["cpu"].abs().max().item()
            worst = max(worst, (out["card"].cpu() - out["cpu"]).abs().max().item() / scale)
            tokens = out["cpu"].argmax(-1)
    if worst > GEN_STEP_LOGIT_TOL:
        fail(f"decode_gen: 2+2-layer decode-step logits card vs CPU rel err {worst}")
    gaps, real = [], genm.top_k_stable

    def spy(x, k):
        vals = torch.sort(x, dim=-1, descending=True, stable=True)[0]
        gaps.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return real(x, k)

    genm.top_k_stable = spy
    try:
        ids_card = genm.beam_search(models["card"], small.to(CARD), K, Tmax).cpu()
    finally:
        genm.top_k_stable = real
    ids_cpu = genm.beam_search(models["cpu"], small, K, Tmax)
    margin = min(gaps)
    compared = margin > 1e-4
    if compared and not torch.equal(ids_card, ids_cpu):
        fail(f"decode_gen: 2+2-layer beam ids differ card vs CPU at margin {margin}")
    emit({"phase": "decode_gen", "ok": True, "sources": n, "beam": K, "max_length": Tmax,
          "seconds": seconds, "sequences_per_sec": n / seconds,
          "mean_output_tokens": statistics.mean(lengths), "kernel_launches": launches,
          "two_layer_step_logit_rel_err": worst, "two_layer_steps": Tmax,
          "two_layer_min_topk_margin": margin, "two_layer_ids_compared": compared,
          "two_layer_ids_equal": bool(torch.equal(ids_card, ids_cpu))})
    return launches


def train_clone_phase(torch, rng):
    """`train-clone`'s path on the card at codet5-base width (fp32): the
    reference's clone files (pairs + data.jsonl, written under build/),
    read and tokenized as the CLI does at 256 tokens, CloneTrainer steps
    on 2 batches of 16 pairs (8 steps); every loss finite; per step the
    launches of the gen step (each code is a row of the seq2seq stack)."""
    import numpy as np

    from deepdfa_tpu_torch import cli
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.models import CloneConfig
    from deepdfa_tpu_torch.nn import flash_attention as fa
    from deepdfa_tpu_torch.nn.dropout import fold_seed
    from deepdfa_tpu_torch.train.clone_loop import CloneTrainer, clone_batches_of

    args = gen_args("train-clone")
    cfg = gen_config()
    vocab = [w for w in C_WORDS if w not in ("->", "++")]
    d = ROOT / "build" / "smoke_gen" / "clone"
    d.mkdir(parents=True, exist_ok=True)
    (d / "data.jsonl").write_text("\n".join(json.dumps(
        {"idx": str(i), "func": " ".join(str(w) for w in rng.choice(vocab, int(
            rng.integers(150, 400))))}) for i in range(40)) + "\n")
    (d / "train.txt").write_text("\n".join(f"{i % 40}\t{(7 * i + 3) % 40}\t{i % 2}"
                                          for i in range(32)) + "\n")
    tok, enc = cli._gen_tokenizer_and_encoder(args)
    ex = gen_data.read_clone_examples(str(d / "train.txt"))
    a = tok.batch_encode([f"clone: {e.source}" for e in ex], max_length=args.max_source_length)
    b = tok.batch_encode([f"clone: {e.target}" for e in ex], max_length=args.max_source_length)
    pairs = np.stack([a, b], axis=1).astype(np.int32)
    batches = clone_batches_of(pairs, [e.label for e in ex], 1, args.batch_size,
                               pad_id=tok.pad_id, shuffle_seed=cfg.train.seed)
    trainer = CloneTrainer(cfg, CloneConfig(encoder=enc), total_steps=8, device=CARD)
    state = trainer.init_state()
    losses, times = [], []
    reset_flash(fa)
    for i in range(8):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        losses.append(trainer.train_step(state, batches[i % len(batches)].to(trainer.device),
                                         fold_seed(0, i)).item())
        times.append(1e3 * (time.perf_counter() - t_a))
    launches = flash_counts(fa)
    L = enc.num_layers
    if launches != {"flash_fwd": 8 * 6 * L, "flash_dq": 8 * 3 * L, "flash_dkv": 8 * 3 * L,
                    "flash_dbias": 8 * 2 * L}:
        fail(f"train_clone: kernel launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_clone: a non-finite loss in {losses}")
    from torch.profiler import ProfilerActivity, profile

    batch = batches[0].to(trainer.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        trainer.train_step(state, batch, fold_seed(0, 8))
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t_a)
    metrics, _ = trainer.evaluate(state, batches[:1])
    emit({"phase": "train_clone", "ok": True, "pairs": len(ex), "batch": list(pairs.shape[1:]),
          "rows": args.batch_size, "steps": 8, "losses": losses,
          "step_ms_median": statistics.median(times[1:]), "eval": metrics,
          "kernel_launches": launches,
          "profiled_step": {**device_profile(prof, profiled_ms),
                            "device_ms_by_group": device_groups(prof)}})
    del state, trainer
    return launches


def device_groups(prof) -> dict:
    """Device ms of one profiled window by kernel group: the four flash
    kernels, the GGNN step kernel (with its bf16/int8 table launch), the
    whole-unroll kernel and the two backward kernels (the step group
    holds the bf16/int8 table launch and the int8 mxu pre-pass), matmuls
    (cuBLAS's gemm and Hopper `nvjet` kernels, CUTLASS) and everything
    else; with launch counts."""
    # kernel-name fragments of each group: the flash kernels, the GGNN
    # whole unroll and step, B3 (gru_bwd_*, reduce_splits) and B4 (dmsg_*);
    # kernel 8 with the sum of its cut batch's partials (dbias_reduce)
    names = {"flash_fwd": ("flash_fwd",), "flash_dq": ("flash_dq",),
             "flash_dkv": ("flash_dkv",), "flash_dbias": ("flash_dbias", "dbias_reduce"),
             "ggnn_fused": ("ggnn_fused",),
             "ggnn_step": ("ggnn_step", "msg_table", "mxu_colmax"),
             "ggnn_gru_bwd": ("gru_bwd", "reduce_splits"), "ggnn_dmsg": ("dmsg_",)}
    groups = {name: [0.0, 0] for name in (*names, "matmul", "other")}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if not str(e.device_type).endswith("CUDA") or us <= 0 or getattr(e, "is_user_annotation", False):
            continue
        name = e.key.lower()
        key = next((k for k, frags in names.items() if any(f in name for f in frags)), None) or (
            "matmul" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90_"))
            else "other")
        groups[key][0] += us / 1e3
        groups[key][1] += e.count
    return {k: {"ms": v[0], "calls": v[1]} for k, v in groups.items()}


def kernel_name(mangled: str) -> str:
    """`flash_dq_bf16_mma<64, bias, causal>` from the mangled name of a
    kernel in an anonymous namespace of a csrc file: the width or element
    type, any further int template arguments (the GGNN kernels' message
    policy: `ggnn_fused_kernel<128, 2>` is int8), then the bool template
    flags that are on (the flash kernels' kBias and kCausal; the dbias
    and FMA instances have kCausal only); the mangled name where the
    pattern does not hold."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    base, rest = mangled[start:start + int(m.group(1))], mangled[start + int(m.group(1)):]
    arg = re.match(r"I(?:Li(\d+)E|(f)|(13__nv_bfloat16))((?:Li\d+E)*)((?:Lb[01]E)*)E", rest)
    if not arg:
        return base
    first = arg.group(1) or ("float" if arg.group(2) else "bf16")
    ints = re.findall(r"Li(\d+)E", arg.group(4))
    flags = re.findall(r"Lb([01])E", arg.group(5))
    names = (("mxu",) if base.startswith("ggnn") else
             ("bias", "causal") if len(flags) == 2 else ("causal",))
    return f"{base}<{', '.join([first, *ints, *(n for n, f in zip(names, flags) if f == '1')])}>"


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers", "spill_bytes"}} from nvcc's -Xptxas -v log."""
    out, name, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = kernel_name(m.group(1)), None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = {"registers": int(m.group(1)), "spill_bytes": spill}
            name = None
    return out


#: the phases --phase can run alone
LONE_PHASES = ("train", "train_gen", "train_clone")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", action="append", choices=LONE_PHASES, default=[],
                    help="run only this training phase (repeatable)")
    only = ap.parse_args().phase
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
    for config in (FLAGSHIP_CONFIG, COMBINED_CONFIG):
        if not config.exists():
            fail(f"{config} is missing")
    import numpy as np

    from deepdfa_tpu_torch.nn import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi could not read the card's name and power limit: {e!r}")
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = cuda_build.build()
    ptxas = {name: ptxas_summary(r["log"]) for name, r in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": {
        name: {"cached": r["cached"], "seconds": r["seconds"], "ptxas": ptxas[name]}
        for name, r in built.items()}})

    rng = np.random.default_rng(0)
    if only:
        for name in only:
            globals()[f"{name}_phase"](torch, rng)
        return
    kernel_err, timing = kernel_phase(torch, rng)
    bwd_err, bwd_timing = bwd_kernel_phase(torch, rng)
    launches, model, serve_specs, serve_probs, budgets, max_graphs = serve_phase(torch, rng)
    profile_phase(torch, model, serve_specs[:max_graphs], budgets)
    train_launches = train_phase(torch, rng)
    # kernel 1's bf16/int8 instances, kernel 2 and their paths, on their
    # own seed so the phases after them see the data they always saw
    vrng = np.random.default_rng(7)
    policy_err, policy_timing = policy_kernel_phase(torch, vrng)
    fused_err, fused_timing = fused_kernel_phase(torch, vrng)
    serve_variants, variant_probs = serve_variants_phase(torch, model, serve_specs, serve_probs)
    train_variants = train_variants_phase(torch, vrng)
    # the mxu scatter's instances, their paths and the tune entry point, on
    # their own seed so the phases after them see the data they always saw
    mrng = np.random.default_rng(8)
    mxu_err, mxu_timing = mxu_kernel_phase(torch, mrng)
    fused_mxu_err, fused_mxu_timing = mxu_fused_kernel_phase(torch, mrng)
    serve_mxu = serve_mxu_phase(torch, model, serve_specs, serve_probs,
                                variant_probs["int8", "per_step"])
    train_mxu = train_mxu_phase(torch, mrng)
    tune_paths = tune_phase(torch, mrng)
    flash_err, flash_timing = flash_kernel_phase(torch)
    combined_launches, cmodel, tok, ccfg, cenc = serve_combined_phase(torch, rng)
    profile_combined_phase(torch, cmodel, tok, ccfg, cenc)
    del cmodel
    bwd_flash_err, bwd_flash = flash_bwd_kernel_phase(torch)
    tc_launches = train_combined_phase(torch, rng)
    fb_err, fb = flash_bias_kernel_phase(torch)
    t5_serve, t5_model, t5_tok, t5_cfg, t5_enc = serve_combined_phase(torch, rng, "t5")
    profile_combined_phase(torch, t5_model, t5_tok, t5_cfg, t5_enc, "profile_t5")
    del t5_model
    t5_train = train_combined_phase(torch, rng, "t5")
    causal_err, causal_timing = flash_causal_kernel_phase(torch, {
        "flash_fwd": flash_timing["ms"], "flash_dq": bwd_flash["dq_ms_rate0.0"],
        "flash_dkv": bwd_flash["dkv_ms_rate0.0"]}, {
        "flagship": flash_timing["ms"], "flagship_dropout": flash_timing["dropout"]["ms"],
        "flagship_bias": fb["fwd_ms"]}, {
        "plain": {"flash_dq": bwd_flash["dq_ms_rate0.0"], "flash_dkv": bwd_flash["dkv_ms_rate0.0"]},
        "dropout": {"flash_dq": bwd_flash[f"dq_ms_rate{DROPOUT_RATE}"],
                    "flash_dkv": bwd_flash[f"dkv_ms_rate{DROPOUT_RATE}"]},
        "bias": {"flash_dq": fb["dq_ms"], "flash_dkv": fb["dkv_ms"]}}, ptxas)
    gen_train, gen_trainer, gen_state, _, gen_src, _ = train_gen_phase(torch, rng)
    gen_decode = decode_gen_phase(torch, gen_trainer, gen_state, gen_src, gen_args())
    del gen_trainer, gen_state
    gen_clone = train_clone_phase(torch, rng)
    # each main path's launches, counted from 0 just before it ran
    paths = {"serve": {"ggnn_step": launches}, "train": train_launches,
             "serve_combined": combined_launches, "train_combined": tc_launches,
             "serve_t5": t5_serve, "train_t5": t5_train, "train_gen": gen_train,
             "decode_gen": gen_decode, "train_clone": gen_clone, **serve_variants,
             **train_variants, **serve_mxu, "train_mxu": train_mxu, **tune_paths}
    for path, counts in paths.items():
        idle = [k for k, n in counts.items() if n <= 0 and (k, path) != ("flash_dbias",
                                                                     "train_combined")]
        if idle:
            fail(f"the {path} run launched {idle} no time: {counts}")

    def by_path(kernel: str) -> dict:
        return {path: c[kernel] for path, c in paths.items() if c.get(kernel)}

    def by_call(kernel: str) -> dict:
        """The kernel's times at the causal and the gen path's calls."""
        fwd = kernel == "fwd"
        return {case: {"ms": t[f"{kernel}_ms"],
                       "plain_ms": t["fwd_plain_ms" if fwd else "bwd_plain_ms"],
                       "library_ms": t["fwd_library_ms" if fwd else "bwd_library_ms"],
                       "library_call": t["library_call"], "bound_ms": t[f"{kernel}_bound"][0],
                       "bound_by": t[f"{kernel}_bound"][1], "live_pairs": t["live_pairs"],
                       **{f: t[f] for f in ("shape", "dtype", "causal", "biased")}}
                for case, t in causal_timing.items() if f"{kernel}_ms" in t}

    flash_src = "deepdfa_tpu_torch/csrc/flash_attention.cu"
    # each flash row's ms, plain_ms and library_ms are at dropout 0 without
    # a bias (the library yardstick computes dq, dk and dv in one call);
    # dropout_ms is the kernel at the training path's rate, bias_* the
    # kernel, bound and yardsticks at the T5 call with its [H, T, T] bias
    step_src = "deepdfa_tpu_torch/csrc/ggnn_step.cu"
    fused_row = {k: fused_timing["fp32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    kernels = [
        {"name": "ggnn_step", "source": step_src,
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:555", "max_abs_err": kernel_err,
         **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        *({"name": f"ggnn_step_{accum}", "source": step_src,
           "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:555", "max_abs_err": policy_err[accum],
           **{k: policy_timing[accum][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
          for accum in ("bf16", "int8")),
        # kernel 2's row: fp32 without the chain; by_policy and chain the rest
        {"name": "ggnn_fused", "source": step_src,
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:717", "max_abs_err": fused_err,
         **fused_row, "by_policy": fused_timing,
         "chain": {a: {"ms": t["chain_ms"], "bound_ms": t["chain_bound_ms"]}
                   for a, t in fused_timing.items()}},
        # kernel 1's mxu instances (int8: with its quantizing and pre-pass
        # launches) and kernel 2's, fp32 without the chain; by_policy the rest
        *({"name": MXU_ROWS[accum][1], "source": step_src,
           "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:555", "max_abs_err": mxu_err[accum],
           "library_ms": None, "fold_ms": mxu_timing[accum]["fold_ms"],
           **{k: mxu_timing[accum][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
          for accum in MXU_ROWS),
        {"name": "ggnn_fused_mxu", "source": step_src,
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:717", "max_abs_err": fused_mxu_err,
         **{k: fused_mxu_timing["fp32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "by_policy": fused_mxu_timing,
         "chain": {a: {"ms": t["chain_ms"], "bound_ms": t["chain_bound_ms"]}
                   for a, t in fused_mxu_timing.items()}},
        {"name": "ggnn_gru_bwd", "source": "deepdfa_tpu_torch/csrc/ggnn_bwd.cu",
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:852",
         "max_abs_err": bwd_err["ggnn_gru_bwd"], **bwd_timing["ggnn_gru_bwd"]},
        {"name": "ggnn_dmsg", "source": "deepdfa_tpu_torch/csrc/ggnn_bwd.cu",
         "replaces": "deepdfa_tpu/nn/ggnn_kernel.py:907",
         "max_abs_err": bwd_err["ggnn_dmsg"], **bwd_timing["ggnn_dmsg"]},
        {"name": "flash_fwd", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:427",
         "max_abs_err": max(flash_err, fb_err["fwd"], causal_err["fwd"]),
         **{k: flash_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "dropout_ms": flash_timing["dropout"]["ms"],
         "dropout_library_ms": flash_timing["dropout"]["library_ms"],
         "bias": {"ms": fb["fwd_ms"], "plain_ms": fb["fwd_plain_ms"],
                  "library_ms": fb["fwd_library_ms"], "bound_ms": fb["fwd_bound"][0],
                  "bound_by": fb["fwd_bound"][1]}},
        {"name": "flash_dq", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:495",
         "max_abs_err": max(bwd_flash_err, fb_err["dq"], causal_err["dq"]),
         "ms": bwd_flash["dq_ms_rate0.0"], "plain_ms": bwd_flash["plain_ms"],
         "bound_ms": bwd_flash["dq_bound_ms"], "bound_by": bwd_flash["dq_bound_by"],
         "library_ms": bwd_flash["library_ms"],
         "dropout_ms": bwd_flash[f"dq_ms_rate{DROPOUT_RATE}"],
         "dropout_library_ms": bwd_flash["dropout_library"]["ms"],
         "bias": {"ms": fb["dq_ms"], "plain_ms": fb["bwd_plain_ms"],
                  "library_ms": fb["bwd_library_ms"], "bound_ms": fb["dq_bound"][0],
                  "bound_by": fb["dq_bound"][1]}},
        {"name": "flash_dkv", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:516",
         "max_abs_err": max(bwd_flash_err, fb_err["dkv"], causal_err["dkv"]),
         "ms": bwd_flash["dkv_ms_rate0.0"], "plain_ms": bwd_flash["plain_ms"],
         "bound_ms": bwd_flash["dkv_bound_ms"], "bound_by": bwd_flash["dkv_bound_by"],
         "library_ms": bwd_flash["library_ms"],
         "dropout_ms": bwd_flash[f"dkv_ms_rate{DROPOUT_RATE}"],
         "dropout_library_ms": bwd_flash["dropout_library"]["ms"],
         "bias": {"ms": fb["dkv_ms"], "plain_ms": fb["bwd_plain_ms"],
                  "library_ms": fb["bwd_library_ms"], "bound_ms": fb["dkv_bound"][0],
                  "bound_by": fb["dkv_bound"][1]}},
        # kernel 8 exists only with a bias: its row is the T5 call's
        {"name": "flash_dbias", "source": flash_src,
         "replaces": "deepdfa_tpu/nn/flash_attention.py:559",
         "max_abs_err": max(fb_err["dbias"], causal_err["dbias"]),
         "ms": fb["dbias_ms"], "plain_ms": fb["bwd_plain_ms"], "bound_ms": fb["dbias_bound"][0],
         "bound_by": fb["dbias_bound"][1], "library_ms": fb["bwd_library_ms"],
         "dropout_ms": fb["dbias_dropout_ms"],
         "dropout_library_ms": fb["dbias_dropout_library"]["ms"]},
    ]
    for k in kernels:
        k["launches_by_path"] = by_path(k["name"])
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"].startswith("flash_"):
            k["by_call"] = by_call(k["name"][len("flash_"):])
    emit({"kernels": [{"name": k["name"], "route": "cuda", "source": k["source"],
                       "replaces": k["replaces"], "launches": k["launches"],
                       "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                       "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                       "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
                       "launches_by_path": k["launches_by_path"],
                       **({"dropout_ms": k["dropout_ms"], "dropout_rate": DROPOUT_RATE}
                          if "dropout_ms" in k else {}),
                       **({"dropout_library_ms": k["dropout_library_ms"]}
                          if "dropout_library_ms" in k else {}),
                       **({f"bias_{f}": v for f, v in k["bias"].items()} if "bias" in k else {}),
                       **({"by_call": k["by_call"]} if "by_call" in k else {}),
                       **({f: k[f] for f in ("by_policy", "chain", "fold_ms") if f in k})}
                      for k in kernels]})
    times = [k[f] for k in kernels for f in ("ms", "plain_ms", "bound_ms")]
    times += [k["bias"][f] for k in kernels if "bias" in k for f in ("ms", "plain_ms", "bound_ms")]
    times += [c[f] for k in kernels for c in k.get("by_call", {}).values()
              for f in ("ms", "plain_ms", "library_ms", "bound_ms")]
    times += [c[f] for k in kernels for c in k.get("by_policy", {}).values()
              for f in ("ms", "chain_ms", "step_launches_ms", "plain_ms", "bound_ms")]
    if not all(math.isfinite(t) for t in times):
        fail("a kernel time is not finite")
    if not all(k["launches"] > 0 for k in kernels):
        fail(f"a kernel launched no time on the main paths: "
             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
