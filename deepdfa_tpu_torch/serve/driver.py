"""Scoring drives: a started DynamicBatcher over an executor (the
reference's `deepdfa_tpu/serve/driver.py:run_score`, from graphs and
token ids; scoring C sources through the port's frontend, `cli score`
and `cli serve` are ROADMAP queue A, item 3(b)).

`score_graphs` (a `GgnnExecutor` over the DeepDFA GGNN) and
`score_combined` (a `CombinedExecutor` over the DeepDFA+LineVul model or
the CodeT5+DeepDFA defect model)
warm the executor, submit every payload to the online batcher, wait for
every answer and report the summary the reference's `run_score` reports
where it applies, plus the kernel launches the scoring made: the GGNN
step kernel's under each message policy and scatter (n_steps per batch
on a CUDA device, 0 on the CPU), the whole-unroll kernel's under each
scatter (one per batch under `model.ggnn_kernel_unroll=fused`), the
fused unrolls that fell back to per step and, for the combined model,
the flash-attention kernel's (one per encoder layer per batch).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import Config, serve_budgets
from deepdfa_tpu_torch.graphs.batch import GraphSpec
from deepdfa_tpu_torch.nn import flash_attention, ggnn_kernel
from deepdfa_tpu_torch.serve.batcher import (
    CombinedExecutor,
    DynamicBatcher,
    GgnnExecutor,
    QueueFull,
    RequestTooLarge,
    ScoreRequest,
    percentile,
)


def _check_serial(cfg: Config) -> None:
    if cfg.serve.pipeline_depth:
        raise NotImplementedError(
            "serve.pipeline_depth > 0: the pipelined batcher comes with a "
            "later slice of the port; use 0 (serial)"
        )


#: score summary key of each GGNN counter (nn/ggnn_kernel.py)
SUMMARY_KEYS = {
    "LAUNCHES": "ggnn_step_launches", "BF16_LAUNCHES": "ggnn_step_bf16_launches",
    "INT8_LAUNCHES": "ggnn_step_int8_launches", "MXU_LAUNCHES": "ggnn_step_mxu_launches",
    "MXU_BF16_LAUNCHES": "ggnn_step_mxu_bf16_launches",
    "MXU_INT8_LAUNCHES": "ggnn_step_mxu_int8_launches",
    "FUSED_LAUNCHES": "ggnn_fused_launches", "FUSED_MXU_LAUNCHES": "ggnn_fused_mxu_launches",
    "FUSED_FALLBACKS": "ggnn_fused_fallbacks",
}


def _launch_counts() -> dict[str, int]:
    gk = ggnn_kernel.launch_counts()
    return {**{key: gk[name] for name, key in SUMMARY_KEYS.items()},
            "flash_fwd_launches": flash_attention.LAUNCHES}


def _serve_online(executor, payloads: Sequence, cfg: Config, timeout_s: float) -> dict:
    """Warm `executor`, score `payloads` through a started
    DynamicBatcher and summarise the run."""
    warmup = executor.warmup()
    batcher = DynamicBatcher(
        executor, queue_limit=cfg.serve.queue_limit,
        max_batch_delay_s=cfg.serve.max_batch_delay_ms / 1e3,
    )
    batcher.start()
    try:
        launches0 = _launch_counts()
        t0 = time.perf_counter()
        reqs: list[ScoreRequest] = []
        for payload in payloads:
            while True:
                try:
                    reqs.append(batcher.submit(payload))
                    break
                except QueueFull:
                    # backpressure: wait for the oldest answer, then retry
                    next(r for r in reqs if not r.done).wait(timeout_s)
                except RequestTooLarge as e:
                    req = ScoreRequest(payload)
                    req.set_error(e)
                    reqs.append(req)
                    break
        probs: list[float | None] = []
        for r in reqs:
            try:
                probs.append(r.wait(timeout_s))
            except Exception as e:
                if e is not r.error:  # a timeout, not a failed request
                    raise
                probs.append(None)
        dt = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
    finally:
        batcher.close()

    ok = sum(p is not None for p in probs)
    lat = sorted(batcher.recent_latencies)

    def pct_ms(p):
        v = percentile(lat, p)
        return None if v is None else 1e3 * v

    return {
        "device": str(executor.device),
        "serve_scored": ok,
        "serve_failed_requests": len(reqs) - ok,
        "serve_seconds": dt,
        "serve_requests_per_sec": ok / dt if dt else None,
        "serve_latency_p50_ms": pct_ms(0.50),
        "serve_latency_p99_ms": pct_ms(0.99),
        "serve_batch_occupancy_mean": batcher.mean_occupancy(),
        "serve_batches": batcher.batches_run,
        "serve_warmup_seconds": warmup,
        **launches,
        "probs": probs,
    }


def score_graphs(
    model: torch.nn.Module,
    specs: Sequence[GraphSpec],
    cfg: Config,
    device: str | torch.device | None = "cuda",
    timeout_s: float = 600.0,
) -> dict:
    """Score `specs` through the online serving path; the summary
    record, with per-request probabilities under "probs" (None for a
    failed request)."""
    _check_serial(cfg)
    node_budget, edge_budget = serve_budgets(cfg)
    executor = GgnnExecutor(
        model, node_budget, edge_budget, cfg.serve.max_batch_graphs,
        etypes=cfg.model.n_etypes > 1, device=device,
    )
    return _serve_online(executor, specs, cfg, timeout_s)


def score_combined(
    model: torch.nn.Module,
    payloads: Sequence,
    cfg: Config,
    tokenizer,
    device: str | torch.device | None = "cuda",
    timeout_s: float = 600.0,
) -> dict:
    """Score (text, GraphSpec | None) payloads with a `CombinedModel` or
    a `DefectModel` through the online serving path; the summary record, with P(class 1)
    per request under "probs" (None for a failed request) and the
    launches of both kernels.

    `text` is a source string, which `tokenizer` encodes at the largest
    bucket edge, or token ids already framed and right-padded with the
    tokenizer's pad id. Buckets and budgets: `data.seq_buckets`,
    `data.token_budget`, and `serve.node_budget`/`edge_budget` (else
    `data.batch.*`)."""
    _check_serial(cfg)
    node_budget, edge_budget = serve_budgets(cfg)
    executor = CombinedExecutor(
        model, tokenizer, cfg.data.seq_buckets, cfg.data.token_budget,
        node_budget, edge_budget, device=device,
    )
    max_length = executor.buckets[-1]
    t0 = time.perf_counter()
    encoded = [
        (tokenizer.encode(text, max_length) if isinstance(text, str)
         else np.asarray(text, np.int32), spec)
        for text, spec in payloads
    ]
    tokenize_s = time.perf_counter() - t0
    summary = _serve_online(executor, encoded, cfg, timeout_s)
    summary["buckets"] = [list(sig) for sig in executor.signatures()]
    # tokenizing precedes the batcher's window: serve_seconds and the
    # latencies leave it out, this counts it
    summary["serve_tokenize_seconds"] = tokenize_s
    return summary
