"""Scoring drive: a started DynamicBatcher over a GgnnExecutor (the
reference's `deepdfa_tpu/serve/driver.py:run_score`, from graphs
instead of C sources — the frontend comes with a later slice).

`score_graphs` warms the executor's ladder, submits every spec to the
online batcher, waits for every answer and reports the summary the
reference's `run_score` reports where it applies, plus the number of
GGNN step kernel launches the scoring made (n_steps per batch on a
CUDA device, 0 on the CPU).
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from deepdfa_tpu_torch.core.config import Config, serve_budgets
from deepdfa_tpu_torch.graphs.batch import GraphSpec
from deepdfa_tpu_torch.nn import ggnn_kernel
from deepdfa_tpu_torch.serve.batcher import (
    DynamicBatcher,
    GgnnExecutor,
    QueueFull,
    RequestTooLarge,
    ScoreRequest,
    percentile,
)


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
    if cfg.serve.pipeline_depth:
        raise NotImplementedError(
            "serve.pipeline_depth > 0: the pipelined batcher comes with a "
            "later slice of the port; use 0 (serial)"
        )
    node_budget, edge_budget = serve_budgets(cfg)
    executor = GgnnExecutor(
        model, node_budget, edge_budget, cfg.serve.max_batch_graphs,
        etypes=cfg.model.n_etypes > 1, device=device,
    )
    warmup = executor.warmup()
    batcher = DynamicBatcher(
        executor, queue_limit=cfg.serve.queue_limit,
        max_batch_delay_s=cfg.serve.max_batch_delay_ms / 1e3,
    )
    batcher.start()
    try:
        launches0 = ggnn_kernel.LAUNCHES
        t0 = time.perf_counter()
        reqs: list[ScoreRequest] = []
        for spec in specs:
            while True:
                try:
                    reqs.append(batcher.submit(spec))
                    break
                except QueueFull:
                    # backpressure: wait for the oldest answer, then retry
                    next(r for r in reqs if not r.done).wait(timeout_s)
                except RequestTooLarge as e:
                    req = ScoreRequest(spec)
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
        launches = ggnn_kernel.LAUNCHES - launches0
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
        "ggnn_step_launches": launches,
        "probs": probs,
    }
