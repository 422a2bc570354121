"""Scoring drives (the reference's `deepdfa_tpu/serve/driver.py`).

From C sources: `run_score` is the `cli score` implementation. It
restores a run's checkpoint through the registry, pushes (name, code)
pairs through the online path (frontend -> batcher -> the model on the
card), writes one scores row a source to `scores.jsonl` and a serve
record to `serve_log.jsonl`, and returns the reference's summary
without its two JAX lowering counts, plus the kernel launches the
scoring made. `build_smoke_run` trains a tiny GGNN on seeded synthetic
functions, extracted by the port itself, and leaves the artifacts a real
run leaves (config.json, the vocabulary, `checkpoints-torch/` with a
`best` tag, a directory of `.c` files), so `score --smoke` and
`serve --smoke` restore through the real path; `run_serve_smoke` adds
real HTTP round trips.

From graphs and token ids the caller built: `score_graphs` (a
`GgnnExecutor` over the DeepDFA GGNN) and `score_combined` (a
`CombinedExecutor` over the DeepDFA+LineVul model or the CodeT5+DeepDFA
defect model) warm the executor, submit every payload to the online
batcher and wait for every answer.

Every summary counts the kernel launches of its window: the GGNN step
kernel's under each message policy and scatter (n_steps per batch on a
CUDA device, 0 on the CPU), the whole-unroll kernel's under each scatter
(one per batch under `model.ggnn_kernel_unroll=fused`), the fused
unrolls that fell back to per step and, for the combined models, the
flash-attention kernel's (one per encoder layer per batch).
"""

from __future__ import annotations

import collections
import json
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import Config, serve_budgets
from deepdfa_tpu_torch.frontend.structfeat import feat_width
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


#: score summary key of each GGNN counter (nn/ggnn_kernel.py)
SUMMARY_KEYS = {
    "LAUNCHES": "ggnn_step_launches", "BF16_LAUNCHES": "ggnn_step_bf16_launches",
    "INT8_LAUNCHES": "ggnn_step_int8_launches", "MXU_LAUNCHES": "ggnn_step_mxu_launches",
    "MXU_BF16_LAUNCHES": "ggnn_step_mxu_bf16_launches",
    "MXU_INT8_LAUNCHES": "ggnn_step_mxu_int8_launches",
    "FUSED_LAUNCHES": "ggnn_fused_launches", "FUSED_MXU_LAUNCHES": "ggnn_fused_mxu_launches",
    "FUSED_FALLBACKS": "ggnn_fused_fallbacks",
}


#: the registry's quantized-entry fields a summary carries (`quant`, and
#: the cascade's `stage2_quant`)
QUANT_KEYS = ("quantized", "quant_drift", "quant_drift_bound", "quant_param_bytes_fraction")


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
        pipeline_depth=cfg.serve.pipeline_depth,
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
    node_budget, edge_budget = serve_budgets(cfg)
    executor = GgnnExecutor(
        model, node_budget, edge_budget, cfg.serve.max_batch_graphs,
        etypes=cfg.model.n_etypes > 1, device=device,
        feat_width=feat_width(cfg.model.struct_feats),
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


# -- scoring C sources ---------------------------------------------------------

#: source extensions `cli score` collects from a directory
SOURCE_SUFFIXES = (".c", ".cc", ".cpp", ".cxx", ".h", ".hpp")


def collect_sources(paths_in: Sequence[str]) -> list[tuple[str, str]]:
    """(name, code) pairs from files and/or directories of C sources."""
    out: list[tuple[str, str]] = []
    for p in paths_in:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*")):
                if f.suffix in SOURCE_SUFFIXES and f.is_file():
                    out.append((str(f), f.read_text(errors="replace")))
        elif p.is_file():
            out.append((str(p), p.read_text(errors="replace")))
        else:
            raise SystemExit(f"no such source file/dir: {p}")
    if not out:
        raise SystemExit(f"no source files found under {list(paths_in)} "
                         f"(looked for {SOURCE_SUFFIXES})")
    return out


def build_smoke_run(
    run_name: str = "serve-smoke",
    dataset: str = "serve-smoke",
    n_examples: int = 24,
    max_epochs: int = 2,
    seed: int = 0,
    extra_overrides: Sequence[str] | None = None,
    vuln_rate: float = 0.06,
    device: str | torch.device | None = None,
):
    """Train a tiny GGNN on `device` (None: the card) over seeded
    synthetic functions that the port's frontend extracts, and leave a
    real run behind under the storage root. Returns (cfg, run_dir,
    sources_dir)."""
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import paths
    from deepdfa_tpu_torch.data import pipeline, synthetic
    from deepdfa_tpu_torch.graphs import shard_bucket_batches
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = config_mod.apply_overrides(Config(), [
        f"run_name={json.dumps(run_name)}",
        f"data.dataset={json.dumps(dataset)}",
        'data.feat={"limit_all": 50, "limit_subkeys": 50}',
        f"train.max_epochs={max_epochs}",
        "model.hidden_dim=8", "model.n_steps=2",
        # small serve batches keep the ladder cheap to warm
        "serve.max_batch_graphs=4", "serve.node_budget=2048", "serve.edge_budget=8192",
        *(extra_overrides or []),
    ])
    examples = synthetic.to_examples(synthetic.generate(n_examples, vuln_rate=vuln_rate,
                                                        seed=seed))
    specs, vocabs = pipeline.build_dataset(
        examples, train_ids=range(n_examples), limit_all=cfg.data.feat.limit_all,
        limit_subkeys=cfg.data.feat.limit_subkeys, struct_feats=cfg.data.feat.struct_feats)
    (paths.processed_dir(dataset) / f"vocab{cfg.data.feat.name}.json").write_text(
        json.dumps({k: v.to_json() for k, v in vocabs.items()}))
    run_dir = paths.runs_dir(run_name)
    config_mod.to_json(cfg, run_dir / "config.json")

    def batches(_epoch=0):
        return list(shard_bucket_batches(specs, 8, 2048, 8192, oversized="raise"))

    trainer = GraphTrainer(DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim), cfg,
                           total_steps=len(batches()) * max_epochs, device=device)
    trainer.fit(trainer.init_state(), batches, val_batches=batches,
                checkpoints=trainer.make_checkpoints(run_dir / paths.CHECKPOINTS_DIR))
    sources_dir = run_dir / "smoke_src"
    sources_dir.mkdir(parents=True, exist_ok=True)
    for e in examples:
        (sources_dir / f"fn_{e.id:04d}.c").write_text(e.code)
    return cfg, run_dir, sources_dir


def run_score(
    cfg: Config,
    run_dir,
    sources: Sequence[tuple[str, str]],
    out_path=None,
    family: str = "deepdfa",
    device: str | torch.device | None = None,
) -> dict:
    """Score (name, code) pairs against a run's `serve.checkpoint` on
    `device` (None: the card); the summary, also appended to
    <run_dir>/serve_log.jsonl with the service's counters. In cascade
    mode the summary's `cascade` holds the cascade's counters and the
    rows each stage decided; an `@int8` entry adds `quant` (and a quantized
    stage 2 the cascade's `stage2_quant`): the drift, its bound and the
    bytes fraction. With the efficiency ledger on (`obs.ledger`, inside
    an obs session) the summary carries its snapshot (a site a warmed
    rung) and `ledger_mfu`."""
    from deepdfa_tpu_torch.obs import ledger as obs_ledger
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import ScoringService, score_texts, write_serve_log

    run_dir = Path(run_dir)
    registry = ModelRegistry(run_dir, family=family, checkpoint=cfg.serve.checkpoint, cfg=cfg,
                             device=device)
    service = ScoringService(registry, cfg)
    try:
        launches0 = _launch_counts()
        t0 = time.perf_counter()
        rows = score_texts(service, list(sources))
        dt = time.perf_counter() - t0
        launches = {k: v - launches0[k] for k, v in _launch_counts().items()}
        out_path = Path(out_path) if out_path else run_dir / "scores.jsonl"
        with out_path.open("w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        ok = sum(1 for r in rows if r.get("ok"))
        lat = sorted(service.batcher.recent_latencies)

        def pct_ms(p):
            v = percentile(lat, p)
            return None if v is None else 1e3 * v

        summary = {
            "device": str(registry.device),
            "serve_scored": ok,
            "serve_failed_requests": len(rows) - ok,
            "serve_seconds": dt,
            "serve_requests_per_sec": ok / dt if dt else None,
            "serve_latency_p50_ms": pct_ms(0.50),
            "serve_latency_p99_ms": pct_ms(0.99),
            "serve_batch_occupancy_mean": service.batcher.mean_occupancy(),
            "serve_batches": service.batcher.batches_run,
            **launches,
            "scores_path": str(out_path),
        }
        if registry.quant_mode:
            info = registry.info()
            summary["quant"] = {k: info[k] for k in QUANT_KEYS}
        if service.cascade is not None:
            # which stage decided each scored row, beside the counters
            stages = collections.Counter(r.get("stage") for r in rows if r.get("ok"))
            summary["cascade"] = {**service.cascade.counters(),
                                  "band": list(service.cascade.band),
                                  "temperature": service.cascade.temperature,
                                  "stage1_rows": stages[1], "stage2_rows": stages[2],
                                  "stage2_batches": service.cascade.service.batcher.batches_run}
            stage2 = service.cascade.service.registry
            if stage2.quant_mode:
                info = stage2.info()
                summary["cascade"]["stage2_quant"] = {k: info[k] for k in QUANT_KEYS}
        led = obs_ledger.get()
        if led is not None:
            # one site a warmed rung, its executions, MFU against the card
            summary["ledger"] = led.snapshot()
            summary.update(led.mfu_record())
        write_serve_log(run_dir, [{**summary, "serve": service.stats()}])
        return summary
    finally:
        service.close()


def run_serve_smoke(extra_overrides: Sequence[str] | None = None,
                    device: str | torch.device | None = None) -> dict:
    """`serve --smoke`: a smoke run, then real HTTP round trips on a free
    port: six functions scored, an unparseable one (422), malformed JSON
    and a body without `code` (400), an unknown route (404), `/healthz`
    and `/stats`; then teardown."""
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import BackgroundServer, ScoringService, write_serve_log

    cfg, run_dir, sources_dir = build_smoke_run(
        extra_overrides=["serve.request_log=true", *(extra_overrides or [])], device=device)
    registry = ModelRegistry(run_dir, family="deepdfa", checkpoint=cfg.serve.checkpoint,
                             cfg=cfg, device=device)
    server = BackgroundServer(ScoringService(registry, cfg))
    try:
        scored = [server.request("POST", "/score", {"code": f.read_text()})
                  for f in sorted(sources_dir.glob("*.c"))[:6]]
        reject_status, _ = server.request("POST", "/score", {"code": "not a function @@@"})
        bad_json_status, _ = server.request("POST", "/score", raw=b"{not json")
        no_code_status, _ = server.request("POST", "/score", {"text": "int f() {}"})
        unknown_status, _ = server.request("GET", "/metrics")
        h_status, health = server.request("GET", "/healthz")
        s_status, stats = server.request("GET", "/stats")
        write_serve_log(run_dir, [{"serve": server.service.stats()}])
    finally:
        server.close()
    return {
        "scored": [{"status": st, "prob": r.get("prob"), "request_id": r.get("request_id")}
                   for st, r in scored],
        "reject_status": reject_status,
        "bad_json_status": bad_json_status,
        "no_code_status": no_code_status,
        "unknown_route_status": unknown_status,
        "healthz_status": h_status,
        "healthz": health,
        "stats_status": s_status,
        "stats": stats,
        "run_dir": str(run_dir),
    }
