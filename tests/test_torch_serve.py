"""The port's serving path (deepdfa_tpu_torch/serve/) on device="cpu":
the dynamic batcher and the ladder executor against the model's direct
forward, ladder rungs against the reference executor's, admission
control, and the CUDA default of the entry points.

Tolerance for batched-vs-direct probabilities: fp32 rtol 1e-5,
atol 1e-5 — co-batching changes which padded rows share a matmul, and
with it the summation blocking, but nothing else."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.serve import batcher as jbatcher  # noqa: E402
from deepdfa_tpu_torch.core.config import Config, ServeConfig  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec, pack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.serve import (  # noqa: E402
    DynamicBatcher,
    GgnnExecutor,
    QueueFull,
    RequestTooLarge,
    score_graphs,
)
from deepdfa_tpu_torch.serve.batcher import _pow2_sizes  # noqa: E402

RTOL = ATOL = 1e-5
INPUT_DIM = 52
NODE_BUDGET, EDGE_BUDGET = 256, 1024


def _spec(rng, gid, n=None):
    n = int(rng.integers(1, 40)) if n is None else n
    e = int(rng.integers(0, 2 * n))
    return GraphSpec(
        graph_id=gid,
        node_feats=rng.integers(0, INPUT_DIM, (n, 4)).astype(np.int32),
        node_vuln=np.zeros((n,), np.int32),
        edge_src=rng.integers(0, n, (e,)).astype(np.int32),
        edge_dst=rng.integers(0, n, (e,)).astype(np.int32),
        label=0.0,
    )


def _model():
    return DeepDFA(INPUT_DIM, 8, 2, generator=torch.Generator().manual_seed(0))


def _direct(model, spec):
    with torch.inference_mode():
        logits = model(pack([spec], 1, NODE_BUDGET, EDGE_BUDGET).to("cpu"))
    return float(torch.sigmoid(logits)[0])


def _executor(max_batch_graphs=4):
    return GgnnExecutor(_model(), NODE_BUDGET, EDGE_BUDGET, max_batch_graphs, device="cpu")


@pytest.mark.parametrize("drive", ["online", "offline"])
def test_batched_scores_equal_direct_forward(drive):
    rng = np.random.default_rng(5)
    specs = [_spec(rng, i) for i in range(11)]
    ex = _executor()
    assert ex.warmup().keys() == {"G1", "G2", "G4"}
    b = DynamicBatcher(ex, queue_limit=64, max_batch_delay_s=0.005)
    if drive == "online":
        b.start()
        try:
            reqs = [b.submit(s) for s in specs]
            got = [r.wait(60) for r in reqs]
        finally:
            b.close()
    else:
        reqs = b.score_all(specs)
        got = [r.wait(0) for r in reqs]
    want = [_direct(ex.model, s) for s in specs]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert b.batches_run >= 3  # 11 requests, 4 per batch at most
    assert all(r.batch_size <= 4 and r.latency_s >= 0 for r in reqs)
    occ = b.mean_occupancy()
    assert 0 < occ <= 1


def test_ladder_and_budgets_match_reference_executor():
    rng = np.random.default_rng(2)
    for cap in (1, 3, 4, 16):
        assert _pow2_sizes(cap) == jbatcher._pow2_sizes(cap)
    port = _executor(max_batch_graphs=16)
    ref = jbatcher.GgnnExecutor(None, lambda: None, NODE_BUDGET, EDGE_BUDGET, 16)
    assert port.sizes == ref.sizes
    for n in range(1, 17):
        assert port._size_for(n) == ref._size_for(n)
    for _ in range(40):
        chunk = [_spec(rng, i, n=int(rng.integers(1, 120))) for i in range(int(rng.integers(0, 4)))]
        spec = _spec(rng, 99, n=int(rng.integers(1, 120)))
        assert port.fits("graph", chunk, spec) == ref.fits("graph", chunk, spec)
    assert port.pack_chunk("graph", [_spec(rng, 0)] * 3)[0] == "G4"


def test_oversized_request_is_refused():
    rng = np.random.default_rng(3)
    ex = _executor()
    big = _spec(rng, 0, n=NODE_BUDGET + 1)
    b = DynamicBatcher(ex)
    with pytest.raises(RequestTooLarge, match="serving budgets"):
        b.submit(big)
    reqs = b.score_all([_spec(rng, 1), big])
    assert reqs[0].wait(0) > 0
    with pytest.raises(RequestTooLarge):
        reqs[1].wait(0)


def test_full_queue_is_refused():
    rng = np.random.default_rng(4)
    b = DynamicBatcher(_executor(), queue_limit=2)
    queued = [b.submit(_spec(rng, 0)), b.submit(_spec(rng, 1))]
    with pytest.raises(QueueFull):
        b.submit(_spec(rng, 2))
    assert b.rejected == 1
    b.drain()
    assert all(r.done for r in queued) and b.batches_run == 1
    b.submit(_spec(rng, 2))  # room again once the queue drained


def test_score_graphs_summary_on_cpu():
    rng = np.random.default_rng(6)
    specs = [_spec(rng, i) for i in range(9)] + [_spec(rng, 9, n=NODE_BUDGET + 5)]
    cfg = Config(serve=ServeConfig(
        max_batch_graphs=4, node_budget=NODE_BUDGET, edge_budget=EDGE_BUDGET,
        max_batch_delay_ms=5.0,
    ))
    model = _model()
    summary = score_graphs(model, specs, cfg, device="cpu")
    assert summary["device"] == "cpu"
    assert summary["serve_scored"] == 9 and summary["serve_failed_requests"] == 1
    assert summary["probs"][-1] is None
    want = [_direct(model, s) for s in specs[:9]]
    np.testing.assert_allclose(summary["probs"][:9], want, rtol=RTOL, atol=ATOL)
    assert summary["ggnn_step_launches"] == 0  # the CPU runs the plain version
    assert summary["serve_batches"] >= 3
    for key in ("serve_seconds", "serve_requests_per_sec", "serve_latency_p50_ms",
                "serve_latency_p99_ms", "serve_batch_occupancy_mean"):
        assert summary[key] > 0, key
    with pytest.raises(NotImplementedError, match="pipeline_depth"):
        score_graphs(model, specs, dataclasses.replace(
            cfg, serve=dataclasses.replace(cfg.serve, pipeline_depth=2)), device="cpu")


def test_entry_points_default_to_cuda():
    """Without a device argument the executor and the scoring drive ask
    for CUDA; with no card they raise, naming CUDA, instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        GgnnExecutor(_model(), NODE_BUDGET, EDGE_BUDGET)
    with pytest.raises(RuntimeError, match="CUDA"):
        score_graphs(_model(), [], Config())
