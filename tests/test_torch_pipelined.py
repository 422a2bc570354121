"""The pipelined batcher and localizer drive (serve.pipeline_depth > 0)
on the CPU, against the serial path and the reference's accounting.

The targets are the reference's tests/test_serve.py
`test_pipelined_bit_identical_any_interleaving`,
`test_pipelined_inflight_never_exceeds_depth` and
`test_pipelined_dispatch_error_isolated`, and tests/test_scan.py
`test_localizer_pipelined_matches_serial`: at every depth the scores
and attributions are the serial path's bits (the same chunks run the
same program; only the sync point moves), dispatched-but-unsynced
batches never exceed the depth in either drive, and a failed dispatch
fails its own requests only. `DeviceWindow` is held to the reference's
busy/idle attribution on the same windows. The card's half (pinned
buffers, events) is in tests/test_torch_cuda.py."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.serve.batcher import DeviceWindow as RefDeviceWindow  # noqa: E402
from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.serve.batcher import (  # noqa: E402
    DeviceWindow,
    DynamicBatcher,
    GgnnExecutor,
)
from deepdfa_tpu_torch.serve.frontend import RequestPreprocessor  # noqa: E402
from deepdfa_tpu_torch.serve.localize import GgnnLocalizer  # noqa: E402

INPUT_DIM = 52
NODE_BUDGET, EDGE_BUDGET = 256, 1024


def _spec(rng, gid):
    n = int(rng.integers(1, 40))
    e = int(rng.integers(0, 2 * n))
    return GraphSpec(
        graph_id=gid,
        node_feats=rng.integers(0, INPUT_DIM, (n, 4)).astype(np.int32),
        node_vuln=np.zeros((n,), np.int32),
        edge_src=rng.integers(0, n, (e,)).astype(np.int32),
        edge_dst=rng.integers(0, n, (e,)).astype(np.int32),
        label=0.0,
    )


def _executor(max_batch=4):
    model = DeepDFA(INPUT_DIM, 8, 2, generator=torch.Generator().manual_seed(0))
    ex = GgnnExecutor(model, NODE_BUDGET, EDGE_BUDGET, max_batch, device="cpu")
    ex.warmup()
    return ex


SPECS = [_spec(np.random.default_rng(1), i) for i in range(13)]


def test_pipelined_bit_identical_any_interleaving():
    """With pipeline_depth 1 and 2, every request's score equals the
    serial path's exactly under shuffled request orders, and the fetch
    side attributed every request."""
    executor = _executor()
    rng = np.random.default_rng(7)
    # no flush timer: groups run when full and the tail at the drain, so
    # both drives form the same batches however slow the host is
    still = dict(queue_limit=64, max_batch_delay_s=3600.0)
    for round_ in range(4):
        order = rng.permutation(len(SPECS))
        serial = DynamicBatcher(executor, **still).score_all([SPECS[i] for i in order])
        for depth in (1, 2):
            piped = DynamicBatcher(executor, pipeline_depth=depth, **still)
            preqs = piped.score_all([SPECS[i] for i in order])
            piped.close()
            assert [r.result for r in preqs] == [r.result for r in serial], (round_, depth)
            assert all(r.device_s is not None and r.device_s >= 0 for r in preqs)
            assert all(r.queue_wait_s is not None for r in preqs)


class _InflightProbe:
    """Executor wrapper counting dispatched-but-unsynced batches."""

    def __init__(self, inner):
        self._inner = inner
        self.now = 0
        self.peak = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def dispatch(self, key, packed):
        self.now += 1
        self.peak = max(self.peak, self.now)
        return self._inner.dispatch(key, packed)

    def fetch(self, handle, n):
        time.sleep(0.005)  # a slow sync gives the dispatcher every chance to race
        out = self._inner.fetch(handle, n)
        self.now -= 1
        return out


def test_pipelined_inflight_never_exceeds_depth():
    """Backpressure: in both drives the in-flight batches never exceed
    the depth, the window fills, and the counts drain to zero."""
    executor = _executor(max_batch=2)
    depth = 2
    probe = _InflightProbe(executor)
    batcher = DynamicBatcher(probe, queue_limit=64, pipeline_depth=depth)
    reqs = batcher.score_all(list(SPECS))
    assert all(r.error is None for r in reqs)
    assert probe.peak == depth == batcher.stats()["pipeline_in_flight_peak"]
    stats = batcher.stats()
    assert stats["queue_depth"] == 0 and stats["pipeline_in_flight"] == 0
    assert stats["pipeline_overlap_seconds"] > 0 and stats["batches"] == 7
    batcher.close()

    probe = _InflightProbe(executor)
    batcher = DynamicBatcher(probe, queue_limit=64, max_batch_delay_s=0.002,
                             pipeline_depth=depth)
    batcher.start()
    try:
        probs = [r.wait(timeout=30.0) for r in [batcher.submit(s) for s in SPECS]]
        assert all(0.0 <= p <= 1.0 for p in probs)
        assert probe.peak <= depth
        assert batcher.stats()["queue_depth"] == 0
    finally:
        batcher.close()
    assert batcher.stats()["pipeline_in_flight"] == 0
    assert batcher._fetch_thread is None


def test_pipelined_dispatch_error_isolated():
    """A batch whose dispatch dies fails only its own requests, frees its
    in-flight slot, and the batcher serves on."""
    executor = _executor(max_batch=2)

    class Flaky:
        def __init__(self):
            self.calls = 0

        def __getattr__(self, name):
            return getattr(executor, name)

        def dispatch(self, key, packed):
            self.calls += 1
            if self.calls == 2:
                raise RuntimeError("injected dispatch failure")
            return executor.dispatch(key, packed)

    batcher = DynamicBatcher(Flaky(), queue_limit=64, pipeline_depth=2)
    reqs = batcher.score_all(SPECS[:6])
    failed = [r for r in reqs if r.error is not None]
    assert len(failed) == 2 and all("injected" in str(r.error) for r in failed)
    assert all(r.result is not None for r in reqs if r.error is None)
    assert batcher.stats()["pipeline_in_flight"] == 0
    again = batcher.score_all(SPECS[:2])
    assert all(r.error is None for r in again)


def test_device_window_is_the_reference():
    """The FIFO-union busy/idle attribution over overlapping and gapped
    windows, step for step the reference's."""
    rng = np.random.default_rng(3)
    t = 0.0
    windows = []
    for _ in range(40):
        t += float(rng.uniform(0, 2))
        windows.append((t, t + float(rng.uniform(0, 5))))
    got, want = DeviceWindow(), RefDeviceWindow()
    assert got.idle_fraction() is None
    for a, b in windows:
        assert got.observe(a, b) == want.observe(a, b)
    assert (got.busy_s, got.idle_s, got.last_sync) == (want.busy_s, want.idle_s, want.last_sync)
    assert got.idle_fraction() == want.idle_fraction()


def test_localizer_pipelined_matches_serial():
    """The pipelined `attribute_all` returns exactly what the serial
    drive returns over the same greedy chunking, for a plain and a
    path method."""
    cfg = config_mod.apply_overrides(config_mod.Config(), [
        'data.feat={"limit_all": 50, "limit_subkeys": 50}', "model.hidden_dim=8",
        "model.n_steps=2"])
    examples = synthetic.to_examples(synthetic.generate(12, seed=5))
    _, vocabs = pipeline.build_dataset(examples, train_ids=range(12), limit_all=50,
                                       limit_subkeys=50)
    model = DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim)
    model.reset_parameters(torch.Generator().manual_seed(2))
    pre = RequestPreprocessor(cfg, vocabs)
    feats = [pre.features_full(e.code) for e in examples]
    for method in ("saliency", "lig"):
        kw = dict(node_budget=512, edge_budget=2048, sizes=(1, 2, 4), method=method,
                  n_steps=2, top_k=0, device="cpu")
        serial = GgnnLocalizer(model, **kw)
        piped = GgnnLocalizer(model, pipeline_depth=2, **kw)
        want = serial.attribute_all(feats)
        assert piped.attribute_all(feats) == want
        assert piped.stats()["batches"] == serial.stats()["batches"] > 2
        assert piped.stats()["device_idle_fraction"] is not None


def test_pipelined_online_drive_under_thread_stress():
    """More submitting threads than cores, with a shortened switch
    interval: every request of a started depth-2 batcher resolves within
    fp32 tolerance of its serial score (batches form by arrival), none is
    lost or counted twice, and the in-flight window drains."""
    import os
    import sys

    executor = _executor(max_batch=4)
    want = {s.graph_id: r.result for s, r in
            zip(SPECS, DynamicBatcher(executor, queue_limit=64).score_all(SPECS))}
    batcher = DynamicBatcher(executor, queue_limit=1024, max_batch_delay_s=0.001,
                             pipeline_depth=2)
    n_threads = 2 * (os.cpu_count() or 4)
    got: dict = {}
    lock = threading.Lock()

    def client(k):
        for rep in range(3):
            for s in SPECS[k % len(SPECS)::3]:
                p = batcher.submit(s).wait(timeout=60)
                with lock:
                    got.setdefault(s.graph_id, []).append(p)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        batcher.start()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
        batcher.close()
    n = sum(len(v) for v in got.values())
    assert n == sum(3 * len(SPECS[k % len(SPECS)::3]) for k in range(n_threads))
    stats = batcher.stats()
    assert stats["pipeline_in_flight"] == 0 and stats["queue_depth"] == 0
    assert 1 <= stats["pipeline_in_flight_peak"] <= 2
    assert stats["batch_occupancy_mean"] * stats["batches"] * 4 == pytest.approx(n)
    for gid, ps in got.items():
        np.testing.assert_allclose(ps, [want[gid]] * len(ps), rtol=1e-5, atol=1e-6)


def test_quantized_model_serializes_concurrent_calls():
    """A QuantizedModel swaps its skeleton's weights while it runs; calls
    from many threads at once (a short switch interval) give the serial
    call's bits every time."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from deepdfa_tpu_torch.graphs import pack
    from deepdfa_tpu_torch.serve import quant

    model = DeepDFA(INPUT_DIM, 8, 2, generator=torch.Generator().manual_seed(4)).eval()
    served = quant.QuantizedModel(DeepDFA(INPUT_DIM, 8, 2),
                                  quant.quantize_params(model.state_dict()))
    batch = pack(SPECS[:4], 4, NODE_BUDGET, EDGE_BUDGET).to("cpu")
    with torch.inference_mode():
        want = served(batch)

    def call(_):
        with torch.inference_mode():
            return served(batch)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            outs = list(pool.map(call, range(64)))
    finally:
        sys.setswitchinterval(saved)
    assert all(torch.equal(o, want) for o in outs)
