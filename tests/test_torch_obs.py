"""The port's telemetry (deepdfa_tpu_torch/obs/, core/backend.py,
core/prng.py) on the CPU, held against the reference's
(deepdfa_tpu/obs/): the same declared schema, epoch records whose every
tag the reference's SCHEMA declares, postmortems the reference's
validator accepts, the same span names in a merged trace of the same
run, the ledger's MFU against the card's peaks, the health probe, and
the default path unchanged with every switch off."""

import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from deepdfa_tpu.obs import flight as jflight, metrics as jmetrics  # noqa: E402
from deepdfa_tpu_torch import obs  # noqa: E402
from deepdfa_tpu_torch.core import backend, config as tconfig, prng  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec, shard_bucket_batches  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.obs import cost, flight, health, ledger, metrics, trace, xprof  # noqa: E402
from deepdfa_tpu_torch.testing import faults  # noqa: E402
from deepdfa_tpu_torch.train import GraphTrainer  # noqa: E402
from deepdfa_tpu_torch.train.resilience import ResilientRunner  # noqa: E402

INPUT_DIM = 32
TBATCH = dict(num_graphs=4, node_budget=64, edge_budget=256)


def _kw(n=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for gid in range(n):
        m = int(rng.integers(4, 10))
        feats = rng.integers(2, 20, (m, 4)).astype(np.int32)
        out.append(dict(graph_id=gid, node_feats=feats, node_vuln=np.zeros((m,), np.int32),
                        edge_src=np.arange(m - 1, dtype=np.int32),
                        edge_dst=np.arange(1, m, dtype=np.int32), label=float(gid % 2)))
    return out


def _cfg(*extra):
    return tconfig.apply_overrides(tconfig.Config(), [
        "model.hidden_dim=8", "train.max_epochs=2", "train.log_every_steps=1", *extra])


@pytest.fixture()
def clean_obs():
    """Every process-wide instrument off before and after."""
    for off in (ledger.disable, flight.uninstall, trace.disable, xprof.uninstall_controller):
        off()
    metrics.REGISTRY.reset()
    yield
    for off in (ledger.disable, flight.uninstall, trace.disable, xprof.uninstall_controller):
        off()
    metrics.REGISTRY.reset()


def _fit(cfg, run_dir=None, plan=None, resilience=False):
    specs = [GraphSpec(**k) for k in _kw()]
    trainer = GraphTrainer(DeepDFA.from_config(cfg.model, INPUT_DIM), cfg, device="cpu")
    state = trainer.init_state()
    runner = (ResilientRunner(cfg.train.resilience, run_dir / "step", seed=cfg.train.seed)
              if resilience else None)
    injector = faults.FaultInjector(plan) if plan is not None else None
    records = []

    def stream(epoch):
        b = list(shard_bucket_batches(specs, **TBATCH))
        return injector.wrap(b) if injector is not None else b

    trainer.fit(state, stream, log_fn=records.append, resilience=runner)
    return records, state


# -- the schema -----------------------------------------------------------------


def test_schema_and_flattening_are_the_references():
    assert metrics.SCHEMA == jmetrics.SCHEMA
    from deepdfa_tpu.train.logging import flatten_scalars as jflatten

    rec = {"epoch": 1, "obs": {"step": {"seconds": {"mean": 0.5}}, "x": True},
           "ledger": {"sites": {"train_step/G4": {"flops": 2.0, "name": "s"}}}, "a/b": 3}
    assert metrics.flatten_scalars(rec) == jflatten(rec)


def test_epoch_record_tags_are_declared_in_the_references_schema(tmp_path, clean_obs):
    """A guarded fit with a skipped step, the metrics snapshot, the
    ledger and tracing on: every tag of every record is declared in the
    reference's obs/metrics.py:SCHEMA."""
    cfg = _cfg("obs.metrics=true", "obs.ledger=true", "obs.trace=true", "obs.flight=true",
               "train.resilience.enabled=true", "train.resilience.step_checkpoint_every=2")
    with obs.session(cfg, tmp_path):
        records, _ = _fit(cfg, tmp_path, faults.FaultPlan(nan_at_steps=frozenset({2})),
                          resilience=True)
    epochs = [r for r in records if "epoch" in r]
    assert epochs and all("obs" in r and "ledger" in r for r in epochs)
    assert epochs[-1]["skipped_steps"] == 1
    assert "obs/step/seconds/count" in metrics.flatten_scalars({"obs": epochs[-1]["obs"]})
    assert jmetrics.undeclared_tags(records) == []
    assert metrics.undeclared_tags(records) == []


# -- the flight recorder ----------------------------------------------------------


def test_postmortem_passes_the_references_validator(tmp_path, clean_obs):
    rec = flight.install(tmp_path / "postmortem.json", max_steps=4)
    ledger.enable(peaks={})
    ledger.record_compile("train_step", "G4", {"flops": 10.0, "bytes_accessed": 4.0}, 0.5)
    for s in range(6):
        rec.note_step(s)
    trace.instant("step_skipped", cat="resilience", consecutive=1)
    metrics.REGISTRY.counter("obs/resilience/skipped_steps").inc()
    assert flight.crash_dump("manual", extra={"why": "test"}) == tmp_path / "postmortem.json"
    doc = json.loads((tmp_path / "postmortem.json").read_text())
    for validate in (jflight.validate_postmortem, flight.validate_postmortem):
        out = validate(doc)
        assert out["ok"], out["problems"]
        assert out["trigger"] == "manual" and out["steps"] == 4 and out["events"] == 1
    assert doc["postmortem"]["ledger"]["sites"]["train_step/G4"]["flops"] == 10.0
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    flight.note_exception(oom, where="serve_batch")
    assert json.loads((tmp_path / "postmortem.json").read_text())["postmortem"]["trigger"] \
        == "oom"
    assert ledger.is_oom(oom) and not ledger.is_oom(ValueError("bad"))


# -- the merged trace ---------------------------------------------------------------


def test_merged_trace_span_names_equal_the_references(tmp_path, clean_obs):
    """The same run (graphs, batches, two epochs, prefetch 2, the metrics
    snapshot on) traced through both packages' fit: the merged traces
    name the same spans and instants, in the same categories."""
    import jax

    from deepdfa_tpu.core import Config as JConfig, MeshConfig as JMesh
    from deepdfa_tpu.core import config as jconfig
    from deepdfa_tpu.graphs import GraphSpec as JSpec, shard_bucket_batches as jbatches
    from deepdfa_tpu.models import DeepDFA as JDeepDFA
    from deepdfa_tpu.obs import trace as jtrace
    from deepdfa_tpu.parallel import make_mesh
    from deepdfa_tpu.train import GraphTrainer as JTrainer

    over = ["model.hidden_dim=8", "train.max_epochs=2", "train.prefetch_batches=2",
            "obs.metrics=true"]
    names = {}
    jcfg = jconfig.apply_overrides(JConfig(), over)
    jb = list(jbatches([JSpec(**k) for k in _kw()], num_shards=1, **TBATCH))
    jtrainer = JTrainer(JDeepDFA.from_config(jcfg.model, input_dim=INPUT_DIM), jcfg,
                        mesh=make_mesh(JMesh(dp=1), devices=jax.devices()[:1]))
    jtrace.enable(tmp_path / "ref")
    try:
        jtrainer.fit(jtrainer.init_state(jb[0]), lambda e: list(jb))
    finally:
        jtrace.disable()
    cfg = _cfg(*over)
    trace.enable(tmp_path / "port")
    try:
        _fit(cfg)
    finally:
        trace.disable()
    for name, mod in (("ref", jtrace), ("port", trace)):
        names[name] = {(e["name"], e.get("cat")) for e in mod.merge(tmp_path / name)
                       if e.get("ph") != "M"}
    assert names["port"] == names["ref"]
    assert {("train_step", "train"), ("step_device", "train"), ("wait", "input")} <= names["port"]
    out = tmp_path / "trace.json"
    assert trace.write_chrome_trace(tmp_path / "port", out) > 0
    assert json.loads(out.read_text())["traceEvents"]


# -- xprof, the step timer ------------------------------------------------------------


def test_step_timer_and_xprof_window_on_the_cpu(tmp_path, clean_obs):
    reg = metrics.MetricsRegistry()
    seen = []
    timer = xprof.StepTimer(lag=1, registry=reg, cuda=False,
                            on_step_seconds=lambda s, site=None: seen.append((s, site)))
    for k in range(3):
        timer.begin()
        time.sleep(0.002)
        timer.dispatched(None, 0.001, site=("train_step", f"G{k}"))
    assert len(seen) == 2  # one pending, read at drain
    timer.drain()
    assert [site for _, site in seen] == [("train_step", "G0"), ("train_step", "G1"),
                                          ("train_step", "G2")]
    assert all(s >= 0.002 for s, _ in seen)
    assert reg.snapshot()["obs/step/seconds/count"] == 3
    ctl = xprof.install_controller(tmp_path / "xprof", start_step=1, num_steps=2, trigger=False)
    for step in range(5):
        ctl.on_step(step)
        torch.ones(8) @ torch.ones(8)
    xprof.uninstall_controller()
    assert ctl.captures == 1
    assert json.loads((tmp_path / "xprof" / "step-00000001" / "trace.json").read_text())
    assert xprof.device_memory_stats() == {} or torch.cuda.is_available()


# -- the ledger ---------------------------------------------------------------------


def test_ledger_mfu_against_the_cards_peaks_and_measured_ceilings(clean_obs):
    peaks = ledger.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12, "bytes": 3.35e12}
    assert ledger.card_peaks("Tesla T4") == {}
    led = ledger.enable(peaks=peaks)
    counted = {"flops": 67e9 + 989e9, "bytes_accessed": 3.35e9,
               "flops_by_precision": {"fp32": 67e9, "bf16": 989e9, "int8": 0.0}}
    led.record_compile("train_step", "T512xR16xG16", counted, 2.0, live_bytes=1e6)
    led.observe_execution("train_step", "T512xR16xG16", 0.004)  # ideal 2 ms
    led.set_step_site("train_step", "T512xR16xG16")
    led.observe_step_seconds(0.004)
    view = led.snapshot()["sites"]["train_step/T512xR16xG16"]
    assert view["executions"] == 2 and view["live_bytes"] == 1e6
    assert view["mfu_vs_measured_ceiling"] == pytest.approx(0.5)
    assert led.mfu_record()["ledger_mfu"] == {"train_step/T512xR16xG16": pytest.approx(0.5)}
    led.ceilings = {"matmul_fp32_flops_per_sec": 33.5e12, "matmul_flops_per_sec": 494.5e12}
    assert led.snapshot()["sites"]["train_step/T512xR16xG16"]["mfu_vs_measured_ceiling"] \
        == pytest.approx(1.0)
    assert led.record_params("model", torch.nn.Linear(4, 2)) == 40.0
    led.record_memory("epoch", {"bytes_in_use": 5.0})
    led.record_memory("epoch", {"bytes_in_use": 3.0})
    snap = led.snapshot()
    assert snap["memory"]["epoch"]["bytes_in_use"] == 5.0 and snap["params"]["model"] == 40.0
    assert jmetrics.undeclared_tags([{"ledger": snap}, led.mfu_record()]) == []
    cpu = ledger.EfficiencyLedger()
    cpu.record_compile("serve_score", "G16", counted, 1.0)
    cpu.observe_execution("serve_score", "G16", 1.0)
    assert "mfu_vs_measured_ceiling" not in cpu.snapshot()["sites"]["serve_score/G16"]
    assert cpu.mfu_record()["ledger_mfu"]["serve_score/G16"] == pytest.approx(1056e9)


def test_read_cost_analysis_normalizes_a_count():
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    h = torch.randn(16, 32)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3], dtype=torch.int32)
    edges = gk.prepare_edges(src, dst, torch.ones(3, dtype=torch.bool), None, 16)
    p = [torch.randn(1, 32, 32), torch.randn(1, 32), torch.randn(32, 96), torch.randn(32, 96),
         torch.randn(96), torch.randn(96)]
    _, counted = cost.count_cost(gk.ggnn_step, h, edges, *p)
    out = ledger.read_cost_analysis(counted)
    assert out["flops"] == sum(gk.step_work(16, 3, 32, 1, False)[:1])
    assert out["bytes_accessed"] == gk.step_work(16, 3, 32, 1, False)[1]
    assert out["cost_analysis"]["aten_flops"] == 0.0


# -- the health probe and the backend probe ------------------------------------------


def test_health_probe_reports_ok_wedges_and_failures(clean_obs):
    reg = metrics.MetricsRegistry()
    calls = iter([(False, "backend probe timed out after 5s (driver or card wedged?)"),
                  (True, "NVIDIA H100 80GB HBM3")])
    h = health.BackendHealth(probe_fn=lambda t: next(calls), registry=reg)
    report = h.probe(timeout_s=5.0, retries=1)
    assert report["ok"] and report["attempts"] == 2 and report["platform"].startswith("NVIDIA")
    snap = reg.snapshot()
    assert snap["backend/wedges"] == 1 and snap["backend/probe_retries"] == 1
    assert snap["backend/healthy"] == 1.0
    assert health.looks_wedged("backend probe rc=1: CUDA error: an illegal memory access was "
                               "encountered")
    assert not health.looks_wedged("backend probe rc=1: CUDA is not available")
    bad = health.BackendHealth(probe_fn=lambda t: (False, "CUDA is not available"),
                               registry=reg)
    assert not bad.probe(timeout_s=1.0)["ok"] and not bad.last()["wedged"]
    assert jmetrics.undeclared_tags([reg.snapshot()]) == []


def test_bounded_run_and_the_backend_probe():
    import sys

    res, err = backend.bounded_run([sys.executable, "-c", "import time; time.sleep(5)"], 0.5)
    assert res is None and "timed out" in err
    res, err = backend.bounded_run([sys.executable, "-c", "raise SystemExit('no card')"], 30)
    assert res is None and "rc=1" in err and "no card" in err
    ok, detail = backend.probe_default_backend(timeout=120, use_cache=False)
    assert ok == torch.cuda.is_available()
    assert ok or "CUDA is not available" in detail


# -- prng ---------------------------------------------------------------------------


def test_host_rng_and_hashstr_are_the_references():
    from deepdfa_tpu.core import prng as jprng

    for seed, name in ((0, ""), (3, "shuffle"), (17, "sample:1")):
        assert np.array_equal(prng.host_rng(seed, name).integers(0, 1 << 30, 8),
                              jprng.host_rng(seed, name).integers(0, 1 << 30, 8))
    assert prng.hashstr("api") == jprng.hashstr("api")


# -- every switch off -----------------------------------------------------------------


def test_the_default_path_is_unchanged(tmp_path, clean_obs):
    """With every switch off the instruments are the shared no-op, no
    count is open, no telemetry file appears, each epoch record has the
    plain loop's keys, and the losses are a hand loop's of train_step."""
    cfg = _cfg("train.prefetch_batches=0")
    assert obs.instruments(cfg) is obs.NULL_INSTRUMENTS and not cost.counting()
    with obs.session(cfg, tmp_path):
        records, _ = _fit(cfg)
    assert sorted(tmp_path.iterdir()) == []
    epochs = [r for r in records if "epoch" in r]
    assert set(epochs[0]) == {"epoch", "train_loss", "epoch_seconds", "host_load_seconds",
                              "host_pack_seconds", "host_place_seconds", "input_wait_seconds",
                              "input_wait_fraction"}
    specs = [GraphSpec(**k) for k in _kw()]
    trainer = GraphTrainer(DeepDFA.from_config(cfg.model, INPUT_DIM), cfg, device="cpu")
    state = trainer.init_state()
    by_hand = [float(trainer.train_step(state, b.to("cpu")))
               for _ in range(2) for b in shard_bucket_batches(specs, **TBATCH)]
    assert [r["loss"] for r in records if "loss" in r] == by_hand


def test_session_installs_and_removes_every_instrument(tmp_path, clean_obs):
    cfg = _cfg("obs.trace=true", "obs.ledger=true", "obs.flight=true", "obs.xprof_trigger=true")
    with obs.session(cfg, tmp_path):
        assert trace.enabled() and ledger.enabled() and flight.installed()
        assert xprof._controller is not None
        inst = obs.instruments(cfg)
        assert isinstance(inst, obs.Instruments) and inst.ledger is ledger.get()
        with trace.span("probe", cat="app"):
            pass
    assert not ledger.enabled() and not flight.installed() and xprof._controller is None
    assert (tmp_path / "trace" / "trace.json").exists()
    stamp = obs.run_stamp()
    assert stamp["torch_version"] == torch.__version__ and stamp["schema_version"] == 1
