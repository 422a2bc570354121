"""The port's resilient training runtime (deepdfa_tpu_torch/train/
resilience.py, testing/faults.py, the guarded update of train/state.py)
on the CPU, held against the reference's (deepdfa_tpu/train/
resilience.py): the same skip, rollback, LR-scale and step-checkpoint
decisions for the same weights, batches and fault plan; a preempted and
resumed run equal to the uninterrupted one to the bit; the watchdog, the
fault grammar and the refusals of the loops that do not run it yet."""

import dataclasses
import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from deepdfa_tpu.core import Config as JConfig, MeshConfig as JMesh  # noqa: E402
from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as JSpec  # noqa: E402
from deepdfa_tpu.graphs import shard_bucket_batches as jbatches  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.core import sanitize  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, GraphStore  # noqa: E402
from deepdfa_tpu_torch.graphs import shard_bucket_batches as tbatches  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.testing import faults  # noqa: E402
from deepdfa_tpu_torch.train import GraphTrainer, TrainState  # noqa: E402
from deepdfa_tpu_torch.train.resilience import (  # noqa: E402
    EXIT_PREEMPTED,
    EXIT_WATCHDOG,
    DivergenceError,
    Preempted,
    ResilientRunner,
    ResumeCursor,
    StepCheckpointer,
    Watchdog,
    finite_mean,
)

INPUT_DIM = 32


def _graph_kw(n=24, seed=0):
    """The reference's tests/test_resilience.py graphs, as kwargs."""
    rng = np.random.default_rng(seed)
    out = []
    for gid in range(n):
        m = int(rng.integers(4, 10))
        feats = rng.integers(2, 20, (m, 4)).astype(np.int32)
        vuln = np.zeros((m,), np.int32)
        if gid % 2 == 0:
            feats[0, 0] = 7
            vuln[0] = 1
        out.append(dict(graph_id=gid, node_feats=feats, node_vuln=vuln,
                        edge_src=np.arange(m - 1, dtype=np.int32),
                        edge_dst=np.arange(1, m, dtype=np.int32), label=float(vuln.max())))
    return out


TBATCH = dict(num_graphs=4, node_budget=64, edge_budget=256)
BATCH = dict(num_shards=1, **TBATCH)


def _overrides(*extra):
    return ["model.hidden_dim=8", "train.max_epochs=3", "train.prefetch_batches=0",
            "train.log_every_steps=1",
            'train.resilience={"enabled": true, "step_checkpoint_every": 2, "guard_lag": 1, '
            '"keep_last_k": 100}', *extra]


def _tcfg(*extra):
    return tconfig.apply_overrides(tconfig.Config(), _overrides(*extra))


@pytest.fixture(scope="module")
def specs():
    kw = _graph_kw()
    return [JSpec(**k) for k in kw], [TSpec(**k) for k in kw]


def _port_fit(specs, ckpt_dir, cfg=None, plan=None, log=None, params=None, runner_kw=None):
    cfg = cfg if cfg is not None else _tcfg()
    trainer = GraphTrainer(DeepDFA.from_config(cfg.model, INPUT_DIM), cfg, device="cpu")
    state = trainer.init_state(params=params)
    runner = ResilientRunner(cfg.train.resilience, ckpt_dir, seed=cfg.train.seed,
                             **(runner_kw or {}))
    injector = faults.FaultInjector(plan) if plan is not None else None

    def stream(epoch):
        b = list(tbatches(specs[1], **TBATCH))
        return injector.wrap(b) if injector is not None else b

    trainer.fit(state, stream, log_fn=log, resilience=runner)
    return state, runner


_REF_TRAINER: dict = {}


def _sidecars(directory):
    return sorted((m["step"], m["epoch"], m["batch_index"], m["reason"])
                  for m in (json.loads(p.read_text())
                            for p in directory.glob("step-*.cursor.json")))


# -- decisions against the reference ---------------------------------------


@pytest.mark.parametrize("nan_steps, over", [
    ({3, 4}, []),
    ({3, 4, 7, 8, 9}, []),
    ({4, 5}, ['train.resilience={"enabled": true, "step_checkpoint_every": 2, "guard_lag": 0, '
              '"keep_last_k": 100, "max_consecutive_bad": 2, "rollback_budget": 3, '
              '"lr_cooldown": 0.25}']),
], ids=["skips", "rollback", "lag0_cooldown"])
def test_runner_decisions_equal_the_reference(specs, tmp_path, nan_steps, over):
    """The same weights, batches and plan through both packages' fit:
    the same ok flags consumed in the same order (which steps are
    skipped), the same rollbacks and LR scale after each, the same
    cursors at every step checkpoint."""
    import jax

    from deepdfa_tpu.models import DeepDFA as JDeepDFA
    from deepdfa_tpu.parallel import make_mesh
    from deepdfa_tpu.testing.faults import FaultInjector as JInjector, FaultPlan as JPlan
    from deepdfa_tpu.train import GraphTrainer as JTrainer
    from deepdfa_tpu.train.resilience import ResilientRunner as JRunner

    jcfg = jconfig.apply_overrides(JConfig(), _overrides(*over))
    jb = list(jbatches(specs[0], **BATCH))
    # one compiled trainer for every case: the cases differ only in the
    # runner's knobs, which the jitted step never reads
    jtrainer = _REF_TRAINER.get("trainer")
    if jtrainer is None:
        jmodel = JDeepDFA.from_config(jcfg.model, input_dim=INPUT_DIM)
        mesh = make_mesh(JMesh(dp=1), devices=jax.devices()[:1])
        jtrainer = _REF_TRAINER["trainer"] = JTrainer(jmodel, jcfg, mesh=mesh)
    jstate = jtrainer.init_state(jb[0])
    params = from_jax_params(jax.tree.map(np.asarray, jax.device_get(jstate.params)))
    jrunner = JRunner(jcfg.train.resilience, tmp_path / "ref", seed=jcfg.train.seed)
    want = []
    orig = jrunner._consume_ok

    def jconsume(ok, state):
        value = bool(jax.device_get(ok))
        out = orig(ok, state)
        want.append((value, jrunner.rollbacks, jrunner.lr_scale()))
        return out

    jrunner._consume_ok = jconsume
    injector = JInjector(JPlan(nan_at_steps=frozenset(nan_steps)))
    jtrainer.fit(jstate, lambda e: injector.wrap(jb), resilience=jrunner)

    got = []
    tcfg = _tcfg(*over)
    trainer = GraphTrainer(DeepDFA.from_config(tcfg.model, INPUT_DIM), tcfg, device="cpu")
    state = trainer.init_state(params=params)
    runner = ResilientRunner(tcfg.train.resilience, tmp_path / "port", seed=tcfg.train.seed)
    orig_t = runner._consume_ok

    def tconsume(flag, state):
        value = flag.value()
        orig_t(flag, state)
        got.append((value, runner.rollbacks, runner.lr_scale()))

    runner._consume_ok = tconsume
    tinjector = faults.FaultInjector(faults.FaultPlan(nan_at_steps=frozenset(nan_steps)))
    trainer.fit(state, lambda e: tinjector.wrap(list(tbatches(specs[1], **TBATCH))),
                resilience=runner)
    assert got == want and len(got) >= 10
    assert runner.record() == jrunner.record()
    assert runner.lr_scale() == jrunner.lr_scale()
    assert _sidecars(tmp_path / "port") == _sidecars(tmp_path / "ref")


def test_guard_skips_nan_steps_and_keeps_params_finite(specs, tmp_path):
    records = []
    state, runner = _port_fit(
        specs, tmp_path / "nan", plan=faults.FaultPlan(nan_at_steps=frozenset({3, 4})),
        log=lambda r: records.append(r) if "train_loss" in r else None)
    assert runner.skipped_steps == 2 and runner.rollbacks == 0
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert records and all(np.isfinite(r["train_loss"]) for r in records)
    assert records[0]["skipped_steps"] == 2
    # 18 steps dispatched, 16 updates applied: the schedule's count too
    assert state.step == 18 and state.update_count() == 16


def test_rollback_budget_exhaustion_raises(specs, tmp_path):
    cfg = _tcfg('train.resilience={"enabled": true, "step_checkpoint_every": 2, '
                '"guard_lag": 0, "max_consecutive_bad": 1, "rollback_budget": 1}')
    with pytest.raises(DivergenceError):
        _port_fit(specs, tmp_path / "budget", cfg=cfg,
                  plan=faults.FaultPlan(nan_at_steps=frozenset(range(2, 12))))


def test_guard_state_survives_preemption(specs, tmp_path):
    cfg = _tcfg('train.resilience={"enabled": true, "step_checkpoint_every": 2, '
                '"guard_lag": 0, "max_consecutive_bad": 1, "rollback_budget": 5, '
                '"lr_cooldown": 0.5}')
    run_dir = tmp_path / "guard-resume"
    with pytest.raises(Preempted):
        _port_fit(specs, run_dir, cfg=cfg,
                  plan=faults.FaultPlan(nan_at_steps=frozenset({3}), sigterm_at_step=6))
    man = json.loads((run_dir / "resume.json").read_text())
    assert man["guard"] == {"lr_scale": 0.5, "rollbacks": 1, "skipped_steps": 1}
    _, runner = _port_fit(specs, run_dir, cfg=cfg)
    assert runner.lr_scale() == 0.5 and runner.rollbacks == 1 and runner.skipped_steps == 1


# -- the guarded update ------------------------------------------------------


@pytest.mark.parametrize("name, kw", [
    ("adamw", {"weight_decay": 0.01}), ("adam", {}), ("sgd", {}),
    ("adamw", {"warmup_frac": 0.5}), ("adamw", {"grad_clip_norm": 0.05}),
])
def test_guarded_update_is_torch_optims_and_a_bad_step_changes_nothing(name, kw):
    """Clean guarded steps follow torch.optim's own update within fp32
    rounding; a poisoned step leaves the weights, moments, counts and the
    schedule's count exactly as they were, and returns ok False."""
    import copy

    cfg = tconfig.OptimConfig(name=name, learning_rate=0.01, **kw)
    torch.manual_seed(0)
    m1 = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh(), torch.nn.Linear(8, 1))
    m2 = copy.deepcopy(m1)
    s1, s2 = TrainState.create(m1, cfg, 10), TrainState.create(m2, cfg, 10)
    x = torch.randn(16, 8)
    for _ in range(6):
        for m, s, guarded in ((m1, s1, False), (m2, s2, True)):
            s.optimizer.zero_grad()
            loss = m(x).pow(2).mean()
            loss.backward()
            if guarded:
                assert bool(s.apply_gradients_guarded(loss))
            else:
                s.apply_gradients()
    for a, b in zip(m1.parameters(), m2.parameters()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    before = s2.state_dict()
    s2.optimizer.zero_grad()
    loss = m2(x).pow(2).mean() * float("nan")
    loss.backward()
    assert not bool(s2.apply_gradients_guarded(loss))
    after = s2.state_dict()
    assert all(torch.equal(before["model"][k], after["model"][k]) for k in before["model"])
    for pa, pb in zip(before["optimizer"]["state"].values(),
                      after["optimizer"]["state"].values()):
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert before["schedule_count"] == after["schedule_count"] == 6
    assert after["step"] == before["step"] + 1  # the data cursor moves on


def test_lr_scale_scales_the_whole_update():
    cfg = tconfig.OptimConfig(name="adamw", learning_rate=0.01, weight_decay=0.1)
    deltas = []
    for scale in (1.0, 0.25):
        torch.manual_seed(1)
        m = torch.nn.Linear(4, 1)
        s = TrainState.create(m, cfg)
        w0 = m.weight.detach().clone()
        s.optimizer.zero_grad()
        loss = m(torch.randn(8, 4)).pow(2).mean()
        loss.backward()
        s.apply_gradients_guarded(loss, scale)
        deltas.append(m.weight.detach() - w0)
    torch.testing.assert_close(deltas[1], 0.25 * deltas[0], rtol=1e-5, atol=1e-9)


# -- preemption and resume, to the bit ---------------------------------------


def _store(tmp_path, specs):
    d = {"run_name": "res", "data": {"feat": {"limit_all": 18, "limit_subkeys": 18},
                                      "batch": {"graphs_per_batch": 4, "node_budget": 64,
                                                "edge_budget": 256}},
         "model": {"hidden_dim": 8, "n_steps": 3},
         "train": {"optim": {"name": "adamw", "learning_rate": 1e-2, "warmup_frac": 0.2},
                   "mesh": {"dp": 1}, "seed": 3, "max_epochs": 2, "prefetch_batches": 0,
                   "log_every_steps": 1, "feat_unknown_dropout": 0.2,
                   "resilience": {"enabled": True, "step_checkpoint_every": 2}}}
    cfg = tconfig.from_dict(d)
    out = tmp_path / "processed" / "bigvul"
    GraphStore(out / cli.graphs_dirname(cfg)).write(specs)
    (out / "splits.json").write_text(json.dumps(
        {str(g.graph_id): ("train", "train", "val", "test")[g.graph_id % 4] for g in specs}))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(d))
    return path


def _cli_train(monkeypatch, cfg_path, run, plan, *extra):
    monkeypatch.setenv("DEEPDFA_FAULTS", plan)
    try:
        cli.main(["train", "--config", str(cfg_path), "--device", "cpu", f'run_name="{run}"',
                  *extra])
        return 0
    except SystemExit as e:
        return e.code
    finally:
        monkeypatch.delenv("DEEPDFA_FAULTS")


def _final(tmp_path, run):
    ck = StepCheckpointer(tmp_path / "runs" / run / cli.STEP_CHECKPOINTS_DIR)
    return ck.restore(ck.latest())


@pytest.mark.parametrize("sigterm_at", [4, 6], ids=["right_after_a_skip", "later"])
def test_sigterm_resume_is_bit_identical(tmp_path, monkeypatch, capsys, sigterm_at):
    """`cli train` under nan@2,nan@3 with feature dropout and a warm-up
    schedule: a run preempted at `sigterm_at` (exit 143) and resumed by a
    second `cli train` ends with the uninterrupted run's weights,
    moments, update counts and step losses, to the bit."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cfg_path = _store(tmp_path, [TSpec(**k) for k in _graph_kw(48, seed=5)])
    assert _cli_train(monkeypatch, cfg_path, "a", "nan@2,nan@3") == 0
    assert _cli_train(monkeypatch, cfg_path, "b", f"nan@2,nan@3,sigterm@{sigterm_at}") \
        == EXIT_PREEMPTED
    assert "preempted" in capsys.readouterr().out
    assert _cli_train(monkeypatch, cfg_path, "b", "nan@2,nan@3") == 0
    a, b = _final(tmp_path, "a"), _final(tmp_path, "b")
    assert a["step"] == b["step"] and a["schedule_count"] == b["schedule_count"] == a["step"] - 2
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for i, st in a["optimizer"]["state"].items():
        assert all(torch.equal(st[k], b["optimizer"]["state"][i][k]) for k in st)

    def losses(run):
        rows = [json.loads(x) for x in
                (tmp_path / "runs" / run / "train_log.jsonl").read_text().splitlines()]
        return [(r["step"], r["loss"]) for r in rows if "loss" in r]

    la, lb = losses("a"), losses("b")
    assert [s for s, _ in lb] == [s for s, _ in la]
    assert all((x == y) or (np.isnan(x) and np.isnan(y)) for (_, x), (_, y) in zip(la, lb))


def test_foreign_seed_is_refused(specs, tmp_path):
    _port_fit(specs, tmp_path / "seeded")
    other = _tcfg("train.seed=2")
    _, runner = _port_fit(specs, tmp_path / "seeded", cfg=other)
    assert runner.resumed_from_step == 0  # trained from scratch
    _, runner = _port_fit(specs, tmp_path / "seeded", runner_kw={"rng": {"dropout_seed": 9}})
    assert runner.resumed_from_step == 0  # a manifest without these seeds


def test_completed_run_resume_is_noop(specs, tmp_path):
    steps_a, steps_b = [], []
    _port_fit(specs, tmp_path / "done", log=lambda r: steps_a.append(r) if "loss" in r else None)
    _, runner = _port_fit(specs, tmp_path / "done",
                          log=lambda r: steps_b.append(r) if "loss" in r else None)
    assert steps_a and not steps_b and runner.resumed_from_step == steps_a[-1]["step"]


# -- the watchdog (the reference's tests/test_resilience.py cases) -------------


def test_watchdog_fires_on_silence_with_stage_attribution(tmp_path):
    fired = []
    wd = Watchdog(timeout_s=0.2, on_stall=fired.append, diagnostic_path=tmp_path / "diag.json",
                  first_step_grace_s=0.2)
    wd.start()
    try:
        wd.beat("input", step=7)
        time.sleep(1.0)
    finally:
        wd.stop()
    assert len(fired) == 1 and fired[0]["stalled_stage"] == "input" and fired[0]["step"] == 7
    assert json.loads((tmp_path / "diag.json").read_text())["stalled_stage"] == "input"


def test_watchdog_first_step_grace_covers_the_first_build():
    fired = []
    wd = Watchdog(timeout_s=0.1, on_stall=fired.append, first_step_grace_s=5.0)
    wd.start()
    try:
        wd.beat("device")
        time.sleep(0.5)
        assert not fired
        wd.step_done()
        wd.beat("device")
        time.sleep(0.5)
    finally:
        wd.stop()
    assert len(fired) == 1 and fired[0]["stalled_stage"] == "device"


def test_watchdog_stays_quiet_under_heartbeats():
    fired = []
    wd = Watchdog(timeout_s=0.3, on_stall=fired.append, first_step_grace_s=0.3)
    wd.start()
    try:
        for _ in range(8):
            wd.beat("device")
            time.sleep(0.05)
    finally:
        wd.stop()
    assert not fired


def test_watchdog_detects_a_stalled_input_in_fit(specs, tmp_path):
    # a first step slower than the default grace (10 x 0.5 s) on a loaded
    # host must not read as a device stall: the stall under test is input
    cfg = _tcfg("train.max_epochs=1", 'train.resilience={"enabled": true, '
                '"step_checkpoint_every": 0, "watchdog_timeout_s": 0.5, '
                '"watchdog_first_step_grace_s": 60}')
    trainer = GraphTrainer(DeepDFA.from_config(cfg.model, INPUT_DIM), cfg, device="cpu")
    state = trainer.init_state()
    stalled = faults.StalledSource(list(tbatches(specs[1], **TBATCH)), n_good=2)
    fired = []

    def on_stall(diag):
        fired.append(diag)
        stalled.release()

    runner = ResilientRunner(cfg.train.resilience, tmp_path / "wd", seed=0, on_stall=on_stall)
    trainer.fit(state, lambda e: stalled, resilience=runner)
    assert fired and fired[0]["stalled_stage"] == "input" and "pipeline" in fired[0]


def test_watchdog_exit_code_is_the_references():
    from deepdfa_tpu.train import resilience as jres

    assert (EXIT_PREEMPTED, EXIT_WATCHDOG) == (jres.EXIT_PREEMPTED, jres.EXIT_WATCHDOG)


# -- step checkpoints ----------------------------------------------------------


def test_step_checkpointer_retention_latest_and_rebuild(tmp_path):
    ck = StepCheckpointer(tmp_path, keep_last=2)
    for s in (2, 4, 6):
        ck.save({"w": torch.arange(6.0)}, ResumeCursor(0, s, s), seed=1)
    assert sorted(p.name for p in tmp_path.glob("step-*") if p.is_dir()) == \
        ["step-00000004", "step-00000006"]
    assert ck.latest()["step"] == 6
    (tmp_path / "resume.json").write_text("{not json")
    assert ck.latest()["step"] == 6  # rebuilt from the sidecars
    assert torch.equal(ck.restore(ck.latest())["w"], torch.arange(6.0))
    (tmp_path / "step-00000008").mkdir()  # an interrupted save: no sidecar
    assert ck.latest()["step"] == 6


def test_finite_mean_is_the_references():
    from deepdfa_tpu.train.resilience import finite_mean as jfinite

    for values in ([1.0, float("nan"), 3.0], [float("nan")], [0.5, 0.25]):
        a, b = finite_mean(values), jfinite(values)
        assert a == b or (np.isnan(a) and np.isnan(b))


# -- the fault grammar ---------------------------------------------------------


@pytest.mark.parametrize("spec", ["sigterm@12, nan@3,nan@4,stall@5", "nan@2", "", "sigterm@1",
                                  "stall@7,nan@7", "explode@1", "nan", "nan@x"])
def test_parse_plan_agrees_with_the_reference(spec):
    from deepdfa_tpu.testing import faults as jfaults

    try:
        want = jfaults.parse_plan(spec)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(e)):
            faults.parse_plan(spec)
        return
    got = faults.parse_plan(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert bool(got) == bool(want)
    assert (faults.injector_from_env(env={"DEEPDFA_FAULTS": spec}) is None) == (not spec.strip())


def test_poison_batch_graph_and_text():
    from deepdfa_tpu_torch.data.text import collate
    from deepdfa_tpu_torch.graphs import pack

    gb = pack([TSpec(**k) for k in _graph_kw(4)], 4, 64, 256)
    assert np.isnan(faults.poison_batch(gb).graph_label).all()
    tb = collate(np.ones((2, 8), np.int32), [0, 1], [0, 1], {}, 2, 32, 64, pad_id=1)
    poisoned = faults.poison_batch(tb)
    assert poisoned.poisoned and poisoned.to("cpu").poisoned
    assert not getattr(tb, "poisoned", False)
    with pytest.raises(TypeError):
        faults.poison_batch([1, 2])


def test_combined_trainer_skips_a_poisoned_text_batch():
    """The combined family under the guard: a poisoned TextBatch's loss
    is NaN on the device, the update is skipped and nothing moves."""
    from deepdfa_tpu_torch.data.text import collate
    from deepdfa_tpu_torch.models import CombinedConfig, TransformerConfig
    from deepdfa_tpu_torch.train import CombinedTrainer

    cfg = _tcfg()
    mcfg = CombinedConfig(encoder=TransformerConfig.tiny(
        vocab_size=64, max_position_embeddings=20, num_layers=1, hidden_size=16, num_heads=2),
        graph_hidden_dim=8, graph_input_dim=102, use_graph=False)
    trainer = CombinedTrainer(cfg, mcfg, total_steps=4, device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    batch = collate(rng.integers(5, 60, (4, 16)).astype(np.int32), [0, 1, 0, 1], [0, 1, 2, 3],
                    {}, 4, 32, 64, pad_id=1)
    loss, ok = trainer.train_step_guarded(state, batch.to("cpu"), 7)
    assert bool(ok) and np.isfinite(float(loss))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    loss, ok = trainer.train_step_guarded(state, faults.poison_batch(batch).to("cpu"), 8)
    assert not bool(ok) and np.isnan(float(loss))
    assert all(torch.equal(before[k], v) for k, v in state.model.state_dict().items())
    assert state.step == 2 and state.update_count() == 1


# -- the sanitizers and the refusals -------------------------------------------


def test_debug_nans_names_the_first_non_finite_module():
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.Linear(4, 1))
    with torch.no_grad():
        model[1].weight.fill_(float("nan"))
    with sanitize.nan_checks(model):
        with pytest.raises(FloatingPointError, match=r"1 \(Linear\)"):
            model(torch.randn(2, 4))
    model(torch.randn(2, 4))  # the hooks are gone after the block
    model = torch.nn.Linear(4, 1)
    with sanitize.nan_checks(model):
        out = model(torch.randn(2, 4))
        with pytest.raises(RuntimeError, match="nan"):
            (out * torch.tensor(float("inf")) * 0).sum().backward()


def test_enable_checks_catch_bad_indices():
    from deepdfa_tpu_torch.nn import ggnn_kernel as gk

    src = torch.tensor([0, 1, 5], dtype=torch.int32)
    dst = torch.tensor([1, 2, 2], dtype=torch.int32)
    edges = gk.prepare_edges(src, dst, torch.ones(3, dtype=torch.bool), None, 3, transpose=True)
    with pytest.raises(IndexError, match="src"):
        sanitize.check_edges("ggnn_step", edges, 3)
    with pytest.raises(IndexError, match="row pointer"):
        sanitize.check_pointer("gather_sum", "ptr", torch.tensor([0, 3, 2]), 3)
    with sanitize.launch_checks():
        assert sanitize.checks_on()
    assert not sanitize.checks_on()


@pytest.mark.parametrize("over", ["train.resilience.enabled=true", "obs.metrics=true",
                                  "train.debug_nans=true", "train.enable_checks=true"])
def test_trainers_take_the_hooks_and_gen_clone_refuse_them(over):
    """The GGNN, combined and generation trainers take every hook; the
    multi-task generation and clone loops take the sanitizers and refuse
    the resilient runtime and the obs instruments, naming the reference's
    loops, which do not run them either."""
    from deepdfa_tpu_torch.models import CloneConfig, GenConfig, T5Config
    from deepdfa_tpu_torch.train.clone_loop import CloneTrainer
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    cfg = tconfig.apply_overrides(tconfig.Config(), [over])
    tconfig.refuse_unported_training(cfg, runtime_hooks=True)
    GraphTrainer(DeepDFA.from_config(cfg.model, INPUT_DIM), cfg, device="cpu")
    GenTrainer(cfg, GenConfig(encoder=T5Config()), device="cpu")
    if "debug_nans" in over or "enable_checks" in over:
        tconfig.refuse_unported_training(cfg)
        CloneTrainer(cfg, CloneConfig(encoder=T5Config()), device="cpu")
        return
    with pytest.raises(NotImplementedError, match="reference's `train-multi-gen`"):
        tconfig.refuse_unported_training(cfg)
    with pytest.raises(NotImplementedError, match="reference's `train-multi-gen`"):
        CloneTrainer(cfg, CloneConfig(encoder=T5Config()), device="cpu")
