"""The generation trainer under the runtime hooks on the CPU
(`train/gen_loop.py:GenTrainer.fit` with a `ResilientRunner`, the obs
instruments and the sanitizers; `cli train-gen` under
`train.resilience.enabled` and DEEPDFA_FAULTS), on a 2 + 2-layer T5 of
width 64 (`T5Config.tiny`):

- a clean resilient run gives the reference `GenTrainer.fit`'s step
  losses (within 1e-5 relative) and its step checkpoints' cursors, from
  the same weights over the same batches (the reference cannot poison a
  generation batch, so the faulted runs are the port's alone);
- a NaN step (`PoisonedGenBatch`) leaves the weights, moments and update
  counts bit-equal to the state before it;
- the runner skips exactly the planned steps and rolls back after
  `max_consecutive_bad` of them with the LR cooled;
- a preempted and resumed run, in-process and through `cli train-gen`
  (exit 143, then a second command), equals the uninterrupted one to the
  bit;
- the ledger books a generation step's site with the FLOPs the flash
  kernels' work formulas count;
- `train-multi-gen`'s and `train-clone`'s loops raise at a NaN under
  `train.debug_nans`, as the GGNN trainer's sanitizer does.

The reference runs its plain (XLA) attention without remat, the port
its flash kernels' plain versions; both sides at dropout 0 (their
dropout streams differ by design)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.data import gen_data as jdata  # noqa: E402
from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.models import t5_gen as jgen  # noqa: E402
from deepdfa_tpu.parallel import make_mesh  # noqa: E402
from deepdfa_tpu.train import gen_loop as jgen_loop  # noqa: E402
from deepdfa_tpu.train.resilience import ResilientRunner as JRunner  # noqa: E402
from deepdfa_tpu_torch import cli, obs  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.data import gen_data as tdata  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    CloneConfig,
    GenConfig,
    T5Config,
    from_jax_gen_params,
)
from deepdfa_tpu_torch.obs.cost import count_cost  # noqa: E402
from deepdfa_tpu_torch.testing import faults  # noqa: E402
from deepdfa_tpu_torch.train import clone_loop as tclone  # noqa: E402
from deepdfa_tpu_torch.train import multi_gen as tmulti  # noqa: E402
from deepdfa_tpu_torch.train.gen_loop import GenTrainer  # noqa: E402
from deepdfa_tpu_torch.train.resilience import (  # noqa: E402
    EXIT_PREEMPTED,
    Preempted,
    ResilientRunner,
    StepCheckpointer,
)

VOCAB = 64
ROWS, EPOCHS = 4, 2
RESILIENCE = {"enabled": True, "step_checkpoint_every": 2, "guard_lag": 1, "keep_last_k": 100}
CFG = {
    "run_name": "gen-hooks",
    "train": {"max_epochs": EPOCHS, "seed": 5,
              "optim": {"name": "sgd", "learning_rate": 0.05, "weight_decay": 0.0,
                        "warmup_frac": 0.0, "grad_clip_norm": 1.0},
              "mesh": {"dp": 1}, "resilience": RESILIENCE},
}


def _cfgs(**train):
    d = {**CFG, "train": {**CFG["train"], **train}}
    return jconfig.from_dict(d), tconfig.from_dict(d)


def _enc():
    return (jt5.T5Config.tiny(vocab_size=VOCAB, dropout_rate=0.0, remat=False),
            T5Config.tiny(vocab_size=VOCAB, dropout_rate=0.0))


def _corpus(n=16, S=20, T=10, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, VOCAB, (n, S)).astype(np.int32)
    tgt = rng.integers(3, VOCAB, (n, T)).astype(np.int32)
    for i in range(n):
        src[i, int(rng.integers(4, S)):] = 0
        end = int(rng.integers(2, T))
        tgt[i, end] = 2
        tgt[i, end + 1:] = 0
    return src, tgt


SRC, TGT = _corpus()
STEPS = EPOCHS * len(SRC) // ROWS


def _stream(mod, injector=None):
    def batches(epoch):
        b = mod.batches_of(SRC, TGT, 1, ROWS, shuffle_seed=5 + epoch)
        return injector.wrap(b) if injector is not None else b
    return batches


def _sidecars(directory):
    return sorted((m["step"], m["epoch"], m["batch_index"], m["reason"])
                  for m in (json.loads(p.read_text())
                            for p in directory.glob("step-*.cursor.json")))


def _port(tcfg, params=None):
    trainer = GenTrainer(tcfg, GenConfig(encoder=_enc()[1], max_target_length=10),
                         total_steps=STEPS, device="cpu")
    return trainer, trainer.init_state(params=params)


def _port_fit(tmp_path, name, plan=None, tcfg=None, params=None, decisions=None):
    """(trainer, state, runner) of a port fit under `plan`; `decisions`
    collects (ok, rollbacks, lr scale) at each consumed guard flag."""
    tcfg = tcfg if tcfg is not None else _cfgs()[1]
    trainer, state = _port(tcfg, params)
    runner = ResilientRunner(tcfg.train.resilience, tmp_path / name, seed=tcfg.train.seed)
    if decisions is not None:
        orig = runner._consume_ok

        def consume(flag, st):
            value = flag.value()
            orig(flag, st)
            decisions.append((value, runner.rollbacks, runner.lr_scale()))

        runner._consume_ok = consume
    injector = faults.FaultInjector(plan) if plan is not None else None
    trainer.fit(state, _stream(tdata, injector), resilience=runner, seed=0)
    return trainer, state, runner


def _equal_states(a: dict, b: dict) -> bool:
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    return (a["step"] == b["step"] and a["schedule_count"] == b["schedule_count"]
            and a["model"].keys() == b["model"].keys()
            and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
            and sa.keys() == sb.keys()
            and all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]))


def test_clean_resilient_run_matches_the_reference(tmp_path):
    jcfg, tcfg = _cfgs()
    jenc, _ = _enc()
    jtr = jgen_loop.GenTrainer(jcfg, jgen.GenConfig(encoder=jenc, max_target_length=10),
                               mesh=make_mesh(jcfg.train.mesh, devices=jax.devices()[:1]),
                               total_steps=STEPS)
    jstate = jtr.init_state()
    params = from_jax_gen_params(jax.tree.map(np.asarray, jax.device_get(jstate.params)))
    want, got = [], []
    jstep = jtr.train_step_guarded

    def jguarded(state, batch, key, lr_scale):
        out = jstep(state, batch, key, lr_scale)
        want.append(float(out[1]))
        return out

    jtr.train_step_guarded = jguarded
    jrunner = JRunner(jcfg.train.resilience, tmp_path / "ref", seed=jcfg.train.seed)
    jtr.fit(jstate, _stream(jdata), resilience=jrunner, seed=0)

    trainer, state = _port(tcfg, params)
    tstep = trainer.train_step_guarded

    def tguarded(*args, **kw):
        loss, ok = tstep(*args, **kw)
        got.append(float(loss))
        return loss, ok

    trainer.train_step_guarded = tguarded
    runner = ResilientRunner(tcfg.train.resilience, tmp_path / "port", seed=tcfg.train.seed)
    trainer.fit(state, _stream(tdata), resilience=runner, seed=0)
    assert len(got) == len(want) == STEPS and len(set(np.round(got, 5))) > 1
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert _sidecars(tmp_path / "port") == _sidecars(tmp_path / "ref")
    # every 2 steps; the last is the final one
    assert [c[0] for c in _sidecars(tmp_path / "port")] == list(range(2, STEPS + 1, 2))
    assert runner.record() == jrunner.record() == {"resumed_from_step": 0, "skipped_steps": 0,
                                                   "rollbacks": 0}
    assert state.step == STEPS == state.update_count()


def test_nan_step_changes_nothing():
    _, tcfg = _cfgs()
    trainer, state = _port(tcfg)
    batches = tdata.batches_of(SRC, TGT, 1, ROWS)
    loss, ok = trainer.train_step_guarded(state, batches[0].to("cpu"), None)
    assert bool(ok) and torch.isfinite(loss)
    before = state.state_dict()
    poisoned = faults.poison_batch(batches[1])
    assert isinstance(poisoned, faults.PoisonedGenBatch) and poisoned.to("cpu").poisoned
    assert not getattr(batches[1], "poisoned", False)
    loss, ok = trainer.train_step_guarded(state, poisoned.to("cpu"), None)
    assert not bool(ok) and not torch.isfinite(loss)
    after = state.state_dict()
    assert after["step"] == before["step"] + 1  # the host step (the data cursor) moves
    assert _equal_states({**before, "step": after["step"]}, after)
    assert after["schedule_count"] == state.update_count() == 1


@pytest.mark.parametrize("nan_steps, over, skipped, rollbacks, lr", [
    ({3, 4}, {}, 2, 0, 1.0),
    ({3, 4, 5}, {"max_consecutive_bad": 3}, 3, 1, 0.5),
    ({2, 3, 6, 7}, {"max_consecutive_bad": 2, "guard_lag": 0, "lr_cooldown": 0.25}, 4, 2,
     0.0625),
], ids=["skips", "rollback", "lag0_cooldown"])
def test_skip_and_rollback_follow_the_plan(tmp_path, nan_steps, over, skipped, rollbacks, lr):
    """The runner consumes one ok flag a step, in order: False exactly at
    the planned steps; a rollback after `max_consecutive_bad` bad steps in
    a row with the LR scaled by `lr_cooldown` (dropping the `guard_lag`
    flags of the abandoned trajectory); the parameters finite."""
    _, tcfg = _cfgs(resilience={**RESILIENCE, **over})
    decisions = []
    _, state, runner = _port_fit(tmp_path, "plan", faults.FaultPlan(
        nan_at_steps=frozenset(nan_steps)), tcfg=tcfg, decisions=decisions)
    assert [s + 1 for s, d in enumerate(decisions) if not d[0]] == sorted(nan_steps)
    assert len(decisions) == STEPS - rollbacks * over.get("guard_lag", 1)
    assert runner.record() == {"resumed_from_step": 0, "skipped_steps": skipped,
                               "rollbacks": rollbacks}
    assert runner.lr_scale() == lr and decisions[-1][1:] == (rollbacks, lr)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    if not rollbacks:
        assert state.update_count() == STEPS - skipped


@pytest.mark.parametrize("sigterm_at", [3, 6], ids=["epoch0_after_a_skip", "epoch1"])
def test_preempted_and_resumed_equals_uninterrupted(tmp_path, sigterm_at):
    nans = frozenset({2, 3})
    _, a, _ = _port_fit(tmp_path, "a", faults.FaultPlan(nan_at_steps=nans))
    with pytest.raises(Preempted):
        _port_fit(tmp_path, "b", faults.FaultPlan(nan_at_steps=nans, sigterm_at_step=sigterm_at))
    man = json.loads((tmp_path / "b" / "resume.json").read_text())
    assert man["reason"] == "preempt" and man["step"] == sigterm_at
    # the resumed stream counts its pulls from the first batch of the
    # resumed epoch (the fast-forward pulls through the injector)
    resumed_nans = nans if man["epoch"] == 0 else frozenset()
    _, b, runner = _port_fit(tmp_path, "b", faults.FaultPlan(nan_at_steps=resumed_nans))
    assert runner.resumed_from_step == sigterm_at and runner.skipped_steps == 2
    assert _equal_states(a.state_dict(), b.state_dict())
    assert a.step == STEPS and a.update_count() == STEPS - 2


def _cli_gen(monkeypatch, tmp_path, run, plan, *extra):
    files = tmp_path / "summarize.jsonl"
    if not files.exists():
        rng = np.random.default_rng(4)
        words = ("int", "x", "=", "foo", "(", ")", ";", "return", "a", "+", "b")
        files.write_text("\n".join(json.dumps(
            {"code_tokens": [str(w) for w in rng.choice(words, 8)],
             "docstring_tokens": [str(w) for w in rng.choice(words, 4)], "idx": i})
            for i in range(12)) + "\n")
        (tmp_path / "cfg.json").write_text(json.dumps(
            {**CFG, "train": {**CFG["train"], "optim": {**CFG["train"]["optim"],
                                                        "name": "adamw",
                                                        "warmup_frac": 0.25}}}))
    monkeypatch.setenv("DEEPDFA_FAULTS", plan)
    try:
        cli.main(["train-gen", "--task", "summarize", "--tiny", "--device", "cpu",
                  "--config", str(tmp_path / "cfg.json"), "--train-file", str(files),
                  "--dev-file", str(files), "--batch-size", "4", "--max-source-length", "16",
                  "--max-target-length", "6", "--vocab-size", "128", f'run_name="{run}"',
                  *extra])
        return 0
    except SystemExit as e:
        return e.code
    finally:
        monkeypatch.delenv("DEEPDFA_FAULTS")


def test_cli_train_gen_sigterm_resume_is_bit_identical(tmp_path, monkeypatch, capsys):
    """`cli train-gen` under nan@2 with a warm-up schedule and dropout: a
    run preempted at step 3 (exit 143) and resumed by a second command
    ends with the uninterrupted run's weights, moments and counts."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    assert _cli_gen(monkeypatch, tmp_path, "a", "nan@2") == 0
    assert _cli_gen(monkeypatch, tmp_path, "b", "nan@2,sigterm@3") == EXIT_PREEMPTED
    assert "preempted" in capsys.readouterr().out
    assert _cli_gen(monkeypatch, tmp_path, "b", "nan@2") == 0

    def final(run):
        ck = StepCheckpointer(tmp_path / "runs" / run / cli.GEN_STEP_CHECKPOINTS_DIR)
        return ck.restore(ck.latest())

    a, b = final("a"), final("b")
    assert a["step"] == 6 and a["schedule_count"] == 5
    assert _equal_states(a, b)
    rec = [json.loads(x) for x in (tmp_path / "runs" / "b" / "train_log.jsonl")
           .read_text().splitlines()][-1]
    assert rec["resumed_from_step"] == 3 and rec["skipped_steps"] == 1 and "val_ppl" in rec


def test_ledger_books_a_generation_step_counted_through_the_flash_kernels():
    """Under obs.ledger the first step of a signature is the ledger's
    site: its FLOPs are the step's count (the flash kernels' work formulas
    plus the aten products), the flash kernels' launches in it."""
    _, tcfg = _cfgs()
    tcfg = tconfig.apply_overrides(tcfg, ["obs.ledger=true", "train.resilience.enabled=false"])
    trainer, state = _port(tcfg)
    batch = _stream(tdata)(0)[0].to("cpu")  # the fit's first batch
    _, counted = count_cost(lambda: trainer.train_step(state, batch, None))
    kernels = {k: v["launches"] for k, v in counted["kernels"].items()}
    # 2 + 2 layers: the encoder's, the decoder's self- and cross-attention,
    # each forward replayed under remat; dbias for the two biased calls
    assert kernels == {"flash_fwd": 12, "flash_dq": 6, "flash_dkv": 6, "flash_dbias": 4}
    assert counted["flops"] > sum(v["flops"] for v in counted["kernels"].values()) > 0
    records = []
    trainer, state = _port(tcfg)
    with obs.session(tcfg, None):
        trainer.fit(state, _stream(tdata), max_epochs=1, log_fn=records.append)
    sites = records[-1]["ledger"]["sites"]
    sig = trainer.signature(batch)
    assert sig == "S20xT10xR4" and list(sites) == [f"train_step/{sig}"]
    assert sites[f"train_step/{sig}"]["flops"] == counted["flops"]


def _poison_weights(model):
    with torch.no_grad():
        next(model.parameters()).fill_(float("nan"))


@pytest.mark.parametrize("loop", ["multi_gen", "clone"])
def test_sanitizers_raise_at_a_nan_in_multi_gen_and_clone(loop):
    _, tcfg = _cfgs(resilience={"enabled": False}, debug_nans=True)
    if loop == "multi_gen":
        trainer, state = _port(tcfg)
        task = tmulti.GenTask("summarize", lambda e: tdata.batches_of(SRC, TGT, 1, ROWS),
                              size=len(SRC))

        def run():
            return tmulti.fit_multi(trainer, state, [task], max_steps=state.step + 2,
                                    eval_every=10)
    else:
        trainer = tclone.CloneTrainer(tcfg, CloneConfig(encoder=_enc()[1]), total_steps=2,
                                      device="cpu")
        state = trainer.init_state()
        pairs = np.stack([SRC, SRC[::-1]], axis=1)
        labels = [i % 2 for i in range(len(SRC))]

        def run():
            return trainer.fit(state, lambda e: tclone.clone_batches_of(
                pairs, labels, 1, ROWS), max_epochs=1)
    run()  # clean: trains
    _poison_weights(state.model)
    with pytest.raises(FloatingPointError, match="debug_nans"):
        run()
