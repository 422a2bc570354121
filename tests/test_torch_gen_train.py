"""The port's generation family on the CPU against the reference: the
task readers and `read_clone_examples` on files the test writes in each
format, `collate_gen`/`batches_of` exactly, `corpus_bleu`, a 4-step SGD
trajectory of `GenTrainer` against the reference `GenTrainer` with
`eval_ppl` and `eval_bleu_em`, `fit`'s checkpoints and patience rule,
`fit_multi`'s task order for a seed, a 4-step `CloneTrainer` trajectory
and its metrics, and `train-gen`, `train-multi-gen` and `train-clone
--tiny` end to end.

The reference runs its flash kernels (the decoder's causal one included)
in interpret mode (DEEPDFA_TPU_FLASH_INTERPRET=1), without remat; both
sides at dropout 0 (their dropout streams differ by design). Tolerances:
losses rtol 1e-4 and weights within 1e-4 of each leaf's scale after 4
steps (floored at 1e-3 of the largest), perplexity rtol 1e-5, decoded ids
and BLEU/EM exactly equal."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.data import gen_data as jdata  # noqa: E402
from deepdfa_tpu.eval import codebleu as jbleu  # noqa: E402
from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.models import t5_gen as jgen  # noqa: E402
from deepdfa_tpu.parallel import make_mesh  # noqa: E402
from deepdfa_tpu.train import clone_loop as jclone  # noqa: E402
from deepdfa_tpu.train import gen_loop as jgen_loop  # noqa: E402
from deepdfa_tpu.train import multi_gen as jmulti  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.data import gen_data as tdata  # noqa: E402
from deepdfa_tpu_torch.eval import codebleu as tbleu  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    CloneConfig,
    GenConfig,
    T5Config,
    T5Seq2Seq,
    from_jax_clone_params,
    from_jax_gen_params,
)
from deepdfa_tpu_torch.nn.dropout import fold_seed  # noqa: E402
from deepdfa_tpu_torch.train import clone_loop as tclone  # noqa: E402
from deepdfa_tpu_torch.train import multi_gen as tmulti  # noqa: E402
from deepdfa_tpu_torch.train.gen_loop import GenTrainer  # noqa: E402

VOCAB = 64
CFG = {
    "run_name": "port-gen",
    "train": {"max_epochs": 1, "seed": 5,
              "optim": {"name": "sgd", "learning_rate": 0.05, "weight_decay": 0.0,
                        "warmup_frac": 0.0, "grad_clip_norm": 1.0},
              "mesh": {"dp": 1}},
}
WORDS = ("int", "x", "=", "foo", "(", ")", ";", "return", "a", "+", "b", "if", "{", "}")


@pytest.fixture
def flash_interpret(monkeypatch):
    monkeypatch.setenv("DEEPDFA_TPU_FLASH_INTERPRET", "1")


def _cfgs():
    return jconfig.from_dict(CFG), tconfig.from_dict(CFG)


def _enc(**kw):
    base = dict(vocab_size=VOCAB, dropout_rate=0.0)
    base.update(kw)
    return jt5.T5Config.tiny(**base, remat=False), T5Config.tiny(**base)


def _leaf_errors(got: dict, want: dict) -> dict:
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


def _state_np(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _mesh(jcfg):
    return make_mesh(jcfg.train.mesh, devices=jax.devices()[:1])


# -- readers and batches ---------------------------------------------------------


def _text(rng, n):
    return " ".join(str(w) for w in rng.choice(WORDS, n))


def _write_task_files(tmp_path, rng, n=7):
    """One file (or file pair) per task family, and a clone pair file."""
    files = {}
    rows = [{"code_tokens": _text(rng, 6).split(), "docstring_tokens": ["do", "it", str(i)],
             **({"idx": 100 + i} if i % 2 else {})} for i in range(n)]
    files["summarize"] = tmp_path / "summ.jsonl"
    files["summarize"].write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    src, trg = tmp_path / "t.src", tmp_path / "t.trg"
    src.write_text("\n".join(f"  {_text(rng, 5)} " for _ in range(n)) + "\n")
    trg.write_text("\n".join(_text(rng, 4) for _ in range(n)) + "\n")
    files["translate"] = files["refine"] = f"{src},{trg}"
    files["concode"] = tmp_path / "concode.jsonl"
    files["concode"].write_text("\n".join(json.dumps({"nl": f" make {i} ", "code": _text(rng, 5)})
                                          for i in range(n)) + "\n")
    files["defect"] = tmp_path / "defect.jsonl"
    files["defect"].write_text("\n".join(json.dumps(
        {"code": _text(rng, 8) + "\n  " + _text(rng, 3), "target": i % 2, "idx": i})
        for i in range(n)) + "\n")
    clone_dir = tmp_path / "clone"
    clone_dir.mkdir()
    (clone_dir / "data.jsonl").write_text("\n".join(json.dumps(
        {"idx": str(i), "func": _text(rng, 7) + "\n " + _text(rng, 2)}) for i in range(6)) + "\n")
    pairs = [f"{i % 6}\t{(i * 5 + 1) % 6}\t{i % 2}" for i in range(2 * n)]
    pairs.insert(3, "0\t99\t1")  # an unknown url: skipped
    files["clone"] = clone_dir / "train.txt"
    files["clone"].write_text("\n".join(pairs) + "\n")
    return {k: str(v) for k, v in files.items()}


@pytest.mark.parametrize("data_num", [-1, 4])
def test_readers_match_reference(tmp_path, data_num):
    files = _write_task_files(tmp_path, np.random.default_rng(0))
    assert sorted(tdata.READERS) == sorted(jdata.READERS)
    for family, reader in tdata.READERS.items():
        got = reader(files[family], data_num)
        want = jdata.READERS[family](files[family], data_num)
        assert [tuple(vars(e).values()) for e in got] == [tuple(vars(e).values()) for e in want]
        assert len(got) == (7 if data_num < 0 else 4)
    got = tdata.read_clone_examples(files["clone"], data_num)
    want = jdata.read_clone_examples(files["clone"], data_num)
    assert [tuple(vars(e).values()) for e in got] == [tuple(vars(e).values()) for e in want]
    assert len(got) == (14 if data_num < 0 else 4)


def test_collate_and_batches_match_reference():
    rng = np.random.default_rng(1)
    src = rng.integers(0, VOCAB, (11, 9)).astype(np.int32)
    tgt = rng.integers(0, VOCAB, (11, 5)).astype(np.int32)
    for seed in (None, 3):
        got = tdata.batches_of(src, tgt, 1, 4, pad_id=0, shuffle_seed=seed)
        want = jdata.batches_of(src, tgt, 1, 4, pad_id=0, shuffle_seed=seed)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for f in ("source_ids", "target_ids", "row_mask"):
                np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f))[0])
    with pytest.raises(NotImplementedError, match="one card"):
        tdata.batches_of(src, tgt, 2, 4)
    pairs = rng.integers(0, VOCAB, (5, 2, 9)).astype(np.int32)
    labels = [0, 1, 1, 0, 1]
    got = tclone.clone_batches_of(pairs, labels, 1, 2, shuffle_seed=4)
    want = jclone.clone_batches_of(pairs, labels, 1, 2, shuffle_seed=4)
    for g, w in zip(got, want):
        for f in ("pair_ids", "labels", "row_mask"):
            np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(w, f))[0])


def test_corpus_bleu_matches_reference():
    rng = np.random.default_rng(2)
    words = [str(i) for i in range(9)]
    refs = [[list(rng.choice(words, int(rng.integers(1, 12))))
             for _ in range(int(rng.integers(1, 3)))] for _ in range(20)]
    hyps = [list(rng.choice(words, int(rng.integers(0, 12)))) for _ in range(20)]
    assert tbleu.corpus_bleu(refs, hyps) == jbleu.corpus_bleu(refs, hyps)
    assert tbleu.corpus_bleu(refs, hyps) > 0
    kw = frozenset(words[:3])
    assert (tbleu.weighted_corpus_bleu(refs, hyps, kw)
            == jbleu.weighted_corpus_bleu(refs, hyps, kw))
    assert tbleu.corpus_bleu([[["a"]]], [[]]) == jbleu.corpus_bleu([[["a"]]], [[]]) == 0.0


# -- GenTrainer against the reference ------------------------------------------------


def _gen_corpus(n=12, S=20, T=10, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, VOCAB, (n, S)).astype(np.int32)
    tgt = rng.integers(3, VOCAB, (n, T)).astype(np.int32)
    for i in range(n):
        src[i, int(rng.integers(4, S)):] = 0
        end = int(rng.integers(2, T))
        tgt[i, end] = 2
        tgt[i, end + 1:] = 0
    return src, tgt


def test_gen_trainer_trajectory_ppl_and_bleu_match_reference(flash_interpret):
    """4 SGD steps (clip 1.0) of the reference GenTrainer (one-device
    mesh) and the port's from the same weights over the same batches (the
    last one half padding rows), then dev perplexity on the trained
    weights, and beam-search BLEU/EM on them with an untied LM head added
    (its random rows make the decoded sequences varied; the tied random
    model repeats a token or ends at once) against references that are
    half the decoded sequences themselves (so EM and BLEU are not 0)."""
    jcfg, tcfg = _cfgs()
    jenc, tenc = _enc()
    jg = jgen.GenConfig(encoder=jenc, max_target_length=10, beam_size=2)
    tg = GenConfig(encoder=tenc, max_target_length=10, beam_size=2)
    jtr = jgen_loop.GenTrainer(jcfg, jg, mesh=_mesh(jcfg), total_steps=4)
    jstate = jtr.init_state()
    trainer = GenTrainer(tcfg, tg, total_steps=4, device="cpu")
    state = trainer.init_state(params=from_jax_gen_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))))
    src, tgt = _gen_corpus()
    jb = jdata.batches_of(src[:14], tgt[:14], 1, 4)
    tb = tdata.batches_of(src[:14], tgt[:14], 1, 4)
    jl, tl = [], []
    for i in range(4):
        b = i % len(jb)
        jstate, loss = jtr.train_step(jstate, jb[b], jax.random.key(i))
        jl.append(float(loss))
        tl.append(float(trainer.train_step(state, tb[b].to("cpu"), fold_seed(0, i))))
    assert len(set(np.round(tl, 5))) > 1 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = {k: v.numpy() for k, v in from_jax_gen_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))).items()}
    errs = _leaf_errors(_state_np(state.model), want)
    assert max(errs.values()) <= 1e-4, errs

    np.testing.assert_allclose(trainer.eval_ppl(state, tb), jtr.eval_ppl(jstate, jb), rtol=1e-5)
    params = jax.tree.map(np.array, jax.device_get(jstate.params))
    params["decoder"]["lm_head"] = (np.random.default_rng(6).standard_normal(
        (VOCAB, jenc.hidden_size)) * 0.2).astype(np.float32)
    untied = T5Seq2Seq(tg, untied_head=True)
    untied.load_state_dict(from_jax_gen_params(params), strict=True)
    jparams = jax.tree.map(jax.numpy.asarray, params)
    decoded = jtr.decode(jparams, src[:6])
    assert len({tuple(x) for x in decoded}) > 2
    refs = decoded[:3] + jgen.trim_at_eos(tgt[3:6], 2, 0)
    got = trainer.eval_bleu_em(untied, src[:6], refs, return_preds=True)
    exp = jtr.eval_bleu_em(jparams, src[:6], refs, return_preds=True)
    assert got["preds"] == exp["preds"]
    assert (got["bleu"], got["em"], got["bleu_em"]) == (exp["bleu"], exp["em"], exp["bleu_em"])
    assert got["em"] >= 50.0 and got["bleu"] > 0


def _scripted_trainer(tmp_path, ppls, bleus):
    """A tiny port GenTrainer whose dev perplexity and BLEU+EM follow the
    given scripts, epoch by epoch."""
    _, tcfg = _cfgs()
    _, tenc = _enc()
    trainer = GenTrainer(tcfg, GenConfig(encoder=tenc, max_target_length=6), device="cpu")
    it_ppl, it_bleu = iter(ppls), iter(bleus)
    trainer.eval_ppl = lambda state, batches: next(it_ppl)
    trainer.eval_bleu_em = lambda state, src, refs: {"bleu": 0.0, "em": 0.0,
                                                     "bleu_em": next(it_bleu)}
    return trainer


def test_fit_keeps_best_checkpoints_and_stops_on_both_counters(tmp_path):
    """The best-ppl and best-BLEU checkpoints follow their own metrics; fit
    stops only when both no-improvement counters exceed the patience
    (run_gen.py:398-405), and never on ppl alone without BLEU eval."""
    src, tgt = _gen_corpus(n=4)
    batches = tdata.batches_of(src, tgt, 1, 4)
    ppls = [5.0, 4.0, 4.5, 4.6, 4.7, 4.8, 4.9]
    bleus = [1.0, 1.0, 2.0, 1.5, 1.4, 1.3, 1.2]
    trainer = _scripted_trainer(tmp_path, ppls, bleus)
    state = trainer.init_state()
    ckpts = trainer.make_checkpoints(tmp_path / "ppl")
    bleu_ckpts = trainer.make_checkpoints(tmp_path / "bleu", monitor="val_bleu_em", mode="max")
    records = []
    trainer.fit(state, lambda e: batches, val_batches=lambda: batches,
                val_decode=(src, [[1]] * 4), checkpoints=ckpts, bleu_checkpoints=bleu_ckpts,
                max_epochs=7, patience=1, log_fn=records.append)
    # ppl stalls from epoch 2, BLEU from epoch 3: both counters exceed 1 at epoch 4
    assert [r["epoch"] for r in records] == [0, 1, 2, 3, 4]
    assert ckpts.best_metrics() == {"val_ppl": 4.0}
    assert bleu_ckpts.best_metrics() == {"val_bleu_em": 2.0}
    assert sorted(t for t in ckpts.available_tags() if t != "best") == ["epoch-0000",
                                                                       "epoch-0001"]
    assert sorted(t for t in bleu_ckpts.available_tags() if t != "best") == ["epoch-0000",
                                                                            "epoch-0002"]
    # without BLEU eval the BLEU counter is infinite: ppl alone decides
    trainer = _scripted_trainer(tmp_path, ppls, bleus)
    records = []
    trainer.fit(trainer.init_state(), lambda e: batches, val_batches=lambda: batches,
                max_epochs=7, patience=1, log_fn=records.append)
    assert [r["epoch"] for r in records] == [0, 1, 2, 3]
    assert all(np.isfinite(r["train_loss"]) for r in records)


class _Tagged:
    """A stand-in batch naming its task."""

    def __init__(self, name):
        self.name = name

    def to(self, device):
        return self


class _Recorder:
    """A stand-in trainer recording the task of each step (both packages'
    fit_multi call only train_step while no task evaluates; the port's
    reads the config's sanitizer switches first)."""

    device = "cpu"
    cfg = tconfig.Config()

    def __init__(self, port: bool):
        self.port, self.order = port, []

    def train_step(self, state, batch, key):
        self.order.append(batch.name)
        if self.port:
            state.step += 1
            return torch.zeros(())
        return state, 0.0


class _Step:
    step = 0
    model = torch.nn.Module()


def test_fit_multi_draws_the_reference_task_order():
    sizes = {"summarize_python": 100, "translate_java-cs": 30, "defect": 7}

    def tasks(mod):
        return [mod.GenTask(name, lambda e, name=name: [_Tagged(name)] * 3, size=n)
                for name, n in sizes.items()]

    np.testing.assert_allclose(tmulti.mixture_probs(list(sizes.values())),
                               jmulti.mixture_probs(list(sizes.values())))
    for seed in (0, 7):
        port, ref = _Recorder(True), _Recorder(False)
        tmulti.fit_multi(port, _Step(), tasks(tmulti), max_steps=60, eval_every=1000, seed=seed)
        jmulti.fit_multi(ref, _Step(), tasks(jmulti), max_steps=60, eval_every=1000, seed=seed)
        assert port.order == ref.order and len(port.order) == 60
        assert len(set(port.order)) == 3
    for name in ("summarize", "translate", "refine_small", "refine_medium", "concode", "defect",
                 "other"):
        assert tmulti.task_target_length(name) == jmulti.task_target_length(name)
        assert (tmulti.GenTask(name, None, 1).resolved_patience()
                == jmulti.GenTask(name, None, 1).resolved_patience())


# -- CloneTrainer against the reference ----------------------------------------------


def test_clone_trainer_trajectory_and_metrics_match_reference(flash_interpret):
    jcfg, tcfg = _cfgs()
    jenc, tenc = _enc()
    jtr = jclone.CloneTrainer(jcfg, jgen.CloneConfig(encoder=jenc), mesh=_mesh(jcfg),
                              total_steps=4)
    jstate = jtr.init_state()
    trainer = tclone.CloneTrainer(tcfg, CloneConfig(encoder=tenc), total_steps=4, device="cpu")
    state = trainer.init_state(params=from_jax_clone_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))))
    rng = np.random.default_rng(9)
    pairs = rng.integers(3, VOCAB, (10, 2, 18)).astype(np.int32)
    for i in range(10):
        for j in range(2):
            end = int(rng.integers(4, 17))
            pairs[i, j, end] = 2
            pairs[i, j, end + 1:] = 0
    labels = [i % 2 for i in range(10)]
    jb = jclone.clone_batches_of(pairs, labels, 1, 4)
    tb = tclone.clone_batches_of(pairs, labels, 1, 4)
    jl, tl = [], []
    for i in range(4):
        b = i % len(jb)
        jstate, loss = jtr.train_step(jstate, jb[b], jax.random.key(i))
        jl.append(float(loss))
        tl.append(float(trainer.train_step(state, tb[b].to("cpu"), fold_seed(0, i))))
    assert len(set(np.round(tl, 6))) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = {k: v.numpy() for k, v in from_jax_clone_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))).items()}
    errs = _leaf_errors(_state_np(state.model), want)
    assert max(errs.values()) <= 1e-4, errs
    got_m, _ = trainer.evaluate(state, tb)
    want_m, _ = jtr.evaluate(jstate, jb)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, atol=1e-6, err_msg=k)


# -- the command line ------------------------------------------------------------------


def _cli_files(tmp_path):
    rng = np.random.default_rng(11)
    files = _write_task_files(tmp_path, rng, n=10)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({**CFG, "train": {**CFG["train"], "max_epochs": 2}}))
    return files, str(cfg_path)


def test_cli_train_gen_end_to_end(tmp_path, monkeypatch, capsys):
    """`train-gen --tiny --device cpu` with dev BLEU and a test file: two
    epochs, the best-ppl and best-BLEU checkpoints, the best-ppl weights
    restored for test decoding and the reference's result files."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    files, cfg_path = _cli_files(tmp_path)
    cli.main(["train-gen", "--task", "summarize", "--tiny", "--device", "cpu",
              "--config", cfg_path, "--train-file", files["summarize"],
              "--dev-file", files["summarize"], "--test-file", files["summarize"],
              "--do-eval-bleu", "--max-source-length", "32", "--max-target-length", "8",
              "--beam-size", "2", "--batch-size", "4", "--vocab-size", "128"])
    out = capsys.readouterr().out
    assert "best:" in out and "test_bleu" in out
    run = tmp_path / "runs" / "port-gen"
    records = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and "val_ppl" in r and "val_bleu_em" in r
               for r in records)
    for d in (cli.GEN_CHECKPOINTS_DIR, cli.GEN_BLEU_CHECKPOINTS_DIR):
        assert json.loads((run / d / "manifest.json").read_text())["best"] is not None
    outputs = (run / "results" / "test_best-ppl.output").read_text().splitlines()
    gold = (run / "results" / "test_best-ppl.gold").read_text().splitlines()
    assert len(outputs) == len(gold) == 10
    assert [x.split("\t")[0] for x in gold] == [str(i if i % 2 == 0 else 100 + i)
                                                for i in range(10)]


def test_cli_train_multi_gen_and_clone_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    files, cfg_path = _cli_files(tmp_path)
    cli.main(["train-multi-gen", "--tiny", "--device", "cpu", "--config", cfg_path,
              "--task-spec", f"summarize_python={files['summarize']}:{files['summarize']}",
              "--task-spec", f"concode={files['concode']}",
              "--max-steps", "4", "--eval-every", "2", "--batch-size", "4",
              "--max-source-length", "32", "--max-target-length", "8", "--vocab-size", "128"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["tasks"]
    assert summary["summarize_python"]["best_ppl"] is not None
    assert summary["concode"]["best_ppl"] is None  # no dev file
    run = tmp_path / "runs" / "port-gen"
    assert (run / "checkpoints-multi-summarize_python-torch" / "best").is_dir()

    cli.main(["train-clone", "--tiny", "--device", "cpu", "--config", cfg_path,
              "--train-file", files["clone"], "--dev-file", files["clone"],
              "--test-file", files["clone"], "--batch-size", "4",
              "--max-source-length", "24", "--vocab-size", "128"])
    out = capsys.readouterr().out.strip().splitlines()
    test = json.loads(out[-1])
    assert {"test_f1", "test_acc", "test_loss"} <= set(test) and np.isfinite(test["test_loss"])
    assert (run / cli.CLONE_CHECKPOINTS_DIR / "best").is_dir()


@pytest.mark.parametrize("cmd", [["train-gen", "--task", "summarize"], ["train-clone"],
                                 ["train-multi-gen", "--task-spec", "summarize=x"]])
def test_cli_refuses_unported_training_options(tmp_path, monkeypatch, cmd):
    """Every generation command trains under the sanitizers
    (`train.debug_nans`, `train.enable_checks`); `train-gen` also under the
    resilient runtime and the obs instruments, which `train-multi-gen` and
    `train-clone` refuse, naming the reference's loops, which do not run
    them either."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    files, cfg_path = _cli_files(tmp_path)
    data = {"train-gen": ["--train-file", files["summarize"]],
            "train-clone": ["--train-file", files["clone"]],
            "train-multi-gen": ["--task-spec", f"summarize={files['summarize']}",
                                "--max-steps", "3"]}[cmd[0]]
    base = [cmd[0], *cmd[1:3 if cmd[0] == "train-gen" else 1], "--tiny", "--device", "cpu",
            "--config", cfg_path, *data, "--batch-size", "4", "--max-source-length", "24",
            "--vocab-size", "128", *(["--max-target-length", "8"]
                                     if cmd[0] != "train-clone" else [])]
    cli.main([*base, "train.debug_nans=true", "train.enable_checks=true"])
    hooks = ["train.resilience.enabled=true", "obs.metrics=true"]
    if cmd[0] == "train-gen":
        cli.main([*base, *hooks, 'run_name="hooks"'])
        run = tmp_path / "runs" / "hooks"
        assert (run / cli.GEN_STEP_CHECKPOINTS_DIR / "resume.json").is_file()
        records = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
        assert all(r["skipped_steps"] == 0 and "obs" in r for r in records)
        return
    for over in hooks:
        with pytest.raises(NotImplementedError, match="reference's `train-multi-gen`"):
            cli.main([*base, over])


@pytest.mark.parametrize("cmd", ["train-gen", "train-clone", "train-multi-gen"])
def test_cli_takes_pretrained_bpe_and_attn_saved(tmp_path, monkeypatch, capsys, cmd):
    """What the generation commands refused before this slice now trains:
    `--tokenizer bpe --vocab-file --merges-file` (the shipped BPE frames
    the model: its vocabulary, pad 1, eos 2), `--pretrained` (a Hugging
    Face T5ForConditionalGeneration state_dict; at learning rate 0 the
    saved weights are the imported ones, bit for bit) and
    `--remat-policy attn_saved`."""
    transformers = pytest.importorskip("transformers")
    from deepdfa_tpu_torch.data.tokenizer import BPE_C_DIR, BpeTokenizer, bpe_files
    from deepdfa_tpu_torch.models import t5_gen as tgen
    from deepdfa_tpu_torch.train import CheckpointManager

    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    files, cfg_path = _cli_files(tmp_path)
    vocab, merges = bpe_files(BPE_C_DIR)
    tok = BpeTokenizer(vocab, merges)
    torch.manual_seed(0)
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=tok.vocab_size, d_model=64, num_layers=2, num_decoder_layers=2, num_heads=4,
        d_kv=16, d_ff=128, relative_attention_num_buckets=32,
        relative_attention_max_distance=128, dropout_rate=0.0, feed_forward_proj="relu",
        decoder_start_token_id=tok.pad_id, eos_token_id=tok.sep_id, pad_token_id=tok.pad_id))
    torch.save(hf.state_dict(), tmp_path / "hf.pt")
    flags = ["--tiny", "--device", "cpu", "--config", cfg_path, "--tokenizer", "bpe",
             "--vocab-file", str(vocab), "--merges-file", str(merges), "--pretrained",
             str(tmp_path / "hf.pt"), "--remat-policy", "attn_saved", "--batch-size", "4",
             "--max-source-length", "32"]
    run = tmp_path / "runs" / "port-gen"
    if cmd == "train-gen":
        cli.main([cmd, "--task", "summarize", "--train-file", files["summarize"],
                  "--dev-file", files["summarize"], "--max-target-length", "8", *flags,
                  "train.optim.learning_rate=0.0"])
        saved = run / cli.GEN_CHECKPOINTS_DIR
    elif cmd == "train-clone":
        cli.main([cmd, "--train-file", files["clone"], "--dev-file", files["clone"], *flags,
                  "train.optim.learning_rate=0.0"])
        saved = run / cli.CLONE_CHECKPOINTS_DIR
    else:
        cli.main([cmd, "--task-spec", f"summarize_python={files['summarize']}:"
                  f"{files['summarize']}", "--max-steps", "2", "--eval-every", "2",
                  "--max-target-length", "8", *flags, "train.optim.learning_rate=0.0"])
        saved = run / "checkpoints-multi-summarize_python-torch"
    capsys.readouterr()
    gcfg = GenConfig(encoder=T5Config.tiny(vocab_size=tok.vocab_size, pad_token_id=tok.pad_id,
                                           eos_token_id=tok.sep_id))
    want = tgen.gen_params_from_hf_torch(gcfg, hf.state_dict())
    got = CheckpointManager(saved).restore("best")["model"]
    if cmd == "train-clone":
        got = {k[len("seq2seq."):]: v for k, v in got.items() if k.startswith("seq2seq.")}
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_clone_trainer_warm_starts_from_a_seq2seq_state():
    """load_seq2seq puts a generation model's weights (an untied LM head
    dropped, as the reference drops it) under the clone head, with a
    fresh optimiser and the step kept; the reference's load_seq2seq on
    the same tree gives the same clone parameters."""
    jcfg, tcfg = _cfgs()
    jenc, tenc = _enc()
    params = jax.tree.map(np.array, jgen.init_gen_params(jgen.GenConfig(encoder=jenc),
                                                        jax.random.key(3)))
    params["decoder"]["lm_head"] = np.ones((VOCAB, jenc.hidden_size), np.float32)
    jtr = jclone.CloneTrainer(jcfg, jgen.CloneConfig(encoder=jenc), mesh=_mesh(jcfg))
    want = from_jax_clone_params(jax.tree.map(np.asarray, jax.device_get(
        jtr.load_seq2seq(jtr.init_state(), params).params)))
    trainer = tclone.CloneTrainer(tcfg, CloneConfig(encoder=tenc), device="cpu")
    state = trainer.init_state(params=from_jax_clone_params(
        jax.tree.map(np.asarray, jax.device_get(jtr.init_state().params))))
    state.step = 3
    state = trainer.load_seq2seq(state, from_jax_gen_params(params))
    assert state.step == 3 and not state.optimizer.state
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
