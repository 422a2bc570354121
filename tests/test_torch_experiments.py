"""The port's experiment tools (deepdfa_tpu_torch/train/logging.py,
nni_bridge.py, tuning.py, experiments.py, data/tokenizer_training.py,
`cli train`'s logger and NNI hooks, `cli run-exp`, `cli coverage`)
against the reference's, on the CPU.

- `RunLogger`: the jsonl the reference's writes, byte for byte, over
  records with nested dicts, strings, bools and non-finite values; the
  non-finite values dropped from the TensorBoard mirror and counted
  (`obs/logging/nonfinite_dropped`), collisions counted; event files where
  `torch.utils.tensorboard` imports; `NullRunLogger` writes nothing;
- `nni_bridge` against a stubbed `nni` module: the reference's calls,
  one for one, and nothing without `NNI_PLATFORM`; `cli train` under it;
- `SearchSpace`/`random_search`/`grid_search`: the reference's override
  strings for the same seeds; `Tuner`: the reference's trials, ledger
  and best for a fixed `train_fn`;
- `expand_matrix`, `load_matrix`, `parse_result`, `run_matrix`'s dry run
  and failure rows as the reference's; every `TASK_DEFAULTS` run parses
  with the port's CLI parser; `cli run-exp` (two `cli train`
  subprocesses) and `cli coverage` in-process over a small CPU store;
- `train_bpe`/`train_word_level`: the reference's files byte for byte;
  without `tokenizers` an ImportError naming it.
"""

import contextlib
import importlib
import io
import json
import math
import sys
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from deepdfa_tpu.core import config as ref_config  # noqa: E402
from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.data import tokenizer_training as ref_tokenizer_training  # noqa: E402
from deepdfa_tpu.graphs import GraphStore as RefGraphStore  # noqa: E402
from deepdfa_tpu.obs import metrics as ref_metrics  # noqa: E402
from deepdfa_tpu.train import experiments as ref_experiments  # noqa: E402
from deepdfa_tpu.train import logging as ref_logging  # noqa: E402
from deepdfa_tpu.train import nni_bridge as ref_nni  # noqa: E402
from deepdfa_tpu.train import tuning as ref_tuning  # noqa: E402

from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic, tokenizer_training  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphStore  # noqa: E402
from deepdfa_tpu_torch.obs import metrics as obs_metrics  # noqa: E402
from deepdfa_tpu_torch.train import experiments, nni_bridge, tuning  # noqa: E402
from deepdfa_tpu_torch.train import logging as run_logging  # noqa: E402

ref_coverage = importlib.import_module("deepdfa_tpu.eval.coverage")

RECORDS = [
    {"epoch": 0, "train_loss": 1.5, "note": "x", "ok": True},
    {"step": 3, "loss": float("nan"), "lr": 1e-3},
    {"epoch": 1, "train_loss": float("inf"), "val_loss": -float("inf"),
     "step_signatures": {"G4xN64": {"compiles": 1, "steps": 7.5}},
     "step_signatures/G4xN64/compiles": 2},
    {"epoch": 2, "val_f1": 0.25, "ledger": {"sites": {"a": {"flops": 1e12}}}},
]


def _counter(mod, name):
    return mod.REGISTRY.counter(name).value


# -- the run logger --------------------------------------------------------


@pytest.mark.parametrize("tensorboard", [True, False])
def test_run_logger_equals_reference(tmp_path, tensorboard):
    drops = (_counter(obs_metrics, "obs/logging/nonfinite_dropped"),
             _counter(ref_metrics, "obs/logging/nonfinite_dropped"))
    coll = (_counter(obs_metrics, "obs/logging/flatten_collisions"),
            _counter(ref_metrics, "obs/logging/flatten_collisions"))
    loggers = {}
    for name, mod in (("port", run_logging), ("ref", ref_logging)):
        with mod.RunLogger(tmp_path / name, tensorboard=tensorboard) as lg:
            for r in RECORDS:
                lg.log(r)
        lg.log({"epoch": 3, "after_close": 1.0})  # reopens the file
        lg.close()
        loggers[name] = lg
    port, ref = loggers["port"], loggers["ref"]
    assert (tmp_path / "port" / "train_log.jsonl").read_bytes() == \
        (tmp_path / "ref" / "train_log.jsonl").read_bytes()
    lines = (tmp_path / "port" / "train_log.jsonl").read_text().splitlines()
    assert len(lines) == 5 and "NaN" in lines[1] and "Infinity" in lines[2]
    assert port.has_tensorboard == ref.has_tensorboard
    assert port.nonfinite_dropped == ref.nonfinite_dropped
    if tensorboard and port.has_tensorboard:
        assert port.nonfinite_dropped == 3
        assert list((tmp_path / "port" / "tb").glob("events*"))
    else:
        assert port.nonfinite_dropped == 0 and not (tmp_path / "port" / "tb").exists()
    assert _counter(obs_metrics, "obs/logging/nonfinite_dropped") - drops[0] == \
        _counter(ref_metrics, "obs/logging/nonfinite_dropped") - drops[1]
    assert _counter(obs_metrics, "obs/logging/flatten_collisions") - coll[0] == \
        _counter(ref_metrics, "obs/logging/flatten_collisions") - coll[1]
    for r in RECORDS:
        assert run_logging.flatten_scalars(r) == ref_logging.flatten_scalars(r)
    null = run_logging.NullRunLogger()
    with null as n:
        n.log(RECORDS[0])
    assert (null.has_tensorboard, null.nonfinite_dropped) == (False, 0)


def test_run_logger_without_tensorboard_warns_once(tmp_path, monkeypatch, caplog):
    """Where torch.utils.tensorboard does not import, the mirror is off
    with one warning and the jsonl is written as before."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with caplog.at_level("WARNING"):
        with run_logging.RunLogger(tmp_path) as lg:
            lg.log(RECORDS[1])
    assert not lg.has_tensorboard and lg.nonfinite_dropped == 0
    assert len([r for r in caplog.records if "TensorBoard" in r.getMessage()]) == 1
    assert (tmp_path / "train_log.jsonl").read_text().count("\n") == 1


# -- NNI ---------------------------------------------------------------------


def _stub_nni(calls, params):
    stub = types.ModuleType("nni")
    stub.get_next_parameter = lambda: calls["get"].append(1) or dict(params)
    stub.report_intermediate_result = calls["intermediate"].append
    stub.report_final_result = calls["final"].append
    return stub


def _nni_trace(mod, monkeypatch, params):
    calls = {"get": [], "intermediate": [], "final": []}
    monkeypatch.setitem(sys.modules, "nni", _stub_nni(calls, params))
    monkeypatch.setenv("NNI_PLATFORM", "local")
    out = {"active": mod.active(), "overrides": mod.nni_overrides(),
           "params": mod.get_next_parameters()}
    inner = []
    log_fn = mod.intermediate_log_fn("val_loss", inner.append)
    for r in ({"epoch": 0, "val_loss": 0.7}, {"epoch": 1}, {"epoch": 2, "val_loss": 0.5}):
        log_fn(r)
    mod.intermediate_log_fn("val_f1")({"val_f1": 0.9})
    mod.report_intermediate(0.1)
    mod.report_final(0.42)
    out.update(calls=calls, inner=inner)
    return out


PARAMS = {"train.optim.learning_rate": 0.01, "model.hidden_dim": 16,
          "train.debug_nans": True, "run_name": "trial", "data.feat.max_defs": None}


def test_nni_bridge_with_a_stubbed_nni_equals_reference(monkeypatch):
    got = _nni_trace(nni_bridge, monkeypatch, PARAMS)
    want = _nni_trace(ref_nni, monkeypatch, PARAMS)
    assert got == want
    assert got["calls"]["intermediate"] == [0.7, 0.5, 0.9, 0.1]
    assert got["calls"]["final"] == [0.42] and len(got["calls"]["get"]) == 2
    cfg = config_mod.apply_overrides(config_mod.Config(), got["overrides"])
    assert (cfg.train.optim.learning_rate, cfg.model.hidden_dim, cfg.train.debug_nans,
            cfg.run_name, cfg.data.feat.max_defs) == (0.01, 16, True, "trial", None)


def test_nni_bridge_inactive_without_platform_or_package(monkeypatch, caplog):
    calls = {"get": [], "intermediate": [], "final": []}
    monkeypatch.setitem(sys.modules, "nni", _stub_nni(calls, PARAMS))
    monkeypatch.delenv("NNI_PLATFORM", raising=False)
    for mod in (nni_bridge, ref_nni):
        assert not mod.active() and mod.get_next_parameters() == {}
        assert mod.nni_overrides() == []
        mod.report_intermediate(0.5)
        mod.report_final(0.9)
        mod.intermediate_log_fn()({"val_loss": 1.0})
    assert calls == {"get": [], "intermediate": [], "final": []}
    monkeypatch.setenv("NNI_PLATFORM", "local")
    monkeypatch.setitem(sys.modules, "nni", None)
    with caplog.at_level("WARNING"):
        assert not nni_bridge.active() and not ref_nni.active()
    assert sum("nni package is missing" in r.getMessage() for r in caplog.records) == 2


# -- search ------------------------------------------------------------------

SPACES = [
    dict(choices={"model.hidden_dim": [8, 16, 32], "train.debug_nans": [True, False],
                  "data.feat.max_defs": [None, 8], "run_name": ["a", "b"]},
         ranges={"train.optim.learning_rate": (1e-5, 1e-2, True),
                 "train.optim.weight_decay": (0.0, 0.1),
                 "train.optim.warmup_frac": (0.0, 0.3, False)}),
    dict(ranges={"train.optim.learning_rate": (1e-4, 3e-3, True)}),
    dict(choices={"h": [10, 50, 30]}),
]


@pytest.mark.parametrize("space", range(len(SPACES)))
def test_search_spaces_equal_reference(space):
    ours, theirs = tuning.SearchSpace(**SPACES[space]), ref_tuning.SearchSpace(**SPACES[space])
    for seed in (0, 1, 17):
        got = list(tuning.random_search(ours, 6, seed=seed))
        assert got == list(ref_tuning.random_search(theirs, 6, seed=seed))
        assert got == list(tuning.random_search(ours, 6, seed=seed))
    if ours.ranges:
        with pytest.raises(ValueError, match="grid"):
            list(tuning.grid_search(ours))
    else:
        assert list(tuning.grid_search(ours)) == list(ref_tuning.grid_search(theirs))


def _tuner_run(mod, path, monitor, mode):
    def train_fn(overrides, report):
        report({"epoch": 0, "loss": 1.0})
        h = float(overrides[0].split("=")[1])
        report({"epoch": 1, "val_f1": h / 100.0})
        return {"val_f1": h / 100.0 if h != 30 else float("nan"), "val_loss": 1.0 - h / 100.0}

    tuner = mod.Tuner(path, monitor=monitor, mode=mode)
    space = mod.SearchSpace(choices={"h": [10, 50, 30, 40]})
    best = tuner.run(mod.grid_search(space), train_fn)
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    for r in rows:
        assert r.pop("seconds") >= 0
    return best, rows


@pytest.mark.parametrize("monitor, mode", [("val_f1", "max"), ("val_loss", "min"),
                                           ("missing", "max")])
def test_tuner_equals_reference(tmp_path, monitor, mode):
    got = _tuner_run(tuning, tmp_path / "port" / "ledger.jsonl", monitor, mode)
    want = _tuner_run(ref_tuning, tmp_path / "ref" / "ledger.jsonl", monitor, mode)
    assert json.dumps(got) == json.dumps(want)
    best, rows = got
    assert len(rows) == 4
    if monitor == "missing":
        assert best is None
    else:
        assert best["overrides"] == ["h=50"]


# -- the experiment runner ---------------------------------------------------


def test_matrix_and_results_equal_reference(tmp_path):
    assert experiments.TASK_DEFAULTS == ref_experiments.TASK_DEFAULTS
    kw = dict(seeds=[0, 1], extra_args=["--x"], overrides=["train.max_epochs=1"])
    got = experiments.expand_matrix(sorted(experiments.TASK_DEFAULTS), **kw)
    want = ref_experiments.expand_matrix(sorted(ref_experiments.TASK_DEFAULTS), **kw)
    assert [(r.name, r.cmd, r.args) for r in got] == [(r.name, r.cmd, r.args) for r in want]
    assert got[0].argv()[1:3] == ["-m", "deepdfa_tpu_torch.cli"]
    assert got[0].argv()[3:] == want[0].argv()[3:]
    with pytest.raises(ValueError, match="unknown task"):
        experiments.expand_matrix(["nope"])
    for text in ('x\n{"f1": 0.5}\n', "best: {'val_f1': 0.9}\n", "no json here",
                 '{"a": 1}\n{"b": 2}', "best: None\n", "best: {'a': nan}\n",
                 '{"a": [1, 2]}\n  \nnoise {bad}\n'):
        assert experiments.parse_result(text) == ref_experiments.parse_result(text), text
    spec = [{"name": "r1", "cmd": "train", "args": ["--x"]}]
    (tmp_path / "m.json").write_text(json.dumps(spec))
    runs = experiments.load_matrix(tmp_path / "m.json")
    assert runs == [experiments.Run(name="r1", cmd="train", args=("--x",))]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert experiments.run_matrix(runs, tmp_path / "out", dry_run=True) == \
            ref_experiments.run_matrix(runs, tmp_path / "ref_out", dry_run=True)
    assert "deepdfa_tpu_torch.cli train --x" in out.getvalue()


def test_every_task_default_parses_with_the_port_parser():
    parser = cli.build_parser()
    for run in experiments.expand_matrix(sorted(experiments.TASK_DEFAULTS), seeds=[0, 3]):
        args = parser.parse_args([run.cmd, *run.args])
        assert args.fn.__name__ == "cmd_" + run.cmd.replace("-", "_")
        assert args.overrides[-2:] == [f"train.seed={run.name[-1]}", f"run_name={run.name}"]
        cfg = config_mod.apply_overrides(config_mod.Config(), args.overrides)
        assert cfg.run_name == run.name


def test_run_matrix_records_a_failing_run(tmp_path, capsys):
    runs = [experiments.Run(name="bad", cmd="definitely-not-a-command", args=())]
    [summary] = experiments.run_matrix(runs, tmp_path / "out")
    assert summary["rc"] != 0 and summary["result"] is None
    assert "invalid choice" in (tmp_path / "out" / "bad.log").read_text()
    rows = [json.loads(x) for x in (tmp_path / "out" / "summary.jsonl").read_text().splitlines()]
    assert rows == [summary] and json.loads(capsys.readouterr().out) == summary


# -- the CLI over a small CPU store -------------------------------------------

STORE_CFG = {"run_name": "exp", "data": {"feat": {"limit_all": 18, "limit_subkeys": 18},
                                         "batch": {"graphs_per_batch": 8, "node_budget": 512,
                                                   "edge_budget": 2048}},
             "model": {"hidden_dim": 8, "n_steps": 2},
             "train": {"optim": {"name": "adamw", "learning_rate": 1e-2}, "seed": 3,
                       "max_epochs": 2, "prefetch_batches": 0, "log_every_steps": 1}}


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A graph store of 48 seeded synthetic functions under a temporary
    storage root; the config's path."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cfg = config_mod.from_dict(STORE_CFG)
    ex = synthetic.to_examples(synthetic.generate(48, vuln_rate=0.4, seed=6))
    specs, _ = pipeline.build_dataset(ex, train_ids=range(32), limit_all=18, limit_subkeys=18)
    out = tmp_path / "processed" / cfg.data.dataset
    GraphStore(out / cli.graphs_dirname(cfg)).write(specs)
    (out / "splits.json").write_text(json.dumps(
        {str(g.graph_id): "train" if g.graph_id < 32 else ("val", "test")[g.graph_id % 2]
         for g in specs}))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(STORE_CFG))
    return path


def test_cli_coverage_equals_reference(store, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["coverage", "--config", str(store)])
    got = json.loads(out.getvalue())
    cfg = ref_config.from_dict(STORE_CFG)
    proc = tmp_path / "processed" / cfg.data.dataset
    splits = json.loads((proc / "splits.json").read_text())
    by_id = RefGraphStore(proc / cli.graphs_dirname(config_mod.from_dict(STORE_CFG))).load_all()
    ref_splits = {"train": [], "val": [], "test": []}
    for gid, spec in by_id.items():
        ref_splits[splits[str(gid)]].append(spec)
    assert got == json.loads(json.dumps(ref_coverage.coverage_report(ref_splits)))
    assert set(got) == {"train", "val", "test"} and got["train"]["n_graphs"] == 32


def test_cli_train_logs_through_run_logger_and_nni(store, tmp_path, monkeypatch):
    """`cli train` under a stubbed NNI trial: the trial's parameters reach
    the saved config, every validation epoch reports train.monitor, the
    best checkpoint's value is the final report; the log has its
    TensorBoard mirror where it imports."""
    calls = {"get": [], "intermediate": [], "final": []}
    monkeypatch.setitem(sys.modules, "nni", _stub_nni(
        calls, {"train.optim.learning_rate": 0.02, "run_name": "trial"}))
    monkeypatch.setenv("NNI_PLATFORM", "local")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["train", "--config", str(store), "--device", "cpu"])
    run = tmp_path / "runs" / "trial"
    saved = json.loads((run / "config.json").read_text())
    assert saved["train"]["optim"]["learning_rate"] == 0.02 and len(calls["get"]) == 1
    log = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    vals = [r["val_loss"] for r in log if "val_loss" in r]
    assert len(vals) == 2 and calls["intermediate"] == vals
    best = experiments.parse_result(out.getvalue())
    assert calls["final"] == [best["val_loss"]] and best["val_loss"] == min(vals)
    from torch.utils import tensorboard  # noqa: F401  (imports here)

    assert list((run / "tb").glob("events*"))


def test_cli_run_exp_runs_train_subprocesses(store, tmp_path, capsys):
    cli.main(["run-exp", "--tasks", "deepdfa", "--seeds", "0", "1", "--tag", "t",
              f"--extra-arg=--config={store}", "--extra-arg=--device=cpu",
              "--override", "train.max_epochs=1"])
    out = tmp_path / "runs" / "experiments" / "t"
    rows = [json.loads(x) for x in (out / "summary.jsonl").read_text().splitlines()]
    assert [r["name"] for r in rows] == ["deepdfa_seed0", "deepdfa_seed1"]
    for r in rows:
        assert r["rc"] == 0 and r["cmd"] == "train", (out / f"{r['name']}.log").read_text()
        assert math.isfinite(r["result"]["val_loss"])
        log = tmp_path / "runs" / r["name"] / "train_log.jsonl"
        epochs = [x for x in map(json.loads, log.read_text().splitlines()) if "epoch" in x]
        assert len(epochs) == 1
        saved = json.loads((tmp_path / "runs" / r["name"] / "config.json").read_text())
        assert saved["train"]["seed"] == int(r["name"][-1])
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] == rows
    with pytest.raises(SystemExit, match="--matrix or --tasks"):
        cli.main(["run-exp"])


# -- tokenizer training --------------------------------------------------------


def _corpus():
    return [e.before for e in ref_synthetic.generate(60, vuln_rate=0.3, seed=4)]


def test_train_bpe_and_word_level_write_the_reference_files(tmp_path):
    pytest.importorskip("tokenizers")
    corpus = _corpus()
    for name, mod in (("port", tokenizer_training), ("ref", ref_tokenizer_training)):
        vocab, merges = mod.train_bpe(iter(corpus), tmp_path / name, vocab_size=400,
                                      min_frequency=1)
        assert (vocab.name, merges.name) == ("bpe_tokenizer-vocab.json",
                                             "bpe_tokenizer-merges.txt")
        mod.train_word_level(iter(corpus), tmp_path / name / "wl" / "wordlevel.json")
    for rel in ("bpe_tokenizer-vocab.json", "bpe_tokenizer-merges.txt", "wl/wordlevel.json"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes()
    from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer

    tok = BpeTokenizer(tmp_path / "port" / "bpe_tokenizer-vocab.json",
                       tmp_path / "port" / "bpe_tokenizer-merges.txt")
    ids = np.asarray(tok.encode("int f(char *src, int len) { return len; }", 32))
    assert ids[0] == tok.cls_id and (ids < tok.vocab_size).all()
    d = json.loads((tmp_path / "port" / "wl" / "wordlevel.json").read_text())
    assert [d["model"]["vocab"][t] for t in tokenizer_training.WORD_LEVEL_SPECIALS] == \
        [0, 1, 2, 3, 4]


def test_tokenizer_training_without_tokenizers_names_the_package(tmp_path, monkeypatch):
    for name in [m for m in sys.modules if m == "tokenizers" or m.startswith("tokenizers.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="tokenizers"):
        tokenizer_training.train_bpe(["int x;"], tmp_path)
    with pytest.raises(ImportError, match="tokenizers"):
        tokenizer_training.train_word_level(["int x;"], tmp_path / "w.json")
    assert not (tmp_path / "w.json").exists()
