"""The port's evaluation tools (deepdfa_tpu_torch/frontend/tokenise.py,
eval/ivdetect.py, eval/coverage.py, eval/trivial_baseline.py, `cli
ivdetect`) against the reference's, on the CPU.

- `tokenise`/`tokenise_lines`: the reference test's strings and 200
  seeded soups of identifiers, punctuation and unicode, exactly;
- IVDetect's per-line features (every row, the PDG line edges) and
  `dump_features`' JSON, byte for byte, on the reference test's function,
  the fidelity corpus and 64 seeded synthetic functions, under the
  default (native) lexer and under the Python lexer of both packages;
  `cli ivdetect` writes the reference's files;
- `coverage_report` over seeded stores built by each package: the
  reference's dict;
- `logistic_control` (pure numpy): histograms exactly, the fitted
  weights and every metric within 1e-6 of the reference's.
"""

import contextlib
import dataclasses
import importlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from deepdfa_tpu import native as ref_native  # noqa: E402
from deepdfa_tpu.data import pipeline as ref_pipeline  # noqa: E402
from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.eval import ivdetect as ref_ivdetect  # noqa: E402
from deepdfa_tpu.eval import trivial_baseline as ref_trivial  # noqa: E402
from deepdfa_tpu.frontend import tokenise as ref_tokenise  # noqa: E402

from deepdfa_tpu_torch import cli, native  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic  # noqa: E402
from deepdfa_tpu_torch.eval import coverage, ivdetect, trivial_baseline  # noqa: E402
from deepdfa_tpu_torch.frontend import tokenise  # noqa: E402

# the reference package's `eval` exports a `coverage` function that
# shadows the module of that name
ref_coverage = importlib.import_module("deepdfa_tpu.eval.coverage")

ROOT = Path(__file__).resolve().parent
CORPUS = {p.name: p.read_text() for p in sorted((ROOT / "fidelity_corpus").glob("*.c*"))}
TOL = 1e-6

#: the reference test's function (tests/test_ivdetect.py)
CODE = """int scale(int nval, int kval) {
  int acc = 0;
  int step = kval + 1;
  if (nval > 10) {
    acc = nval * step;
  }
  return acc;
}
"""


@contextlib.contextmanager
def python_paths():
    """Both packages' lexer and solver without their native libraries."""
    saved = ref_native.available, native.available
    ref_native.available = native.available = lambda: False
    try:
        yield
    finally:
        ref_native.available, native.available = saved


def _soups(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = ["FooBar", "fooBar", "HTTPServer", "parseURLQuery", "x", "a1", "bar_blub23",
             "getXMLHttpRequest", "IO", "ÄpfelBaum", "naïveCount", "k", "ID2Name", "__init__",
             "snake_case_name", "CONST_VALUE", "i", "é"]
    punct = list("/~'\"(){}[];,.-+*&|!<>=?:%^#@$\\") + [" ", "  ", "\t", "\n", "\n\n"]
    out = []
    for _ in range(n):
        parts = [words[int(rng.integers(len(words)))] if rng.random() < 0.6
                 else punct[int(rng.integers(len(punct)))] for _ in range(int(rng.integers(0, 24)))]
        out.append("".join(parts))
    return out


def test_tokenise_equals_reference():
    cases = ["FooBar fooBar foo bar_blub23/x~y'z", "line1a line1b\nline2a asdf\nf f f f f\na",
             "", "\n", CODE, *CORPUS.values(), *_soups(200, seed=5)]
    for s in cases:
        assert tokenise.tokenise(s) == ref_tokenise.tokenise(s), s
        assert tokenise.tokenise_lines(s) == ref_tokenise.tokenise_lines(s), s
    assert len(tokenise.tokenise_lines(cases[1])) == 2


def _functions() -> dict[str, str]:
    out = {"reference_test": CODE, **{f"corpus/{k}": v for k, v in CORPUS.items()}}
    sizes = ref_synthetic.bigvul_stmt_sizes(64, seed=9)
    for e in ref_synthetic.generate(64, seed=9, stmt_sizes=sizes, vuln_rate=0.5):
        out[f"synthetic/{e.id}"] = e.before
    return out


def _features(mod, code):
    try:
        rows, pdg = mod.feature_extraction_code(code)
    except Exception as e:  # the packages must fail alike
        return type(e).__name__
    return [dataclasses.asdict(r) for r in rows], pdg


@pytest.mark.parametrize("lexer", ["default", "python"])
def test_ivdetect_features_equal_reference(lexer):
    ctx = python_paths() if lexer == "python" else contextlib.nullcontext()
    differ, rows = [], 0
    with ctx:
        for name, code in _functions().items():
            got, want = _features(ivdetect, code), _features(ref_ivdetect, code)
            if got != want:
                differ.append(name)
            elif not isinstance(got, str):
                rows += len(got[0])
    assert differ == []
    assert rows > 1000


def test_ivdetect_reference_answers():
    """The reference tests' expectations, on the port."""
    rows, pdg = ivdetect.feature_extraction_code(CODE)
    by = {r.line: r for r in rows}
    assert set(by) >= {2, 3, 4, 5, 7}
    assert by[3].subseq.startswith("int") and "step" in by[3].subseq
    assert "nval" in by[5].subseq
    parents, children, codes = by[5].ast
    assert len(parents) == len(children) and 0 in parents
    assert 2 in by[5].data and 4 in by[5].control
    assert all(isinstance(x, int) for x in pdg[0] + pdg[1])


@pytest.mark.parametrize("lexer", ["default", "python"])
def test_dump_features_and_cli_ivdetect_write_the_reference_bytes(tmp_path, lexer):
    ctx = python_paths() if lexer == "python" else contextlib.nullcontext()
    names = ["reference_test", *[f"corpus/{k}" for k in sorted(CORPUS)[:6]]]
    funcs = _functions()
    src_dir = tmp_path / "src"
    src_dir.mkdir()
    paths = []
    with ctx:
        for i, name in enumerate(names):
            code = funcs[name]
            ivdetect.dump_features(code, tmp_path / f"port{i}.json")
            ref_ivdetect.dump_features(code, tmp_path / f"ref{i}.json")
            assert (tmp_path / f"port{i}.json").read_bytes() == \
                (tmp_path / f"ref{i}.json").read_bytes(), name
            p = src_dir / f"f{i}.c"
            p.write_text(code)
            paths.append(p)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["ivdetect", *map(str, paths), "--out-dir", str(tmp_path / "out")])
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["ivdetect", str(paths[0])])  # beside the source
    assert out.getvalue().split() == [str(tmp_path / "out" / f"f{i}.ivdetect.json")
                                      for i in range(len(names))]
    for i in range(len(names)):
        assert (tmp_path / "out" / f"f{i}.ivdetect.json").read_bytes() == \
            (tmp_path / f"ref{i}.json").read_bytes()
    assert (src_dir / "f0.ivdetect.json").read_bytes() == (tmp_path / "ref0.json").read_bytes()
    json.loads((tmp_path / "ref0.json").read_text())["lines"]


@pytest.fixture(scope="module")
def stores():
    """(port specs, reference specs) of one seeded v2 corpus at two
    vocabulary limits, split 3:1 by id."""
    def build(synth_mod, pipe_mod, limit):
        ex = synth_mod.to_examples(synth_mod.generate_v2(
            160, vuln_rate=0.5, seed=4, lookalike_rate=0.5, label_noise=0.02))
        train = range(120)
        specs, _ = pipe_mod.build_dataset(ex, train_ids=train, limit_all=limit,
                                          limit_subkeys=limit)
        return {"train": [s for s in specs if s.graph_id in train],
                "test": [s for s in specs if s.graph_id not in train]}

    return {limit: (build(synthetic, pipeline, limit), build(ref_synthetic, ref_pipeline, limit))
            for limit in (8, 64)}


@pytest.mark.parametrize("limit", [8, 64])
def test_coverage_report_equals_reference(stores, limit):
    ours, theirs = stores[limit]
    got = coverage.coverage_report(ours)
    assert got == ref_coverage.coverage_report(theirs)
    assert got["train"]["n_def_nodes"] > 0 and got["test"]["n_known"] > 0
    for col in range(4):
        assert coverage.coverage(ours["test"], col).as_dict() == \
            ref_coverage.coverage(theirs["test"], col).as_dict()
    assert coverage.coverage([]).as_dict() == ref_coverage.coverage([]).as_dict()


@pytest.mark.parametrize("limit", [8, 64])
def test_logistic_control_equals_reference(stores, limit):
    ours, theirs = stores[limit]
    dim = limit + 2
    X = trivial_baseline.subkey_histograms(ours["train"], dim)
    assert np.array_equal(X, ref_trivial.subkey_histograms(theirs["train"], dim))
    y = np.array([s.label for s in ours["train"]])
    w, b = trivial_baseline.train_logistic(X, y, seed=3)
    rw, rb = ref_trivial.train_logistic(X, y, seed=3)
    assert np.abs(w - rw).max() <= TOL and abs(b - rb) <= TOL
    got = trivial_baseline.logistic_control(ours["train"], ours, dim, seed=1)
    want = ref_trivial.logistic_control(theirs["train"], theirs, dim, seed=1)
    assert got.keys() == want.keys()
    for split in got:
        assert got[split].keys() == want[split].keys()
        for k, v in got[split].items():
            assert abs(v - want[split][k]) <= TOL, (split, k)
    assert trivial_baseline.subkey_histograms([], dim).shape == (0, 0)
    probs = np.array([0.1, 0.6, 0.7, 0.2])
    labels = np.array([0, 1, 0, 1])
    assert trivial_baseline.binary_metrics(probs, labels) == \
        ref_trivial.binary_metrics(probs, labels)
