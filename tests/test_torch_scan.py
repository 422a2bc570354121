"""The port's whole-repo scanner (`deepdfa_tpu_torch/scan/`) against the
reference's (`deepdfa_tpu/scan/`), on the CPU:

- `split_functions` and `walk_repo` exactly equal: the reference's tricky
  source, its walker-rule tree and seeded multi-function sources strewn
  with comments, strings, macros and declarations;
- `ScanManifest` documents and `sarif_report` documents equal for the
  same inputs, and `validate_sarif` finding the same damage;
- the port's `RepoScanner` against the reference's, each driven
  in-process over a namespace service (the reference's
  tests/test_scan.py pattern, never its registry restore) with the same
  weights carried through `convert.from_jax_params`, for the planar and
  the struct-feature GGNN: findings equal but for their scores, which
  agree within 1e-5 (probabilities) and 1e-5 of each function's largest
  line score (line attributions, the bound tests/test_torch_localize.py
  holds the localizer to); manifests and SARIF documents the same up to
  those scores;
- the incremental property, identity drift forcing a cold scan, and
  `cli scan --smoke --device cpu` plus a second `cli scan` of its
  repository in-process.
"""

import copy
import dataclasses
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.core import Config as JConfig, config as jconfig  # noqa: E402
from deepdfa_tpu.data import build_dataset as ref_build_dataset  # noqa: E402
from deepdfa_tpu.data import generate, to_examples  # noqa: E402
from deepdfa_tpu.graphs.batch import pack as jpack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.scan import manifest as ref_manifest  # noqa: E402
from deepdfa_tpu.scan import sarif as ref_sarif  # noqa: E402
from deepdfa_tpu.scan import scanner as ref_scanner  # noqa: E402
from deepdfa_tpu.scan import walker as ref_walker  # noqa: E402

from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.scan import manifest, sarif, scanner, walker  # noqa: E402

NODE_BUDGET, EDGE_BUDGET = 2048, 8192

#: the reference's tests/test_scan.py tricky translation unit
TRICKY = """/* file comment with { brace */
#include <stdio.h>
#define WRAP(x) { (x)++; }

static const int table[] = { 1, 2, 3 };

struct ops { int (*fn)(void); };

int add(int a, int b) {
  const char *s = "{ not a brace }";
  // } also not a brace
  return a + b;
}

static inline unsigned long
get_value(struct ops *o)
{
  if (o->fn) {
    return o->fn();
  }
  return 0;
}

int (*pick(void))(void) {
  return 0;
}

namespace foo {
extern "C" {
int inner(int x) { return x * 2; }
}
}

class Widget {
  int method() { return 1; }
};
"""

TRANSPARENT = ('extern "C" {\nint g_x = 0;\nvoid api(void) { g_x++; }\n}\n'
               "namespace ns {\nstatic int counter = 3;\nint f(int a) { return a + counter; }\n}\n")

#: pieces a seeded source is made of: functions, and the things the
#: splitter must see through or skip
FRAGMENTS = (
    "/* { comment brace */", "// } line comment", '#define M(x) { x; }', "#include <x.h>",
    "static const int t[] = { 1, 2 };", "struct s { int a; };", 'const char *g = "}{";',
    "char c = '{';", "int v = 0;", 'extern "C" {', "}", "namespace n {",
    "class K { int m() { return 0; } };",
    "int f@(int a) { return a + @; }",
    "static void\ng@(char *p)\n{\n  if (p) { p[0] = '}'; }\n}",
    "unsigned long h@(void) const { return @UL; }",
    "int (*pf@(void))(int) { return 0; }",
    "void w@(void) { /* } */ int x = @; }",
)


def seeded_source(seed: int) -> str:
    rng = np.random.default_rng(seed)
    parts = []
    for k, j in enumerate(rng.integers(0, len(FRAGMENTS), int(rng.integers(3, 24)))):
        parts.append(FRAGMENTS[j].replace("@", str(k)))
    return "\n".join(parts) + "\n"


def spans(mod, text):
    return [dataclasses.astuple(s) for s in mod.split_functions(text)]


@pytest.mark.parametrize("name", ["tricky", "transparent", *(f"seed{s}" for s in range(8))])
def test_split_functions_equal(name):
    cases = {"tricky": [TRICKY], "transparent": [TRANSPARENT]}
    texts = cases.get(name) or [seeded_source(s) for s in range(int(name[4:]), 96, 8)]
    found = 0
    for text in texts:
        want = spans(ref_walker, text)
        assert spans(walker, text) == want
        assert walker.mask_code(text) == ref_walker.mask_code(text)
        for min_lines in (2, 3):
            assert ([dataclasses.astuple(s) for s in walker.split_functions(text, min_lines)]
                    == [dataclasses.astuple(s)
                        for s in ref_walker.split_functions(text, min_lines)])
        found += len(want)
    assert found > 0
    if name == "tricky":
        assert [s[0] for s in spans(walker, TRICKY)] == ["add", "get_value", "pick", "inner"]


def test_walk_repo_equal(tmp_path):
    (tmp_path / "src" / "util").mkdir(parents=True)
    (tmp_path / "src" / "a.c").write_text("int a(void) { return 0; }\n")
    (tmp_path / "src" / "util" / "b.hpp").write_text("int b(void) { return 1; }\n")
    (tmp_path / "src" / "b.txt").write_text("not source")
    (tmp_path / ".git").mkdir()
    (tmp_path / ".git" / "decoy.c").write_text("int g(void) { return 0; }\n")
    (tmp_path / ".hidden").mkdir()
    (tmp_path / ".hidden" / "h.c").write_text("int h(void) { return 0; }\n")
    (tmp_path / "vendor").mkdir()
    (tmp_path / "vendor" / "v.c").write_text("int v(void) { return 0; }\n")
    (tmp_path / "big.c").write_text("int big;\n" * 10000)
    (tmp_path / "latin.c").write_bytes(b"int l(void) { return '\xe9'; }\n")
    for suffixes, exclude, cap in (((".c",), ("vendor",), 1024),
                                   ((".c", ".hpp"), (), 1 << 20),
                                   (tconfig.ScanConfig().suffixes,
                                    tconfig.ScanConfig().exclude_dirs, 1024)):
        got_stats, want_stats = {}, {}
        got = walker.walk_repo(tmp_path, suffixes, exclude, cap, stats=got_stats)
        want = ref_walker.walk_repo(tmp_path, suffixes, exclude, cap, stats=want_stats)
        assert [dataclasses.astuple(f) for f in got] == [dataclasses.astuple(f) for f in want]
        assert got_stats == want_stats
    assert [f.rel for f in walker.walk_repo(tmp_path, (".c",), ("vendor",), 1024)] == [
        "latin.c", "src/a.c"]


def _drive_manifest(mod, path):
    m = mod.ScanManifest(path, {"config_digest": "aaa", "lines": True, "method": "saliency"})
    for i in range(4):
        m.record_file(f"f{i}.c", f"sha{i}", [{"key": f"k{i}", "name": f"fn{i}",
                                              "start_line": 1 + i, "end_line": 5 + i}])
        m.record_result(f"k{i}", {"ok": i != 2, **({"prob": 0.1 * i} if i != 2
                                                   else {"error": "unparseable"})})
    m.functions["k1"]["lines"] = [{"line": 3, "score": 0.25}]
    m.prune({"f0.c", "f1.c", "f2.c"}, {"k0", "k1", "k2"})
    m.save()
    same = mod.ScanManifest.load(path, {"config_digest": "aaa", "lines": True,
                                        "method": "saliency"})
    other = mod.ScanManifest.load(path, {"config_digest": "bbb", "lines": True,
                                         "method": "saliency"})
    return (json.loads(Path(path).read_text()), same.resumed, other.resumed,
            same.file_functions("f0.c", "sha0"), same.file_functions("f0.c", "X"),
            other.result("k0"))


def test_manifest_documents_equal(tmp_path):
    got = _drive_manifest(manifest, tmp_path / "port" / "m.json")
    want = _drive_manifest(ref_manifest, tmp_path / "ref" / "m.json")
    assert got == want
    assert (tmp_path / "port" / "m.json").read_text() == (tmp_path / "ref" / "m.json").read_text()
    assert [p.name for p in (tmp_path / "port").iterdir()] == ["m.json"]


def _finding(prob=0.7, lines=None, **kw):
    return {"file": "src/a.c", "function": "f", "start_line": 3, "end_line": 9, "ok": True,
            "prob": prob, **({"lines": lines} if lines else {}), **kw}


FINDINGS = [
    _finding(0.95, lines=[{"line": 5, "score": 0.4}, {"line": 7, "score": 0.125}]),
    _finding(0.6), _finding(0.2), _finding(0.9, file="b/c.cc", function="g"),
    {"file": "b.c", "function": "g", "start_line": 1, "end_line": 2, "ok": False,
     "error": "unparseable"},
]


@pytest.mark.parametrize("threshold", [0.0, 0.5, 0.95])
def test_sarif_documents_equal(tmp_path, threshold):
    got = sarif.sarif_report(FINDINGS, tmp_path, threshold=threshold)
    want = ref_sarif.sarif_report(FINDINGS, tmp_path, threshold=threshold)
    assert got == want and sarif.validate_sarif(got) == [] == ref_sarif.validate_sarif(want)
    sarif.write_sarif(got, tmp_path / "port.sarif")
    ref_sarif.write_sarif(want, tmp_path / "ref.sarif")
    assert (tmp_path / "port.sarif").read_bytes() == (tmp_path / "ref.sarif").read_bytes()
    damaged = copy.deepcopy(got)
    damaged["version"] = "2.0.0"
    damaged["runs"][0]["tool"]["driver"]["rules"] = []
    if damaged["runs"][0]["results"]:
        damaged["runs"][0]["results"][0]["locations"][0]["physicalLocation"]["region"][
            "startLine"] = 0
    assert sarif.validate_sarif(damaged) == ref_sarif.validate_sarif(damaged) != []
    assert sarif.validate_sarif([]) == ref_sarif.validate_sarif([])


# -- the scanner against the reference's ---------------------------------------


@pytest.fixture(scope="module")
def corpus():
    examples = to_examples(generate(12, seed=5))
    return {struct: (examples,) + ref_build_dataset(
        examples, train_ids=range(12), limit_all=50, limit_subkeys=50, struct_feats=struct)
        for struct in (False, True)}


def _overrides(struct: bool) -> list[str]:
    return ['data.feat={"limit_all": 50, "limit_subkeys": 50}', "model.hidden_dim=8",
            "model.n_steps=2", "serve.max_batch_graphs=4", "serve.node_budget=2048",
            "serve.edge_budget=8192", "scan.lines=true", "serve.lines_steps=2",
            "scan.threshold=0.0",
            *(["data.feat.struct_feats=true", "model.struct_feats=true"] if struct else [])]


def _registry(run_dir, width, model, params, step=0):
    return types.SimpleNamespace(
        run_dir=run_dir, config_digest="cfg0", vocab_digest="voc0", checkpoint="best",
        _loaded_step=step, model=model, params=params, _feat_width=lambda: width,
        family="deepdfa", device=torch.device("cpu"))


def _services(corpus, struct, tmp_path):
    """(reference service, port service) over the same weights: the
    pieces RepoScanner touches, around each package's own frontend,
    executor and batcher."""
    from deepdfa_tpu.serve.batcher import DynamicBatcher as JBatcher, GgnnExecutor as JExecutor
    from deepdfa_tpu.serve.frontend import RequestPreprocessor as JPre

    from deepdfa_tpu_torch.serve.batcher import DynamicBatcher, GgnnExecutor
    from deepdfa_tpu_torch.serve.frontend import RequestPreprocessor

    examples, _, vocabs = corpus[struct]
    width = 9 if struct else 4
    jcfg = jconfig.apply_overrides(JConfig(), _overrides(struct))
    tcfg = tconfig.apply_overrides(tconfig.Config(), _overrides(struct))
    jmodel = JDeepDFA.from_config(jcfg.model, input_dim=jcfg.data.feat.input_dim)
    params = jmodel.init(jax.random.key(0), jpack([], 1, NODE_BUDGET, EDGE_BUDGET,
                                                  feat_width=width))
    model = DeepDFA.from_config(tcfg.model, tcfg.data.feat.input_dim).eval()
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jax.device_get(params))))
    out = []
    for name, cfg in (("ref", jcfg), ("port", tcfg)):
        run_dir = tmp_path / name / "run"
        run_dir.mkdir(parents=True)
        if name == "ref":
            ex = JExecutor(jmodel, lambda: params, node_budget=NODE_BUDGET,
                           edge_budget=EDGE_BUDGET, max_batch_graphs=4, feat_width=width)
            reg = _registry(run_dir, width, jmodel, lambda: params)
            front, batcher = JPre(cfg, vocabs, cache_entries=256), JBatcher(ex, queue_limit=64)
        else:
            ex = GgnnExecutor(model, NODE_BUDGET, EDGE_BUDGET, 4, device="cpu", feat_width=width)
            reg = _registry(run_dir, width, lambda: model, None)
            front = RequestPreprocessor(cfg, vocabs, cache_entries=256)
            batcher = DynamicBatcher(ex, queue_limit=64)
        ex.warmup()
        out.append(types.SimpleNamespace(cfg=cfg, registry=reg, frontend=front, executor=ex,
                                         batcher=batcher, localizer=None))
    return out[0], out[1], examples


def _write_repo(repo: Path, examples, per_file=2):
    repo.mkdir(parents=True, exist_ok=True)
    codes = [e.code for e in examples]
    for i in range(0, len(codes), per_file):
        sub = repo / ("src" if i % 4 == 0 else "src/util")
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"mod_{i // per_file}.c").write_text("\n".join(codes[i:i + per_file]) + "\n")


_NUM = re.compile(r"\d+\.\d+")


def assert_close_docs(got, want, path="", tol=1e-5):
    """Equal documents but for floats (within `tol` of the sibling list's
    scale for line scores, else of 1) and numbers formatted into strings
    (within the format's last digit)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_close_docs(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        if want and all(isinstance(w, dict) and "score" in w for w in want):
            scale = max(abs(w["score"]) for w in want) or 1.0
            for g, w in zip(got, want):
                assert g["line"] == w["line"], path
                assert abs(g["score"] - w["score"]) <= tol * scale, (path, g, w)
            return
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_docs(g, w, f"{path}[{i}]", tol)
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= tol, (path, got, want)
    elif isinstance(want, str) and _NUM.search(want):
        assert _NUM.sub("#", got) == _NUM.sub("#", want), path
        for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
            assert abs(float(g) - float(w)) <= 10.0 ** -len(w.split(".")[1]) + tol, (path, g, w)
    else:
        assert got == want, (path, got, want)


def _paths_relative(doc, root):
    return json.loads(json.dumps(doc).replace(str(root), "<root>"))


@pytest.mark.parametrize("struct", [False, True], ids=["planar", "struct"])
def test_scanner_matches_the_reference_scanner(corpus, tmp_path, struct):
    ref_service, port_service, examples = _services(corpus, struct, tmp_path)
    repo = tmp_path / "repo"
    _write_repo(repo, examples, per_file=3)
    want = ref_scanner.RepoScanner(ref_service, ref_service.cfg).scan(repo)
    got = scanner.RepoScanner(port_service, port_service.cfg).scan(repo)
    for k in ("scan_files", "scan_files_reused", "scan_functions", "scan_reused",
              "scan_extracted", "scan_scored", "scan_functions_failed", "scan_findings",
              "scan_cache_hit_fraction", "repo"):
        assert got[k] == want[k], k
    assert got["device"] == "cpu" and got["ggnn_step_launches"] == 0
    findings = [[json.loads(ln) for ln in Path(s["scores_path"]).read_text().splitlines()]
                for s in (got, want)]
    assert len(findings[0]) == 12 and all(f["ok"] and f["lines"] for f in findings[0])
    assert_close_docs(*findings)
    assert_close_docs(json.loads(Path(got["sarif_path"]).read_text()),
                      json.loads(Path(want["sarif_path"]).read_text()))
    states = [_paths_relative(json.loads(s.read_text()), repo)
              for s in (scanner.RepoScanner(port_service).state_path(repo),
                        ref_scanner.RepoScanner(ref_service).state_path(repo))]
    assert_close_docs(*states)
    # the same content keys: the frontends key by the same feature recipe
    assert sorted(states[0]["functions"]) == sorted(states[1]["functions"])


def test_incremental_rescan_property(corpus, tmp_path):
    _, service, examples = _services(corpus, False, tmp_path)
    scan = scanner.RepoScanner(service, service.cfg)
    repo = tmp_path / "repo"
    _write_repo(repo, examples[:8], per_file=2)
    cold = scan.scan(repo)
    assert cold["scan_functions"] == 8
    assert cold["scan_extracted"] == 8 and cold["scan_reused"] == 0
    idle = scan.scan(repo)
    assert idle["scan_extracted"] == 0 and idle["scan_reused"] == 8
    assert idle["scan_files_reused"] == idle["scan_files"]
    target = repo / "src" / "mod_0.c"
    text = target.read_text()
    sp = walker.split_functions(text)
    lines = text.split("\n")
    lines.insert(sp[0].start_line, "  int edited_marker = 1;")
    target.write_text("\n".join(lines))
    incr = scan.scan(repo)
    assert incr["scan_extracted"] == 1
    assert incr["scan_reused"] == incr["scan_functions"] - 1
    moved = [json.loads(ln) for ln in Path(incr["scores_path"]).read_text().splitlines()]
    moved = [f for f in moved if f["file"] == "src/mod_0.c"]
    assert moved[1]["start_line"] == sp[1].start_line + 1
    target.rename(repo / "src" / "renamed.c")
    ren = scan.scan(repo)
    assert ren["scan_extracted"] == 0 and ren["scan_reused"] == ren["scan_functions"]
    log = (service.registry.run_dir / "scan_log.jsonl").read_text().splitlines()
    assert [json.loads(r)["scan_extracted"] for r in log] == [8, 0, 1, 0]


def test_identity_drift_forces_cold_scan(corpus, tmp_path):
    """A new checkpoint step never serves manifest-cached scores."""
    _, service, examples = _services(corpus, False, tmp_path)
    scan = scanner.RepoScanner(service, service.cfg)
    repo = tmp_path / "repo3"
    _write_repo(repo, examples[:4])
    assert scan.scan(repo)["scan_extracted"] == 4
    service.registry._loaded_step = 7  # a hot swap advanced the tag
    redo = scan.scan(repo)
    assert redo["scan_reused"] == 0 and redo["scan_scored"] == 4
    assert redo["scan_cache_hit_fraction"] == 1.0  # off the warm frontend cache
    cold = tconfig.apply_overrides(service.cfg, ["scan.incremental=false"])
    assert scanner.RepoScanner(service, cold).scan(repo)["scan_reused"] == 0


def test_cli_scan_smoke_and_rescan(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cli.main(["scan", "--smoke", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert scanner.smoke_problems(report) == []
    assert report["cold"]["scan_functions"] == 24 and report["findings_with_lines"] == 24
    assert report["cold"]["device"] == "cpu"
    # a second process-level scan of the smoke's repository reuses all
    cli.main(["scan", report["repo"], "--lines", "--device", "cpu",
              "--override", 'run_name="scan-smoke"'])
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["scan_extracted"] == 0
    assert again["scan_reused"] == again["scan_functions"] == 24
    cli.main(["scan", report["repo"], "--no-incremental", "--device", "cpu",
              "--out", str(tmp_path / "f.jsonl"), "--sarif", str(tmp_path / "f.sarif"),
              "--override", 'run_name="scan-smoke"'])
    cold = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cold["scan_reused"] == 0 and cold["scan_scored"] == 24
    assert sarif.validate_sarif(json.loads((tmp_path / "f.sarif").read_text())) == []
    with pytest.raises(SystemExit, match="repository path"):
        cli.main(["scan", "--device", "cpu"])
