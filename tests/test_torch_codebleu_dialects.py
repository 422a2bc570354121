"""The port's six non-C dialects and CodeBLEU against the reference's,
exactly: `tokenize(code, dialect=d)` token for token (kind, text, line,
column) and `parse_function(code, dialect=d)` node for node and edge for
edge (or the same error) for java, c#, js, go, php and ruby, on every
string of the reference's CodeBLEU tests and seeded variants of them;
the C path unchanged on tests/fidelity_corpus/; `corpus_syntax_match`,
`corpus_dataflow_match` and `get_codebleu` equal with `==` for all nine
languages, their
degenerate-to-0 warnings too; and `cli codebleu`'s JSON equal to the
reference's `cmd_codebleu` on the same files.

The reference's merged dataflow parent lists take the order of a set of
strings, so both packages run in this one process, under one hash seed."""

import argparse
import ast
import importlib
import json
import logging
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from deepdfa_tpu.eval import codebleu as ref_bleu  # noqa: E402
from deepdfa_tpu.frontend import parser as ref_parser  # noqa: E402
from deepdfa_tpu.frontend import tokens as ref_tokens  # noqa: E402

from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch import native  # noqa: E402
from deepdfa_tpu_torch.eval import codebleu as bleu  # noqa: E402
from deepdfa_tpu_torch.frontend import parser, tokens  # noqa: E402
from deepdfa_tpu_torch.frontend import reaching  # noqa: E402

ref_cli = importlib.import_module("deepdfa_tpu.cli.main")
ROOT = Path(__file__).resolve().parent

# -- the inputs: every string literal of the reference's tests/test_codebleu.py
# and tests/test_dfg_parity.py (their code snippets in all nine languages,
# and their prose, which mostly fails to parse: both packages must fail
# alike), plus seeded variants of each with lines dropped and identifiers
# renamed (tests/test_torch_dfg_parity.py reads them from here)

SOURCES = ("test_codebleu.py", "test_dfg_parity.py")
DIALECTS = ("java", "cs", "js", "go", "php", "ruby")
LANGS = ("c", "cpp", "java", "c_sharp", "javascript", "php", "go", "ruby", "python")
_NAME = re.compile(r"(?<![\w$@])[A-Za-z_]\w*")


def _strings(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and len(n.value) >= 4 and id(n) not in docs]


def variant(code: str, seed: int) -> str:
    """`code` with one or two lines dropped (when it has more than two)
    and up to three of its names renamed, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    lines = code.split("\n")
    for _ in range(int(rng.integers(1, 3))):
        if len(lines) > 2:
            del lines[int(rng.integers(0, len(lines)))]
    code = "\n".join(lines)
    names = sorted(set(_NAME.findall(code)))
    if names:
        pick = rng.choice(names, min(len(names), int(rng.integers(1, 4))), replace=False)
        new = {str(n): f"v{i}_{seed % 7}" for i, n in enumerate(pick)}
        code = _NAME.sub(lambda m: new.get(m.group(0), m.group(0)), code)
    return code


@lru_cache(maxsize=1)
def snippets() -> tuple[str, ...]:
    return tuple(sorted({s for name in SOURCES for s in _strings(ROOT / name)}))


@lru_cache(maxsize=1)
def variants() -> tuple[str, ...]:
    return tuple(variant(code, 1000 + 3 * i + k)
                 for i, code in enumerate(snippets()) for k in range(3))


def named(prefix: str) -> list[str]:
    """The reference's module-level snippet constants whose names start
    with `prefix` (e.g. "JAVA_"), in file order."""
    tree = ast.parse((ROOT / "test_codebleu.py").read_text())
    return [node.value.value for node in tree.body
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
            and any(isinstance(t, ast.Name) and t.id.startswith(prefix) for t in node.targets)]

CORPUS = {p.name: p.read_text() for p in sorted((ROOT / "fidelity_corpus").glob("*.c*"))}


def toks(seq) -> list[tuple]:
    return [(t.kind, t.text, t.line, t.col) for t in seq]


def cpg_view(cpg) -> dict:
    return {
        "method": cpg.method_name,
        "nodes": [(n.id, n.label, n.name, n.code, n.line, n.order, n.type_full_name)
                  for n in cpg.nodes],
        "edges": list(cpg.edges),
    }


def parse_view(mod, code: str, **kw):
    """The CPG's view, or the exception's class and message."""
    try:
        return cpg_view(mod.parse_function(code, **kw))
    except Exception as e:  # the packages must fail alike
        return f"{type(e).__name__}: {e}"


def inputs() -> tuple[str, ...]:
    return snippets() + variants()


def test_inputs_are_there():
    assert len(snippets()) >= 140 and len(variants()) == 3 * len(snippets())
    assert len(CORPUS) == 67  # the corpus's C and C++ files (its 68th is a json)
    for prefix in ("JAVA_", "CSHARP_", "JS_", "PHP_", "GO_", "RUBY_", "PY_", "CODE_"):
        assert named(prefix), prefix


@pytest.mark.parametrize("dialect", DIALECTS)
def test_dialect_tokens_equal(dialect):
    for code in inputs():
        assert toks(tokens.tokenize(code, dialect=dialect)) == toks(
            ref_tokens.tokenize(code, dialect=dialect)), code
    # a dialect lexes through the Python path whatever the backend says
    code = snippets()[0]
    assert toks(tokens.tokenize(code, backend="native", dialect=dialect)) == toks(
        tokens.tokenize(code, backend="python", dialect=dialect))
    with pytest.raises(ValueError, match="unknown dialect"):
        tokens.tokenize(code, dialect="swift")
    with pytest.raises(ValueError, match="unknown dialect"):
        ref_tokens.tokenize(code, dialect="swift")


@pytest.mark.parametrize("dialect", DIALECTS)
def test_dialect_cpgs_equal(dialect):
    parsed = 0
    for code in inputs():
        got = parse_view(parser, code, dialect=dialect)
        assert got == parse_view(ref_parser, code, dialect=dialect), code
        parsed += not isinstance(got, str)
    # the snippets of the dialect's own language parse; prose does not
    assert 0 < parsed < len(inputs())


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_c_path_unchanged(name):
    """Under dialect "c" (the default) the fidelity corpus lexes and
    parses to the reference's tokens and CPG, by the native path and the
    Python path alike."""
    code = CORPUS[name]
    want = parse_view(ref_parser, code)
    assert parse_view(parser, code) == parse_view(parser, code, dialect="c") == want
    assert not isinstance(want, str)
    assert toks(tokens.tokenize(code, dialect="c")) == toks(ref_tokens.tokenize(code))
    assert toks(tokens.tokenize(code, backend="python")) == toks(
        ref_tokens.tokenize(code, backend="python"))


def test_tables_equal():
    assert bleu.KEYWORDS == ref_bleu.KEYWORDS and set(bleu.KEYWORDS) == set(LANGS)
    assert bleu.LANG_DIALECT == ref_bleu.LANG_DIALECT
    assert bleu._WRAPPERS == ref_bleu._WRAPPERS
    assert tokens.DIALECT_OPERATORS == ref_tokens.DIALECT_OPERATORS
    assert parser.DIALECT_BIN_PREC == ref_parser.DIALECT_BIN_PREC
    assert parser.DIALECT_WORD_BINOPS == ref_parser.DIALECT_WORD_BINOPS
    assert parser.DIALECT_ASSIGN_OPS == ref_parser.DIALECT_ASSIGN_OPS
    for lang in ("swift", "rust"):
        with pytest.raises(ValueError) as got:
            bleu.get_codebleu(["x"], ["x"], lang=lang)
        with pytest.raises(ValueError) as want:
            ref_bleu.get_codebleu(["x"], ["x"], lang=lang)
        assert str(got.value) == str(want.value)


def _corpus():
    """(references, hypotheses): every input as a reference, with a
    second reference (the next variant) for every third row; each
    hypothesis a variant of its first reference."""
    snips, var = snippets(), variants()
    refs = [[s] if i % 3 else [s, var[3 * i + 1]] for i, s in enumerate(snips)]
    hyps = [var[3 * i] for i in range(len(snips))]
    return refs, hyps


@pytest.mark.parametrize("lang", LANGS)
def test_syntax_match_equal(lang):
    refs, hyps = _corpus()
    got = bleu.corpus_syntax_match(refs, hyps, lang)
    assert got == ref_bleu.corpus_syntax_match(refs, hyps, lang)
    assert 0.0 < got < 1.0
    flat = [r[0] for r in refs]
    assert bleu.corpus_syntax_match([[r] for r in flat], flat, lang) == 1.0


@pytest.mark.parametrize("lang", LANGS)
def test_dataflow_match_equal(lang):
    refs, hyps = _corpus()
    got = bleu.corpus_dataflow_match(refs, hyps, lang)
    assert got == ref_bleu.corpus_dataflow_match(refs, hyps, lang)
    assert 0.0 < got < 1.0


@pytest.mark.parametrize("lang", LANGS)
def test_get_codebleu_equal(lang):
    refs, hyps = _corpus()
    for params in ((0.25, 0.25, 0.25, 0.25), (0.1, 0.2, 0.3, 0.4)):
        got = bleu.get_codebleu(refs, hyps, lang, params)
        assert got == ref_bleu.get_codebleu(refs, hyps, lang, params)
        assert all(0.0 < v < 1.0 for v in got.values()), got
    flat = [r[0] for r in refs]
    assert bleu.get_codebleu(flat, flat, lang) == ref_bleu.get_codebleu(flat, flat, lang)


@pytest.mark.parametrize("lang", LANGS)
def test_degenerate_warnings_equal(lang):
    """A corpus whose references do not parse scores 0 in both
    structural matches, with the reference's warnings."""
    messages = {}
    for (name, mod), refs, hyps in (
            (pair, refs, hyps) for pair in (("port", bleu), ("reference", ref_bleu))
            for refs, hyps in (([["]]] ((( not code"]], ["x"]), ([[]], ["x"]))):
        records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        log = logging.getLogger(mod.__name__)
        log.addHandler(handler)
        try:
            scores = (mod.corpus_syntax_match(refs, hyps, lang),
                      mod.corpus_dataflow_match(refs, hyps, lang))
        finally:
            log.removeHandler(handler)
        assert scores == (0.0, 0.0)
        messages.setdefault(name, []).append([(r.levelname, r.getMessage()) for r in records])
    assert messages["port"] == messages["reference"]
    assert len(messages["port"][1]) >= 1  # no reference at all: at least the syntax warning


@pytest.mark.parametrize("lang", ["c", "go", "ruby", "javascript"])
def test_dataflow_triples_take_the_python_solvers_sets(lang, monkeypatch):
    """The reaching-definitions triples are the same with the native
    solver ("auto") and with the Python one."""
    assert native.available()
    dialect = bleu.LANG_DIALECT[lang]
    cpgs = [c for c in (bleu._parse(s, dialect) for s in snippets()) if c is not None]
    auto = [bleu._dataflow_triples(c) for c in cpgs]
    solve = reaching.ReachingDefinitions.solve
    monkeypatch.setattr(reaching.ReachingDefinitions, "solve",
                        lambda self, backend="auto": solve(self, backend="python"))
    assert [bleu._dataflow_triples(c) for c in cpgs] == auto
    assert sum(map(len, auto)) > 0


def _files(tmp_path, refs, hyps):
    paths = []
    for k in range(max(len(r) for r in refs)):
        p = tmp_path / f"ref{k}.txt"
        p.write_text("\n".join(r[min(k, len(r) - 1)].replace("\n", " ") for r in refs) + "\n")
        paths.append(str(p))
    hyp = tmp_path / "hyp.txt"
    hyp.write_text("\n".join(h.replace("\n", " ") for h in hyps) + "\n")
    return paths, str(hyp)


@pytest.mark.parametrize("lang", ["c", "java", "c_sharp", "python"])
def test_cli_codebleu_equals_reference(lang, tmp_path, capsys):
    refs, hyps = _corpus()
    lines = {"python": named("PY_")}.get(lang, named("JAVA_") + named("CSHARP_") + named("CODE_"))
    refs = refs[:40] + [[s] for s in lines]
    hyps = hyps[:40] + lines[1:] + lines[:1]
    ref_files, hyp = _files(tmp_path, refs, hyps)
    for params in ("0.25,0.25,0.25,0.25", "0.1,0.2,0.3,0.4"):
        cli.main(["codebleu", "--refs", *ref_files, "--hyp", hyp, "--lang", lang,
                  "--params", params])
        got = capsys.readouterr().out
        ref_cli.cmd_codebleu(argparse.Namespace(refs=ref_files, hyp=hyp, lang=lang,
                                                params=params))
        assert got == capsys.readouterr().out
        assert set(json.loads(got)) == {"ngram_match", "weighted_ngram_match",
                                        "syntax_match", "dataflow_match", "codebleu"}
    short = tmp_path / "short.txt"
    short.write_text("int x;\n")
    with pytest.raises(SystemExit) as got:
        cli.main(["codebleu", "--refs", ref_files[0], "--hyp", str(short), "--lang", lang])
    with pytest.raises(SystemExit) as want:
        ref_cli.cmd_codebleu(argparse.Namespace(refs=[ref_files[0]], hyp=str(short),
                                                lang=lang, params="0.25,0.25,0.25,0.25"))
    assert str(got.value) == str(want.value) == "refs and hyp must have equal line counts"


def test_cli_codebleu_takes_the_references_flags():
    p = cli.build_parser()
    args = p.parse_args(["codebleu", "--refs", "a", "b", "--hyp", "h"])
    assert (args.refs, args.hyp, args.lang, args.params) == (
        ["a", "b"], "h", "c", "0.25,0.25,0.25,0.25")
    with pytest.raises(SystemExit):
        p.parse_args(["codebleu", "--refs", "a", "--hyp", "h", "--lang", "swift"])
    choices = next(a for a in p._subparsers._group_actions[0].choices["codebleu"]._actions
                   if a.dest == "lang").choices
    assert sorted(choices) == sorted(LANGS)
