"""The port's C frontend (`deepdfa_tpu_torch/frontend/`) and diff labels
against the reference's, exactly: tokens, `evaluate_conditionals`, CPGs
node for node and edge for edge, reaching definitions, dependences,
abstract-dataflow features, vocabularies and their encodings, on every
function of tests/fidelity_corpus/, on non-ASCII sources and on seeded
token soups; `labeled_diff` on tests/goldens/diff_labels.json.

Both packages take their native C++ lexer and solver by default
("auto", for ASCII input), and each has its Python spec. The port's
default path is held against the reference's default path, and the
port's Python path (native switched off in both packages) against the
reference's Python path. The two paths differ: native tokens carry col
0, and on a source that ends without a statement after its last newline
the native lexer puts the end-of-file token on the last token's line,
the Python lexer on the line after, so a CPG node placed at the end of
file moves with it. The port's native path equals the reference's
native path there, token for token and node for node."""

import contextlib
import json
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from deepdfa_tpu import native as ref_native  # noqa: E402
from deepdfa_tpu.data import diffs as ref_diffs  # noqa: E402
from deepdfa_tpu.frontend import absdf as ref_absdf  # noqa: E402
from deepdfa_tpu.frontend import deps as ref_deps  # noqa: E402
from deepdfa_tpu.frontend import parser as ref_parser  # noqa: E402
from deepdfa_tpu.frontend import preproc as ref_preproc  # noqa: E402
from deepdfa_tpu.frontend import reaching as ref_reaching  # noqa: E402
from deepdfa_tpu.frontend import tokens as ref_tokens  # noqa: E402
from deepdfa_tpu.frontend import vocab as ref_vocab  # noqa: E402

from deepdfa_tpu_torch import native  # noqa: E402
from deepdfa_tpu_torch.data import diffs  # noqa: E402
from deepdfa_tpu_torch.frontend import (  # noqa: E402
    absdf,
    deps,
    parser,
    preproc,
    reaching,
    tokens,
    vocab,
)
from deepdfa_tpu_torch.nn.embedding import SUBKEY_ORDER  # noqa: E402

ROOT = Path(__file__).resolve().parent
CORPUS = {p.name: p.read_text() for p in sorted((ROOT / "fidelity_corpus").glob("*.c*"))}
GOLDENS = {k: v for k, v in json.loads((ROOT / "goldens" / "diff_labels.json").read_text()).items()
           if not k.startswith("_")}

#: non-ASCII sources: unicode identifiers, literals and comments
UNICODE = {
    "identifiers": "int f(int größe) {\n  int ñ = größe * 2;\n  return ñ;\n}\n",
    "literals": 'void g(char *s) {\n  s = "héllo → wörld";\n  char c = \'é\';\n}\n',
    "comments": "int h(int x) {\n  /* ünïcödé */ x += 1; // ☃\n  return x;\n}\n",
    "mixed": "int 变量(int 参数) {\n  if (参数 > 0) { 参数--; }\n  return 参数;\n}\n",
}

#: token soups: C-like words, between a function head and a closing
#: brace for an even seed (most parse) and bare for an odd one (most fail)
SOUP_WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
              "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n",
              "size_t", "->", "next", "while", "<", "for", "i", "++", "NULL", "&", "ptr",
              "else", ",", "x", "#if 0", "#endif", "/* c */", "switch", "case", ":", "break")
N_SOUPS = 160


def soup(seed: int) -> str:
    rng = np.random.default_rng(seed)
    headed = seed % 2 == 0
    lines, line = ["int f(int n, char *buf) {"] if headed else [], []
    for w in rng.choice(SOUP_WORDS, int(rng.integers(4, 48))):
        if w.startswith("#"):
            lines.extend([" ".join(line), str(w)])
            line = []
            continue
        line.append(str(w))
        if w in (";", "{", "}"):
            lines.append(" ".join(line))
            line = []
    lines.extend([" ".join(line), "}"] if headed else [" ".join(line)])
    return "\n".join(lines) + "\n"


SOURCES = {**{f"corpus/{k}": v for k, v in CORPUS.items()},
           **{f"unicode/{k}": v for k, v in UNICODE.items()}}


def toks(seq) -> list[tuple]:
    return [(t.kind, t.text, t.line, t.col) for t in seq]


def cpg_view(cpg) -> dict:
    return {
        "method": cpg.method_name,
        "nodes": [(n.id, n.label, n.name, n.code, n.line, n.order, n.type_full_name)
                  for n in cpg.nodes],
        "edges": list(cpg.edges),
    }


@contextlib.contextmanager
def python_paths():
    """Both packages' lexer and solver without their native libraries."""
    saved = ref_native.available, native.available
    ref_native.available = native.available = lambda: False
    try:
        yield
    finally:
        ref_native.available, native.available = saved


def parse_or_error(mod, code: str):
    try:
        return mod.parse_function(code)
    except Exception as e:  # the packages must fail alike
        return type(e).__name__


@lru_cache(maxsize=None)
def parsed(code: str):
    """(reference CPG, port CPG), or the exceptions' class names."""
    return parse_or_error(ref_parser, code), parse_or_error(parser, code)


@lru_cache(maxsize=None)
def parsed_by_python(code: str):
    """(reference CPG, port CPG) on both Python paths, or the exceptions'
    class names."""
    with python_paths():
        return parse_or_error(ref_parser, code), parse_or_error(parser, code)


def view(got):
    return got if isinstance(got, str) else cpg_view(got)


def both_cpgs(code: str):
    ref, port = parsed(code)
    assert not isinstance(ref, str), ref
    return ref, port


def rd_view(in_sets: dict) -> dict:
    return {n: sorted((d.var, d.node, d.code) for d in s) for n, s in in_sets.items()}


def test_sources_are_there():
    assert native.available() and ref_native.available()
    assert len(CORPUS) >= 60
    assert sum(name.endswith(".cc") for name in CORPUS) >= 10
    assert not all(code.isascii() for code in UNICODE.values())


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_tokens_and_preprocessor_equal(name):
    code = SOURCES[name]
    assert toks(tokens.tokenize(code)) == toks(ref_tokens.tokenize(code))
    assert toks(tokens.tokenize(code, backend="python")) == toks(
        ref_tokens.tokenize(code, backend="python"))
    if code.isascii():
        assert toks(tokens.tokenize(code, backend="native")) == toks(
            ref_tokens.tokenize(code, backend="native"))
    assert tokens.strip_comments(code) == ref_tokens.strip_comments(code)
    assert preproc.evaluate_conditionals(code) == ref_preproc.evaluate_conditionals(code)


def test_native_backends_are_refused():
    """`backend="native"` (refused before the port had its C++ library)
    refuses only what the reference's refuses: non-ASCII input. On ASCII
    it is the reference's native lexer and bitset solver, bit for bit,
    and the raw bindings equal the reference's on the programs of
    tests/test_native.py and its lexer edge cases."""
    with pytest.raises(ValueError, match="ASCII"):
        tokens.tokenize(UNICODE["identifiers"], backend="native")
    with pytest.raises(ValueError, match="unknown backend"):
        tokens.tokenize("int x;", backend="rust")
    from tests.test_native import PROGRAMS

    edge_cases = ['char *s = "a\\"b\\\\";', "int x = 0xFF + 1.5e-3 - 07u;",
                  "#define FOO(a) \\\n  (a+1)\nint y;", "/* multi\nline */ int z; // tail",
                  "a <<= 2; b >>= 1; c ...", '"unterminated', "#define A /* multi\nline */ int q;",
                  "#define C // tail comment\nint s;", "#define D \\\n  cont /* x\ny */ int t;"]
    for code in PROGRAMS + edge_cases:
        assert toks(native.lex_c_native(code)) == toks(ref_native.lex_c_native(code))
        assert toks(tokens.tokenize(code, backend="native")) == toks(
            ref_tokens.tokenize(code, backend="native"))
    for code in PROGRAMS + [CORPUS["casts.c"]]:
        port_rd = reaching.ReachingDefinitions(parser.parse_function(code))
        ref_rd = ref_reaching.ReachingDefinitions(ref_parser.parse_function(code))
        assert rd_view(port_rd.solve(backend="native")) == rd_view(
            ref_rd.solve(backend="native"))
        assert rd_view(port_rd.solve(backend="native")) == rd_view(
            port_rd.solve(backend="python"))
        nodes, _, src, dst = port_rd.dense_cfg()
        def_var = np.array([i % 3 - 1 for i in range(len(nodes))], np.int32)
        args = (len(nodes), np.array(src, np.int32), np.array(dst, np.int32), def_var)
        assert native.rd_solve_native(*args) == ref_native.rd_solve_native(*args)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_cpg_equal(name):
    ref, port = both_cpgs(SOURCES[name])
    assert cpg_view(port) == cpg_view(ref)
    ref_python, port_python = parsed_by_python(SOURCES[name])
    assert view(port_python) == view(ref_python)
    assert port.cfg_nodes() == ref.cfg_nodes()


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_reaching_definitions_and_dependences_equal(name):
    ref, port = both_cpgs(SOURCES[name])
    ref_rd, port_rd = ref_reaching.ReachingDefinitions(ref), reaching.ReachingDefinitions(port)
    assert rd_view(port_rd.solve()) == rd_view(ref_rd.solve())
    assert rd_view(port_rd.solve_out()) == rd_view(ref_rd.solve_out())
    assert port_rd.dense_cfg() == ref_rd.dense_cfg()
    assert deps.data_dependences(port) == ref_deps.data_dependences(ref)
    assert deps.control_dependences(port) == ref_deps.control_dependences(ref)
    lines = sorted({n.line for n in ref.nodes if n.line is not None})
    for target in ({lines[0]}, set(lines[len(lines) // 2:len(lines) // 2 + 2]), set(lines)):
        assert deps.dependent_lines(port, target) == ref_deps.dependent_lines(ref, target)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_abstract_dataflow_features_equal(name):
    ref, port = both_cpgs(SOURCES[name])
    decls = [n.id for n in ref.nodes if ref_absdf.is_decl(ref, n.id)]
    assert [n.id for n in port.nodes if absdf.is_decl(port, n.id)] == decls
    for nid in decls:
        fields = ref_absdf.decl_features(ref, nid)
        assert absdf.decl_features(port, nid) == fields
        assert absdf.node_hash(fields) == ref_absdf.node_hash(fields)
    assert absdf.graph_features(port) == ref_absdf.graph_features(ref)


@pytest.mark.parametrize("limit", [None, 2, 1000])
def test_vocabularies_and_encodings_equal(limit):
    """The train fields of the whole corpus through both packages'
    `build_vocabs` (the JSON each writes) and `encode_nodes`."""
    fields, per_graph = [], []
    for name in sorted(SOURCES):
        ref, _ = both_cpgs(SOURCES[name])
        by_node = {n.id: ref_absdf.decl_features(ref, n.id) for n in ref.nodes
                   if ref_absdf.is_decl(ref, n.id)}
        by_node = {k: v for k, v in by_node.items() if v}
        fields.extend(by_node.values())
        per_graph.append((by_node, [n.id for n in ref.nodes]))
    train = fields[: 2 * len(fields) // 3]
    ref_v = ref_vocab.build_vocabs(train, SUBKEY_ORDER, limit_all=limit, limit_subkeys=limit)
    port_v = vocab.build_vocabs(train, SUBKEY_ORDER, limit_all=limit, limit_subkeys=limit)
    ref_json = json.dumps({k: v.to_json() for k, v in ref_v.items()})
    assert json.dumps({k: v.to_json() for k, v in port_v.items()}) == ref_json
    loaded = {k: vocab.AbsDfVocab.from_json(v) for k, v in json.loads(ref_json).items()}
    for by_node, ids in per_graph:
        want = ref_vocab.encode_nodes(ref_v, by_node, ids, SUBKEY_ORDER)
        for v in (port_v, loaded):
            got = vocab.encode_nodes(v, by_node, ids, SUBKEY_ORDER)
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("block", range(8))
def test_token_soups_parse_or_fail_alike(block):
    """Seeded soups: both packages raise the same error, or give the same
    CPG, reaching definitions, dependences and features, on their default
    (native) paths and on their Python paths; where the two paths
    disagree, the port's native path is the reference's native path and
    the two lexers differ in the end-of-file line alone."""
    n_parsed = n_differ = 0
    for seed in range(block * N_SOUPS // 8, (block + 1) * N_SOUPS // 8):
        code = soup(seed)
        want = toks(ref_tokens.tokenize(code))
        assert toks(tokens.tokenize(code)) == want
        python_toks = toks(ref_tokens.tokenize(code, backend="python"))
        assert toks(tokens.tokenize(code, backend="python")) == python_toks
        assert preproc.evaluate_conditionals(code) == ref_preproc.evaluate_conditionals(code)
        ref, port = parsed(code)
        assert view(port) == view(ref), (seed, code)
        ref_python, port_python = parsed_by_python(code)
        assert view(port_python) == view(ref_python), (seed, code)
        if view(ref) != view(ref_python):
            n_differ += 1
            assert [t[:3] for t in want[:-1]] == [t[:3] for t in python_toks[:-1]], (seed, code)
            assert want[-1][:2] == ("eof", "") and want[-1][:3] != python_toks[-1][:3]
        if isinstance(ref, str):
            continue
        n_parsed += 1
        assert rd_view(reaching.ReachingDefinitions(port).solve()) == rd_view(
            ref_reaching.ReachingDefinitions(ref).solve())
        assert deps.data_dependences(port) == ref_deps.data_dependences(ref)
        assert deps.control_dependences(port) == ref_deps.control_dependences(ref)
        assert absdf.graph_features(port) == ref_absdf.graph_features(ref)
    assert n_parsed > 0 and n_differ <= 1


#: other languages' spellings (the reference parses java, c#, js, go, php
#: and ruby under its `dialect=`, which the port leaves out): in C source
#: they must lex and parse as the reference's C path does
OTHER_LANGUAGE_WORDS = SOUP_WORDS + (
    "foreach", "using", "lock", "=>", "instanceof", "is", "as", "func", "var", "def", "end",
    "$x", "@y", "`s`", "?.", "?->", "&.", "..", "...", ":=", "<-", "===", "**", "try",
    "catch", "finally", "throw", "public", "static", "String", ">", "T", "template", "new",
    "delete", "::", "operator", "typeof", "await", "function", "echo", "unless", "do",
    "goto", "'c'", '"s"', "1.5", "0x1f", "1..9", "empty?", "save!", "\n")
N_OTHER = 96


def other_language_soup(seed: int) -> str:
    rng = np.random.default_rng(10_000 + seed)
    heads = ["int f(int n, char *buf) {", "public static int[] g(String[] a) {", ""]
    lines, line = [heads[seed % 3]], []
    for w in rng.choice(OTHER_LANGUAGE_WORDS, int(rng.integers(4, 60))):
        line.append(str(w))
        if w in (";", "{", "}", "\n"):
            lines.append(" ".join(line))
            line = []
    lines.extend([" ".join(line), "}"] if seed % 3 != 2 else [" ".join(line)])
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("block", range(4))
def test_other_language_spellings_parse_as_c_alike(block):
    """The port's lexer and parser take C alone; on C sources strewn with
    other languages' tokens they give the reference's C tokens and CPG, or
    the same error."""
    outcomes = set()
    for seed in range(block * N_OTHER // 4, (block + 1) * N_OTHER // 4):
        code = other_language_soup(seed)
        assert toks(tokens.tokenize(code)) == toks(ref_tokens.tokenize(code))
        assert toks(tokens.tokenize(code, backend="python")) == toks(
            ref_tokens.tokenize(code, backend="python"))
        got = view(parse_or_error(parser, code))
        assert got == view(parse_or_error(ref_parser, code)), (seed, code)
        assert view(parsed_by_python(code)[1]) == view(parsed_by_python(code)[0]), (seed, code)
        outcomes.add(isinstance(got, str))
    assert outcomes == {True, False}


@pytest.mark.parametrize("code", ["int f(]) { return 0; }",
                                  "int f(int a ] b, char *c) { return c[a]; }"])
def test_stray_bracket_in_parameters_ends(code):
    """A ']' in a parameter list stops the reference's parser for good (it
    never returns); the port steps over it and keeps the parameters it
    can name. Run in a process of its own, so a regression fails here in
    seconds instead of hanging the run."""
    probe = ("import sys; from deepdfa_tpu_torch.frontend import parser; "
             "g = parser.parse_function(sys.argv[1]); "
             "print(g.method_name, [n.name for n in g.nodes if n.label == 'METHOD_PARAMETER_IN'])")
    res = subprocess.run([sys.executable, "-c", probe, code], capture_output=True, text=True,
                         timeout=60, cwd=ROOT.parent)
    assert res.returncode == 0, res.stderr
    params = ["a", "c"] if "a ]" in code else []
    assert res.stdout.split("\n")[0] == f"f {params}"


def test_token_soups_cover_both_outcomes():
    outcomes = [parsed(soup(seed))[0] for seed in range(N_SOUPS)]
    errors = {o for o in outcomes if isinstance(o, str)}
    assert errors == {"ParseError"}
    n_parsed = sum(not isinstance(o, str) for o in outcomes)
    assert N_SOUPS // 4 < n_parsed < 3 * N_SOUPS // 4


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_labeled_diff_equal(name):
    rec = GOLDENS[name]
    before, after = rec["before"], rec["after"]
    want = ref_diffs.labeled_diff(before, after)
    assert diffs.labeled_diff(before, after) == want
    assert want[0] == set(rec["removed_before"])
    assert diffs.diff_lines(before, after) == ref_diffs.diff_lines(before, after)
    assert diffs.vulnerable_lines(before, after) == ref_diffs.vulnerable_lines(before, after)
    assert diffs.split_lines(before) == ref_diffs.split_lines(before)
