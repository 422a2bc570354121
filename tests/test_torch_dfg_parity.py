"""The port's digit-exact java/c# dataflow (`eval/dfg_parity.py`) against
the reference's, exactly: comment stripping, the tree-sitter-shaped
mini-AST, the variable index, the DFG recursion's triples and states,
`get_data_flow`, `normalize_dataflow` and `corpus_dataflow_match`, on
every string of the reference's CodeBLEU tests and seeded variants of
them (tests/test_torch_codebleu_dialects.py), and on the reference's own
goldens.

Merged parent lists take the order of a set of strings in both
packages, so the comparisons run in this one process, under one hash
seed, and compare those lists as they come."""

import dataclasses

import pytest

pytest.importorskip("torch")

from deepdfa_tpu.eval import dfg_parity as ref  # noqa: E402

from deepdfa_tpu_torch.eval import dfg_parity as port  # noqa: E402
from tests.test_torch_codebleu_dialects import snippets, variants  # noqa: E402

LANGS = ("java", "c_sharp")


def inputs() -> tuple[str, ...]:
    return snippets() + variants()


def tree(node) -> tuple:
    return (node.type, node.idx, node.text, tuple(tree(c) for c in node.children),
            tuple(sorted((k, tree(v)) for k, v in node.fields.items())))


def attempt(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # the packages must fail alike
        return f"{type(e).__name__}: {e}"


def test_node_and_tables_equal():
    assert [f.name for f in dataclasses.fields(port.Node)] == [
        f.name for f in dataclasses.fields(ref.Node)]
    assert port.JAVA_KEYWORDS == ref.JAVA_KEYWORDS
    assert port.CSHARP_KEYWORDS == ref.CSHARP_KEYWORDS
    assert port._COMMENT_RE.pattern == ref._COMMENT_RE.pattern


def test_remove_comments_equal():
    for code in inputs():
        assert port.remove_comments(code) == ref.remove_comments(code)


@pytest.mark.parametrize("lang", LANGS)
def test_parse_snippet_and_variable_index_equal(lang):
    parsed = 0
    for code in inputs():
        got = attempt(port.parse_snippet, code, lang)
        want = attempt(ref.parse_snippet, code, lang)
        if isinstance(want, str):
            assert got == want, code
            continue
        parsed += 1
        assert tree(got) == tree(want), code
        assert [tree(n) for n in port.tree_to_variable_index(got)] == [
            tree(n) for n in ref.tree_to_variable_index(want)]
    assert parsed > 100


@pytest.mark.parametrize("lang", LANGS)
def test_dfg_extract_equal(lang):
    flows = 0
    for code in inputs():
        want = attempt(ref.parse_snippet, code, lang)
        if isinstance(want, str):
            continue
        got = attempt(port.dfg_extract, port.parse_snippet(code, lang), lang, {})
        assert got == attempt(ref.dfg_extract, want, lang, {}), code
        flows += not isinstance(got, str) and len(got[0]) > 0
    assert flows > 50


@pytest.mark.parametrize("lang", LANGS)
def test_get_data_flow_and_normalize_equal(lang):
    kept = 0
    for code in inputs():
        got = port.get_data_flow(code, lang)
        assert got == ref.get_data_flow(code, lang), code
        assert port.normalize_dataflow(got) == ref.normalize_dataflow(got)
        kept += len(got)
    assert kept > 100


@pytest.mark.parametrize("lang", LANGS)
def test_corpus_dataflow_match_equal(lang):
    snips, var = snippets(), variants()
    refs = [[s] if i % 2 else [s, var[3 * i + 2]] for i, s in enumerate(snips)]
    hyps = [var[3 * i] for i in range(len(snips))]
    got = port.corpus_dataflow_match(refs, hyps, lang)
    assert got == ref.corpus_dataflow_match(refs, hyps, lang)
    assert 0.0 < got < 1.0
    flat = [[s] for s in snips]
    assert port.corpus_dataflow_match(flat, snips, lang) == 1.0
    assert port.corpus_dataflow_match([["int x;"]], ["int x;"], lang) == 0.0


def test_reference_goldens_hold_for_the_port():
    """A few of the reference's hand-derived goldens
    (tests/test_dfg_parity.py), on the port."""
    assert port.get_data_flow("int x;", "java") == []
    kept = [(t[0], t[1], t[2], sorted(t[3]), sorted(t[4]))
            for t in port.get_data_flow("int x = 5;\nint y = x + 2;\nx = y;", "java")]
    assert ("y", 6, "comesFrom", ["2", "x"], [8, 10]) in kept
    norm = port.normalize_dataflow(port.get_data_flow("x = y;\nz = x;", "java"))
    assert ("var_1", "computedFrom", ["var_0"]) in norm
    assert ("var_2", "computedFrom", ["var_1"]) in norm
    assert port.corpus_dataflow_match([["int total = start;\ntotal += delta;"]],
                                      ["int sum = s0;\nsum += d;"], "java") == 1.0
