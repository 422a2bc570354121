"""CodeBLEU: ngram + weighted-ngram + syntax + dataflow match (the port's
copy of the reference's `deepdfa_tpu/eval/codebleu.py`; the role of
CodeT5/evaluator/CodeBLEU/calc_code_bleu.py:11-63):

    CodeBLEU = alpha * BLEU + beta * BLEU_weighted
             + gamma * Match_ast + theta * Match_df

- BLEU: corpus BLEU with clipped micro-averaged n-gram precision, the
  closest-reference brevity penalty and epsilon smoothing on zero counts
  (NLTK's SmoothingFunction().method1). The generation trainer scores
  decoded token sequences with `corpus_bleu`.
- weighted BLEU: per-reference modified recall with keyword-weighted
  unigram counts (1.0 for a language keyword, 0.2 otherwise; `KEYWORDS`).
- syntax match: the fraction of the reference's AST subtrees (as
  s-expressions of node labels) found in the candidate's. The AST comes
  from the port's frontend in the language's dialect (`LANG_DIALECT`: c
  and cpp through the C grammar; java, c_sharp, javascript, php, go and
  ruby through its dialect-gated extensions, frontend/parser.py) or from
  the stdlib `ast` module (python).
- dataflow match: the fraction of the reference's normalized def-use
  triples (var_i, relation, [var_j...]) found in the candidate's. java
  and c_sharp take eval/dfg_parity.py (DFG_java/DFG_csharp over a
  tree-sitter-shaped mini-AST, digit-exact with the reference
  evaluator); the other languages take the reaching-definitions solver
  (frontend/reaching.py, its "auto" backend: the native solver where g++
  builds it, the same sets as the Python one); python a source-order walk
  of its AST.

Both structural scores degenerate to 0 with the reference evaluator's
warning when nothing parses (dataflow_match.py:61-64). Each language's
numbers equal the reference package's exactly
(tests/test_torch_codebleu_dialects.py).
"""

from __future__ import annotations

import functools
import logging
import math
from collections import Counter
from typing import Iterable, Sequence

logger = logging.getLogger(__name__)

_EPSILON = 0.1  # NLTK SmoothingFunction default, used by the reference

# language keyword tables for the weighted-ngram match
# (role of CodeBLEU/keywords/<lang>.txt; standard-defined keyword sets)
KEYWORDS: dict[str, frozenset[str]] = {
    "c": frozenset(
        """auto break case char const continue default do double else enum
        extern float for goto if inline int long register restrict return
        short signed sizeof static struct switch typedef union unsigned void
        volatile while _Bool _Complex _Imaginary""".split()
    ),
    "java": frozenset(
        """abstract assert boolean break byte case catch char class const
        continue default do double else enum extends final finally float for
        goto if implements import instanceof int interface long native new
        package private protected public return short static strictfp super
        switch synchronized this throw throws transient try void volatile
        while""".split()
    ),
    "python": frozenset(
        """False None True and as assert async await break class continue def
        del elif else except finally for from global if import in is lambda
        nonlocal not or pass raise return try while with yield""".split()
    ),
}
KEYWORDS["cpp"] = KEYWORDS["c"] | frozenset(
    """alignas alignof bool catch class constexpr const_cast decltype delete
    dynamic_cast explicit export false friend mutable namespace new noexcept
    nullptr operator private protected public reinterpret_cast static_assert
    static_cast template this thread_local throw true try typeid typename
    using virtual wchar_t""".split()
)
# C# keyword + contextual-keyword set (standard-defined; same contents as
# the reference's keywords/c_sharp.txt — the only keyword file besides
# java.txt the reference actually ships, so java+c_sharp is the complete
# runnable surface of its evaluator)
KEYWORDS["c_sharp"] = frozenset(
    """abstract as base bool break byte case catch char checked class const
    continue decimal default delegate do double else enum event explicit
    extern false finally fixed float for foreach goto if implicit in int
    interface internal is lock long namespace new null object operator out
    override params private protected public readonly ref return sbyte
    sealed short sizeof stackalloc static string struct switch this throw
    true try typeof uint ulong unchecked unsafe ushort using virtual void
    volatile while add alias ascending async await by descending dynamic
    equals from get global group into join let nameof notnull on orderby
    partial remove select set unmanaged value var when where yield""".split()
)

# ECMAScript reserved words + strict-mode/contextual additions
# (standard-defined set; role of a keywords/javascript.txt the reference
# does not ship — its evaluator cannot actually run js, see _check_lang)
KEYWORDS["javascript"] = frozenset(
    """await break case catch class const continue debugger default delete
    do else enum export extends false finally for function if implements
    import in instanceof interface let new null of package private
    protected public return static super switch this throw true try
    typeof var void while with yield async get set""".split()
)

# PHP reserved words + compile-time constants (standard-defined set;
# role of the keywords/php.txt the reference does not ship)
KEYWORDS["php"] = frozenset(
    """abstract and array as break callable case catch class clone const
    continue declare default die do echo else elseif empty enddeclare
    endfor endforeach endif endswitch endwhile eval exit extends final
    finally fn for foreach function global goto if implements include
    include_once instanceof insteadof interface isset list match
    namespace new or print private protected public readonly require
    require_once return static switch throw trait try unset use var
    while xor yield true false null""".split()
)

# Go spec keyword set + predeclared constants (standard-defined; role of
# the keywords/go.txt the reference does not ship)
KEYWORDS["go"] = frozenset(
    """break case chan const continue default defer else fallthrough for
    func go goto if import interface map package range return select
    struct switch type var true false nil iota""".split()
)
# Ruby keyword set (standard-defined; role of the keywords/ruby.txt the
# reference does not ship)
KEYWORDS["ruby"] = frozenset(
    """BEGIN END alias and begin break case class def defined? do else
    elsif end ensure false for if in module next nil not or redo rescue
    retry return self super then true undef unless until when while
    yield""".split()
)

#: CodeBLEU lang -> frontend parser dialect (frontend/parser.py); python
#: goes through the stdlib-ast backend instead
LANG_DIALECT: dict[str, str] = {
    "c": "c",
    "cpp": "c",
    "java": "java",
    "c_sharp": "cs",
    "javascript": "js",
    "php": "php",
    "go": "go",
    "ruby": "ruby",
}

#: snippet wrapper per dialect for bare statement sequences
_WRAPPERS = {
    "js": "function __snippet__() {\n%s\n}",
    "php": "function __snippet__() {\n%s\n}",
    "go": "func __snippet__() {\n%s\n}",
    "ruby": "def __snippet__\n%s\nend",
}


# ---------------------------------------------------------------------------
# n-gram matches
# ---------------------------------------------------------------------------


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def _closest_ref_length(references: Sequence[Sequence[str]], hyp_len: int) -> int:
    return min(
        (len(r) for r in references),
        key=lambda rl: (abs(rl - hyp_len), rl),
    )


def _brevity_penalty(ref_len: int, hyp_len: int) -> float:
    if hyp_len > ref_len:
        return 1.0
    if hyp_len == 0:
        return 0.0
    return math.exp(1 - ref_len / hyp_len)


def _combine(p_n: list[tuple[float, int]], weights, bp: float) -> float:
    """exp(sum w_i log p_i) with epsilon smoothing on zero numerators."""
    if p_n[0][0] == 0:
        return 0.0
    s = 0.0
    for w, (num, den) in zip(weights, p_n):
        num = num if num != 0 else _EPSILON
        s += w * math.log(num / max(den, 1))
    return bp * math.exp(s)


def corpus_bleu(
    list_of_references: Sequence[Sequence[Sequence[str]]],
    hypotheses: Sequence[Sequence[str]],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
) -> float:
    """Corpus BLEU with clipped micro-averaged precision (bleu.py role)."""
    assert len(list_of_references) == len(hypotheses)
    numer = Counter()
    denom = Counter()
    hyp_lengths = 0
    ref_lengths = 0
    for references, hyp in zip(list_of_references, hypotheses):
        for n, _ in enumerate(weights, start=1):
            hyp_counts = _ngrams(hyp, n)
            max_ref = Counter()
            for ref in references:
                for g, c in _ngrams(ref, n).items():
                    max_ref[g] = max(max_ref[g], c)
            clipped = {g: min(c, max_ref[g]) for g, c in hyp_counts.items()}
            numer[n] += sum(clipped.values())
            denom[n] += max(1, sum(hyp_counts.values()))
        hyp_lengths += len(hyp)
        ref_lengths += _closest_ref_length(references, len(hyp))
    bp = _brevity_penalty(ref_lengths, hyp_lengths)
    p_n = [(numer[n], denom[n]) for n, _ in enumerate(weights, start=1)]
    return _combine(p_n, weights, bp)


def weighted_corpus_bleu(
    list_of_references: Sequence[Sequence[Sequence[str]]],
    hypotheses: Sequence[Sequence[str]],
    keywords: frozenset[str],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    keyword_weight: float = 1.0,
    other_weight: float = 0.2,
) -> float:
    """Keyword-weighted variant (weighted_ngram_match.py role): modified
    n-gram *recall* accumulated per reference, with unigram counts scaled
    by token weights (keywords count 5x as much as other tokens)."""
    assert len(list_of_references) == len(hypotheses)
    numer = Counter()
    denom = Counter()
    hyp_lengths = 0
    ref_lengths = 0

    def w(tok: str) -> float:
        return keyword_weight if tok in keywords else other_weight

    for references, hyp in zip(list_of_references, hypotheses):
        for n, _ in enumerate(weights, start=1):
            hyp_counts = _ngrams(hyp, n)
            for ref in references:
                ref_counts = _ngrams(ref, n)
                clipped = {
                    g: min(c, hyp_counts[g]) for g, c in ref_counts.items()
                }
                if n == 1:
                    numer[n] += sum(c * w(g[0]) for g, c in clipped.items())
                    denom[n] += max(
                        1, sum(c * w(g[0]) for g, c in ref_counts.items())
                    )
                else:
                    numer[n] += sum(clipped.values())
                    denom[n] += max(1, sum(ref_counts.values()))
        hyp_lengths += len(hyp)
        ref_lengths += _closest_ref_length(references, len(hyp))
    bp = _brevity_penalty(ref_lengths, hyp_lengths)
    p_n = [(numer[n], denom[n]) for n, _ in enumerate(weights, start=1)]
    return _combine(p_n, weights, bp)


# ---------------------------------------------------------------------------
# syntax match (AST subtrees via the hermetic frontend)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def _parse(code: str, dialect: str = "c"):
    """Parse a snippet with the hermetic frontend; None on failure.

    Generated snippets are frequently bare statement sequences, so a
    function wrapper is tried when direct parsing fails (the reference
    swallows parse failures the same way, syntax_match.py:36-43). Cached:
    the syntax and dataflow matchers score the same snippets, and CPG
    construction dominates CodeBLEU runtime.
    """
    from deepdfa_tpu_torch.frontend.parser import parse_function

    wrapper = _WRAPPERS.get(dialect, "void __snippet__() {\n%s\n}") % code
    for candidate in (code, wrapper):
        try:
            return parse_function(candidate, dialect=dialect)
        except Exception:
            continue
    return None


def _subtree_sexps(cpg) -> list[str]:
    """S-expressions (node labels only, like tree-sitter's sexp) for every
    AST node that has children, plus the root (syntax_match.py:49-61)."""
    from deepdfa_tpu_torch.frontend.cpg import AST

    children: dict[int, list[int]] = {}
    has_parent: set[int] = set()
    for s, d, t in cpg.edges:
        if t == AST:
            children.setdefault(s, []).append(d)
            has_parent.add(d)

    def sexp(nid: int) -> str:
        kids = sorted(
            children.get(nid, []),
            key=lambda k: (cpg.nodes[k].order or 0, k),
        )
        label = cpg.nodes[nid].label
        if not kids:
            return f"({label})"
        return f"({label} " + " ".join(sexp(k) for k in kids) + ")"

    roots = [n.id for n in cpg.nodes if n.id not in has_parent]
    out: list[str] = []
    stack = list(roots)
    while stack:
        nid = stack.pop()
        kids = children.get(nid, [])
        if kids or nid in roots:
            out.append(sexp(nid))
        stack.extend(kids)
    return out


# ---------------------------------------------------------------------------
# python structural backends (stdlib ast replaces tree-sitter's grammar;
# reference: CodeT5/evaluator/CodeBLEU/parser/DFG.py DFG_python)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4096)
def _parse_py(code: str):
    import ast
    import textwrap

    for candidate in (code, textwrap.dedent(code)):
        try:
            return ast.parse(candidate)
        except SyntaxError:
            continue
    return None


def _py_sexps(tree) -> list[str]:
    """S-expressions of python AST node type names for every node with
    children (same shape as the tree-sitter sexps used on C)."""
    import ast

    out: list[str] = []

    def sexp(node) -> str:
        kids = list(ast.iter_child_nodes(node))
        label = type(node).__name__
        if not kids:
            return f"({label})"
        return f"({label} " + " ".join(sexp(k) for k in kids) + ")"

    def walk(node, is_root=False):
        kids = list(ast.iter_child_nodes(node))
        if kids or is_root:
            out.append(sexp(node))
        for k in kids:
            walk(k)

    walk(tree, is_root=True)
    return out


def _py_dataflow_triples(tree) -> list[tuple[str, str, tuple[str, ...]]]:
    """Def-use triples from a python AST, in source order:

    - assignment/aug-assignment/for-target/with-as/arg: ("x",
      "computedFrom", (rhs names...))
    - a Load of a name with a prior definition: ("x", "comesFrom", ("x",))

    Same triple vocabulary as the C extractor above and the reference DFG
    functions; like the reference's DFG_python it is a linear (source
    -order) approximation, not a full-CFG solution.
    """
    import ast

    triples: list[tuple[str, str, tuple[str, ...]]] = []
    defined: set[str] = set()

    def names_in(node) -> tuple[str, ...]:
        return tuple(
            sorted(
                {
                    n.id
                    for n in ast.walk(node)
                    if isinstance(n, ast.Name)
                }
            )
        )

    def define(target, rhs: tuple[str, ...]):
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                triples.append((n.id, "computedFrom", rhs))
                defined.add(n.id)

    def visit(node):
        if isinstance(node, ast.Assign):
            visit_children(node.value)
            rhs = names_in(node.value)
            for t in node.targets:
                define(t, rhs)
            return
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if node.value is not None:
                visit_children(node.value)
                define(node.target, names_in(node.value))
            return
        if isinstance(node, ast.For):
            visit_children(node.iter)
            define(node.target, names_in(node.iter))
            for b in node.body + node.orelse:
                visit(b)
            return
        if isinstance(node, ast.withitem) and node.optional_vars is not None:
            visit_children(node.context_expr)
            define(node.optional_vars, names_in(node.context_expr))
            return
        if isinstance(node, ast.arg):
            defined.add(node.arg)
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in defined:
                triples.append((node.id, "comesFrom", (node.id,)))
            return
        visit_children(node)

    def visit_children(node):
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit_children(tree)
    return triples


def corpus_syntax_match(
    list_of_references: Sequence[Sequence[str]],
    candidates: Sequence[str],
    lang: str = "c",
) -> float:
    _check_lang(lang)
    if lang == "python":
        parse, sexps = _parse_py, _py_sexps
    else:
        parse = functools.partial(_parse, dialect=LANG_DIALECT[lang])
        sexps = _subtree_sexps
    match = 0
    total = 0
    for references, cand in zip(list_of_references, candidates):
        cand_cpg = parse(cand)
        cand_sexps = sexps(cand_cpg) if cand_cpg else []
        for ref in references:
            ref_cpg = parse(ref)
            if ref_cpg is None:
                continue
            ref_sexps = sexps(ref_cpg)
            match += sum(1 for s in ref_sexps if s in cand_sexps)
            total += len(ref_sexps)
    if total == 0:
        logger.warning(
            "no reference ASTs parsed; syntax match degenerates to 0"
        )
        return 0.0
    return match / total


# ---------------------------------------------------------------------------
# dataflow match (def-use triples via the reaching-definitions solver)
# ---------------------------------------------------------------------------


def _dataflow_triples(cpg) -> list[tuple[str, str, tuple[str, ...]]]:
    """(var, relation, parent-vars) triples:

    - ("x", "computedFrom", (rhs vars...)) for every definition x = expr
    - ("x", "comesFrom", (defining vars...)) for every use of x reached by
      at least one definition (from the worklist solver)
    Triple vocabulary mirrors the reference DFG functions (parser/DFG.py).
    """
    from deepdfa_tpu_torch.frontend.reaching import ReachingDefinitions

    rd = ReachingDefinitions(cpg)

    def identifiers(root: int) -> list[str]:
        ids = []
        for nid in [root, *cpg.ast_descendants(root)]:
            node = cpg.nodes[nid]
            if node.label == "IDENTIFIER":
                ids.append(node.code)
        return ids

    triples: list[tuple[str, str, tuple[str, ...]]] = []
    in_sets = rd.solve()
    for n in rd.cfg_nodes:
        reaching = in_sets.get(n, set())
        uses = sorted(set(identifiers(n)))
        for d in rd.gen_set[n]:
            args = cpg.arguments(n)
            rhs_roots = args[1:] if len(args) > 1 else args[:1]
            rhs = sorted(
                {i for r in rhs_roots for i in identifiers(r)}
            )
            triples.append((d.var, "computedFrom", tuple(rhs)))
        for u in uses:
            if any(dd.var == u for dd in reaching):
                triples.append((u, "comesFrom", (u,)))
    return triples


def _normalize_dataflow(
    triples: Iterable[tuple[str, str, tuple[str, ...]]]
) -> list[tuple[str, str, tuple[str, ...]]]:
    """Alpha-rename variables in order of appearance
    (dataflow_match.py:132-148): parents first, then the target var."""
    var_map: dict[str, str] = {}

    def norm(v: str) -> str:
        if v not in var_map:
            var_map[v] = f"var_{len(var_map)}"
        return var_map[v]

    out = []
    for var, rel, parents in triples:
        normed_parents = tuple(norm(p) for p in parents)
        out.append((norm(var), rel, normed_parents))
    return out


def corpus_dataflow_match(
    list_of_references: Sequence[Sequence[str]],
    candidates: Sequence[str],
    lang: str = "c",
) -> float:
    _check_lang(lang)
    if lang in ("java", "c_sharp"):
        # digit-exact path: a faithful port of the reference's
        # DFG_java/DFG_csharp recursion + dataflow_match.py pipeline
        # over a tree-sitter-shaped mini-AST (eval/dfg_parity.py;
        # golden-pinned in tests/test_dfg_parity.py). The remaining
        # languages keep the reaching-defs approximation below.
        from deepdfa_tpu_torch.eval import dfg_parity

        return dfg_parity.corpus_dataflow_match(
            list_of_references, candidates, lang
        )
    if lang == "python":
        parse, triples_fn = _parse_py, _py_dataflow_triples
    else:
        parse = functools.partial(_parse, dialect=LANG_DIALECT[lang])
        triples_fn = _dataflow_triples
    match = 0
    total = 0
    for references, cand in zip(list_of_references, candidates):
        cand_cpg = parse(cand)
        cand_dfg = (
            _normalize_dataflow(triples_fn(cand_cpg))
            if cand_cpg
            else []
        )
        for ref in references:
            ref_cpg = parse(ref)
            if ref_cpg is None:
                continue
            ref_dfg = _normalize_dataflow(triples_fn(ref_cpg))
            if not ref_dfg:
                continue
            remaining = list(cand_dfg)
            total += len(ref_dfg)
            for t in ref_dfg:
                if t in remaining:
                    match += 1
                    remaining.remove(t)
    if total == 0:
        logger.warning(
            "no reference data-flows extracted; dataflow match degenerates "
            "to 0 (reference emits the same warning, dataflow_match.py:61-64)"
        )
        return 0.0
    return match / total


# ---------------------------------------------------------------------------
# the composite score
# ---------------------------------------------------------------------------


def _check_lang(lang: str) -> None:
    if lang not in set(LANG_DIALECT) | {"python"}:
        raise ValueError(
            f"lang={lang!r}: structural matches need a parser; supported "
            f"langs are {sorted(set(LANG_DIALECT) | {'python'})} (hermetic "
            "frontend dialects + stdlib ast for python) — already beyond "
            "the reference evaluator's runnable surface (java+c_sharp, "
            "the only keyword lists it ships, calc_code_bleu.py:39). "
            "Anything else is descoped — see docs/PARITY.md."
        )


def get_codebleu(
    references: Sequence[str] | Sequence[Sequence[str]],
    hypotheses: Sequence[str],
    lang: str = "c",
    params: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
) -> dict[str, float]:
    """Composite CodeBLEU over parallel corpora (calc_code_bleu.py:11-63).

    `references` is either one string per hypothesis or a list of
    reference variants per hypothesis. Returns all four components plus
    the weighted composite under "codebleu".
    """
    _check_lang(lang)  # before KEYWORDS[lang] can KeyError on e.g. "swift"
    refs: list[list[str]] = [
        [r] if isinstance(r, str) else list(r) for r in references
    ]
    if len(refs) != len(hypotheses):
        raise ValueError(
            f"{len(refs)} references vs {len(hypotheses)} hypotheses"
        )
    if len(params) != 4:
        raise ValueError(
            f"params needs 4 weights (alpha,beta,gamma,theta), got {params}"
        )
    alpha, beta, gamma, theta = params

    tokenized_hyps = [h.split() for h in hypotheses]
    tokenized_refs = [[r.split() for r in rr] for rr in refs]

    ngram = corpus_bleu(tokenized_refs, tokenized_hyps)
    weighted = weighted_corpus_bleu(
        tokenized_refs, tokenized_hyps, KEYWORDS[lang]
    )
    syntax = corpus_syntax_match(refs, hypotheses, lang)
    dataflow = corpus_dataflow_match(refs, hypotheses, lang)
    return {
        "ngram_match": ngram,
        "weighted_ngram_match": weighted,
        "syntax_match": syntax,
        "dataflow_match": dataflow,
        "codebleu": alpha * ngram
        + beta * weighted
        + gamma * syntax
        + theta * dataflow,
    }
