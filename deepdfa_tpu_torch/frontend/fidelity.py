"""CPG fidelity measurement: hermetic frontend vs Joern exports (the
port's copy of the reference's `deepdfa_tpu/frontend/fidelity.py`).

The framework replaces Joern (the reference's external JVM analyzer,
get_func_graph.sc:26-80) with the hermetic parser in frontend/parser.py;
CPG-shape divergence on real C code is the main effectiveness risk.
This module quantifies agreement between two CPGs of the
same function — typically parse_function(code) vs
load_joern_cpg(export) — on the signals that actually feed the model:

- statement coverage: CFG-participating source lines (the GGNN's nodes),
- cfg_edge_jaccard: CFG edges as (src_line, dst_line) pairs — the
  message-passing structure,
- def_line_jaccard: lines holding definition nodes (is_decl),
- hash_agreement: fraction of common def lines whose abstract-dataflow
  feature hash (to_hash over decl_features) is identical — the exact
  quantity that indexes the learned embedding table.

Line-keyed comparison deliberately ignores node-id numbering and interior
AST shape: two extractors that disagree there but agree on these metrics
produce identical model inputs.
"""

from __future__ import annotations

import json
from typing import Iterable

from deepdfa_tpu_torch.frontend.absdf import graph_features
from deepdfa_tpu_torch.frontend.cpg import CFG, Cpg


def _cfg_lines(cpg: Cpg) -> set[int]:
    out = set()
    for nid in cpg.cfg_nodes():
        n = cpg.node(nid)
        if n.line is not None and n.label not in ("METHOD", "METHOD_RETURN"):
            out.add(int(n.line))
    return out


def _cfg_line_edges(cpg: Cpg) -> set[tuple[int, int]]:
    out = set()
    for s, d, t in cpg.edges:
        if t != CFG:
            continue
        ls, ld = cpg.node(s).line, cpg.node(d).line
        if ls is not None and ld is not None and ls != ld:
            out.add((int(ls), int(ld)))
    return out


def _def_hashes_by_line(cpg: Cpg) -> dict[int, set[str]]:
    """line -> set of abstract-dataflow hashes of its definition nodes."""
    out: dict[int, set[str]] = {}
    for nid, h in graph_features(cpg).items():
        line = cpg.node(nid).line
        if line is not None:
            out.setdefault(int(line), set()).add(h)
    return out


def _jaccard(a: set, b: set) -> float:
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)


def _rd_in_lines(cpg: Cpg) -> dict[int, set[int]]:
    """Line-keyed reaching-definitions IN sets: statement line -> the set
    of definition LINES reaching it (the hermetic solver runs on whatever
    CPG it is given, so comparing two CPGs through this isolates graph
    divergence from solver divergence)."""
    from deepdfa_tpu_torch.frontend.reaching import ReachingDefinitions

    rd = ReachingDefinitions(cpg)
    by_line: dict[int, set[int]] = {}
    for nid, defs in rd.solve().items():
        line = cpg.nodes[nid].line
        if line is None:
            continue
        by_line.setdefault(int(line), set()).update(
            int(cpg.nodes[d.node].line)
            for d in defs
            if cpg.nodes[d.node].line is not None
        )
    return by_line


def compare_cpgs(ours: Cpg, theirs: Cpg) -> dict:
    """Agreement metrics between two CPGs of the same function."""
    lines_a, lines_b = _cfg_lines(ours), _cfg_lines(theirs)
    edges_a, edges_b = _cfg_line_edges(ours), _cfg_line_edges(theirs)
    defs_a = _def_hashes_by_line(ours)
    defs_b = _def_hashes_by_line(theirs)
    common_def_lines = set(defs_a) & set(defs_b)
    # a line agrees only when BOTH sides produce the identical hash set —
    # a missing/extra definition node is a real model-input divergence
    hash_match = sum(
        1 for ln in common_def_lines if defs_a[ln] == defs_b[ln]
    )
    rd_a, rd_b = _rd_in_lines(ours), _rd_in_lines(theirs)
    rd_lines = set(rd_a) | set(rd_b)
    rd_in_jaccard = (
        sum(_jaccard(rd_a.get(ln, set()), rd_b.get(ln, set())) for ln in rd_lines)
        / len(rd_lines)
        if rd_lines
        else 1.0
    )
    return {
        "stmt_line_jaccard": round(_jaccard(lines_a, lines_b), 4),
        "cfg_edge_jaccard": round(_jaccard(edges_a, edges_b), 4),
        "def_line_jaccard": round(
            _jaccard(set(defs_a), set(defs_b)), 4
        ),
        "hash_agreement": round(
            hash_match / len(common_def_lines), 4
        )
        if common_def_lines
        else 1.0,
        "rd_in_jaccard": round(rd_in_jaccard, 4),
        "n_stmt_lines": (len(lines_a), len(lines_b)),
        "n_cfg_edges": (len(edges_a), len(edges_b)),
        "n_def_lines": (len(defs_a), len(defs_b)),
    }


def agreement_report(pairs: Iterable[tuple[str, Cpg, Cpg]]) -> dict:
    """Aggregate compare_cpgs over (name, ours, theirs) pairs."""
    per_example = {}
    sums: dict[str, float] = {}
    n = 0
    for name, ours, theirs in pairs:
        m = compare_cpgs(ours, theirs)
        per_example[name] = m
        for k in ("stmt_line_jaccard", "cfg_edge_jaccard",
                  "def_line_jaccard", "hash_agreement", "rd_in_jaccard"):
            sums[k] = sums.get(k, 0.0) + m[k]
        n += 1
    report = {
        "n_examples": n,
        "mean": {k: round(v / n, 4) for k, v in sums.items()} if n else {},
        "per_example": per_example,
    }
    return report


def cpg_line_spec(cpg: Cpg) -> dict:
    """Line-level CPG spec: the exact signals the fidelity metrics read.

    {stmt_lines, cfg_edges (src_line,dst_line pairs), def_lines} — the
    compact ground-truth format used by the committed fidelity corpus
    (tests/fidelity_corpus/expected.json). Hash agreement needs full CPG
    structure and stays on the builder fixtures (tests/joern_fixtures.py).
    """
    return {
        "stmt_lines": sorted(_cfg_lines(cpg)),
        "cfg_edges": sorted(list(e) for e in _cfg_line_edges(cpg)),
        "def_lines": sorted(_def_hashes_by_line(cpg)),
    }


def compare_to_spec(cpg: Cpg, spec: dict) -> dict:
    """Agreement metrics between a CPG and a hand-specified line spec."""
    lines_a = _cfg_lines(cpg)
    edges_a = _cfg_line_edges(cpg)
    defs_a = set(_def_hashes_by_line(cpg))
    lines_b = set(spec["stmt_lines"])
    edges_b = {tuple(e) for e in spec["cfg_edges"]}
    defs_b = set(spec["def_lines"])
    return {
        "stmt_line_jaccard": round(_jaccard(lines_a, lines_b), 4),
        "cfg_edge_jaccard": round(_jaccard(edges_a, edges_b), 4),
        "def_line_jaccard": round(_jaccard(defs_a, defs_b), 4),
        "n_stmt_lines": (len(lines_a), len(lines_b)),
        "n_cfg_edges": (len(edges_a), len(edges_b)),
        "n_def_lines": (len(defs_a), len(defs_b)),
    }


def corpus_report(corpus_dir, expected_path=None) -> dict:
    """Fidelity report over a committed corpus directory.

    corpus_dir holds one function per .c/.cc file; expected_path (default
    <corpus_dir>/expected.json) maps file stem -> line spec. Aggregates
    the same jaccards as agreement_report.
    """
    from pathlib import Path

    from deepdfa_tpu_torch.frontend.parser import parse_function

    corpus_dir = Path(corpus_dir)
    expected_path = Path(expected_path or corpus_dir / "expected.json")
    expected = json.loads(expected_path.read_text())
    per_example = {}
    sums: dict[str, float] = {}
    for path in sorted(corpus_dir.glob("*.c*")):
        name = path.stem
        if name not in expected:
            continue
        m = compare_to_spec(parse_function(path.read_text()), expected[name])
        per_example[name] = m
        for k in ("stmt_line_jaccard", "cfg_edge_jaccard", "def_line_jaccard"):
            sums[k] = sums.get(k, 0.0) + m[k]
    n = len(per_example)
    return {
        "n_examples": n,
        "mean": {k: round(v / n, 4) for k, v in sums.items()} if n else {},
        "per_example": per_example,
    }


def fidelity_against_joern(
    sources: dict[str, str],
    joern_prefixes: dict[str, str] | None = None,
    session=None,
) -> dict:
    """Compare the hermetic parser against Joern on named C functions.

    sources: name -> C code. Joern CPGs come from `joern_prefixes`
    (name -> path prefix of existing .nodes.json/.edges.json exports) or,
    when a live `session` (frontend/joern_session.JoernSession) is given,
    from driving the real binary per function.
    """
    import tempfile
    from pathlib import Path

    from deepdfa_tpu_torch.frontend.joern_io import load_joern_cpg
    from deepdfa_tpu_torch.frontend.parser import parse_function

    pairs = []
    for name, code in sources.items():
        ours = parse_function(code)
        if joern_prefixes and name in joern_prefixes:
            theirs = load_joern_cpg(joern_prefixes[name])
        elif session is not None:
            d = Path(tempfile.mkdtemp(prefix="fidelity-"))
            src = d / f"{name}.c"
            src.write_text(code)
            session.import_code(src)
            session.export_cpg_json(src)
            theirs = load_joern_cpg(src)
        else:
            raise ValueError(f"no joern source for {name!r}")
        pairs.append((name, ours, theirs))
    return agreement_report(pairs)


def main(argv=None) -> None:  # pragma: no cover - thin CLI shim
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sources", nargs="*", help="C files to compare")
    ap.add_argument(
        "--corpus", default=None,
        help="corpus dir with *.c/*.cc + expected.json line specs "
        "(e.g. tests/fidelity_corpus)",
    )
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from pathlib import Path

    if args.corpus:
        report = corpus_report(args.corpus)
        text = json.dumps(report, indent=2)
        print(text)
        if args.out:
            Path(args.out).write_text(text)
        return

    from deepdfa_tpu_torch.frontend import joern_session

    sources = {Path(p).stem: Path(p).read_text() for p in args.sources}
    prefixes = {
        Path(p).stem: p
        for p in args.sources
        if Path(p + ".nodes.json").exists()
    }
    session = None
    if len(prefixes) < len(sources) and joern_session.available():
        session = joern_session.JoernSession()
    report = fidelity_against_joern(sources, prefixes, session)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text)


if __name__ == "__main__":  # pragma: no cover
    main()
