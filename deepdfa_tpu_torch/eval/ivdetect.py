"""IVDetect per-line code-representation features (the port's copy of
the reference's `deepdfa_tpu/eval/ivdetect.py`).

The reference's `feature_extraction` (DDFA/sastvd/helpers/evaluate.py:
19-191) dumps, per statement line of a function, the five IVDetect
feature families consumed by its line-level baselines:

1. **subseq** — the line's code (longest code string among the line's
   nodes, prefixed with the local declaration type when present),
   tokenised with the IVDetect subtoken splitter (tokenise.py);
2. **ast** — the intra-line AST as `[parent_idx, child_idx, token_lists]`
   with per-line node indices, lone/parent nodes re-rooted onto index 0
   (evaluate.py:69-103);
3. **nametypes** — tokenised "type name" pairs for identifiers whose
   declared type is known on that line (the reference walks Joern's
   REF/EVAL_TYPE component, evaluate.py:106-124; the hermetic CPG carries
   declared types directly on IDENTIFIER/LOCAL nodes);
4. **data** — line-level DDG neighbours (reaching-def use-def edges,
   undirected, evaluate.py:127-168);
5. **control** — line-level CDG neighbours (Ferrante-Ottenstein-Warren
   control dependence, same treatment).

Output mirrors the reference's `[pdg_nodes, pdg_edges]` cache record:
a per-line feature table plus line-level PDG edge lists.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from deepdfa_tpu_torch.frontend.cpg import AST, Cpg
from deepdfa_tpu_torch.frontend.deps import control_dependences, data_dependences
from deepdfa_tpu_torch.frontend.tokenise import tokenise


@dataclasses.dataclass
class LineFeatures:
    line: int
    subseq: str
    ast: tuple[list[int], list[int], list[str]]
    nametypes: str
    data: list[int]
    control: list[int]


def _line_nodes(cpg: Cpg) -> dict[int, list[int]]:
    by_line: dict[int, list[int]] = {}
    for node in cpg.nodes:
        if node.line is None or node.label in ("METHOD", "METHOD_RETURN"):
            continue
        by_line.setdefault(int(node.line), []).append(node.id)
    return by_line


def _subseq(cpg: Cpg, nids: list[int]) -> str:
    """Longest code string on the line; LOCAL declarations contribute
    their type as a prefix (reference: local_type + " " + code)."""
    best = max(nids, key=lambda n: len(cpg.nodes[n].code or ""))
    code = cpg.nodes[best].code or ""
    local_types = [
        cpg.nodes[n].type_full_name
        for n in nids
        if cpg.nodes[n].label == "LOCAL"
        and cpg.nodes[n].type_full_name not in (None, "", "ANY")
    ]
    if local_types:
        code = f"{local_types[0]} {code}"
    return tokenise(code)


def _line_ast(
    cpg: Cpg, line: int, nids: list[int]
) -> tuple[list[int], list[int], list[str]]:
    """Intra-line AST with per-line indices; lone/parent nodes re-rooted
    under index 0 (evaluate.py:93-103)."""
    idx = {nid: i for i, nid in enumerate(sorted(nids))}
    parents: list[int] = []
    children: list[int] = []
    for src, dst, t in cpg.edges:
        if t != AST:
            continue
        if src in idx and dst in idx:
            parents.append(idx[src])
            children.append(idx[dst])
    all_idx = set(idx.values())
    lone = all_idx - set(parents) - set(children)
    roots = set(parents) - set(children)
    for n in sorted((lone | roots) - {0}):
        parents.append(0)
        children.append(n)
    codes = [tokenise(cpg.nodes[nid].code or "") for nid in sorted(nids)]
    return parents, children, codes


def _nametypes(cpg: Cpg, nids: list[int]) -> str:
    pairs: list[tuple[str, str]] = []
    seen = set()
    for nid in sorted(nids):
        node = cpg.nodes[nid]
        if node.label not in ("IDENTIFIER", "LOCAL"):
            continue
        typ = node.type_full_name
        if not typ or typ == "ANY" or not node.name:
            continue
        key = (typ, node.name)
        if key in seen:
            continue
        seen.add(key)
        pairs.append(key)
    return " ".join(f"{tokenise(t)} {tokenise(n)}" for t, n in pairs)


def _line_edges(cpg: Cpg, pairs: set[tuple[int, int]]) -> set[tuple[int, int]]:
    out: set[tuple[int, int]] = set()
    for a, b in pairs:
        la, lb = cpg.nodes[a].line, cpg.nodes[b].line
        if la is None or lb is None or la == lb:
            continue
        out.add((int(la), int(lb)))
    return out


def feature_extraction(
    cpg: Cpg,
) -> tuple[list[LineFeatures], tuple[list[int], list[int]]]:
    """Per-line IVDetect features + line-level PDG edges.

    Returns (rows sorted by line, (pdg_src_lines, pdg_dst_lines)) — the
    same record shape the reference caches per file
    (evaluate.py:173-191).
    """
    by_line = _line_nodes(cpg)
    ddg = _line_edges(cpg, data_dependences(cpg))
    cdg = _line_edges(cpg, control_dependences(cpg))

    data_adj: dict[int, set[int]] = {}
    control_adj: dict[int, set[int]] = {}
    for adj, pairs in ((data_adj, ddg), (control_adj, cdg)):
        for a, b in pairs:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set()).add(a)  # reference symmetrizes

    rows = [
        LineFeatures(
            line=line,
            subseq=_subseq(cpg, nids),
            ast=_line_ast(cpg, line, nids),
            nametypes=_nametypes(cpg, nids),
            data=sorted(data_adj.get(line, ())),
            control=sorted(control_adj.get(line, ())),
        )
        for line, nids in sorted(by_line.items())
    ]
    pdg = sorted(ddg | cdg)
    return rows, ([a for a, _ in pdg], [b for _, b in pdg])


def feature_extraction_code(code: str):
    from deepdfa_tpu_torch.frontend.parser import parse_function

    return feature_extraction(parse_function(code))


def dump_features(code: str, out_path: str | Path) -> None:
    """JSON dump (the reference pickles; JSON keeps the artifact
    inspectable and language-neutral)."""
    rows, pdg = feature_extraction_code(code)
    Path(out_path).write_text(
        json.dumps(
            {
                "lines": [dataclasses.asdict(r) for r in rows],
                "pdg_edges": pdg,
            },
            indent=1,
        )
    )
