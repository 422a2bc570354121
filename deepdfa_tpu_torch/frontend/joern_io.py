"""Joern export import (the port's copy of the reference's
`deepdfa_tpu/frontend/joern_io.py`): drop-in backend for
reference-produced artifacts.

The reference drives the Joern JVM to emit `<file>.nodes.json` /
`<file>.edges.json` per function (DDFA/storage/external/get_func_graph.sc,
parsed by DDFA/sastvd/helpers/joern.py:182-319). Users who already ran that
preprocessing — or who want bit-exact Joern CPGs instead of the built-in
frontend — can load those files here into the same `Cpg` the rest of the
pipeline consumes.

Format: nodes.json is a list of records (id, _label, name, code,
lineNumber, order, typeFullName, ...); edges.json is a list of
[innode, outnode, etype, dataflow] rows where OUTNODE is the source and
INNODE the destination (reference get_cpg edge construction,
code_gnn/analysis/dataflow.py:243-245). Reference filters are applied:
COMMENT/FILE nodes and CONTAINS/SOURCE_FILE/DOMINATE/POST_DOMINATE edges
are dropped.
"""

from __future__ import annotations

import json
from pathlib import Path

from deepdfa_tpu_torch.frontend.cpg import Cpg

_DROP_NODE_LABELS = {"COMMENT", "FILE"}
_DROP_EDGE_TYPES = {"CONTAINS", "SOURCE_FILE", "DOMINATE", "POST_DOMINATE"}


def load_joern_cpg(path_prefix: str | Path) -> Cpg:
    """Load `<prefix>.nodes.json` + `<prefix>.edges.json` into a Cpg."""
    prefix = str(path_prefix)
    nodes_raw = json.loads(Path(prefix + ".nodes.json").read_text())
    edges_raw = json.loads(Path(prefix + ".edges.json").read_text())

    cpg = Cpg()
    dense: dict[int, int] = {}
    for rec in nodes_raw:
        label = rec.get("_label", "")
        if label in _DROP_NODE_LABELS:
            continue
        code = rec.get("code", "") or ""
        if code == "<empty>":
            code = ""
        name = rec.get("name", "") or ""
        if not code:
            code = name  # reference: code falls back to name
        line = rec.get("lineNumber")
        try:
            line = int(line) if line not in (None, "") else None
        except (TypeError, ValueError):
            line = None
        order = rec.get("order")
        try:
            order = int(order) if order not in (None, "") else 0
        except (TypeError, ValueError):
            order = 0
        nid = cpg.add_node(
            label=label,
            name=name,
            code=code,
            line=line,
            order=order,
            type_full_name=rec.get("typeFullName", "") or "ANY",
        )
        dense[int(rec["id"])] = nid
        if label == "METHOD" and cpg.method_id is None:
            cpg.method_id = nid
            cpg.method_name = name
        if label == "METHOD_RETURN" and cpg.method_return_id is None:
            cpg.method_return_id = nid

    for row in edges_raw:
        innode, outnode, etype = row[0], row[1], row[2]
        if etype in _DROP_EDGE_TYPES:
            continue
        try:
            src = dense[int(outnode)]
            dst = dense[int(innode)]
        except (KeyError, TypeError, ValueError):
            continue  # endpoint filtered out or synthetic id
        cpg.add_edge(src, dst, etype)
    return cpg


def load_joern_dataflow(path: str | Path) -> dict[str, dict[str, dict[int, frozenset[int]]]]:
    """Parse a `<file>.dataflow.json` reaching-definitions export.

    Produced by JoernSession.export_dataflow_json (role of the reference's
    get_dataflow_output.sc cache files, consumed via
    datasets.get_dataflow_output). Shape:
    {method fullName: {"in"|"out": {node id: frozenset(definition idx)}}}.
    """
    import re

    def node_id(key: str) -> int:
        # bare integer ids normally; tolerate joern-version drift where a
        # node's toString leaks through ("Call[label=CALL; id=42]")
        try:
            return int(key)
        except ValueError:
            m = re.search(r"id=(\d+)", key)
            if m:
                return int(m.group(1))
            raise ValueError(f"unparseable dataflow node key {key!r}")

    raw = json.loads(Path(path).read_text())
    out: dict[str, dict[str, dict[int, frozenset[int]]]] = {}
    for method, sol in raw.items():
        out[method] = {
            kind: {
                node_id(nid): frozenset(int(d) for d in defs)
                for nid, defs in sol.get(kind, {}).items()
            }
            for kind in ("in", "out")
        }
    return out
