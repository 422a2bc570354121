"""Abstract-dataflow feature extraction.

Faithful re-implementation of the reference's two-stage extractor
(DDFA/sastvd/scripts/abstract_dataflow_full.py):

stage 1 — per definition node (CALL with assignment-family name,
is_decl :44-51), collect (subkey, value) fields:
  datatype: recurse the first argument down accessor/cast operators to the
            underlying IDENTIFIER's declared type (:67-121), then clean it
            (strip const, collapse [N] -> [], squeeze spaces, :240-250)
  literal:  code of every LITERAL AST-descendant (:153-154)
  operator: "<operator>.X" descendant call names minus "indirection" (:155-159)
  api:      names of non-operator descendant CALLs (:160-162)
AST descendants skip METHOD subtrees (:136-145).

stage 2 — per node, hash = json dump of {subkey: sorted values} over the
selected subkeys (to_hash :285-295).

The port's copy of the reference's `deepdfa_tpu/frontend/absdf.py`.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Iterable

from deepdfa_tpu_torch.frontend.cpg import Cpg

ALL_SUBKEYS = ("api", "datatype", "literal", "operator")

_ASSIGNMENT_TYPES = frozenset(
    f"<operator>.{op}"
    for op in (
        "assignmentDivision", "assignmentExponentiation", "assignmentPlus",
        "assignmentMinus", "assignmentModulo", "assignmentMultiplication",
        "preIncrement", "preDecrement", "postIncrement", "postDecrement",
        "assignment", "assignmentOr", "assignmentAnd", "assignmentXor",
        "assignmentArithmeticShiftRight", "assignmentLogicalShiftRight",
        "assignmentShiftLeft",
    )
)

# operator name -> which argument (1-based order) holds the variable whose
# datatype we want (reference name_idx, abstract_dataflow_full.py:72-84)
_DATATYPE_ARG_IDX = {
    "<operator>.indirectIndexAccess": 1,
    "<operator>.indirectFieldAccess": 1,
    "<operator>.indirection": 1,
    "<operator>.fieldAccess": 1,
    "<operator>.postIncrement": 1,
    "<operator>.postDecrement": 1,
    "<operator>.preIncrement": 1,
    "<operator>.preDecrement": 1,
    "<operator>.addressOf": 1,
    "<operator>.cast": 2,
    "<operator>.addition": 1,
}


def is_decl(cpg: Cpg, nid: int) -> bool:
    n = cpg.nodes[nid]
    return n.label == "CALL" and n.name in _ASSIGNMENT_TYPES


def clean_datatype(dt: str) -> str:
    """Reference cleanup_datatype (abstract_dataflow_full.py:240-250)."""
    dt = re.sub(r"\s*\[.*\]", "[]", dt)
    dt = re.sub(r"^const ", "", dt)
    dt = re.sub(r"\s+", " ", dt)
    return dt.strip()


def _recurse_datatype(cpg: Cpg, v: int) -> tuple[int, str]:
    """Unhandled shapes RAISE (NotImplementedError / KeyError), exactly like
    the reference (abstract_dataflow_full.py:67-107) — the exception aborts
    decl_features, so the node keeps only fields collected before it."""
    attr = cpg.nodes[v]
    if attr.label == "IDENTIFIER":
        return v, attr.type_full_name
    if attr.label == "CALL" and attr.name in _DATATYPE_ARG_IDX:
        args = {cpg.nodes[a].order: a for a in cpg.successors(v, "ARGUMENT")}
        arg = args[_DATATYPE_ARG_IDX[attr.name]]  # KeyError when absent
        arg_attr = cpg.nodes[arg]
        if arg_attr.label == "IDENTIFIER":
            return arg, arg_attr.type_full_name
        if arg_attr.label == "CALL":
            return _recurse_datatype(cpg, arg)
        raise NotImplementedError(
            f"recurse_datatype index could not handle {arg} {arg_attr}"
        )
    raise NotImplementedError(f"recurse_datatype var could not handle {v} {attr}")


def _raw_datatype(cpg: Cpg, decl: int) -> tuple[int, str]:
    attr = cpg.nodes[decl]
    if attr.label == "LOCAL":
        return decl, attr.type_full_name
    if attr.label == "CALL" and attr.name in _ASSIGNMENT_TYPES | {"<operator>.cast"}:
        args = {cpg.nodes[a].order: a for a in cpg.successors(decl, "ARGUMENT")}
        return _recurse_datatype(cpg, args[1])  # KeyError when no 1st arg
    raise NotImplementedError(f"get_raw_datatype did not handle {decl} {attr}")


def decl_features(cpg: Cpg, nid: int) -> list[tuple[str, str]]:
    """(subkey, value) fields for one definition node.

    Mirrors the reference's grab_declfeats error contract
    (abstract_dataflow_full.py:127-166): any failure — most commonly an
    unhandled LHS shape inside the datatype recursion — aborts collection
    and returns only the fields gathered so far (usually none, since
    datatype comes first). Nodes whose recursion fails therefore get NO
    hash, keeping the feature vocabulary aligned with the reference's.
    """
    fields: list[tuple[str, str]] = []
    try:
        ret = _raw_datatype(cpg, nid)
        if ret is not None:
            _, dt = ret
            if dt is not None:
                fields.append(("datatype", clean_datatype(dt)))
        for d in cpg.ast_descendants(nid, skip_labels=("METHOD",)):
            n = cpg.nodes[d]
            if n.label == "LITERAL":
                fields.append(("literal", n.code))
            elif n.label == "CALL":
                # reference matches '<operator>\.' only: legacy
                # '<operators>.x' names classify as api, not operator
                m = re.match(r"<operator>\.(.*)", n.name)
                if m:
                    if m.group(1) not in ("indirection",):
                        fields.append(("operator", m.group(1)))
                else:
                    fields.append(("api", n.name))
    except Exception:
        # the reference logs and keeps the partial fields ("node error" +
        # traceback, :163-166); debug level so corpus runs aren't flooded —
        # expected failures are NotImplementedError/KeyError from the
        # datatype recursion above
        logging.getLogger(__name__).debug(
            "decl_features aborted for node %s", nid, exc_info=True
        )
    return fields


def node_hash(fields: Iterable[tuple[str, str]], subkeys: Iterable[str] = ALL_SUBKEYS) -> str:
    """stage-2 hash: json of {subkey: sorted values} (reference to_hash).

    Values are NOT de-duplicated (the reference sorts the full list), so
    `x = y + y` and `x = y` hash differently.
    """
    d = {sk: sorted(v for k, v in fields if k == sk) for sk in subkeys}
    return json.dumps(d)


def graph_features(cpg: Cpg) -> dict[int, str]:
    """All definition nodes of a CPG -> stage-2 hash strings."""
    out: dict[int, str] = {}
    for n in cpg.nodes:
        if is_decl(cpg, n.id):
            fields = decl_features(cpg, n.id)
            if fields:
                out[n.id] = node_hash(fields)
    return out
