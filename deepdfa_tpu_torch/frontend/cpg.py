"""CPG-lite: the in-memory code property graph produced by the built-in
C frontend (and by the optional Joern import path).

Schema is deliberately Joern-compatible (node labels CALL / IDENTIFIER /
LITERAL / LOCAL / METHOD / METHOD_RETURN / METHOD_PARAMETER_IN /
FIELD_IDENTIFIER / RETURN / UNKNOWN; edge types AST / CFG / ARGUMENT;
operator call names like "<operator>.assignment") because the entire
downstream feature definition in the reference keys off those strings:
- mod-op detection (DDFA/code_gnn/analysis/dataflow.py:60-84)
- is_decl / datatype recursion / subkey extraction
  (DDFA/sastvd/scripts/abstract_dataflow_full.py:24-167)

The port's copy of the reference's `deepdfa_tpu/frontend/cpg.py`.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable

AST = "AST"
CFG = "CFG"
ARGUMENT = "ARGUMENT"

# Joern operator-call names (joern.io default.semantics / operatorextension)
OP_NAMES = {
    "=": "<operator>.assignment",
    "+=": "<operator>.assignmentPlus",
    "-=": "<operator>.assignmentMinus",
    "*=": "<operator>.assignmentMultiplication",
    "/=": "<operator>.assignmentDivision",
    "%=": "<operator>.assignmentModulo",
    "&=": "<operator>.assignmentAnd",
    "|=": "<operator>.assignmentOr",
    "^=": "<operator>.assignmentXor",
    "<<=": "<operator>.assignmentShiftLeft",
    ">>=": "<operator>.assignmentArithmeticShiftRight",
    "+": "<operator>.addition",
    "-": "<operator>.subtraction",
    "*": "<operator>.multiplication",
    "/": "<operator>.division",
    "%": "<operator>.modulo",
    "==": "<operator>.equals",
    "!=": "<operator>.notEquals",
    "<": "<operator>.lessThan",
    ">": "<operator>.greaterThan",
    "<=": "<operator>.lessEqualsThan",
    ">=": "<operator>.greaterEqualsThan",
    "&&": "<operator>.logicalAnd",
    "||": "<operator>.logicalOr",
    "&": "<operator>.and",
    "|": "<operator>.or",
    "^": "<operator>.xor",
    "<<": "<operator>.shiftLeft",
    ">>": "<operator>.arithmeticShiftRight",
}

UNARY_OP_NAMES = {
    "!": "<operator>.logicalNot",
    "~": "<operator>.not",
    "-": "<operator>.minus",
    "+": "<operator>.plus",
    "*": "<operator>.indirection",
    "&": "<operator>.addressOf",
}

PRE_INC_DEC = {"++": "<operator>.preIncrement", "--": "<operator>.preDecrement"}
POST_INC_DEC = {"++": "<operator>.postIncrement", "--": "<operator>.postDecrement"}

FIELD_ACCESS = "<operator>.fieldAccess"
INDIRECT_FIELD_ACCESS = "<operator>.indirectFieldAccess"
INDEX_ACCESS = "<operator>.indirectIndexAccess"  # joern's name for C subscripts
CAST = "<operator>.cast"
CONDITIONAL = "<operator>.conditional"
SIZEOF = "<operator>.sizeOf"
COMMA = "<operator>.expressionList"


@dataclasses.dataclass
class Node:
    id: int
    label: str  # _label in joern terms
    name: str = ""
    code: str = ""
    line: int | None = None
    order: int = 0
    type_full_name: str = "ANY"


class Cpg:
    """Mutable CPG under construction; read interfaces used downstream."""

    def __init__(self, method_name: str = "<fn>"):
        self.method_name = method_name
        self.nodes: list[Node] = []
        self.edges: list[tuple[int, int, str]] = []  # (src, dst, etype)
        self._out: dict[str, dict[int, list[int]]] = defaultdict(
            lambda: defaultdict(list)
        )
        self._in: dict[str, dict[int, list[int]]] = defaultdict(
            lambda: defaultdict(list)
        )
        self.method_id: int | None = None
        self.method_return_id: int | None = None

    # -- construction -------------------------------------------------------

    def add_node(
        self,
        label: str,
        name: str = "",
        code: str = "",
        line: int | None = None,
        order: int = 0,
        type_full_name: str = "ANY",
    ) -> int:
        nid = len(self.nodes)
        self.nodes.append(Node(nid, label, name, code, line, order, type_full_name))
        return nid

    def add_edge(self, src: int, dst: int, etype: str) -> None:
        self.edges.append((src, dst, etype))
        self._out[etype][src].append(dst)
        self._in[etype][dst].append(src)

    # -- queries -------------------------------------------------------------

    def node(self, nid: int) -> Node:
        return self.nodes[nid]

    def successors(self, nid: int, etype: str) -> list[int]:
        return self._out[etype].get(nid, [])

    def predecessors(self, nid: int, etype: str) -> list[int]:
        return self._in[etype].get(nid, [])

    def cfg_nodes(self) -> list[int]:
        """Nodes participating in at least one CFG edge."""
        seen: set[int] = set()
        for s, d, t in self.edges:
            if t == CFG:
                seen.add(s)
                seen.add(d)
        return sorted(seen)

    def arguments(self, call_id: int) -> list[int]:
        """ARGUMENT successors sorted by their `order` attribute."""
        args = self.successors(call_id, ARGUMENT)
        return sorted(args, key=lambda a: self.nodes[a].order)

    def ast_descendants(self, root: int, skip_labels: Iterable[str] = ()) -> set[int]:
        """All AST descendants of `root` (root excluded), skipping subtrees
        rooted at nodes whose label is in skip_labels (reference behavior:
        METHOD subtrees are excluded, abstract_dataflow_full.py:137-145)."""
        skip = set(skip_labels)
        out: set[int] = set()
        stack = list(self.successors(root, AST))
        while stack:
            n = stack.pop()
            if self.nodes[n].label in skip or n in out:
                continue
            out.add(n)
            stack.extend(self.successors(n, AST))
        return out

    def __repr__(self):
        return (
            f"Cpg({self.method_name!r}, {len(self.nodes)} nodes, "
            f"{len(self.edges)} edges)"
        )
