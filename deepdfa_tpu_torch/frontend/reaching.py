"""Reaching-definitions analysis over CPG-lite CFGs.

Semantics mirror the reference's in-Python worklist solver
(DDFA/code_gnn/analysis/dataflow.py:103-177) and, transitively, the Joern
ReachingDefProblem export it mimics:

- a definition site is any CFG node that is a CALL whose name is an
  assignment or increment/decrement operator (mod_ops, dataflow.py:60-84,
  including the "<operators>." spelling variant Joern sometimes emits);
- the defined variable is the *code string* of the first ARGUMENT child
  (ordered), i.e. `x` for `x = e`, `*p` for `*p = e`;
- gen(n) = {n}; kill(n) = all other definitions of the same variable;
- IN(n) = union of OUT(preds); OUT(n) = gen(n) u (IN(n) - kill(n));
  iterated with a worklist to fixpoint.

The port's copy of the reference's `deepdfa_tpu/frontend/reaching.py`.
The pure-Python solver here is the executable spec; the C++ bitset solver
(the port's `native/`) is the fast path, held equal to this one.
"""

from __future__ import annotations

import dataclasses

from deepdfa_tpu_torch.frontend.cpg import ARGUMENT, CFG, Cpg

_ASSIGNMENT_OPS = [
    "assignment", "assignmentAnd", "assignmentArithmeticShiftRight",
    "assignmentDivision", "assignmentExponentiation",
    "assignmentLogicalShiftRight", "assignmentMinus", "assignmentModulo",
    "assignmentMultiplication", "assignmentOr", "assignmentPlus",
    "assignmentShiftLeft", "assignmentXor",
]
_INC_DEC_OPS = [
    "incBy", "postDecrement", "postIncrement", "preDecrement", "preIncrement",
]

MOD_OPS = frozenset(
    f"{prefix}.{op}"
    for prefix in ("<operator>", "<operators>")
    for op in _ASSIGNMENT_OPS + _INC_DEC_OPS
)


@dataclasses.dataclass(frozen=True)
class Definition:
    var: str
    node: int
    code: str

    def __lt__(self, other):
        return self.node < other.node


class ReachingDefinitions:
    def __init__(self, cpg: Cpg):
        self.cpg = cpg
        self.cfg_nodes = cpg.cfg_nodes()
        self.gen_set: dict[int, frozenset[Definition]] = {}
        self._var: dict[int, str | None] = {}
        for n in self.cfg_nodes:
            v = self.assigned_variable(n)
            self._var[n] = v
            if v is not None:
                self.gen_set[n] = frozenset(
                    {Definition(v, n, cpg.nodes[n].code)}
                )
            else:
                self.gen_set[n] = frozenset()

    def assigned_variable(self, nid: int) -> str | None:
        node = self.cpg.nodes[nid]
        if node.label != "CALL" or node.name not in MOD_OPS:
            return None
        args = self.cpg.arguments(nid)
        if not args:
            return None
        return self.cpg.nodes[args[0]].code

    @property
    def domain(self) -> set[Definition]:
        out: set[Definition] = set()
        for s in self.gen_set.values():
            out |= s
        return out

    def gen(self, n: int) -> frozenset[Definition]:
        return self.gen_set[n]

    def kill(self, n: int, definitions) -> set[Definition]:
        v = self._var[n]
        if v is None:
            return set()
        return {d for d in definitions if d.var == v and d.node != n}

    def solve(self, backend: str = "auto") -> dict[int, set[Definition]]:
        """Worklist to fixpoint; returns IN sets per CFG node.

        backend: "python" (the executable spec below), "native" (the C++
        bitset solver, `deepdfa_tpu_torch/native`), or "auto" (native
        unless the machine has no g++ to build it).
        """
        if backend != "python":
            from deepdfa_tpu_torch import native

            if native.available():
                return self._solve_native()
            if backend == "native":
                raise RuntimeError(
                    "native backend requested but g++ is not on PATH to build "
                    "libdeepdfa_native (python -m deepdfa_tpu_torch.native.build)")
        return self._solve_python()

    def dense_cfg(self) -> tuple[list[int], dict[int, int], list[int], list[int]]:
        """(nodes, node->dense index, edge src, edge dst) over the CFG —
        the shared dense view of the native solver and of the reference's
        training label builders (nn/bitprop.rd_bit_problem)."""
        nodes = self.cfg_nodes
        dense = {n: i for i, n in enumerate(nodes)}
        src, dst = [], []
        for n in nodes:
            for s in self.cpg.successors(n, CFG):
                if s in dense:
                    src.append(dense[n])
                    dst.append(dense[s])
        return nodes, dense, src, dst

    def _solve_native(self) -> dict[int, set[Definition]]:
        import numpy as np

        from deepdfa_tpu_torch.native import rd_solve_native

        nodes, dense, src, dst = self.dense_cfg()
        var_ids: dict[str, int] = {}
        def_var = np.full(len(nodes), -1, np.int32)
        for n in nodes:
            v = self._var[n]
            if v is not None:
                def_var[dense[n]] = var_ids.setdefault(v, len(var_ids))
        raw = rd_solve_native(
            len(nodes), np.array(src, np.int32), np.array(dst, np.int32), def_var
        )
        by_node = {
            d.node: d for s in self.gen_set.values() for d in s
        }
        return {
            nodes[i]: {by_node[nodes[j]] for j in sites}
            for i, sites in raw.items()
        }

    def _solve_python(self) -> dict[int, set[Definition]]:
        """Worklist to fixpoint; returns IN sets per CFG node."""
        out: dict[int, set[Definition]] = {n: set() for n in self.cfg_nodes}
        in_: dict[int, set[Definition]] = {n: set() for n in self.cfg_nodes}
        work = list(self.cfg_nodes)
        while work:
            n = work.pop()
            new_in: set[Definition] = set()
            for p in self.cpg.predecessors(n, CFG):
                new_in |= out[p]
            in_[n] = new_in
            new_out = set(self.gen(n)) | (new_in - self.kill(n, new_in))
            if new_out != out[n]:
                out[n] = new_out
                for s in self.cpg.successors(n, CFG):
                    work.append(s)
        return in_

    def solve_out(self) -> dict[int, set[Definition]]:
        in_ = self.solve()
        return {
            n: set(self.gen(n)) | (in_[n] - self.kill(n, in_[n]))
            for n in self.cfg_nodes
        }
