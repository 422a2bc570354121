"""Family-invariant structural node features (VERDICT r4 #3).

The abstract-dataflow subkey features (frontend/absdf.py — the
reference's `_ABS_DATAFLOW_*` definition) are VOCABULARY features: on a
held-out bug family whose API/literal/datatype buckets never appeared in
training, nodes collapse to the UNKNOWN index and the GGNN is left with
nothing but bare graph structure — the round-4 diagnosis for held-out
family F1 0.11 ("the order signal is >5 featureless hops away",
docs/convergence_run_featdrop.json).

These channels are the structural complement: small FIXED vocabularies
derived from the CPG itself, so they are identical in distribution
across bug families and survive UNKNOWN-collapse by construction:

  ch0 op_class   (16) — operator CLASS of the statement's root call
                        (assign / arith / compare / logical / call /
                        access / cast / jump ...), from the Joern
                        operator name, not its identity
  ch1 degree     (16) — (min(cfg_in,3), min(cfg_out,3)) packed — branch
                        and join shape
  ch2 ast_depth   (8) — statement nesting depth, capped
  ch3 du_dist     (8) — CFG hops (backward) to the nearest definition
                        of any variable used at this node, capped 6;
                        7 = none found
  ch4 reach_count (4) — number of DISTINCT reaching definitions of this
                        node's used variables (from the same solver the
                        dataflow labels use), capped 3. This is the
                        order-family signal in local form: a use AFTER
                        a clamp/guard redefinition sees 2 reaching defs
                        where the buggy order sees 1.

The channels append as extra node_feats columns (data/pipeline.py
`extract(struct_feats=True)`); `nn/embedding.py` embeds them with their
own small tables when `ModelConfig.struct_feats` is on. Everything is
computed from the hermetic CPG — no reference counterpart exists (the
reference never attacks cross-family generalization; its paper Table 7
analog is cross-project, where the vocab largely transfers).

The port's copy of the JAX package's `deepdfa_tpu/frontend/structfeat.py`,
over the port's own CPG and reaching-definitions solver.
"""

from __future__ import annotations

import numpy as np

from deepdfa_tpu_torch.frontend.cpg import AST, CFG, Cpg

#: vocab size per struct channel, in column order
STRUCT_VOCAB: tuple[int, ...] = (16, 16, 8, 8, 4)
NUM_STRUCT_FEATS = len(STRUCT_VOCAB)

_ASSIGN = 1
_ARITH = 2
_COMPARE = 3
_LOGICAL = 4
_CALL = 5
_ACCESS = 6
_CAST = 7
_JUMP = 8
_INCDEC = 9
_COND = 10

_OP_CLASS = {
    "<operator>.assignment": _ASSIGN,
    "<operator>.assignmentPlus": _ASSIGN,
    "<operator>.assignmentMinus": _ASSIGN,
    "<operator>.assignmentMultiplication": _ASSIGN,
    "<operator>.assignmentDivision": _ASSIGN,
    "<operator>.assignmentModulo": _ASSIGN,
    "<operator>.assignmentAnd": _ASSIGN,
    "<operator>.assignmentOr": _ASSIGN,
    "<operator>.assignmentXor": _ASSIGN,
    "<operator>.assignmentShiftLeft": _ASSIGN,
    "<operator>.assignmentArithmeticShiftRight": _ASSIGN,
    "<operator>.addition": _ARITH,
    "<operator>.subtraction": _ARITH,
    "<operator>.multiplication": _ARITH,
    "<operator>.division": _ARITH,
    "<operator>.modulo": _ARITH,
    "<operator>.shiftLeft": _ARITH,
    "<operator>.arithmeticShiftRight": _ARITH,
    "<operator>.and": _ARITH,
    "<operator>.or": _ARITH,
    "<operator>.xor": _ARITH,
    "<operator>.equals": _COMPARE,
    "<operator>.notEquals": _COMPARE,
    "<operator>.lessThan": _COMPARE,
    "<operator>.greaterThan": _COMPARE,
    "<operator>.lessEqualsThan": _COMPARE,
    "<operator>.greaterEqualsThan": _COMPARE,
    "<operator>.logicalAnd": _LOGICAL,
    "<operator>.logicalOr": _LOGICAL,
    "<operator>.logicalNot": _LOGICAL,
    "<operator>.fieldAccess": _ACCESS,
    "<operator>.indirectFieldAccess": _ACCESS,
    "<operator>.indirectIndexAccess": _ACCESS,
    "<operator>.indirection": _ACCESS,
    "<operator>.addressOf": _ACCESS,
    "<operator>.cast": _CAST,
    "<operator>.conditional": _COND,
    "<operator>.preIncrement": _INCDEC,
    "<operator>.postIncrement": _INCDEC,
    "<operator>.preDecrement": _INCDEC,
    "<operator>.postDecrement": _INCDEC,
}

def feat_width(struct_feats: bool) -> int:
    """Columns of a node_feats row: the four subkey columns, then the
    struct channels when the model embeds them (the registry's
    `_feat_width`, the executors' and localizer's pack width)."""
    return 4 + (NUM_STRUCT_FEATS if struct_feats else 0)


_DU_CAP = 6  # ch3: distances 0..6; 7 = no def found / no vars used
_BFS_VISIT_CAP = 256  # bound the backward walk on pathological graphs


def _op_class(cpg: Cpg, nid: int) -> int:
    n = cpg.nodes[nid]
    if n.label == "RETURN" or n.label == "JUMP_TARGET":
        return _JUMP
    if n.label == "CALL":
        if n.name.startswith("<operator>"):
            return _OP_CLASS.get(n.name, 0)
        return _CALL
    return 0


def _used_vars(cpg: Cpg, nid: int) -> set[str]:
    names = set()
    if cpg.nodes[nid].label == "IDENTIFIER":
        names.add(cpg.nodes[nid].name)
    for d in cpg.ast_descendants(nid, skip_labels=("METHOD",)):
        if cpg.nodes[d].label == "IDENTIFIER":
            names.add(cpg.nodes[d].name)
    return names


def struct_features(cpg: Cpg, keep: list[int]) -> np.ndarray:
    """[len(keep), NUM_STRUCT_FEATS] int32 — channels documented above,
    rows aligned with `keep` (the extraction's dense node order)."""
    from deepdfa_tpu_torch.frontend.reaching import ReachingDefinitions

    keep_set = set(keep)
    n = len(keep)
    out = np.zeros((n, NUM_STRUCT_FEATS), np.int32)

    # ast depth via BFS from the method root over AST edges
    depth: dict[int, int] = {}
    if cpg.method_id is not None:
        frontier = [(cpg.method_id, 0)]
        while frontier:
            nid, d = frontier.pop()
            if nid in depth and depth[nid] <= d:
                continue
            depth[nid] = d
            for c in cpg.successors(nid, AST):
                frontier.append((c, d + 1))

    rd = ReachingDefinitions(cpg)
    try:
        in_sets = rd.solve()
    except Exception:  # solver failure must not cost extraction
        in_sets = {}
    defines: dict[int, str] = {}
    for nid in keep:
        var = rd.assigned_variable(nid)
        if var is not None:
            defines[nid] = var

    used = {nid: _used_vars(cpg, nid) for nid in keep}

    for row, nid in enumerate(keep):
        out[row, 0] = _op_class(cpg, nid)
        indeg = sum(1 for p in cpg.predecessors(nid, CFG) if p in keep_set)
        outdeg = sum(1 for s in cpg.successors(nid, CFG) if s in keep_set)
        out[row, 1] = min(indeg, 3) * 4 + min(outdeg, 3)
        out[row, 2] = min(depth.get(nid, 0), 7)

        vars_here = used[nid]
        if not vars_here:
            out[row, 3] = 7
            continue
        # ch3: backward BFS to the nearest def of a used var
        dist = 7
        frontier = [nid]
        seen = {nid}
        for d in range(_DU_CAP + 1):
            if any(defines.get(f) in vars_here for f in frontier):
                dist = d
                break
            nxt = []
            for f in frontier:
                for p in cpg.predecessors(f, CFG):
                    if p in keep_set and p not in seen:
                        seen.add(p)
                        nxt.append(p)
            if not nxt or len(seen) > _BFS_VISIT_CAP:
                break
            frontier = nxt
        out[row, 3] = dist
        # ch4: distinct reaching defs of the used vars
        reaching = in_sets.get(nid, set())
        out[row, 4] = min(
            sum(1 for d in reaching if d.var in vars_here), 3
        )
    return out
