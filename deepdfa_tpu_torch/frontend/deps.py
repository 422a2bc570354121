"""Data- and control-dependence over CPG-lite graphs.

Powers the reference's statement-labeling closure ("lines removed by the
fix plus lines data/control dependent on added lines",
DDFA/sastvd/helpers/evaluate.py:194-236) and the pdg-style graph
reductions (joern.py rdg):

- data dependence: use-def edges from the reaching-definitions solution —
  node N depends on definition D when D reaches N and N references D's
  variable.
- control dependence: classic Ferrante-Ottenstein-Warren construction on
  the CFG via postdominance frontiers (reverse-CFG dominators, computed
  with the Cooper-Harvey-Kennedy iteration).

The port's copy of the reference's `deepdfa_tpu/frontend/deps.py`.
"""

from __future__ import annotations

from collections import defaultdict

from deepdfa_tpu_torch.frontend.cpg import CFG, Cpg
from deepdfa_tpu_torch.frontend.reaching import ReachingDefinitions


def data_dependences(cpg: Cpg) -> set[tuple[int, int]]:
    """(def_node, use_node) pairs: use_node references a variable whose
    definition at def_node reaches it."""
    rd = ReachingDefinitions(cpg)
    in_sets = rd.solve()
    out: set[tuple[int, int]] = set()
    for n in rd.cfg_nodes:
        node = cpg.nodes[n]
        # identifiers referenced at n: its own code plus AST descendants
        names = {node.name} if node.label == "IDENTIFIER" else set()
        for d in cpg.ast_descendants(n, skip_labels=("METHOD",)):
            if cpg.nodes[d].label == "IDENTIFIER":
                names.add(cpg.nodes[d].name)
        for dfn in in_sets.get(n, ()):
            # variable code strings may be compound ("*p"); match on the
            # identifier tokens they contain
            if dfn.var in names or any(tok in names for tok in _id_tokens(dfn.var)):
                out.add((dfn.node, n))
    return out


def _id_tokens(code: str) -> list[str]:
    import re

    return re.findall(r"[A-Za-z_][A-Za-z0-9_]*", code)


def _postorder(cpg: Cpg, entry: int, succ) -> list[int]:
    seen: set[int] = set()
    order: list[int] = []
    stack: list[tuple[int, int]] = [(entry, 0)]
    while stack:
        n, i = stack.pop()
        if i == 0:
            if n in seen:
                continue
            seen.add(n)
        nxt = succ(n)
        if i < len(nxt):
            stack.append((n, i + 1))
            stack.append((nxt[i], 0))
        else:
            order.append(n)
    return order


def _idoms(nodes: list[int], entry: int, preds, succ) -> dict[int, int]:
    """Cooper-Harvey-Kennedy iterative dominators over `nodes`."""
    order = _postorder_nodes(nodes, entry, succ)
    rpo = list(reversed(order))
    index = {n: i for i, n in enumerate(rpo)}
    idom: dict[int, int | None] = {n: None for n in rpo}
    idom[entry] = entry

    def intersect(a, b):
        while a != b:
            while index[a] > index[b]:
                a = idom[a]
            while index[b] > index[a]:
                b = idom[b]
        return a

    changed = True
    while changed:
        changed = False
        for n in rpo:
            if n == entry:
                continue
            new = None
            for p in preds(n):
                if p in index and idom.get(p) is not None:
                    new = p if new is None else intersect(new, p)
            if new is not None and idom[n] != new:
                idom[n] = new
                changed = True
    return {n: d for n, d in idom.items() if d is not None}


def _postorder_nodes(nodes, entry, succ):
    seen = set()
    order = []

    def rec_iter(start):
        stack = [(start, iter(succ(start)))]
        seen.add(start)
        while stack:
            n, it = stack[-1]
            advanced = False
            for s in it:
                if s not in seen:
                    seen.add(s)
                    stack.append((s, iter(succ(s))))
                    advanced = True
                    break
            if not advanced:
                order.append(n)
                stack.pop()
    rec_iter(entry)
    return order


def control_dependences(cpg: Cpg) -> set[tuple[int, int]]:
    """(controller, dependent) pairs via reverse-dominance frontiers."""
    cfg_nodes = cpg.cfg_nodes()
    if not cfg_nodes or cpg.method_return_id is None:
        return set()
    nodes = set(cfg_nodes)
    exit_n = cpg.method_return_id

    def rsucc(n):
        return [p for p in cpg.predecessors(n, CFG) if p in nodes]

    def rpred(n):
        return [s for s in cpg.successors(n, CFG) if s in nodes]

    ipdom = _idoms(cfg_nodes, exit_n, rpred, rsucc)

    out: set[tuple[int, int]] = set()
    # postdominance frontier: for each node n with multiple CFG successors,
    # walk up from each successor until ipdom(n)
    for n in cfg_nodes:
        succs = [s for s in cpg.successors(n, CFG) if s in nodes]
        if len(succs) < 2:
            continue
        for s in succs:
            runner = s
            guard = 0
            while runner != ipdom.get(n) and runner in ipdom and guard < len(nodes) + 2:
                if runner != n:
                    out.add((n, runner))
                runner = ipdom[runner]
                guard += 1
    return out


def dependent_lines(cpg: Cpg, target_lines: set[int]) -> set[int]:
    """Lines with statements data/control dependent on any statement whose
    line is in target_lines (one-step closure, reference semantics)."""
    by_line: dict[int, list[int]] = defaultdict(list)
    for n in cpg.nodes:
        if n.line is not None:
            by_line[n.line].append(n.id)
    targets = {nid for ln in target_lines for nid in by_line.get(ln, [])}
    deps: set[int] = set()
    for src, dst in data_dependences(cpg) | control_dependences(cpg):
        if src in targets:
            deps.add(dst)
        if dst in targets:
            deps.add(src)
    return {
        cpg.nodes[n].line for n in deps if cpg.nodes[n].line is not None
    }
