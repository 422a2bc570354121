"""Static-shape padded graph batches (the port's copy of the reference's
`deepdfa_tpu/graphs/batch.py`).

A batch is a fixed budget of graphs/nodes/edges with padding masks:

- `node_graph` maps every node slot to its graph segment; padding slots
  map to segment `num_graphs` (one dummy segment sliced off after
  pooling) — non-decreasing by construction.
- edge arrays are sorted by destination and the live edges form a
  prefix; padded edge slots carry the maximum node index
  (node_budget - 1) with a False mask, so `edge_dst` stays
  non-decreasing end to end. The CUDA GGNN step relies on both: each
  node's in-edges are one contiguous run of the live prefix.
- self-loop edges are added for every real node.

`pack` is bit-for-bit the reference's (held equal array for array in
tests/test_torch_pack.py), and so is the batch planner below
(`plan_shard_bucket_batches` and friends, with one logical shard;
tests/test_torch_train.py). A `GraphBatch` holds numpy arrays on the
host; `to(device)` gives the same batch as torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, Sequence

import numpy as np
import torch

NUM_SUBKEY_FEATS = 4  # api, datatype, literal, operator


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """One host-side graph: ragged arrays, pre-batching. The optional
    bit-label block (all four or none) carries reaching-definitions
    supervision; `edge_type` carries per-edge relation ids for
    n_etypes > 1."""

    graph_id: int
    node_feats: np.ndarray  # [n, NUM_SUBKEY_FEATS] int32 vocab indices
    node_vuln: np.ndarray  # [n] int32 per-statement vulnerability label
    edge_src: np.ndarray  # [e] int32 (CFG edges, no self loops)
    edge_dst: np.ndarray  # [e] int32
    label: float
    node_gen: np.ndarray | None = None  # [n, B] float32
    node_kill: np.ndarray | None = None
    node_bits_in: np.ndarray | None = None
    node_bits_out: np.ndarray | None = None
    edge_type: np.ndarray | None = None  # [e] int32 in [0, n_etypes)

    @property
    def num_nodes(self) -> int:
        return int(self.node_feats.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Fixed-budget batched graphs: numpy arrays from `pack`, torch
    tensors after `to(device)`.

    Invariant (maintained by `pack`, checked by `to`): `edge_dst` is
    non-decreasing and the live edges (`edge_mask`) are a prefix."""

    node_feats: Any  # [N, K] int32
    node_vuln: Any  # [N] int32
    node_graph: Any  # [N] int32 segment ids; padding -> num_graphs
    node_mask: Any  # [N] bool
    edge_src: Any  # [E] int32
    edge_dst: Any  # [E] int32
    edge_mask: Any  # [E] bool
    graph_label: Any  # [G] float32
    graph_mask: Any  # [G] bool
    graph_ids: Any  # [G] int32 original example ids (-1 padding)
    num_graphs: int
    node_gen: Any = None
    node_kill: Any = None
    node_bits_in: Any = None
    node_bits_out: Any = None
    edge_type: Any = None  # [E] int32 (padding/self-loop slots carry 0)

    @property
    def node_budget(self) -> int:
        return int(self.node_feats.shape[0])

    @property
    def edge_budget(self) -> int:
        return int(self.edge_src.shape[0])

    def to(self, device: str | torch.device) -> "GraphBatch":
        """The same batch as torch tensors on `device` (dtypes kept:
        int32, bool, float32). Host arrays are checked for the edge
        invariant first, since the CUDA step cannot check it without a
        device sync."""
        if isinstance(self.edge_mask, np.ndarray):
            _check_edge_layout(self.edge_dst, self.edge_mask)
        dev = torch.device(device)
        moved = {}
        for f in ARRAY_FIELDS:
            v = getattr(self, f)
            if v is None:
                moved[f] = None
            elif isinstance(v, torch.Tensor):
                moved[f] = v.to(dev)
            else:
                moved[f] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        return dataclasses.replace(self, **moved)


#: GraphBatch's array fields (everything but the static num_graphs)
ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(GraphBatch) if f.name != "num_graphs"
)


def _check_edge_layout(edge_dst: np.ndarray, edge_mask: np.ndarray) -> None:
    live = int(edge_mask.sum())
    if not edge_mask[:live].all():
        raise ValueError("live edges must form a prefix of the edge arrays")
    if edge_dst.size and np.any(np.diff(edge_dst) < 0):
        raise ValueError("edge_dst must be non-decreasing (dst-sorted edges)")


class BudgetExceeded(ValueError):
    pass


_BIT_FIELDS = ("node_gen", "node_kill", "node_bits_in", "node_bits_out")


def bit_width(graphs: Sequence[GraphSpec]) -> int | None:
    """Corpus-wide bit-label width B, or None when graphs carry no bits.
    Raises ValueError on mixed presence or inconsistent widths."""
    widths = set()
    for g in graphs:
        present = [getattr(g, f) is not None for f in _BIT_FIELDS]
        if any(present) != all(present):
            raise ValueError(f"graph {g.graph_id}: partial bit-label block")
        widths.add(g.node_gen.shape[1] if g.node_gen is not None else None)
    if not widths or widths == {None}:
        return None
    if None in widths or len(widths) > 1:
        raise ValueError(f"inconsistent bit-label widths: {widths}")
    return widths.pop()


def edge_typed(graphs: Sequence[GraphSpec]) -> bool:
    """Whether the graphs carry per-edge type ids; raises on a mix."""
    present = {g.edge_type is not None for g in graphs}
    if present == {True, False}:
        raise ValueError("mixed edge_type presence across graphs")
    return present == {True}


def pack(
    graphs: Sequence[GraphSpec],
    num_graphs: int,
    node_budget: int,
    edge_budget: int,
    add_self_loops: bool = True,
    bits: int | None = None,
    etypes: bool | None = None,
    feat_width: int | None = None,
) -> GraphBatch:
    """Pack host graphs into one padded batch (numpy arrays).

    Raises BudgetExceeded when the graphs do not fit. `bits`, `etypes`
    and `feat_width` force the bit-label width, the presence of the
    per-edge type array and the feature width, so that an empty batch
    matches its non-empty siblings."""
    if len(graphs) > num_graphs:
        raise BudgetExceeded(f"{len(graphs)} graphs > budget {num_graphs}")
    n_tot = sum(g.num_nodes for g in graphs)
    e_tot = sum(g.num_edges for g in graphs) + (n_tot if add_self_loops else 0)
    if n_tot > node_budget:
        raise BudgetExceeded(f"{n_tot} nodes > budget {node_budget}")
    if e_tot > edge_budget:
        raise BudgetExceeded(f"{e_tot} edges > budget {edge_budget}")

    if bits is None:
        bits = bit_width(graphs)
    elif graphs and bit_width(graphs) not in (None, bits):
        raise ValueError(
            f"bits={bits} does not match graphs' width {bit_width(graphs)}"
        )
    if etypes is None:
        etypes = edge_typed(graphs) if graphs else False
    elif graphs and edge_typed(graphs) != etypes:
        raise ValueError(
            f"etypes={etypes} does not match graphs' edge_type presence"
        )
    bit_arrays = (
        {f: np.zeros((node_budget, bits), np.float32) for f in _BIT_FIELDS}
        if bits is not None
        else {f: None for f in _BIT_FIELDS}
    )
    if feat_width is None:
        feat_width = (
            graphs[0].node_feats.shape[1] if graphs else NUM_SUBKEY_FEATS
        )
    elif graphs and graphs[0].node_feats.shape[1] != feat_width:
        raise ValueError(
            f"feat_width={feat_width} does not match graphs' width "
            f"{graphs[0].node_feats.shape[1]}"
        )
    node_feats = np.zeros((node_budget, feat_width), np.int32)
    node_vuln = np.zeros((node_budget,), np.int32)
    node_graph = np.full((node_budget,), num_graphs, np.int32)
    node_mask = np.zeros((node_budget,), bool)
    edge_src = np.zeros((edge_budget,), np.int32)
    edge_dst = np.zeros((edge_budget,), np.int32)
    edge_mask = np.zeros((edge_budget,), bool)
    edge_type = np.zeros((edge_budget,), np.int32) if etypes else None
    graph_label = np.zeros((num_graphs,), np.float32)
    graph_mask = np.zeros((num_graphs,), bool)
    graph_ids = np.full((num_graphs,), -1, np.int32)

    n_off = 0
    e_off = 0
    for gi, g in enumerate(graphs):
        n, e = g.num_nodes, g.num_edges
        node_feats[n_off : n_off + n] = g.node_feats
        node_vuln[n_off : n_off + n] = g.node_vuln
        node_graph[n_off : n_off + n] = gi
        node_mask[n_off : n_off + n] = True
        if bits is not None and g.node_gen is not None:
            for f in _BIT_FIELDS:
                bit_arrays[f][n_off : n_off + n] = getattr(g, f)
        # graph edges + self loops, sorted by destination: graphs occupy
        # increasing node ranges, so per-graph sorting makes the whole
        # batch dst-sorted
        g_src = g.edge_src + n_off
        g_dst = g.edge_dst + n_off
        g_type = (
            g.edge_type
            if g.edge_type is not None
            else np.zeros((e,), np.int32)
        )
        if add_self_loops:
            loop = np.arange(n_off, n_off + n, dtype=np.int32)
            g_src = np.concatenate([g_src, loop])
            g_dst = np.concatenate([g_dst, loop])
            g_type = np.concatenate([g_type, np.zeros((n,), np.int32)])
        order = np.argsort(g_dst, kind="stable")
        ne = len(order)
        edge_src[e_off : e_off + ne] = g_src[order]
        edge_dst[e_off : e_off + ne] = g_dst[order]
        edge_mask[e_off : e_off + ne] = True
        if edge_type is not None:
            edge_type[e_off : e_off + ne] = g_type[order]
        e_off += ne
        graph_label[gi] = g.label
        graph_mask[gi] = True
        graph_ids[gi] = g.graph_id
        n_off += n
    # padded edge slots carry the largest segment id so dst stays sorted
    edge_src[e_off:] = max(node_budget - 1, 0)
    edge_dst[e_off:] = max(node_budget - 1, 0)

    return GraphBatch(
        node_feats=node_feats,
        node_vuln=node_vuln,
        node_graph=node_graph,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_mask=edge_mask,
        graph_label=graph_label,
        graph_mask=graph_mask,
        graph_ids=graph_ids,
        num_graphs=num_graphs,
        edge_type=edge_type,
        **bit_arrays,
    )


# ---------------------------------------------------------------------------
# budget-aware batch planning (the reference's planner with one logical
# shard: the same graphs land in the same batches, bit for bit)


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 1 else 1


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Packing recipe for one batch: indices into the source graph
    sequence plus the static budgets. Planning is bookkeeping over
    node/edge counts; `pack_plan` turns a plan into arrays."""

    indices: tuple[int, ...]
    num_graphs: int
    node_budget: int
    edge_budget: int


def pack_plan(
    graphs: Sequence[GraphSpec], plan: BatchPlan, add_self_loops: bool = True
) -> GraphBatch:
    """Materialize one planned batch."""
    return pack([graphs[i] for i in plan.indices], plan.num_graphs,
                 plan.node_budget, plan.edge_budget, add_self_loops)


def plan_shard_bucket_batches(
    graphs: Sequence[GraphSpec],
    num_graphs: int,
    node_budget: int,
    edge_budget: int,
    add_self_loops: bool = True,
    oversized: str = "drop",
    stats: dict | None = None,
) -> Iterator[BatchPlan]:
    """Greedy budget-aware planning of fixed-budget batches: a new batch
    starts whenever the next graph does not fit the current one.

    `oversized` decides graphs over the budgets outright: "drop" skips
    them (training), "raise" raises BudgetExceeded, "singleton" gives
    each a trailing batch of its own whose budgets are its needs rounded
    up to powers of two (evaluation: every example is scored). `stats`
    receives "batches", "dropped", "oversized" and
    "overflow_signatures", final once the generator is exhausted."""
    if oversized not in ("drop", "raise", "singleton"):
        raise ValueError(f"oversized={oversized!r}")
    if stats is None:
        stats = {}
    stats.update(batches=0, dropped=0, oversized=0, overflow_signatures=0)
    overflow: dict[tuple[int, int], list[int]] = {}
    cur: list[int] = []
    n_used = e_used = 0
    for gi, g in enumerate(graphs):
        e_need = g.num_edges + (g.num_nodes if add_self_loops else 0)
        if g.num_nodes > node_budget or e_need > edge_budget:
            stats["oversized"] += 1
            if oversized == "raise":
                raise BudgetExceeded(
                    f"graph {g.graph_id}: {g.num_nodes} nodes / {e_need} "
                    f"edges exceed budgets ({node_budget}/{edge_budget})"
                )
            if oversized == "drop":
                stats["dropped"] += 1
                continue
            sig = (_pow2_ceil(g.num_nodes), _pow2_ceil(e_need))
            overflow.setdefault(sig, []).append(gi)
            continue
        if not (len(cur) < num_graphs and n_used + g.num_nodes <= node_budget
                and e_used + e_need <= edge_budget):
            if cur:
                stats["batches"] += 1
                yield BatchPlan(tuple(cur), num_graphs, node_budget, edge_budget)
            cur, n_used, e_used = [], 0, 0
        cur.append(gi)
        n_used += g.num_nodes
        e_used += e_need
    if cur:
        stats["batches"] += 1
        yield BatchPlan(tuple(cur), num_graphs, node_budget, edge_budget)
    stats["overflow_signatures"] = len(overflow)
    for (nb, eb), gis in sorted(overflow.items()):
        for gi in gis:
            stats["batches"] += 1
            yield BatchPlan((gi,), 1, nb, eb)


def shard_bucket_batches(
    graphs: Iterable[GraphSpec],
    num_graphs: int,
    node_budget: int,
    edge_budget: int,
    add_self_loops: bool = True,
    oversized: str = "drop",
    stats: dict | None = None,
) -> Iterator[GraphBatch]:
    """`plan_shard_bucket_batches`, each plan packed inline."""
    graphs = graphs if isinstance(graphs, Sequence) else list(graphs)
    for plan in plan_shard_bucket_batches(
        graphs, num_graphs, node_budget, edge_budget, add_self_loops, oversized, stats
    ):
        yield pack_plan(graphs, plan, add_self_loops)


def bucket_batches(
    graphs: Iterable[GraphSpec],
    num_graphs: int,
    node_budget: int,
    edge_budget: int,
    drop_oversized: bool = True,
    add_self_loops: bool = True,
    stats: dict | None = None,
) -> Iterator[GraphBatch]:
    """Greedy first-fit packing of a graph stream into fixed-budget
    batches; over-budget graphs are dropped (counted in
    stats["dropped"]) or raise."""
    if stats is None:
        stats = {}
    stats.setdefault("dropped", 0)
    cur: list[GraphSpec] = []
    n_used = e_used = 0
    for g in graphs:
        e_need = g.num_edges + (g.num_nodes if add_self_loops else 0)
        if g.num_nodes > node_budget or e_need > edge_budget:
            if drop_oversized:
                stats["dropped"] += 1
                continue
            raise BudgetExceeded(
                f"graph {g.graph_id}: {g.num_nodes} nodes / {e_need} edges "
                f"exceed budgets ({node_budget}/{edge_budget})"
            )
        if (len(cur) == num_graphs or n_used + g.num_nodes > node_budget
                or e_used + e_need > edge_budget):
            yield pack(cur, num_graphs, node_budget, edge_budget, add_self_loops)
            cur, n_used, e_used = [], 0, 0
        cur.append(g)
        n_used += g.num_nodes
        e_used += e_need
    if cur:
        yield pack(cur, num_graphs, node_budget, edge_budget, add_self_loops)
