"""Text (+ graph) batches for the combined transformer models (the port's
copy of the reference's `deepdfa_tpu/data/text.py`).

The collater is the index-join bridge with static shapes: text row i
aligns with graph slot i of one packed `GraphBatch`; a row with no graph,
or whose graph does not fit the batch's node/edge budgets, gets
`has_graph = False` and a 1-node placeholder graph instead of being
dropped. A bucketed batch pads every row to its bucket edge T and holds
`rows_for_bucket(T, token_budget)` rows. Training plans its batches
with `plan_bucketed_batches` (each row to the smallest edge that holds
its real length, a bucket flushed when full, partial buckets at the end
in ascending order) and materialises them with `collate_plan`. Every
function here equals the reference's array for array
(tests/test_torch_combined.py, tests/test_torch_combined_train.py),
for one logical shard: the reference's `collate_shards` stacks several
along a leading axis, which the one-card port has no use for, so
`collate_plan` takes plans of one shard and `TextBatch` has no leading
shard axis.

A `TextBatch` holds numpy arrays from `collate`; `to(device)` gives the
same batch as torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Iterable, Iterator, Mapping, Sequence

import numpy as np

if TYPE_CHECKING:
    import torch

from deepdfa_tpu_torch.core.config import PAD_ID_BY_FAMILY
from deepdfa_tpu_torch.graphs.batch import GraphBatch, GraphSpec, host_tensor, pack, pin


@dataclasses.dataclass(frozen=True)
class TextBatch:
    input_ids: Any  # [B, T] int32
    labels: Any  # [B] int32
    row_mask: Any  # [B] bool (False = padding row)
    has_graph: Any  # [B] bool
    graphs: GraphBatch  # num_graphs == B, graph i <-> text row i

    def to(self, device: str | torch.device, non_blocking: bool = False) -> "TextBatch":
        """The same batch as torch tensors on `device` (dtypes kept);
        `non_blocking` as `GraphBatch.to`."""
        import torch

        dev = torch.device(device)

        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(dev, non_blocking=non_blocking)
            return host_tensor(x).to(dev)

        return TextBatch(
            input_ids=move(self.input_ids), labels=move(self.labels),
            row_mask=move(self.row_mask), has_graph=move(self.has_graph),
            graphs=self.graphs.to(dev, non_blocking=non_blocking),
        )

    def pinned(self) -> "TextBatch":
        """The same batch as host tensors in page-locked memory
        (`GraphBatch.pinned`)."""
        return TextBatch(
            input_ids=pin(self.input_ids), labels=pin(self.labels),
            row_mask=pin(self.row_mask), has_graph=pin(self.has_graph),
            graphs=self.graphs.pinned(),
        )


#: TextBatch's own array fields (its `graphs` is a GraphBatch)
TEXT_ARRAY_FIELDS = ("input_ids", "labels", "row_mask", "has_graph")

#: the 1-node, 0-edge placeholder graph of a row without one
_EMPTY = GraphSpec(
    graph_id=-1,
    node_feats=np.zeros((1, 4), np.int32),
    node_vuln=np.zeros((1,), np.int32),
    edge_src=np.zeros((0,), np.int32),
    edge_dst=np.zeros((0,), np.int32),
    label=0.0,
)


def collate(
    token_ids: np.ndarray,  # [n, T]
    labels: Sequence[int],
    example_ids: Sequence[int],
    graphs_by_id: Mapping[int, GraphSpec],
    batch_rows: int,
    node_budget: int,
    edge_budget: int,
    pad_id: int = PAD_ID_BY_FAMILY["roberta"],
) -> TextBatch:
    """One static-shape TextBatch of `batch_rows` rows (n <= batch_rows).

    Padding rows are filled with `pad_id`, which must be the encoder's
    (its attention mask is `input_ids != pad_id`). Rows whose graph does
    not fit the budgets, alone or after the rows before it, degrade to
    has_graph=False: every row holds at least the placeholder's 1 node
    and 1 self loop, and a real graph costs its excess over that."""
    n = len(labels)
    if n > batch_rows:
        raise ValueError(f"{n} rows > batch_rows {batch_rows}")
    T = token_ids.shape[1]
    ids = np.full((batch_rows, T), pad_id, np.int32)
    ids[:n] = token_ids
    lab = np.zeros((batch_rows,), np.int32)
    lab[:n] = np.asarray(labels, np.int32)
    row_mask = np.zeros((batch_rows,), bool)
    row_mask[:n] = True
    has_graph = np.zeros((batch_rows,), bool)
    specs: list[GraphSpec] = []
    n_used = batch_rows
    e_used = batch_rows
    for i in range(batch_rows):
        if i < n and example_ids[i] in graphs_by_id:
            g = graphs_by_id[example_ids[i]]
            dn = g.num_nodes - _EMPTY.num_nodes
            de = (g.num_edges + g.num_nodes) - (_EMPTY.num_edges + _EMPTY.num_nodes)
            if n_used + dn <= node_budget and e_used + de <= edge_budget:
                specs.append(g)
                has_graph[i] = True
                n_used += dn
                e_used += de
                continue
        specs.append(_EMPTY)
    gb = pack(specs, batch_rows, node_budget, edge_budget)
    return TextBatch(input_ids=ids, labels=lab, row_mask=row_mask, has_graph=has_graph, graphs=gb)


def token_lengths(token_ids: np.ndarray, pad_id: int) -> np.ndarray:
    """[n] real length per row of a right-padded id matrix: the index of
    the last non-pad token + 1; an all-pad row has length 0."""
    ids = np.asarray(token_ids)
    nonpad = ids != pad_id
    tail = np.argmax(nonpad[:, ::-1], axis=1)
    return np.where(nonpad.any(axis=1), ids.shape[1] - tail, 0).astype(np.int64)


def rows_for_bucket(seq_len: int, token_budget: int, num_shards: int) -> int:
    """Rows per shard a `token_budget` allows at bucket edge `seq_len`
    (rows x T <= budget split over the shards; at least 1)."""
    return max(1, int(token_budget) // (int(seq_len) * max(1, num_shards)))


def _fit_width(row: np.ndarray, seq_len: int, pad_id: int) -> np.ndarray:
    """A row cut or right-padded with `pad_id` to `seq_len` ids."""
    row = np.asarray(row, np.int32)
    if row.shape[0] >= seq_len:
        return row[:seq_len]
    out = np.full((seq_len,), pad_id, np.int32)
    out[: row.shape[0]] = row
    return out


def batch_token_counts(input_ids, row_mask, pad_id: int) -> tuple[int, int, int]:
    """(real, padded, rows) of one batch: non-pad tokens in valid rows,
    every token slot of the static shape (padding rows are device work
    too), and valid rows."""
    ids = np.asarray(input_ids)
    mask = np.asarray(row_mask, bool)
    real = int(((ids != pad_id) & mask[..., None]).sum())
    return real, int(ids.size), int(mask.sum())


def lengths_for(token_ids_by_id: Mapping[int, np.ndarray], example_ids: Sequence[int],
                pad_id: int) -> list[int]:
    """Real token length per selected example, in selection order (one
    vectorised `token_lengths` when the rows share a width)."""
    if not len(example_ids):
        return []
    rows = [np.asarray(token_ids_by_id[i]) for i in example_ids]
    if len({r.shape[0] for r in rows}) == 1:
        return [int(n) for n in token_lengths(np.stack(rows), pad_id)]
    return [int(token_lengths(r[None], pad_id)[0]) for r in rows]


@dataclasses.dataclass(frozen=True)
class TextBatchPlan:
    """One bucketed batch: which examples, padded to which bucket edge,
    at which (token-budget-derived) row count."""

    example_ids: tuple[int, ...]
    seq_len: int
    rows_per_shard: int
    num_shards: int
    node_budget: int
    edge_budget: int


def plan_bucketed_batches(
    lengths: Sequence[int] | np.ndarray,
    example_ids: Sequence[int],
    buckets: Sequence[int],
    token_budget: int,
    num_shards: int,
    node_budget: int,
    edge_budget: int,
    stats: dict | None = None,
) -> Iterator[TextBatchPlan]:
    """Assign rows to length buckets and emit token-budget-sized plans.

    Each row goes to the smallest bucket edge >= its real length, in
    arrival order; a bucket flushes when it holds `rows_for_bucket`
    rows, and partial buckets flush in ascending order at the end. A row
    longer than the largest edge raises. `stats` receives "batches",
    "rows", "real_tokens", "padded_tokens" (capacity x edge, summed) and
    "by_bucket" ({edge: rows}), final once the generator is exhausted."""
    buckets = tuple(int(b) for b in buckets)
    if not buckets or list(buckets) != sorted(set(buckets)):
        raise ValueError(f"seq_buckets must be ascending unique edges, got {buckets}")
    if buckets[0] < 2:
        raise ValueError(f"bucket edge {buckets[0]} < 2 is meaningless")
    lengths = np.asarray(lengths, np.int64)
    if len(lengths) != len(example_ids):
        raise ValueError(f"{len(lengths)} lengths vs {len(example_ids)} example_ids")
    if stats is None:
        stats = {}
    stats.update(batches=0, rows=0, real_tokens=0, padded_tokens=0,
                 by_bucket={b: 0 for b in buckets})
    capacity = {b: rows_for_bucket(b, token_budget, num_shards) * num_shards for b in buckets}
    pending: dict[int, list[int]] = {b: [] for b in buckets}

    def emit(edge: int) -> TextBatchPlan:
        ids = pending[edge]
        pending[edge] = []
        stats["batches"] += 1
        stats["rows"] += len(ids)
        stats["by_bucket"][edge] += len(ids)
        stats["padded_tokens"] += capacity[edge] * edge
        return TextBatchPlan(tuple(ids), edge, capacity[edge] // num_shards, num_shards,
                             node_budget, edge_budget)

    edges = np.asarray(buckets, np.int64)
    for eid, ln in zip(example_ids, lengths):
        ln = int(ln)
        if ln > buckets[-1]:
            raise ValueError(
                f"example {eid}: real token length {ln} exceeds the largest bucket "
                f"edge {buckets[-1]} (add a bucket >= the tokenizer max_length, "
                f"data.seq_buckets)"
            )
        edge = int(edges[np.searchsorted(edges, max(ln, 1))])
        pending[edge].append(int(eid))
        stats["real_tokens"] += ln
        if len(pending[edge]) == capacity[edge]:
            yield emit(edge)
    for edge in buckets:
        if pending[edge]:
            yield emit(edge)


def collate_plan(
    plan: TextBatchPlan,
    token_ids_by_id: Mapping[int, np.ndarray],
    labels_by_id: Mapping[int, int],
    graphs_by_id: Mapping[int, GraphSpec],
    pad_id: int = PAD_ID_BY_FAMILY["roberta"],
) -> TextBatch:
    """Materialise one plan of one shard through `collate`: rows cut (only
    trailing padding: the planner guarantees the fit) or padded to the
    bucket edge."""
    if plan.num_shards != 1:
        raise NotImplementedError(
            f"a plan of {plan.num_shards} shards: the port collates one logical shard "
            "(data parallelism comes with the multi-device slice, ROADMAP queue A, item 9)"
        )
    ids = plan.example_ids
    if ids:
        tok = np.stack([_fit_width(token_ids_by_id[i], plan.seq_len, pad_id) for i in ids])
    else:
        tok = np.zeros((0, plan.seq_len), np.int32)
    return collate(tok, [int(labels_by_id[i]) for i in ids], list(ids), graphs_by_id,
                   plan.rows_per_shard, plan.node_budget, plan.edge_budget, pad_id=pad_id)


def bucketed_collate_batches(
    token_ids_by_id: Mapping[int, np.ndarray],
    labels_by_id: Mapping[int, int],
    example_ids: Sequence[int],
    graphs_by_id: Mapping[int, GraphSpec],
    buckets: Sequence[int],
    token_budget: int,
    num_shards: int,
    node_budget: int,
    edge_budget: int,
    pad_id: int = PAD_ID_BY_FAMILY["roberta"],
    lengths: Sequence[int] | None = None,
    stats: dict | None = None,
) -> Iterable[TextBatch]:
    """Plan and collate in one pass."""
    if lengths is None:
        lengths = lengths_for(token_ids_by_id, example_ids, pad_id)
    for plan in plan_bucketed_batches(lengths, example_ids, buckets, token_budget, num_shards,
                                      node_budget, edge_budget, stats=stats):
        yield collate_plan(plan, token_ids_by_id, labels_by_id, graphs_by_id, pad_id)
