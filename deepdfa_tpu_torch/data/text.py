"""Text (+ graph) batches for the combined transformer models (the port's
copy of the reference's `deepdfa_tpu/data/text.py`, serving half).

The collater is the index-join bridge with static shapes: text row i
aligns with graph slot i of one packed `GraphBatch`; a row with no graph,
or whose graph does not fit the batch's node/edge budgets, gets
`has_graph = False` and a 1-node placeholder graph instead of being
dropped. A bucketed batch pads every row to its bucket edge T and holds
`rows_for_bucket(T, token_budget)` rows. `collate`, `token_lengths`,
`rows_for_bucket` and `_fit_width` equal the reference's array for array
(tests/test_torch_combined.py). The training planner
(`plan_bucketed_batches`) comes with the combined-training slice.

A `TextBatch` holds numpy arrays from `collate`; `to(device)` gives the
same batch as torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import PAD_ID_BY_FAMILY
from deepdfa_tpu_torch.graphs.batch import GraphBatch, GraphSpec, pack


@dataclasses.dataclass(frozen=True)
class TextBatch:
    input_ids: Any  # [B, T] int32
    labels: Any  # [B] int32
    row_mask: Any  # [B] bool (False = padding row)
    has_graph: Any  # [B] bool
    graphs: GraphBatch  # num_graphs == B, graph i <-> text row i

    def to(self, device: str | torch.device) -> "TextBatch":
        """The same batch as torch tensors on `device` (dtypes kept)."""
        dev = torch.device(device)

        def move(x):
            if isinstance(x, torch.Tensor):
                return x.to(dev)
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        return TextBatch(
            input_ids=move(self.input_ids), labels=move(self.labels),
            row_mask=move(self.row_mask), has_graph=move(self.has_graph),
            graphs=self.graphs.to(dev),
        )


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
