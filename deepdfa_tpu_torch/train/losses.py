"""Losses and label extraction for graph batches (the reference's
`deepdfa_tpu/train/losses.py`).

- label styles: "graph" = max over the graph's node vulnerability
  labels, OR'd with the stored graph label; "node" = per-node labels.
  The dataflow_solution_* styles raise, as the model does: their
  bit-propagation head comes with a later slice of the port.
- loss = BCE-with-logits with optional pos_weight, as masked means over
  the valid (non-padding) slots, so padding never biases the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepdfa_tpu_torch.graphs.batch import GraphBatch


def check_label_style(style: str) -> str:
    """`style` if the port trains it; the dataflow_solution_* styles
    raise NotImplementedError, anything else ValueError."""
    if style.startswith("dataflow_solution"):
        raise NotImplementedError(
            f"label_style={style!r}: the bit-propagation head comes with a "
            "later slice of the port"
        )
    if style not in ("graph", "node"):
        raise ValueError(f"unsupported label_style: {style}")
    return style


def graph_labels(batch: GraphBatch) -> torch.Tensor:
    """[G] f32: max of node vuln per graph (padding-safe), OR'd with the
    stored graph_label so graph-only-labelled data is not negated. The
    segment max is an amax over a one-hot [G + 1, N] mask (no atomics)."""
    vuln = torch.where(batch.node_mask, batch.node_vuln, torch.zeros_like(batch.node_vuln))
    onehot = batch.node_graph[None, :] == torch.arange(
        batch.num_graphs + 1, device=vuln.device, dtype=batch.node_graph.dtype
    )[:, None]
    per_graph = torch.where(onehot, vuln[None, :], torch.full_like(vuln, -1)[None, :])
    per_graph = per_graph.amax(dim=1)[: batch.num_graphs]
    derived = per_graph.clamp(min=0).to(torch.float32)
    return torch.maximum(derived, batch.graph_label.to(torch.float32))


def node_labels(batch: GraphBatch) -> torch.Tensor:
    return batch.node_vuln.to(torch.float32)


def labels_and_mask(batch: GraphBatch, label_style: str = "graph"):
    """(labels, mask) of the configured label style."""
    if check_label_style(label_style) == "graph":
        return graph_labels(batch), batch.graph_mask
    return node_labels(batch), batch.node_mask


def bce_elements(logits, labels, pos_weight: float = 1.0) -> torch.Tensor:
    """Per-element binary cross-entropy on logits:
    -[pos_weight * y * log sigmoid(x) + (1 - y) * log sigmoid(-x)]."""
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


def bce_with_logits(logits, labels, mask, pos_weight: float = 1.0) -> torch.Tensor:
    """Masked mean binary cross-entropy on logits."""
    per = bce_elements(logits, labels, pos_weight)
    m = mask.to(per.dtype)
    return (per * m).sum() / m.sum().clamp(min=1.0)


def classifier_loss(logits, batch: GraphBatch, label_style: str = "graph",
                    pos_weight: float = 1.0):
    """(loss, labels, mask) for the configured label style."""
    labels, mask = labels_and_mask(batch, label_style)
    return bce_with_logits(logits, labels, mask, pos_weight), labels, mask
