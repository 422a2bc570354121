"""Losses and label extraction for graph batches (the reference's
`deepdfa_tpu/train/losses.py`).

- label styles: "graph" = max over the graph's node vulnerability
  labels, OR'd with the stored graph label; "node" = per-node labels;
  "dataflow_solution_in" / "_out" = the exact reaching-definitions IN /
  OUT bits of every node, [N, max_defs], with the node mask broadcast
  over the bit axis.
- loss = BCE-with-logits with optional pos_weight, as masked means over
  the valid (non-padding) slots, so padding never biases the loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.models.deepdfa import LABEL_STYLES


def check_label_style(style: str) -> str:
    """`style` if the port trains it, else ValueError."""
    if style not in LABEL_STYLES:
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


def dataflow_labels(batch: GraphBatch, style: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, mask), both [N, B]: the exact reaching-definitions IN/OUT
    fixpoint bits; the node mask broadcasts over the bit axis."""
    if style == "dataflow_solution_in":
        bits = batch.node_bits_in
    elif style == "dataflow_solution_out":
        bits = batch.node_bits_out
    else:
        raise ValueError(f"unsupported dataflow label_style: {style}")
    if bits is None:
        raise ValueError(f"label_style={style} requires bit labels on the batch "
                         "(extract with max_defs set)")
    return bits, batch.node_mask[:, None].expand(bits.shape)


def labels_and_mask(batch: GraphBatch, label_style: str = "graph"):
    """(labels, mask) of the configured label style."""
    style = check_label_style(label_style)
    if style == "graph":
        return graph_labels(batch), batch.graph_mask
    if style.startswith("dataflow_solution"):
        return dataflow_labels(batch, style)
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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy of [B, C] logits against integer labels
    (`optax.softmax_cross_entropy_with_integer_labels`), in fp32."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def masked_softmax_cross_entropy(logits, labels, mask):
    """(sum of the per-row losses over valid rows, valid count): the
    combined trainer's loss is sum / max(count, 1)
    (`combined_loop.py:_loss_sum` and `_sharded_grads`)."""
    per = softmax_cross_entropy(logits, labels)
    m = mask.to(per.dtype)
    return (per * m).sum(), m.sum()
