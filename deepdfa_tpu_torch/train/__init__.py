"""Training on one device: losses, optimiser state, samplers, metrics,
checkpoints and the GraphTrainer loop (the reference's
`deepdfa_tpu/train/`, for the DeepDFA GGNN)."""

from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.loop import GraphTrainer, drop_known_feats
from deepdfa_tpu_torch.train.losses import (
    bce_elements,
    bce_with_logits,
    check_label_style,
    classifier_loss,
    graph_labels,
    labels_and_mask,
    node_labels,
)
from deepdfa_tpu_torch.train.metrics import (
    BinaryClassificationMetrics,
    classification_report,
)
from deepdfa_tpu_torch.train.sampler import (
    oversample_epoch,
    positive_weight,
    undersample_epoch,
)
from deepdfa_tpu_torch.train.state import TrainState, lr_factor, make_optimizer

__all__ = [
    "BinaryClassificationMetrics",
    "CheckpointManager",
    "GraphTrainer",
    "TrainState",
    "bce_elements",
    "bce_with_logits",
    "check_label_style",
    "classification_report",
    "classifier_loss",
    "drop_known_feats",
    "graph_labels",
    "labels_and_mask",
    "lr_factor",
    "make_optimizer",
    "node_labels",
    "oversample_epoch",
    "positive_weight",
    "undersample_epoch",
]
