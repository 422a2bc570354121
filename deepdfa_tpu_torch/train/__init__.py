"""Training on one device: losses, optimiser state, samplers, metrics,
checkpoints, the GraphTrainer loop (the DeepDFA GGNN), the
CombinedTrainer loop (the combined DeepDFA+LineVul and CodeT5+DeepDFA
models) with the graph-encoder transfer, and the generation family's
GenTrainer, fit_multi and CloneTrainer (the reference's
`deepdfa_tpu/train/`)."""

from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.clone_loop import CloneTrainer
from deepdfa_tpu_torch.train.combined_loop import CombinedTrainer
from deepdfa_tpu_torch.train.gen_loop import GenTrainer
from deepdfa_tpu_torch.train.loop import GraphTrainer, drop_known_feats
from deepdfa_tpu_torch.train.losses import (
    bce_elements,
    bce_with_logits,
    check_label_style,
    classifier_loss,
    dataflow_labels,
    graph_labels,
    labels_and_mask,
    masked_softmax_cross_entropy,
    node_labels,
    softmax_cross_entropy,
)
from deepdfa_tpu_torch.train.metrics import (
    BinaryClassificationMetrics,
    classification_report,
)
from deepdfa_tpu_torch.train.multi_gen import GenTask, fit_multi
from deepdfa_tpu_torch.train.sampler import (
    oversample_epoch,
    positive_weight,
    undersample_epoch,
)
from deepdfa_tpu_torch.train.state import TrainState, lr_factor, make_optimizer
from deepdfa_tpu_torch.train.transfer import (
    freeze,
    graph_encoder_subset,
    load_graph_encoder,
)

__all__ = [
    "BinaryClassificationMetrics",
    "CheckpointManager",
    "CloneTrainer",
    "CombinedTrainer",
    "GenTask",
    "GenTrainer",
    "GraphTrainer",
    "TrainState",
    "bce_elements",
    "bce_with_logits",
    "check_label_style",
    "classification_report",
    "classifier_loss",
    "dataflow_labels",
    "drop_known_feats",
    "fit_multi",
    "freeze",
    "graph_encoder_subset",
    "graph_labels",
    "labels_and_mask",
    "load_graph_encoder",
    "lr_factor",
    "make_optimizer",
    "masked_softmax_cross_entropy",
    "node_labels",
    "oversample_epoch",
    "positive_weight",
    "softmax_cross_entropy",
    "undersample_epoch",
]
