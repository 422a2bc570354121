from deepdfa_tpu_torch.nn.embedding import SUBKEY_ORDER, AbstractDataflowEmbedding
from deepdfa_tpu_torch.nn.gnn import (
    GatedGraphConv,
    GlobalAttentionPooling,
    GRUCell,
    attention_pool,
    segment_softmax,
)
from deepdfa_tpu_torch.nn.mlp import OutputHead

__all__ = [
    "SUBKEY_ORDER",
    "AbstractDataflowEmbedding",
    "GatedGraphConv",
    "GlobalAttentionPooling",
    "GRUCell",
    "OutputHead",
    "attention_pool",
    "segment_softmax",
]
