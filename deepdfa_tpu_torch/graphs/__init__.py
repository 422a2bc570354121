from deepdfa_tpu_torch.graphs.batch import (
    ARRAY_FIELDS,
    NUM_SUBKEY_FEATS,
    BudgetExceeded,
    GraphBatch,
    GraphSpec,
    pack,
)

__all__ = [
    "ARRAY_FIELDS",
    "NUM_SUBKEY_FEATS",
    "BudgetExceeded",
    "GraphBatch",
    "GraphSpec",
    "pack",
]
