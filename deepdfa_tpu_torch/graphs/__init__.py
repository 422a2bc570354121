from deepdfa_tpu_torch.graphs.batch import (
    ARRAY_FIELDS,
    NUM_SUBKEY_FEATS,
    BatchPlan,
    BudgetExceeded,
    GraphBatch,
    GraphSpec,
    bucket_batches,
    pack,
    pack_plan,
    plan_shard_bucket_batches,
    shard_bucket_batches,
)
from deepdfa_tpu_torch.graphs.store import GraphStore, load_shard

__all__ = [
    "ARRAY_FIELDS",
    "NUM_SUBKEY_FEATS",
    "BatchPlan",
    "BudgetExceeded",
    "GraphBatch",
    "GraphSpec",
    "GraphStore",
    "bucket_batches",
    "load_shard",
    "pack",
    "pack_plan",
    "plan_shard_bucket_batches",
    "shard_bucket_batches",
]
