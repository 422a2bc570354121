from deepdfa_tpu_torch.serve.batcher import (
    CombinedExecutor,
    DynamicBatcher,
    GgnnExecutor,
    QueueFull,
    RequestTooLarge,
    ScoreRequest,
)
from deepdfa_tpu_torch.serve.driver import score_combined, score_graphs

__all__ = [
    "CombinedExecutor",
    "DynamicBatcher",
    "GgnnExecutor",
    "QueueFull",
    "RequestTooLarge",
    "ScoreRequest",
    "score_combined",
    "score_graphs",
]
