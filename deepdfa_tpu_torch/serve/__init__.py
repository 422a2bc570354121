from deepdfa_tpu_torch.serve.batcher import (
    DynamicBatcher,
    GgnnExecutor,
    QueueFull,
    RequestTooLarge,
    ScoreRequest,
)
from deepdfa_tpu_torch.serve.driver import score_graphs

__all__ = [
    "DynamicBatcher",
    "GgnnExecutor",
    "QueueFull",
    "RequestTooLarge",
    "ScoreRequest",
    "score_graphs",
]
