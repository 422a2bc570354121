from deepdfa_tpu_torch.data.examples import Example, load_examples
from deepdfa_tpu_torch.data.text import (
    TextBatch,
    TextBatchPlan,
    batch_token_counts,
    bucketed_collate_batches,
    collate,
    collate_plan,
    lengths_for,
    plan_bucketed_batches,
    rows_for_bucket,
    token_lengths,
)
from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer, HashTokenizer, Tokenizer, split_lines

__all__ = [
    "BpeTokenizer",
    "Example",
    "HashTokenizer",
    "TextBatch",
    "TextBatchPlan",
    "Tokenizer",
    "batch_token_counts",
    "bucketed_collate_batches",
    "collate",
    "collate_plan",
    "lengths_for",
    "load_examples",
    "plan_bucketed_batches",
    "rows_for_bucket",
    "split_lines",
    "token_lengths",
]
