from deepdfa_tpu_torch.data.text import TextBatch, collate, rows_for_bucket, token_lengths
from deepdfa_tpu_torch.data.tokenizer import HashTokenizer, Tokenizer, split_lines

__all__ = [
    "HashTokenizer",
    "TextBatch",
    "Tokenizer",
    "collate",
    "rows_for_bucket",
    "split_lines",
    "token_lengths",
]
