"""Tokenizers for the transformer path (the port's copy of the
reference's `deepdfa_tpu/data/tokenizer.py`, hash tokenizer only).

`HashTokenizer` buckets identifier / number / punctuation tokens by a
blake2s hash into a fixed vocabulary and frames them as
`<s> ... </s>` right-padded to `max_length`, the shape contract of
LineVul's convert_examples_to_features. Its ids equal the reference's
exactly (tests/test_torch_combined.py). The byte-level BPE tokenizer
(`BpeTokenizer`) waits for vocabulary files in the repository.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

from deepdfa_tpu_torch.core.config import PAD_ID_BY_FAMILY


def split_lines(text: str) -> list[str]:
    """Split on "\\n" only, as git does (form feeds, vertical tabs and
    U+2028 are line content), with no empty line after a trailing
    newline: the line numbering every label and localization agrees on
    (the reference's `data/diffs.py:split_lines`)."""
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return lines


class Tokenizer:
    cls_id: int
    sep_id: int
    pad_id: int
    vocab_size: int

    def encode(self, text: str, max_length: int = 512) -> np.ndarray:
        raise NotImplementedError

    def encode_with_lines(self, text: str, max_length: int = 512) -> tuple[np.ndarray, np.ndarray]:
        """(ids, line_of_token): the 1-based source line of each token,
        0 for specials and padding."""
        raise NotImplementedError

    def batch_encode(self, texts, max_length: int = 512) -> np.ndarray:
        return np.stack([self.encode(t, max_length) for t in texts])


class HashTokenizer(Tokenizer):
    """Deterministic hash-bucket tokenizer (tests, synthetic corpora).

    Special ids follow the RoBERTa frame (cls 0 / pad 1 / sep 2), or with
    `t5_frame` the T5 one (pad 0 / sep == eos 2)."""

    _WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+|\S")

    def __init__(self, vocab_size: int = 4096, t5_frame: bool = False):
        if vocab_size <= 8:
            raise ValueError(f"vocab_size {vocab_size} leaves no room past the specials")
        self.vocab_size = vocab_size
        if t5_frame:
            self.pad_id = PAD_ID_BY_FAMILY["t5"]
            self.cls_id, self.sep_id, self.unk_id = 1, 2, 3
        else:
            self.pad_id = PAD_ID_BY_FAMILY["roberta"]
            self.cls_id, self.sep_id, self.unk_id = 0, 2, 3
        self._first = 4

    def encode(self, text: str, max_length: int = 512) -> np.ndarray:
        return self.encode_with_lines(text, max_length)[0]

    def encode_with_lines(self, text: str, max_length: int = 512):
        ids = [self.cls_id]
        lines = [0]
        for lineno, line in enumerate(split_lines(text), start=1):
            for m in self._WORD.finditer(line):
                if len(ids) >= max_length - 1:
                    break
                h = int.from_bytes(
                    hashlib.blake2s(m.group().encode(), digest_size=4).digest(), "little"
                )
                ids.append(self._first + h % (self.vocab_size - self._first))
                lines.append(lineno)
            if len(ids) >= max_length - 1:
                break
        ids.append(self.sep_id)
        lines.append(0)
        out = np.full((max_length,), self.pad_id, np.int32)
        out[: len(ids)] = ids[:max_length]
        out_lines = np.zeros((max_length,), np.int32)
        out_lines[: len(lines)] = lines[:max_length]
        return out, out_lines
