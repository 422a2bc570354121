r"""Tokenizers for the transformer path (the port's copy of the
reference's `deepdfa_tpu/data/tokenizer.py`).

Both frame their ids as `<s> ... </s>` right-padded to `max_length`, the
shape contract of LineVul's convert_examples_to_features.

- `HashTokenizer` buckets identifier / number / punctuation tokens by a
  blake2s hash into a fixed vocabulary (tests, synthetic corpora).
- `BpeTokenizer`: GPT-2 / RoBERTa byte-level BPE from `vocab.json` and
  `merges.txt` (codebert-base's format, and what the reference's
  `data/tokenizer_training.py:train_bpe` writes). The reference
  pre-tokenizes with the `regex` module's `\p{L}` / `\p{N}` classes,
  which Python's `re` lacks (its `\w` takes in No/Nl numerals, its `\d`
  is Nd only), so the port compiles the same pattern with `re` over
  explicit character classes built once from `unicodedata`: letters are
  the L* categories, numbers the N* ones, whitespace `str.isspace()`
  without U+001C..U+001F (the `regex` module's `\s`). Characters that
  Python's Unicode database does not assign yet (Unicode 16 and later)
  fall in neither class. The vocabulary the port ships is under
  `data/assets/bpe_c/` (its README says how it was trained).

Their ids equal the reference's exactly (tests/test_torch_combined.py,
tests/test_torch_bpe.py).
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import json
import re
import unicodedata
from pathlib import Path

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


#: the vocabulary the port ships: byte-level BPE over C sources
BPE_C_DIR = Path(__file__).resolve().parent / "assets" / "bpe_c"


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> unicode table (the byte-level BPE alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _char_class(member) -> str:
    """A `re` character-class body of every code point `member` takes."""
    parts = []
    for inside, run in itertools.groupby(range(0x110000), key=lambda cp: member(chr(cp))):
        if inside:
            run = list(run)
            lo, hi = re.escape(chr(run[0])), re.escape(chr(run[-1]))
            parts.append(lo if run[0] == run[-1] else f"{lo}-{hi}")
    return "".join(parts)


def _is_space(c: str) -> bool:
    return c.isspace() and not "\x1c" <= c <= "\x1f"


@functools.lru_cache()
def gpt2_pretokenizer() -> re.Pattern:
    r"""GPT-2's pre-tokenizer, `'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|
    ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+`, compiled with `re` over explicit
    classes (built on first use, about a second)."""
    cat = unicodedata.category
    letters = _char_class(lambda c: cat(c)[0] == "L")
    numbers = _char_class(lambda c: cat(c)[0] == "N")
    space = _char_class(_is_space)
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+| ?[^{space}{letters}{numbers}]+"
        rf"|[{space}]+(?![^{space}])|[{space}]+")


class BpeTokenizer(Tokenizer):
    """GPT-2-style byte-level BPE from vocab.json + merges.txt."""

    def __init__(self, vocab_file: str | Path, merges_file: str | Path, cls_token="<s>",
                 sep_token="</s>", pad_token="<pad>", unk_token="<unk>"):
        self.vocab: dict[str, int] = json.loads(Path(vocab_file).read_text())
        merges = Path(merges_file).read_text().splitlines()
        merges = [m for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.vocab_size = len(self.vocab)
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_id = self.vocab.get(unk_token, 3)
        self._pat = gpt2_pretokenizer()
        self._cache: dict[str, list[str]] = {}  # pre-token -> its pieces

    @classmethod
    def from_dir(cls, directory: str | Path) -> "BpeTokenizer":
        """The `*vocab.json` and `*merges.txt` of `directory` (what
        `train-combined --tokenizer DIR` reads)."""
        vocab, merges = bpe_files(directory)
        return cls(vocab, merges)

    def _bpe(self, token: str) -> list[str]:
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 60))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        return word

    def _pieces(self, chunk: str) -> list[str]:
        """A pre-token's BPE pieces (cached by the raw chunk)."""
        pieces = self._cache.get(chunk)
        if pieces is None:
            pieces = self._bpe("".join(self.byte_encoder[b] for b in chunk.encode("utf-8")))
            self._cache[chunk] = pieces
        return pieces

    def encode(self, text: str, max_length: int = 512) -> np.ndarray:
        ids = [self.cls_id]
        for chunk in self._pat.findall(text):
            for piece in self._pieces(chunk):
                ids.append(self.vocab.get(piece, self.unk_id))
                if len(ids) >= max_length - 1:
                    break
            if len(ids) >= max_length - 1:
                break
        ids.append(self.sep_id)
        out = np.full((max_length,), self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_with_lines(self, text: str, max_length: int = 512):
        """(ids, line_of_token): a piece's line is its chunk's 1-based
        line ("\\n" counted before the chunk starts)."""
        ids = [self.cls_id]
        lines = [0]
        pos = 0
        line = 1
        for m in self._pat.finditer(text):
            line += text.count("\n", pos, m.start())
            pos = m.start()
            for piece in self._pieces(m.group()):
                if len(ids) >= max_length - 1:
                    break
                ids.append(self.vocab.get(piece, self.unk_id))
                lines.append(line)
            if len(ids) >= max_length - 1:
                break
        ids.append(self.sep_id)
        lines.append(0)
        out = np.full((max_length,), self.pad_id, np.int32)
        out[: len(ids)] = ids
        out_lines = np.zeros((max_length,), np.int32)
        out_lines[: len(lines)] = lines
        return out, out_lines


def bpe_files(directory: str | Path) -> tuple[Path, Path]:
    """(vocab.json, merges.txt) of a tokenizer directory: its first
    `*vocab.json` and `*merges.txt`, as the reference's train-combined
    globs them."""
    d = Path(directory)
    try:
        return next(iter(sorted(d.glob("*vocab.json")))), next(iter(sorted(d.glob("*merges.txt"))))
    except StopIteration:
        raise FileNotFoundError(f"{d} holds no *vocab.json and *merges.txt pair") from None
