"""Byte-level BPE tokenizer training on a code corpus (the port's copy of
the reference's `deepdfa_tpu/data/tokenizer_training.py`).

The reference trains Salesforce-style BPE vocabularies with the
`tokenizers` library (CodeT5/tokenizer/*.py); this produces the same
vocab.json + merges.txt artifacts, which `data/tokenizer.py:BpeTokenizer`
(and HF tokenizers) load directly. Special tokens follow the RoBERTa
frame the combined models expect.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

SPECIAL_TOKENS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]


def train_bpe(
    corpus: Iterable[str],
    out_dir: str | Path,
    vocab_size: int = 32000,
    min_frequency: int = 2,
    prefix: str = "bpe_tokenizer",
) -> tuple[Path, Path]:
    """Train byte-level BPE over in-memory code strings; writes
    `<prefix>-vocab.json` + `<prefix>-merges.txt` into out_dir and returns
    their paths."""
    from tokenizers import ByteLevelBPETokenizer

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(
        corpus,
        vocab_size=vocab_size,
        min_frequency=min_frequency,
        special_tokens=SPECIAL_TOKENS,
    )
    tok.save_model(str(out_dir), prefix)
    return out_dir / f"{prefix}-vocab.json", out_dir / f"{prefix}-merges.txt"


WORD_LEVEL_SPECIALS = ["[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"]


def train_word_level(
    corpus: Iterable[str],
    out_path: str | Path,
    vocab_size: int = 50000,
    min_frequency: int = 1,
) -> Path:
    """Train a whitespace word-level tokenizer; writes one tokenizer.json.

    Asset parity with the reference's
    LineVul/linevul/word_level_tokenizer/wordlevel.json (HF `tokenizers`
    WordLevel model, Whitespace pre-tokenizer, BERT-style special tokens
    [UNK]/[CLS]/[SEP]/[PAD]/[MASK] at ids 0-4) — used by LineVul's
    `--use_word_level_tokenizer` path."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import WordLevelTrainer

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tok = Tokenizer(WordLevel(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    trainer = WordLevelTrainer(
        vocab_size=vocab_size,
        min_frequency=min_frequency,
        special_tokens=WORD_LEVEL_SPECIALS,
    )
    tok.train_from_iterator(corpus, trainer)
    tok.save(str(out_path))
    return out_path
