"""The port's byte-level BPE tokenizer (deepdfa_tpu_torch/data/tokenizer.py:
BpeTokenizer) against the reference's `BpeTokenizer` (which
pre-tokenizes with the `regex` module) and `transformers`'
`RobertaTokenizerFast` (the `tokenizers` library), on the CPU.

- ids and per-token lines equal the reference's exactly, and ids equal
  `RobertaTokenizerFast`'s, on the shipped vocabulary
  (`data/assets/bpe_c/`) and on one this test trains with the reference's
  `train_bpe`, over C sources and over the non-ASCII cases the `re`
  rebuild of `\\p{L}` / `\\p{N}` must get right: combining marks, No/Nl
  numerals, CJK, emoji, NBSP and ideographic spaces, CR LF, the
  contractions and the separators U+001C..U+001F;
- the pre-tokenizer chunks every code point that Python's Unicode
  database assigns as the reference's `regex` pattern does;
- truncation frames as the reference's;
- the shipped vocabulary retrains to the same bytes.
"""

import unicodedata
from pathlib import Path

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.data.tokenizer import _GPT2_PAT, BpeTokenizer as RefBpe  # noqa: E402
from deepdfa_tpu.data.tokenizer_training import train_bpe  # noqa: E402
from deepdfa_tpu_torch.data.tokenizer import (  # noqa: E402
    BPE_C_DIR,
    BpeTokenizer,
    bpe_files,
    gpt2_pretokenizer,
)

ROOT = Path(__file__).resolve().parents[1]
CORPUS_DIR = ROOT / "tests" / "fidelity_corpus"

NON_ASCII = {
    "combining": "été café ño ẍy ́alone",
    "numerals_no_nl": "x² + Ⅻ = 12½; ④ ٣٤ ¾Ⅷ",
    "cjk": "中文字符 日本語テスト 한국어",
    "emoji": "ok \U0001f600\U0001f680!! ❤️ \U0001f468‍\U0001f4bb",
    "nbsp_ideographic": "a b 　c d e    f",
    "crlf": "int a;\r\nint b;\r\n\r\n  return a\r\n",
    "contractions": "it's they're we've I'm we'll he'd don't 'S 'LL o'clock",
    "separators": "a\x1cb\x1dc \x1e d\x1f\x85e  f g",
    "mixed": "/* über ça */ int π = 3; // 中 \U0001f600 ²",
}


def _c_texts() -> dict:
    texts = {p.name: p.read_text() for p in sorted(CORPUS_DIR.iterdir())
             if p.suffix in (".c", ".cc")}
    texts.update({f"synthetic_{i}": ex.before
                  for i, ex in enumerate(ref_synthetic.generate(24, seed=7))})
    return texts


def _train_corpus():
    yield from _c_texts().values()
    yield from NON_ASCII.values()
    for _ in range(3):  # frequent enough for merges over multi-byte characters
        yield from NON_ASCII.values()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("bpe")
    return train_bpe(_train_corpus(), out, vocab_size=2000, min_frequency=2, prefix="t")


@pytest.fixture(scope="module", params=["shipped", "trained"])
def vocab(request, trained):
    return bpe_files(BPE_C_DIR) if request.param == "shipped" else trained


def _hf(vocab):
    return transformers.RobertaTokenizerFast(vocab_file=str(vocab[0]),
                                             merges_file=str(vocab[1]))


@pytest.mark.parametrize("case", ["c", *NON_ASCII])
def test_ids_and_lines_equal_the_reference_and_hf(vocab, case):
    tok, ref, hf = BpeTokenizer(*vocab), RefBpe(*vocab), _hf(vocab)
    texts = _c_texts() if case == "c" else {case: NON_ASCII[case]}
    for name, text in texts.items():
        got, got_lines = tok.encode_with_lines(text, 4096)
        want, want_lines = ref.encode_with_lines(text, 4096)
        assert np.array_equal(got, want) and np.array_equal(got_lines, want_lines), name
        assert np.array_equal(tok.encode(text, 4096), ref.encode(text, 4096)), name
        ids = hf(text)["input_ids"]
        assert len(ids) < 4096 and got[:len(ids)].tolist() == ids, name
        assert (got[len(ids):] == tok.pad_id).all()


def test_truncation_frames_as_the_reference(vocab):
    tok, ref = BpeTokenizer(*vocab), RefBpe(*vocab)
    text = _c_texts()["synthetic_3"] + NON_ASCII["mixed"]
    for n in (3, 4, 8, 17, 64):
        assert np.array_equal(tok.encode(text, n), ref.encode(text, n))
        for a, b in zip(tok.encode_with_lines(text, n), ref.encode_with_lines(text, n)):
            assert np.array_equal(a, b)


def test_pretokenizer_chunks_every_assigned_code_point_as_the_reference():
    """Each code point Python's Unicode database assigns, in a context of
    letters, digits, spaces, a repeat and a contraction: the same chunks
    as the reference's `regex` pattern (code points assigned only in
    later Unicode versions are outside the `re` classes by design)."""
    pat = gpt2_pretokenizer()
    cps = [cp for cp in range(0x110000) if not 0xD800 <= cp < 0xE000
           and unicodedata.category(chr(cp)) != "Cn"]
    for i in range(0, len(cps), 400):
        s = "".join(f"x{chr(c)}1{chr(c)} {chr(c)}{chr(c)}'s \n" for c in cps[i:i + 400])
        assert pat.findall(s) == _GPT2_PAT.findall(s), hex(cps[i])


def test_shipped_vocabulary_retrains_to_the_same_bytes(tmp_path):
    """The recipe of data/assets/bpe_c/README.md: the reference's
    `train_bpe` (8192, min_frequency 2) over the fidelity corpus's C and
    C++ files, the native extension's source and 2048 synthetic
    functions."""
    def corpus():
        for p in sorted(CORPUS_DIR.iterdir()):
            if p.suffix in (".c", ".cc"):
                yield p.read_text()
        yield (ROOT / "deepdfa_tpu" / "native" / "src" / "native.cpp").read_text()
        for ex in ref_synthetic.generate(2048, seed=0):
            yield ex.before

    vocab, merges = train_bpe(corpus(), tmp_path, vocab_size=8192, min_frequency=2,
                              prefix="bpe_c")
    shipped = bpe_files(BPE_C_DIR)
    assert vocab.read_bytes() == shipped[0].read_bytes()
    assert merges.read_bytes() == shipped[1].read_bytes()


def test_from_dir_needs_both_files(tmp_path):
    assert BpeTokenizer.from_dir(BPE_C_DIR).vocab_size == RefBpe(*bpe_files(BPE_C_DIR)).vocab_size
    (tmp_path / "x-vocab.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="merges"):
        BpeTokenizer.from_dir(tmp_path)
