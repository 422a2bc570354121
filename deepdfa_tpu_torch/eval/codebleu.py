"""Corpus BLEU and its keyword-weighted variant: the n-gram halves of
CodeBLEU (the port's copy of the reference's `deepdfa_tpu/eval/codebleu.py`,
`:173-270`; the reference's `bleu.py` and `weighted_ngram_match.py` roles).
The generation trainer scores decoded token sequences with `corpus_bleu`.
CodeBLEU's syntax and dataflow matches need the C frontend and are not in
the port yet (ROADMAP queue A, item 3).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

_EPSILON = 0.1  # NLTK SmoothingFunction default, used by the reference


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def _closest_ref_length(references: Sequence[Sequence[str]], hyp_len: int) -> int:
    return min(
        (len(r) for r in references),
        key=lambda rl: (abs(rl - hyp_len), rl),
    )


def _brevity_penalty(ref_len: int, hyp_len: int) -> float:
    if hyp_len > ref_len:
        return 1.0
    if hyp_len == 0:
        return 0.0
    return math.exp(1 - ref_len / hyp_len)


def _combine(p_n: list[tuple[float, int]], weights, bp: float) -> float:
    """exp(sum w_i log p_i) with epsilon smoothing on zero numerators."""
    if p_n[0][0] == 0:
        return 0.0
    s = 0.0
    for w, (num, den) in zip(weights, p_n):
        num = num if num != 0 else _EPSILON
        s += w * math.log(num / max(den, 1))
    return bp * math.exp(s)


def corpus_bleu(
    list_of_references: Sequence[Sequence[Sequence[str]]],
    hypotheses: Sequence[Sequence[str]],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
) -> float:
    """Corpus BLEU with clipped micro-averaged precision (bleu.py role)."""
    assert len(list_of_references) == len(hypotheses)
    numer = Counter()
    denom = Counter()
    hyp_lengths = 0
    ref_lengths = 0
    for references, hyp in zip(list_of_references, hypotheses):
        for n, _ in enumerate(weights, start=1):
            hyp_counts = _ngrams(hyp, n)
            max_ref = Counter()
            for ref in references:
                for g, c in _ngrams(ref, n).items():
                    max_ref[g] = max(max_ref[g], c)
            clipped = {g: min(c, max_ref[g]) for g, c in hyp_counts.items()}
            numer[n] += sum(clipped.values())
            denom[n] += max(1, sum(hyp_counts.values()))
        hyp_lengths += len(hyp)
        ref_lengths += _closest_ref_length(references, len(hyp))
    bp = _brevity_penalty(ref_lengths, hyp_lengths)
    p_n = [(numer[n], denom[n]) for n, _ in enumerate(weights, start=1)]
    return _combine(p_n, weights, bp)


def weighted_corpus_bleu(
    list_of_references: Sequence[Sequence[Sequence[str]]],
    hypotheses: Sequence[Sequence[str]],
    keywords: frozenset[str],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    keyword_weight: float = 1.0,
    other_weight: float = 0.2,
) -> float:
    """Keyword-weighted variant (weighted_ngram_match.py role): modified
    n-gram *recall* accumulated per reference, with unigram counts scaled
    by token weights (keywords count 5x as much as other tokens)."""
    assert len(list_of_references) == len(hypotheses)
    numer = Counter()
    denom = Counter()
    hyp_lengths = 0
    ref_lengths = 0

    def w(tok: str) -> float:
        return keyword_weight if tok in keywords else other_weight

    for references, hyp in zip(list_of_references, hypotheses):
        for n, _ in enumerate(weights, start=1):
            hyp_counts = _ngrams(hyp, n)
            for ref in references:
                ref_counts = _ngrams(ref, n)
                clipped = {
                    g: min(c, hyp_counts[g]) for g, c in ref_counts.items()
                }
                if n == 1:
                    numer[n] += sum(c * w(g[0]) for g, c in clipped.items())
                    denom[n] += max(
                        1, sum(c * w(g[0]) for g, c in ref_counts.items())
                    )
                else:
                    numer[n] += sum(clipped.values())
                    denom[n] += max(1, sum(ref_counts.values()))
        hyp_lengths += len(hyp)
        ref_lengths += _closest_ref_length(references, len(hyp))
    bp = _brevity_penalty(ref_lengths, hyp_lengths)
    p_n = [(numer[n], denom[n]) for n, _ in enumerate(weights, start=1)]
    return _combine(p_n, weights, bp)
