"""Class-imbalance samplers (the port's copy of the reference's
`deepdfa_tpu/train/sampler.py`; the same indices bit for bit).

Big-Vul is ~6% vulnerable, so each training epoch draws all positives
plus an equal-size fresh random subset of negatives (1:1 undersampling,
resampled per epoch). Oversampling duplicates positives up to the
negative count instead.
"""

from __future__ import annotations

import numpy as np


def undersample_epoch(
    labels: np.ndarray, epoch: int, seed: int, ratio: float = 1.0
) -> np.ndarray:
    """Indices for one epoch: all positives + ratio*|pos| random negatives."""
    labels = np.asarray(labels)
    pos = np.flatnonzero(labels > 0)
    neg = np.flatnonzero(labels <= 0)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    n_neg = min(len(neg), int(round(len(pos) * ratio))) if len(pos) else len(neg)
    chosen_neg = rng.choice(neg, size=n_neg, replace=False)
    idx = np.concatenate([pos, chosen_neg])
    rng.shuffle(idx)
    return idx


def oversample_epoch(labels: np.ndarray, epoch: int, seed: int) -> np.ndarray:
    """Indices with positives resampled (with replacement) to |neg|."""
    labels = np.asarray(labels)
    pos = np.flatnonzero(labels > 0)
    neg = np.flatnonzero(labels <= 0)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 1]))
    if len(pos) == 0:
        idx = neg.copy()
    else:
        idx = np.concatenate([neg, rng.choice(pos, size=len(neg), replace=True)])
    rng.shuffle(idx)
    return idx


def positive_weight(labels: np.ndarray) -> float:
    """pos_weight = |neg| / |pos|."""
    labels = np.asarray(labels)
    npos = int((labels > 0).sum())
    nneg = int((labels <= 0).sum())
    return nneg / max(npos, 1)
