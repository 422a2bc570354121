"""Trivial-baseline control: logistic regression over subkey histograms
(the port's copy of the reference's `deepdfa_tpu/eval/trivial_baseline.py`).

The effectiveness evidence on the synthetic corpus only means something
if the task is not linearly separable from bag-of-feature counts (a
test precision of 1.000 is consistent with template counting rather
than learned dataflow). This control fits an
L2-regularized logistic regression on each graph's histogram of
abstract-dataflow vocab indices — exactly the information a
token/feature counter has, with all graph structure discarded — and is
reported next to the GGNN's test metrics. The reference
bar is paper Table 3's dynamics: DeepDFA's wins come from dataflow, so
the GGNN must beat this control by a clear margin on corpus v2's
order-sensitive families (data/synthetic.py:generate_v2), where the
buggy and fixed forms have IDENTICAL histograms.

Pure numpy on purpose: the control must be too simple to hide capacity.
"""

from __future__ import annotations

import numpy as np


def subkey_histograms(specs, input_dim: int) -> np.ndarray:
    """[n_specs, n_feats * input_dim] log1p counts of each (feature
    column, vocab index) pair over the graph's nodes."""
    if not specs:
        return np.zeros((0, 0), np.float32)
    n_feats = specs[0].node_feats.shape[1]
    X = np.zeros((len(specs), n_feats * input_dim), np.float32)
    for r, s in enumerate(specs):
        feats = np.asarray(s.node_feats)
        for c in range(n_feats):
            np.add.at(X[r], c * input_dim + feats[:, c], 1.0)
    return np.log1p(X)


def train_logistic(
    X: np.ndarray,
    y: np.ndarray,
    l2: float = 1e-3,
    lr: float = 0.5,
    epochs: int = 400,
    seed: int = 0,
) -> tuple[np.ndarray, float]:
    """Full-batch gradient descent with balanced class weights (the
    corpus keeps Big-Vul's ~6% positive rate); returns (w, b)."""
    rng = np.random.default_rng(seed)
    n, d = X.shape
    w = rng.normal(0, 0.01, size=d).astype(np.float64)
    b = 0.0
    y = np.asarray(y, np.float64)
    pos = max(y.sum(), 1.0)
    neg = max(n - y.sum(), 1.0)
    sample_w = np.where(y == 1.0, n / (2.0 * pos), n / (2.0 * neg))
    Xd = np.asarray(X, np.float64)
    for _ in range(epochs):
        z = Xd @ w + b
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))
        g = sample_w * (p - y)
        w -= lr * (Xd.T @ g / n + l2 * w)
        b -= lr * float(g.mean())
    return w, b


def predict_proba(X: np.ndarray, w: np.ndarray, b: float) -> np.ndarray:
    z = np.asarray(X, np.float64) @ w + b
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))


def binary_metrics(probs: np.ndarray, y: np.ndarray) -> dict[str, float]:
    pred = (np.asarray(probs) >= 0.5).astype(np.int64)
    y = np.asarray(y, np.int64)
    tp = int(((pred == 1) & (y == 1)).sum())
    fp = int(((pred == 1) & (y == 0)).sum())
    fn = int(((pred == 0) & (y == 1)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    return {
        "acc": float((pred == y).mean()) if len(y) else 0.0,
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def logistic_control(
    train_specs, eval_splits: dict[str, list], input_dim: int, seed: int = 0
) -> dict[str, dict[str, float]]:
    """Fit on the train split, evaluate on every split in `eval_splits`;
    returns {split: metrics}."""
    Xtr = subkey_histograms(train_specs, input_dim)
    ytr = np.array([s.label for s in train_specs])
    w, b = train_logistic(Xtr, ytr, seed=seed)
    out = {}
    for name, specs in eval_splits.items():
        X = subkey_histograms(specs, input_dim)
        y = np.array([s.label for s in specs])
        out[name] = binary_metrics(predict_proba(X, w, b), y)
    return out
