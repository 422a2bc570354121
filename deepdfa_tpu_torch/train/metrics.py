"""Streaming classification metrics, accumulated on the host in numpy
(the port's copy of the reference's `deepdfa_tpu/train/metrics.py`):
accuracy, precision, recall, F1, the positive and negative subsets, a
binned PR curve and the confusion matrix. The device only emits
(probs, labels, mask).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BinaryClassificationMetrics:
    threshold: float = 0.5
    store_curve: bool = True

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        self.tp = self.fp = self.tn = self.fn = 0
        self._probs: list[np.ndarray] = []
        self._labels: list[np.ndarray] = []

    def update(self, probs, labels, mask=None) -> None:
        probs = np.asarray(probs, np.float32).reshape(-1)
        labels = np.asarray(labels, np.float32).reshape(-1)
        if mask is not None:
            keep = np.asarray(mask, bool).reshape(-1)
            probs, labels = probs[keep], labels[keep]
        preds = probs >= self.threshold
        pos = labels >= 0.5
        self.tp += int(np.sum(preds & pos))
        self.fp += int(np.sum(preds & ~pos))
        self.fn += int(np.sum(~preds & pos))
        self.tn += int(np.sum(~preds & ~pos))
        if self.store_curve:
            self._probs.append(probs)
            self._labels.append(labels)

    @property
    def count(self) -> int:
        return self.tp + self.fp + self.tn + self.fn

    def compute(self) -> dict[str, float]:
        tp, fp, tn, fn = self.tp, self.fp, self.tn, self.fn
        total = max(tp + fp + tn + fn, 1)
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return {
            "acc": (tp + tn) / total,
            "precision": prec,
            "recall": rec,
            "f1": f1,
            "pos_acc": rec,
            "neg_acc": tn / (tn + fp) if tn + fp else 0.0,
            "pred_pos_rate": (tp + fp) / total,
            "label_pos_rate": (tp + fn) / total,
        }

    def confusion_matrix(self) -> np.ndarray:
        return np.array([[self.tn, self.fp], [self.fn, self.tp]], np.int64)

    def pr_curve(self, num_points: int = 200) -> dict[str, np.ndarray]:
        """PR pairs over score thresholds, binned so the curve's size is
        independent of the dataset's."""
        if not self._probs:
            return {"precision": np.array([]), "recall": np.array([]), "thresholds": np.array([])}
        probs = np.concatenate(self._probs)
        labels = np.concatenate(self._labels) >= 0.5
        thresholds = np.linspace(0.0, 1.0, num_points, endpoint=False)
        prec = np.zeros(num_points)
        rec = np.zeros(num_points)
        npos = max(labels.sum(), 1)
        for i, t in enumerate(thresholds):
            preds = probs >= t
            tp = np.sum(preds & labels)
            prec[i] = tp / max(preds.sum(), 1)
            rec[i] = tp / npos
        return {"precision": prec, "recall": rec, "thresholds": thresholds}


def classification_report(m: BinaryClassificationMetrics) -> str:
    c = m.compute()
    cm = m.confusion_matrix()
    lines = [
        f"examples: {m.count}",
        f"confusion matrix [[tn fp][fn tp]]: {cm.tolist()}",
    ]
    lines += [f"{k:>15}: {v:.4f}" for k, v in c.items()]
    return "\n".join(lines)
