"""Statement-level vulnerability localization metrics (the port's copy of
the reference's `deepdfa_tpu/eval/statements.py`; numpy only, its
outputs equal the reference's bit for bit).

The reference's line-level evaluation suite:
- top-k accuracy over ranked statements
  (DDFA/sastvd/helpers/evaluate.py:262-322 eval_statements*)
- IFA (initial false alarm), top-k localization accuracy, effort@20%
  recall and recall@1%LOC (LineVul/unixcoder/linevul_main.py:886-1316).

All functions take per-example (scores, true_line_flags) pairs; the
scoring methods of eval/localize.py (attention, gradient attributions,
GGNN node scores) plug in above this layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RankedExample:
    """Per-statement scores + binary ground truth for one function."""

    scores: np.ndarray  # [n_statements] float
    flagged: np.ndarray  # [n_statements] bool (true vulnerable lines)

    def ranking(self) -> np.ndarray:
        return np.argsort(-np.asarray(self.scores), kind="stable")


def top_k_accuracy(examples: list[RankedExample], k: int = 10) -> float:
    """Fraction of positive examples with a true line in the top k."""
    hits, total = 0, 0
    for ex in examples:
        if not ex.flagged.any():
            continue
        total += 1
        top = ex.ranking()[:k]
        if ex.flagged[top].any():
            hits += 1
    return hits / total if total else 0.0


def per_example_ifa(examples: list[RankedExample]) -> list[int]:
    """Per-positive-example Initial False Alarm values (clean lines ranked
    above the first truly vulnerable one) — the rows of the reference's
    ifa_records/ifa_<method>.txt dumps."""
    vals = []
    for ex in examples:
        if not ex.flagged.any():
            continue
        order = ex.ranking()
        vals.append(int(np.argmax(ex.flagged[order])))
    return vals


def ifa(examples: list[RankedExample]) -> float:
    """Mean Initial False Alarm: false positives ranked above the first
    true positive (per positive example)."""
    vals = per_example_ifa(examples)
    return float(np.mean(vals)) if vals else 0.0


def effort_at_recall(
    examples: list[RankedExample], recall_frac: float = 0.2
) -> float:
    """Fraction of all statements inspected (global ranking) to reach
    `recall_frac` of all true vulnerable statements (Effort@20%Recall)."""
    if not examples:
        return 0.0
    scores = np.concatenate([np.asarray(e.scores) for e in examples])
    flags = np.concatenate([np.asarray(e.flagged) for e in examples])
    if not flags.any():
        return 0.0
    order = np.argsort(-scores, kind="stable")
    cum = np.cumsum(flags[order])
    target = recall_frac * flags.sum()
    idx = int(np.argmax(cum >= target))
    return (idx + 1) / len(flags)


def recall_at_effort(
    examples: list[RankedExample], effort_frac: float = 0.01
) -> float:
    """Recall of true statements within the top `effort_frac` of the
    global statement ranking (Recall@1%LOC)."""
    if not examples:
        return 0.0
    scores = np.concatenate([np.asarray(e.scores) for e in examples])
    flags = np.concatenate([np.asarray(e.flagged) for e in examples])
    if not flags.any():
        return 0.0
    order = np.argsort(-scores, kind="stable")
    budget = max(1, int(len(flags) * effort_frac))
    return float(flags[order[:budget]].sum() / flags.sum())


def statement_report(examples: list[RankedExample], ks=(1, 3, 5, 10)) -> dict:
    rep = {f"top_{k}_acc": top_k_accuracy(examples, k) for k in ks}
    rep["ifa"] = ifa(examples)
    rep["effort_at_20_recall"] = effort_at_recall(examples, 0.2)
    rep["recall_at_1_loc"] = recall_at_effort(examples, 0.01)
    return rep
