"""Temperature scaling and the cascade's uncertainty band (the port's
copy of the reference's `deepdfa_tpu/eval/calibrate.py`; numpy only, its
outputs equal the reference's bit for bit).

The two-stage cascade (serve/cascade.py) escalates the requests whose
stage-1 probability is uncertain, which needs a calibrated probability
first:

- `fit_temperature(probs, labels)`: one scalar T minimising the NLL of
  sigmoid(logit(p) / T) (Guo et al. 2017), by golden-section search
  over log T; deterministic.
- `fit_band(probs, labels, temperature, target_escalation)`: the band
  (lo, hi) around 0.5 of the calibrated probabilities that holds about
  `target_escalation` of the dev set: the symmetric |p - 0.5| quantile.
- `in_band(prob, band)`: the one escalation predicate, half-open.
- `auc(probs, labels)`: rank AUC, ties averaged.
- `calibrate(probs, labels, target_escalation)`: the recipe that `cli
  cascade-calibrate` prints; its temperature and band feed
  `serve.cascade_temperature` / `serve.cascade_band`.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-7


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), _EPS, 1.0 - _EPS)
    return np.log(p / (1.0 - p))


def temperature_scale(probs, temperature: float) -> np.ndarray:
    """sigmoid(logit(p) / T): T > 1 softens (towards 0.5), T < 1
    sharpens. T=1 is the identity up to float round-trip."""
    z = _logit(probs) / max(float(temperature), _EPS)
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float64)


def nll(probs, labels, temperature: float = 1.0) -> float:
    """Mean negative log likelihood of the (temperature-scaled) probs."""
    p = np.clip(
        temperature_scale(probs, temperature), _EPS, 1.0 - _EPS
    )
    y = np.asarray(labels, dtype=np.float64)
    return float(-np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


def fit_temperature(
    probs, labels, lo: float = -3.0, hi: float = 3.0, iters: int = 60
) -> float:
    """Golden-section minimization of NLL over log T in [lo, hi].

    Needs both classes present (a one-class dev set has a degenerate
    optimum at T -> inf); raises ValueError otherwise."""
    y = np.asarray(labels)
    if y.size == 0 or y.min() == y.max():
        raise ValueError(
            "fit_temperature needs a labeled dev set with BOTH classes "
            f"present (got labels {sorted(set(np.asarray(y).tolist()))})"
        )
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = float(lo), float(hi)
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = nll(probs, y, np.exp(c)), nll(probs, y, np.exp(d))
    for _ in range(int(iters)):
        if fc <= fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = nll(probs, y, np.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = nll(probs, y, np.exp(d))
    return float(np.exp((a + b) / 2.0))


def fit_band(
    probs,
    labels=None,
    temperature: float = 1.0,
    target_escalation: float = 0.3,
) -> tuple[float, float]:
    """The uncertainty band (lo, hi): symmetric around 0.5 in calibrated
    probability space, sized so ~`target_escalation` of the dev set
    falls inside. `labels` is accepted (the calibration recipe passes
    the same arrays to both fits) but the band itself is a quantile of
    the score distribution, not of the labels."""
    del labels  # recipe symmetry; see docstring
    t = float(np.clip(target_escalation, 0.0, 1.0))
    if t <= 0.0:
        return (0.5, 0.5)  # empty band: nothing escalates
    cal = temperature_scale(probs, temperature)
    d = np.sort(np.abs(cal - 0.5))
    r = float(d[min(len(d) - 1, max(0, int(np.ceil(t * len(d))) - 1))])
    # half-open band [lo, hi): nudge hi so the boundary sample escalates
    r = min(r + 1e-9, 0.5)
    return (0.5 - r, 0.5 + r)


def in_band(prob: float, band: tuple[float, float]) -> bool:
    """The one escalation predicate (serve/cascade.py imports it): the
    band is half-open [lo, hi) so a degenerate (x, x) band is empty."""
    lo, hi = band
    return float(lo) <= float(prob) < float(hi)


def auc(probs, labels) -> float | None:
    """Rank AUC with tied-score averaging; None when one class is
    missing (AUC undefined)."""
    p = np.asarray(probs, dtype=np.float64)
    y = np.asarray(labels)
    n_pos = int(np.sum(y == 1))
    n_neg = int(np.sum(y == 0))
    if n_pos == 0 or n_neg == 0:
        return None
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty(len(p), dtype=np.float64)
    sorted_p = p[order]
    i = 0
    while i < len(p):
        j = i
        while j + 1 < len(p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float(
        (np.sum(ranks[y == 1]) - n_pos * (n_pos + 1) / 2.0)
        / (n_pos * n_neg)
    )


def calibrate(
    probs, labels, target_escalation: float = 0.3
) -> dict:
    """The one-call recipe: fit T, fit the band, report the dev-set
    escalation rate and AUC — what `cascade-calibrate` prints and the
    cascade bench embeds."""
    temperature = fit_temperature(probs, labels)
    band = fit_band(
        probs, labels, temperature=temperature,
        target_escalation=target_escalation,
    )
    cal = temperature_scale(probs, temperature)
    esc = float(np.mean([in_band(p, band) for p in cal]))
    return {
        "temperature": round(temperature, 6),
        "band": [round(band[0], 6), round(band[1], 6)],
        "dev_escalation_rate": round(esc, 4),
        "dev_auc": auc(probs, labels),
        "dev_nll": round(nll(probs, labels, temperature), 6),
        "n": int(np.asarray(probs).size),
    }
