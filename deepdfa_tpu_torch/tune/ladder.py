"""Ladder fits: batch-ladder rungs and sequence-bucket edges fitted to
an observed size distribution (the port's copy of the reference's
`deepdfa_tpu/tune/ladder.py`, which gives the same rungs and edges).

The serve executor warms a pow2 rung ladder (1, 2, 4, ...,
max_batch_graphs) and every executed chunk pads to the smallest rung >=
its row count; a stream whose chunk sizes land just above a rung (size 5
against rungs {4, 8}) pads ~2x every batch. `data.seq_buckets` has the
same shape problem for token lengths. This module fits the rungs to the
distribution replayed from serve_log.jsonl / fleet_log.jsonl request
entries, or a training-manifest length list, by exact dynamic
programming:

  minimize   sum_i w_i * rung(s_i)        (expected padded compute)
  subject to |rungs| <= max_rungs          (each rung is one warm-up)
             max(sizes) <= max(rungs) = capacity

Only observed sizes (plus the forced capacity) can be optimal rung
positions, so the DP runs over the distinct sizes in
O(max_rungs * k^2). `padding_waste` is the objective read back out,
comparable to the pow2 baseline (`pow2_rungs`).
"""

from __future__ import annotations

import json
import logging
import math
from collections import Counter
from pathlib import Path
from typing import Sequence

from deepdfa_tpu_torch.serve.batcher import _pow2_sizes

logger = logging.getLogger(__name__)


def pow2_rungs(capacity: int) -> tuple[int, ...]:
    """The hand-picked baseline: the ladder the serve executor warms
    without a tuned record (1, 2, 4, ..., capacity; serve/batcher.py)."""
    return _pow2_sizes(int(capacity))


def rung_for(size: int, rungs: Sequence[int]) -> int:
    """The smallest rung >= size (the executor's `_size_for` rule)."""
    for r in rungs:
        if r >= size:
            return int(r)
    return int(rungs[-1])


def padding_waste(
    sizes: Sequence[int],
    rungs: Sequence[int],
    weights: Sequence[float] | None = None,
) -> float:
    """Fraction of padded compute under a rung assignment:
    1 - sum(w*s) / sum(w*rung(s)). 0 = every batch lands exactly on a
    rung; 0.5 = half the executed rows/tokens are padding."""
    rungs = sorted(int(r) for r in rungs)
    real = 0.0
    padded = 0.0
    for i, s in enumerate(sizes):
        w = float(weights[i]) if weights is not None else 1.0
        real += w * s
        padded += w * rung_for(int(s), rungs)
    if padded <= 0:
        return 0.0
    return 1.0 - real / padded


def fit_rungs(
    sizes: Sequence[int],
    max_rungs: int,
    capacity: int,
    weights: Sequence[float] | None = None,
) -> tuple[int, ...]:
    """Exact min-expected-padded-compute rung set (ascending, capacity
    always the top rung so any legal chunk still fits a warmed rung).

    `weights` weight each observation (default 1 each — a batch is a
    batch); sizes above capacity raise (they could never have executed).
    """
    capacity = int(capacity)
    max_rungs = max(1, int(max_rungs))
    agg: dict[int, float] = {}
    for i, s in enumerate(sizes):
        s = int(s)
        if s < 1:
            continue
        if s > capacity:
            raise ValueError(
                f"observed size {s} exceeds capacity {capacity} — the "
                f"replayed log belongs to a larger-capacity deployment"
            )
        agg[s] = agg.get(s, 0.0) + (
            float(weights[i]) if weights is not None else 1.0
        )
    if not agg:
        return (capacity,)
    cand = sorted(set(agg) | {capacity})
    if len(cand) <= max_rungs:
        return tuple(cand)

    m = len(cand)
    wsum = [0.0] * (m + 1)  # prefix of weights, aligned to cand order
    for i, c in enumerate(cand):
        wsum[i + 1] = wsum[i] + agg.get(c, 0.0)

    def seg_cost(j: int, i: int) -> float:
        # candidates (j, i] all pad to rung cand[i]
        return cand[i] * (wsum[i + 1] - wsum[j + 1])

    inf = math.inf
    # dp[k][i]: min cost covering cand[0..i] with k rungs, last at cand[i]
    dp = [[inf] * m for _ in range(max_rungs + 1)]
    back = [[-1] * m for _ in range(max_rungs + 1)]
    for i in range(m):
        dp[1][i] = seg_cost(-1, i)
    for k in range(2, max_rungs + 1):
        for i in range(k - 1, m):
            best, arg = inf, -1
            for j in range(k - 2, i):
                c = dp[k - 1][j] + seg_cost(j, i)
                if c < best:
                    best, arg = c, j
            dp[k][i] = best
            back[k][i] = arg
    # the top rung is forced to capacity = cand[m-1]
    k_best = min(
        range(1, max_rungs + 1), key=lambda k: dp[k][m - 1]
    )
    rungs = [cand[m - 1]]
    k, i = k_best, m - 1
    while k > 1:
        i = back[k][i]
        rungs.append(cand[i])
        k -= 1
    return tuple(sorted(rungs))


def max_rungs_for_budget(
    compile_budget_s: float,
    per_compile_s: float,
    hard_max: int,
) -> int:
    """The rung count the compile-seconds budget affords: each rung is
    one warm-up (an AOT compile in the reference, the first run of the
    rung's shapes here), so the budget divided by the measured (or
    assumed) per-rung seconds caps the ladder length under the
    configured hard max. Always >= 1 (a ladder needs its capacity rung)."""
    n = int(hard_max)
    if compile_budget_s > 0 and per_compile_s > 0:
        n = min(n, int(compile_budget_s // per_compile_s))
    return max(1, n)


# ---------------------------------------------------------------------------
# observed-distribution replay


def batch_sizes_from_log(path: str | Path) -> list[int]:
    """Executed-chunk sizes replayed from a serve_log.jsonl /
    fleet_log.jsonl request stream.

    Each `{"request": {...}}` entry carries the `batch_size` of the
    batch that scored it, so a batch of size b appears b times — the
    replay divides the request count per size by the size to recover
    the BATCH distribution (the thing the ladder pads)."""
    counts: Counter[int] = Counter()
    path = Path(path)
    with path.open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            req = rec.get("request") if isinstance(rec, dict) else None
            if not isinstance(req, dict):
                continue
            b = req.get("batch_size")
            if isinstance(b, int) and not isinstance(b, bool) and b > 0:
                counts[b] += 1
    sizes: list[int] = []
    for b in sorted(counts):
        sizes.extend([b] * max(1, round(counts[b] / b)))
    if not sizes:
        logger.warning(
            "no request entries with batch_size in %s — was the log "
            "written with serve.request_log=true?", path,
        )
    return sizes


def lengths_from_manifest(path: str | Path) -> list[int]:
    """Real token lengths replayed from a training manifest: a JSON
    array of ints, or a JSONL stream whose rows carry one of
    length/tokens/token_length."""
    path = Path(path)
    text = path.read_text()
    stripped = text.lstrip()
    if stripped.startswith("["):
        return [int(x) for x in json.loads(text)]
    out: list[int] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(row, (int, float)) and not isinstance(row, bool):
            out.append(int(row))
            continue
        if isinstance(row, dict):
            for key in ("length", "tokens", "token_length"):
                v = row.get(key)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out.append(int(v))
                    break
    if not out:
        logger.warning("no lengths found in manifest %s", path)
    return out


# ---------------------------------------------------------------------------
# fit records (what tuned.json persists)


def fit_serve_ladder(
    sizes: Sequence[int],
    capacity: int,
    max_rungs: int,
    compile_budget_s: float = 0.0,
    per_compile_s: float = 0.0,
) -> dict:
    """Fit the serve warmup-ladder rungs to observed chunk sizes; one
    JSON-able record with the pow2 baseline alongside so the win (or
    regression) is always on the record."""
    max_rungs = max_rungs_for_budget(
        compile_budget_s, per_compile_s, max_rungs
    )
    rungs = fit_rungs(sizes, max_rungs, capacity)
    baseline = pow2_rungs(capacity)
    fitted_waste = padding_waste(sizes, rungs)
    baseline_waste = padding_waste(sizes, baseline)
    out = {
        "rungs": [int(r) for r in rungs],
        "pow2_rungs": [int(r) for r in baseline],
        "padding_waste": round(fitted_waste, 6),
        "pow2_padding_waste": round(baseline_waste, 6),
        "samples": len(sizes),
        "capacity": int(capacity),
        "max_rungs": int(max_rungs),
    }
    if fitted_waste > baseline_waste:
        # a tight rung budget CAN lose to pow2 (fewer rungs than the
        # incumbent ladder). The incumbent is already running — a tuned
        # record must never make serving WORSE, so persist the pow2
        # rungs as the layout (the fit-beats-pow2 gate invariant holds
        # by construction) and say so on the record.
        logger.warning(
            "ladder fit (%d rungs, waste %.3f) loses to the pow2 "
            "baseline (waste %.3f) under the rung budget — persisting "
            "the pow2 rungs instead", max_rungs, fitted_waste,
            baseline_waste,
        )
        out["rungs"] = [int(r) for r in baseline]
        out["padding_waste"] = out["pow2_padding_waste"]
        out["fallback_pow2"] = True
    return out


def fit_seq_buckets(
    lengths: Sequence[int],
    max_length: int,
    max_edges: int,
    compile_budget_s: float = 0.0,
    per_compile_s: float = 0.0,
) -> dict:
    """Fit `data.seq_buckets` edges to observed token lengths. The
    largest edge is forced to max_length (the CLI contract: smaller
    cannot hold a full-length row) and edges below 2 are illegal for
    the planner, so observed 0/1-token rows clamp to 2."""
    max_edges = max_rungs_for_budget(
        compile_budget_s, per_compile_s, max_edges
    )
    clamped = [min(max(int(ln), 2), int(max_length)) for ln in lengths]
    edges = fit_rungs(clamped, max_edges, int(max_length))
    baseline = tuple(
        e for e in pow2_rungs(int(max_length)) if e >= 2
    )
    fitted_waste = padding_waste(clamped, edges)
    baseline_waste = padding_waste(clamped, baseline)
    out = {
        "edges": [int(e) for e in edges],
        "pow2_edges": [int(e) for e in baseline],
        "padding_waste": round(fitted_waste, 6),
        "pow2_padding_waste": round(baseline_waste, 6),
        "samples": len(clamped),
        "max_length": int(max_length),
        "max_edges": int(max_edges),
    }
    if fitted_waste > baseline_waste:
        # same never-worse-than-the-incumbent rule as fit_serve_ladder
        logger.warning(
            "seq-bucket fit (%d edges, waste %.3f) loses to the pow2 "
            "baseline (waste %.3f) under the edge budget — persisting "
            "the pow2 edges instead", max_edges, fitted_waste,
            baseline_waste,
        )
        out["edges"] = [int(e) for e in baseline]
        out["padding_waste"] = out["pow2_padding_waste"]
        out["fallback_pow2"] = True
    return out
