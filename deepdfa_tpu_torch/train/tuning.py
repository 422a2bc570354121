"""Hyperparameter search: the framework's NNI-role component (the port's
copy of the reference's `deepdfa_tpu/train/tuning.py`).

The reference wires NNI through LightningCLI (nni.get_next_parameter
mutating the config, per-epoch report_intermediate_result, final report —
DDFA/code_gnn/main_cli.py:110-120,184, base_module.py:346). Here search is
a plain in-process driver over the typed config:

- `SearchSpace`: dotted-config-key -> choices / (low, high[, log]) ranges,
- `random_search` / `grid_search`: yield override lists,
- `Tuner`: runs a user train_fn per trial, records intermediate metrics
  (the train loop's log_fn hooks straight in), tracks the best trial, and
  persists every trial to a jsonl ledger for offline analysis.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """choices: key -> list of values; ranges: key -> (low, high, log?)."""

    choices: dict[str, Sequence[Any]] = dataclasses.field(default_factory=dict)
    ranges: dict[str, tuple] = dataclasses.field(default_factory=dict)

    def sample(self, rng: np.random.Generator) -> list[str]:
        out = []
        for key, vals in self.choices.items():
            out.append(f"{key}={json.dumps(vals[int(rng.integers(len(vals)))])}")
        for key, spec in self.ranges.items():
            low, high = spec[0], spec[1]
            log = len(spec) > 2 and spec[2]
            if log:
                v = math.exp(rng.uniform(math.log(low), math.log(high)))
            else:
                v = rng.uniform(low, high)
            out.append(f"{key}={v}")
        return out


def random_search(
    space: SearchSpace, n_trials: int, seed: int = 0
) -> Iterator[list[str]]:
    rng = np.random.default_rng(seed)
    for _ in range(n_trials):
        yield space.sample(rng)


def grid_search(space: SearchSpace) -> Iterator[list[str]]:
    if space.ranges:
        raise ValueError("grid search requires pure choice spaces")
    keys = list(space.choices)
    for combo in itertools.product(*(space.choices[k] for k in keys)):
        yield [f"{k}={json.dumps(v)}" for k, v in zip(keys, combo)]


class Tuner:
    """Trial runner + ledger (monitor metric maximized by default)."""

    def __init__(
        self,
        ledger_path: str | Path,
        monitor: str = "val_f1",
        mode: str = "max",
    ):
        self.ledger_path = Path(ledger_path)
        self.ledger_path.parent.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best: dict | None = None

    def _better(self, value: float) -> bool:
        if not math.isfinite(value):
            return False  # diverged trials (NaN/inf) never become best
        if self.best is None:
            return True
        prev = self.best["metric"]
        return value > prev if self.mode == "max" else value < prev

    def run(
        self,
        trials: Iterator[list[str]],
        train_fn: Callable[[list[str], Callable[[dict], None]], dict],
    ) -> dict | None:
        """train_fn(overrides, report) -> final metrics dict; `report` may
        be called with intermediate records (the fit loop's log_fn)."""
        for i, overrides in enumerate(trials):
            t0 = time.perf_counter()
            intermediates: list[dict] = []
            final = train_fn(overrides, intermediates.append)
            record = {
                "trial": i,
                "overrides": overrides,
                "final": final,
                "intermediate": intermediates,
                "seconds": time.perf_counter() - t0,
            }
            value = final.get(self.monitor)
            if value is not None and self._better(float(value)):
                self.best = {"trial": i, "overrides": overrides, "metric": float(value)}
                record["is_best"] = True
            with self.ledger_path.open("a") as f:
                f.write(json.dumps(record) + "\n")
        return self.best
