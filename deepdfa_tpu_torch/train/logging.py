"""Run logging: jsonl always, TensorBoard when available (the port's copy
of the reference's `deepdfa_tpu/train/logging.py`).

Every run writes `train_log.jsonl` unconditionally (machine-readable,
append-only) and mirrors scalar records into TensorBoard event files
through `torch.utils.tensorboard` when it imports (it needs the
`tensorboard` package; without it the mirror is off, with one warning).

One append handle is held for the logger's lifetime, flushed after every
record, so a killed run keeps every line it logged. Non-finite scalars
stay in the jsonl as they are and are dropped, and counted, before the
TensorBoard mirror (`obs/logging/nonfinite_dropped`); the flattening's
tag collisions are counted under `obs/logging/flatten_collisions`
(obs/metrics.py:flatten_scalars, the one place that mapping lives).
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path

from deepdfa_tpu_torch.obs import metrics as obs_metrics
from deepdfa_tpu_torch.obs.metrics import flatten_scalars

logger = logging.getLogger(__name__)

__all__ = ["NullRunLogger", "RunLogger", "flatten_scalars"]


class RunLogger:
    def __init__(self, run_dir: str | Path, tensorboard: bool = True):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.run_dir / "train_log.jsonl"
        self._file = self.jsonl_path.open("a")
        #: non-finite scalars dropped from the TensorBoard mirror (the
        #: jsonl keeps them)
        self.nonfinite_dropped = 0
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.run_dir / "tb"))
            except Exception as e:
                logger.warning("RunLogger: no TensorBoard mirror (%s); train_log.jsonl only",
                               e)
                self._tb = None

    @property
    def has_tensorboard(self) -> bool:
        return self._tb is not None

    def log(self, record: dict) -> None:
        if self._file is None:  # log after close: reopen rather than die
            self._file = self.jsonl_path.open("a")
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            step = int(record.get("step", record.get("epoch", 0)))
            for k, v in flatten_scalars(record).items():
                if k in ("step", "epoch"):
                    continue
                if not math.isfinite(v):
                    self.nonfinite_dropped += 1
                    obs_metrics.REGISTRY.counter("obs/logging/nonfinite_dropped").inc()
                    continue
                self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._tb is not None:
            if self.nonfinite_dropped:
                logger.warning(
                    "RunLogger: dropped %d non-finite scalar(s) from the TensorBoard mirror "
                    "(train_log.jsonl keeps them)", self.nonfinite_dropped)
            self._tb.flush()
            self._tb.close()

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullRunLogger:
    """A logger that writes nothing and creates nothing (a process that
    does not own the run log), with RunLogger's surface."""

    has_tensorboard = False
    nonfinite_dropped = 0

    def log(self, record: dict) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullRunLogger":
        return self

    def __exit__(self, *exc) -> None:
        pass
