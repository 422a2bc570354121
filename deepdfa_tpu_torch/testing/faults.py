"""Deterministic fault injection for the resilience runtime (the port of
the reference's `deepdfa_tpu/testing/faults.py`, on the same
`DEEPDFA_FAULTS` variable and grammar).

Every failure mode the runtime claims to survive is injectable on
purpose, so tests and `chip_smoke.py` exercise preemption, NaN batches,
stalled producers and corrupt cache shards without timing games:

- **SIGTERM at step N** — `FaultPlan(sigterm_at_step=N)`: the wrapped
  batch stream sends SIGTERM to its own process right before handing out
  the Nth batch; the PreemptionHandler flag is set, the loop finishes the
  in-flight step, checkpoints, and raises Preempted.
- **NaN batch at step N** — the Nth batch's loss goes non-finite
  (`poison_batch`), so the divergence guard's skip path fires.
- **stalled producer** — the stream blocks before the Nth batch (for the
  watchdog's input-stage attribution), or use `StalledSource` directly.
- **truncated / corrupt cache shard** — `truncate_cache_file` /
  `corrupt_cache_file` damage a packed-cache entry the way a killed
  writer or bit rot would.

Subprocess runs arm injection through the `DEEPDFA_FAULTS` env var, e.g.
``DEEPDFA_FAULTS="sigterm@12"`` or ``"nan@3,nan@4"`` — the CLI train
commands call `injector_from_env()` and wrap their train streams.

Step numbering is 1-based over the whole run (batch k feeds global step
k, counted across epochs). The injector acts when a batch is PULLED from
the source; with `train.prefetch_batches > 0` producers run ahead, so
SIGTERM lands while the consumer is up to that many steps behind — the
checkpoint cursor is exact either way, delivery is just a little early.
Set `train.prefetch_batches=0` when a test needs exact step alignment.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import threading
import time
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from deepdfa_tpu_torch.data.gen_data import GenBatch
from deepdfa_tpu_torch.data.text import TextBatch
from deepdfa_tpu_torch.graphs.batch import GraphBatch

logger = logging.getLogger(__name__)

ENV_VAR = "DEEPDFA_FAULTS"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject, keyed on the 1-based global batch/step count."""

    sigterm_at_step: int | None = None
    nan_at_steps: frozenset = frozenset()
    stall_at_step: int | None = None
    stall_seconds: float = 3600.0

    def __bool__(self) -> bool:
        return (
            self.sigterm_at_step is not None
            or bool(self.nan_at_steps)
            or self.stall_at_step is not None
        )


def parse_plan(spec: str) -> FaultPlan:
    """Parse ``"sigterm@12,nan@3,nan@4,stall@5"`` into a FaultPlan."""
    sigterm = stall = None
    nans: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, at = part.partition("@")
        if not at:
            raise ValueError(f"fault {part!r}: expected kind@step")
        step = int(at)
        if kind == "sigterm":
            sigterm = step
        elif kind == "nan":
            nans.add(step)
        elif kind == "stall":
            stall = step
        else:
            raise ValueError(
                f"unknown fault kind {kind!r} (known: sigterm, nan, stall)"
            )
    return FaultPlan(
        sigterm_at_step=sigterm,
        nan_at_steps=frozenset(nans),
        stall_at_step=stall,
    )


def injector_from_env(env=None) -> "FaultInjector | None":
    """The CLI hook: a FaultInjector when DEEPDFA_FAULTS is set."""
    spec = (env if env is not None else os.environ).get(ENV_VAR, "").strip()
    if not spec:
        return None
    plan = parse_plan(spec)
    logger.warning("fault injection armed: %s", plan)
    return FaultInjector(plan)


def poison_batch(batch):
    """A copy of `batch` whose loss goes non-finite, so the divergence
    guard's skip path fires. A GraphBatch gets an all-NaN float label
    array (the reference's injection). A TextBatch (the combined
    families) and a GenBatch (the generation family) have no float input
    at all, so they become a `PoisonedTextBatch` or a `PoisonedGenBatch`,
    whose loss the trainer multiplies by NaN (the reference's injector
    refuses both). Other batch types raise loudly rather than inject
    nothing."""
    if isinstance(batch, GraphBatch):
        label = np.asarray(batch.graph_label)
        return dataclasses.replace(batch, graph_label=np.full_like(label, np.nan))
    if isinstance(batch, TextBatch):
        return PoisonedTextBatch.of(batch)
    if isinstance(batch, GenBatch):
        return PoisonedGenBatch.of(batch)
    raise TypeError(
        f"nan injection supports GraphBatch, TextBatch and GenBatch streams, got "
        f"{type(batch).__name__}"
    )


class PoisonedTextBatch(TextBatch):
    """A TextBatch marked `poisoned`: the combined trainer multiplies its
    loss by NaN (on the device, with no sync). Placement keeps the
    mark."""

    poisoned = True

    @classmethod
    def of(cls, batch: TextBatch) -> "PoisonedTextBatch":
        return cls(**{f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)})

    def to(self, device, non_blocking: bool = False) -> "PoisonedTextBatch":
        return self.of(super().to(device, non_blocking))

    def pinned(self) -> "PoisonedTextBatch":
        return self.of(super().pinned())


class PoisonedGenBatch(GenBatch):
    """A GenBatch marked `poisoned`: the generation trainer multiplies its
    loss by NaN (on the device, with no sync). Placement keeps the
    mark."""

    poisoned = True

    @classmethod
    def of(cls, batch: GenBatch) -> "PoisonedGenBatch":
        return cls(**{f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)})

    def to(self, device) -> "PoisonedGenBatch":
        return self.of(super().to(device))


class FaultInjector:
    """Counts batches pulled across every wrapped stream (epochs
    included) and fires the plan's faults at their 1-based positions."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.delivered = 0
        self._lock = threading.Lock()

    def wrap(self, stream: Iterable) -> "_InjectedStream":
        return _InjectedStream(self, stream)

    def _next_index(self) -> int:
        with self._lock:
            self.delivered += 1
            return self.delivered

    def _apply(self, n: int, batch):
        plan = self.plan
        if plan.stall_at_step == n:
            logger.warning("fault: stalling producer at step %d", n)
            time.sleep(plan.stall_seconds)
        if n in plan.nan_at_steps:
            logger.warning("fault: poisoning batch %d with NaN labels", n)
            batch = poison_batch(batch)
        if plan.sigterm_at_step == n:
            logger.warning("fault: delivering SIGTERM at step %d", n)
            os.kill(os.getpid(), signal.SIGTERM)
        return batch


class _InjectedStream:
    """Iterable wrapper that preserves the source's `source_stage` hint
    (cli _BatchStream) so pipeline stage attribution is unchanged."""

    def __init__(self, injector: FaultInjector, inner: Iterable):
        self._injector = injector
        self._inner = inner
        stage = getattr(inner, "source_stage", None)
        if stage is not None:
            self.source_stage = stage

    def __iter__(self) -> Iterator:
        for batch in self._inner:
            n = self._injector._next_index()
            yield self._injector._apply(n, batch)


class StalledSource:
    """An iterable that yields `n_good` items then blocks (until
    `release()` or forever) — the watchdog's input-stall scenario in
    isolation."""

    def __init__(self, items: Iterable, n_good: int, stall_seconds: float = 3600.0):
        self._items = list(items)
        self.n_good = int(n_good)
        self.stall_seconds = float(stall_seconds)
        self._release = threading.Event()

    def release(self) -> None:
        self._release.set()

    def __iter__(self) -> Iterator:
        for i, item in enumerate(self._items):
            if i == self.n_good:
                self._release.wait(self.stall_seconds)
            yield item


# ---------------------------------------------------------------------------
# packed-cache damage (the killed-writer / bit-rot scenarios)


def _pick_entry_file(cache_root: str | Path, key: str | None) -> Path:
    from deepdfa_tpu_torch.data import packed_cache as pc

    cache = pc.PackedBatchCache(cache_root)
    keys = [key] if key is not None else cache.keys()
    if not keys:
        raise FileNotFoundError(f"no complete cache entries under {cache_root}")
    files = sorted(cache.entry_dir(keys[-1]).glob("*.npy"))
    if not files:
        raise FileNotFoundError(f"entry {keys[-1]} has no npy files")
    # drop the entry's verified latch so an in-process replay re-hashes
    # (subprocess scenarios get this for free — fresh process, empty set)
    pc._VERIFIED.discard(str(files[0].parent))
    return files[0]


def truncate_cache_file(
    cache_root: str | Path, key: str | None = None, frac: float = 0.5
) -> Path:
    """Truncate one .npy of a complete entry to `frac` of its size — the
    on-disk state a writer killed mid-np.save (or a post-rename power
    loss) leaves behind. Returns the damaged path."""
    path = _pick_entry_file(cache_root, key)
    size = path.stat().st_size
    with path.open("rb+") as f:
        f.truncate(max(1, int(size * frac)))
    return path


def corrupt_cache_file(cache_root: str | Path, key: str | None = None) -> Path:
    """Flip bytes in the middle of one .npy WITHOUT changing its size —
    corruption only the content digest can catch. Returns the path."""
    path = _pick_entry_file(cache_root, key)
    data = bytearray(path.read_bytes())
    mid = len(data) // 2
    for i in range(mid, min(mid + 16, len(data))):
        data[i] ^= 0xFF
    path.write_bytes(bytes(data))
    return path
