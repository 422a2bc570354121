"""The one cost reader: the counted FLOPs and bytes of one call (the
counterpart of the reference's `obs/ledger.py:read_cost_analysis` and
`executable_memory`, which read XLA's cost analysis of a compiled
program; PyTorch has no compiled program to ask).

A count has two halves:

- **the kernels**: every wrapper of a hand-written kernel
  (`nn/ggnn_kernel.py`, `nn/flash_attention.py`, `nn/setops.py`)
  reports, at each launch, the operations and bytes of its call from its
  shapes, by the work formulas that sit beside the kernels
  (`step_work`, `gru_bwd_work`, `flash_work`, ...). The same formulas
  give `chip_smoke.py` its `bound_ms` columns, so the bounds and the
  ledger cannot drift. They count live edges and live (query, key)
  pairs, so a report reads the batch's live counts from the device: a
  host sync, paid only while a count is open;
- **the aten ops outside the kernels**: `torch.utils.flop_counter.
  FlopCounterMode`'s count (matrix products, convolutions; elementwise
  work is not counted, as XLA's count of the products dominates it).

`FlopCounterMode` cannot see a kernel launched through `ctypes`. On the
CPU the wrappers run their plain versions in the kernels' place; under
an open count they do it inside `plain()`, which hides their aten ops
from `FlopCounterMode`, and report the kernel's formula instead. So the
same batch gives the same count on the CPU and on the card.

Bytes are the kernels' only (each input read once, each output written
once); the aten ops' bytes are not counted.

Off by default: `counting()` is one module-global check, and a wrapper
computes nothing for the count unless one is open.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

#: the operation types a kernel's work is counted in (the card's peak
#: differs for each)
PRECISIONS = ("fp32", "bf16", "int8")

_active: list["CostCounter"] = []
_lock = threading.Lock()


def counting() -> bool:
    """Is a count open? Wrappers ask before they compute a report."""
    return bool(_active)


def report(kernel: str, flops: float | dict, nbytes: float, precision: str = "fp32") -> None:
    """One launch of `kernel` (or its plain version in its place):
    `flops` operations of `precision` (or {precision: operations}) and
    `nbytes` bytes, added to every open count."""
    by = dict(flops) if isinstance(flops, dict) else {precision: flops}
    with _lock:
        for c in _active:
            c._add(kernel, by, nbytes)


@contextlib.contextmanager
def plain():
    """Around a plain version run in a kernel's place: while a count is
    open its aten ops are hidden from FlopCounterMode (the wrapper
    reports the kernel's formula instead); otherwise a no-op."""
    if not _active:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


class CostCounter:
    """Context manager: the kernels' reports and FlopCounterMode's count
    of the aten ops in between, over everything run inside it (every
    thread: the autograd engine runs a CUDA backward on a thread of its
    own). `aten_precision` is the type the aten products run in (the
    model's compute dtype)."""

    def __init__(self, aten_precision: str = "fp32"):
        if aten_precision not in PRECISIONS:
            raise ValueError(f"unknown precision {aten_precision!r} (one of {PRECISIONS})")
        self.aten_precision = aten_precision
        self.kernels: dict[str, dict] = {}
        self.aten_flops = 0.0
        self._fcm = None

    def _add(self, kernel: str, by: dict, nbytes: float) -> None:
        k = self.kernels.setdefault(
            kernel, {"launches": 0, "flops": 0.0, "bytes": 0.0,
                     "by_precision": {p: 0.0 for p in PRECISIONS}})
        k["launches"] += 1
        for p, f in by.items():
            if p not in PRECISIONS:
                raise ValueError(f"{kernel}: unknown precision {p!r}")
            k["flops"] += float(f)
            k["by_precision"][p] += float(f)
        k["bytes"] += float(nbytes)

    def __enter__(self) -> "CostCounter":
        from torch.utils.flop_counter import FlopCounterMode

        self._fcm = FlopCounterMode(display=False)
        self._fcm.__enter__()
        with _lock:
            _active.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        with _lock:
            _active.remove(self)
        self._fcm.__exit__(*exc)
        self.aten_flops = float(self._fcm.get_total_flops())
        return False

    def result(self) -> dict:
        """{"flops", "bytes_accessed", "kernel_flops", "aten_flops",
        "flops_by_precision", "kernels": {name: {launches, flops, bytes,
        by_precision}}}."""
        by = {p: sum(k["by_precision"][p] for k in self.kernels.values())
              for p in PRECISIONS}
        by[self.aten_precision] += self.aten_flops
        kernel_flops = sum(k["flops"] for k in self.kernels.values())
        return {
            "flops": kernel_flops + self.aten_flops,
            "bytes_accessed": sum(k["bytes"] for k in self.kernels.values()),
            "kernel_flops": kernel_flops,
            "aten_flops": self.aten_flops,
            "flops_by_precision": by,
            "kernels": {n: {**k, "by_precision": dict(k["by_precision"])}
                        for n, k in sorted(self.kernels.items())},
        }


def count_cost(fn: Callable, *args, aten_precision: str = "fp32", **kwargs) -> tuple[Any, dict]:
    """(fn(*args, **kwargs), its counted cost: `CostCounter.result()`)."""
    with CostCounter(aten_precision) as c:
        out = fn(*args, **kwargs)
    return out, c.result()
