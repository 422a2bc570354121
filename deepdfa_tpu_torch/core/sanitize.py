"""The training sanitizers, `train.debug_nans` and `train.enable_checks`
(the counterparts of the reference's `jax_debug_nans` and
`jax_enable_checks`).

- **debug_nans** (`nan_checks(model)`): a forward hook on every
  submodule raises `FloatingPointError` at the first module whose output
  is not finite, naming it; autograd's anomaly mode with `check_nan`
  raises at the first backward function that returns a non-finite
  gradient, naming it (and printing the forward call that made it).
  Every check reads its result on the host: a sync per module.
- **enable_checks** (`launch_checks()`): every hand-written kernel's
  wrapper, on a CUDA tensor, checks its launch's arguments beyond the
  shapes, strides and dtypes it always checks — the edge, row-pointer and
  segment indices within their bounds, the key mask against the keys —
  and synchronizes after the launch, so an asynchronous CUDA error names
  the launch that caused it (`after_launch`). A sync or two per launch.

Both are off by default and cost one module-global check when off.
"""

from __future__ import annotations

import contextlib
import threading

_checks = False
_lock = threading.Lock()


def checks_on() -> bool:
    """Is `enable_checks` on? Wrappers ask before checking."""
    return _checks


@contextlib.contextmanager
def launch_checks(on: bool = True):
    """`train.enable_checks` over the block (a no-op when `on` is False)."""
    global _checks
    if not on:
        yield
        return
    with _lock:
        prev, _checks = _checks, True
    try:
        yield
    finally:
        with _lock:
            _checks = prev


def check_index(kernel: str, name: str, idx, upper: int, count: int | None = None) -> None:
    """idx[:count] (all of it by default) lies in [0, upper)."""
    import torch

    x = idx if count is None else idx[:count]
    if x.numel() and bool(((x < 0) | (x >= upper)).any()):
        bad = int(torch.where((x < 0) | (x >= upper))[0][0])
        raise IndexError(f"enable_checks: {kernel}: {name}[{bad}] = {int(x[bad])} outside "
                         f"[0, {upper})")


def check_pointer(kernel: str, name: str, ptr, total: int) -> int:
    """A CSR row pointer: starts at 0, never decreases, ends at most at
    `total`; returns its last entry."""
    first, last = int(ptr[0]), int(ptr[-1])
    if first != 0 or last > total or bool((ptr[1:] < ptr[:-1]).any()):
        raise IndexError(f"enable_checks: {kernel}: {name} is not a row pointer over "
                         f"{total} entries (first {first}, last {last})")
    return last


def after_launch(kernel: str, device) -> None:
    """With `enable_checks`: synchronize, and raise naming `kernel` when
    its launch (or anything queued before it) failed."""
    if not _checks:
        return
    import torch

    try:
        torch.cuda.synchronize(device)
    except Exception as e:
        raise RuntimeError(f"enable_checks: {kernel}: the launch failed on the card: {e}") from e


def check_edges(kernel: str, edges, n: int) -> None:
    """A GGNN EdgeIndex: the row pointers over the live edges, their src
    and dst (and the src-sorted layout's) within the n nodes."""
    e = edges.src.shape[0]
    live = check_pointer(kernel, "rowptr", edges.rowptr, e)
    check_index(kernel, "src", edges.src, n, live)
    check_index(kernel, "dst", edges.dst, n, live)
    if edges.srcptr is not None:
        live_t = check_pointer(kernel, "srcptr", edges.srcptr, e)
        check_index(kernel, "srcp", edges.srcp, n, live_t)
        check_index(kernel, "dstp", edges.dstp, n, live_t)


@contextlib.contextmanager
def nan_checks(model, on: bool = True):
    """`train.debug_nans` over the block for `model`: the forward hooks
    and anomaly mode with check_nan (a no-op when `on` is False)."""
    if not on:
        yield
        return
    import torch

    def finite(x) -> bool:
        if isinstance(x, torch.Tensor):
            return not x.is_floating_point() or bool(torch.isfinite(x).all())
        if isinstance(x, (tuple, list)):
            return all(finite(y) for y in x)
        if isinstance(x, dict):
            return all(finite(y) for y in x.values())
        return True

    def hook(name):
        def check(module, args, output):
            if not finite(output):
                raise FloatingPointError(
                    f"debug_nans: the output of {name or 'the model'} "
                    f"({type(module).__name__}) is not finite")
        return check

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=True):
            yield
    finally:
        for h in handles:
            h.remove()
