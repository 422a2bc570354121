"""The bounded backend-health probe (the port of the reference's
`deepdfa_tpu/core/backend.py:bounded_run` and `probe_default_backend`).

A CUDA call that hangs (a wedged driver, a card lost to an Xid) cannot
be interrupted from Python, so health is probed in a subprocess bounded
by a timeout: it initializes CUDA, runs one small product on the card
and synchronizes. The caller's process never touches a sick card.

The reference's JAX-only parts have no counterpart here: `set_platform`
and `force_cpu` (the port's entry points take `--device` instead, and
never fall back on their own: core/device.py) and
`enable_compile_cache` (the port's kernel build cache is
`nn/cuda_build.py`'s, keyed by the source's and flags' hash).
"""

from __future__ import annotations

import subprocess
import sys

_PROBE_SRC = """
import torch
if not torch.cuda.is_available():
    raise SystemExit("CUDA is not available")
x = torch.ones((128, 128), dtype=torch.bfloat16, device="cuda")
(x @ x).float().sum().item()
torch.cuda.synchronize()
print("PLATFORM:" + torch.cuda.get_device_name(0), flush=True)
"""

#: cached (ok, detail) of the last probe, so entry points sharing a process
#: pay the subprocess cost once.
_last_probe: tuple[bool, str] | None = None


def bounded_run(
    argv: list[str], timeout: float, what: str = "subprocess"
) -> tuple[subprocess.CompletedProcess | None, str]:
    """Run argv with a hard timeout; (result, error-tail-or-empty).

    The single place that turns a child failure into a short diagnostic:
    timeout -> "timed out" message, nonzero rc -> last stderr/stdout line
    truncated to 500 chars.
    """
    try:
        res = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return None, f"{what} timed out after {timeout:.0f}s (driver or card wedged?)"
    if res.returncode != 0:
        lines = (res.stderr or res.stdout).strip().splitlines()
        tail = lines[-1] if lines else ""
        return None, f"{what} rc={res.returncode}: {tail[:500]}"
    return res, ""


def probe_default_backend(timeout: float = 240.0, use_cache: bool = True) -> tuple[bool, str]:
    """Initialize CUDA and run one small product on the card in a
    subprocess. Returns ``(ok, detail)``: detail is the card's name on
    success, else a short error (a hang shows as a timeout; no card or a
    CUDA error as a nonzero exit with its message)."""
    global _last_probe
    if use_cache and _last_probe is not None:
        return _last_probe
    res, err = bounded_run([sys.executable, "-c", _PROBE_SRC], timeout, what="backend probe")
    if res is None:
        _last_probe = (False, err)
        return _last_probe
    platform = "unknown"
    for line in res.stdout.splitlines():
        if line.startswith("PLATFORM:"):
            platform = line[len("PLATFORM:"):].strip()
    _last_probe = (True, platform)
    return _last_probe
