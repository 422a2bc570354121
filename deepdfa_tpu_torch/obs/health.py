"""Backend health observability (the port of the reference's
`deepdfa_tpu/obs/health.py`).

- `BackendHealth.probe()` — the bounded probe
  (`core/backend.py:probe_default_backend`: one small CUDA product in a
  subprocess, so a wedged card can never hang the caller) with bounded
  retries, emitting `backend/*` registry metrics and cat="backend"
  trace instants for every attempt: probe latency, retries, wedge
  detected (`looks_wedged`: a timeout or one of CUDA's sticky errors),
  failures.
- `BackendHealth.record_fallback()` — the moment a caller gives up on
  the card, counted and traced.
- `probe_backend()` / `record_fallback()` module-level wrappers over a
  process-wide singleton.

The probe function is injectable (`probe_fn`) so tests can drive the
timeout/wedge path without a real hang.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from deepdfa_tpu_torch.obs import metrics as obs_metrics, trace as obs_trace


def _default_probe(timeout_s: float) -> tuple[bool, str]:
    from deepdfa_tpu_torch.core.backend import probe_default_backend

    # use_cache=False: health checks sample NOW, not the process's first
    # impression — a wedge that develops mid-run must be seen
    return probe_default_backend(timeout_s, use_cache=False)


#: CUDA's error strings that mean the card or its driver is stuck, not
#: merely absent (cudaGetErrorString's texts)
WEDGE_ERRORS = (
    "timed out",
    "unspecified launch failure",
    "an illegal memory access was encountered",
    "uncorrectable ECC error",
    "GPU is lost",
    "the launch timed out and was terminated",
    "device-side assert triggered",
)


def looks_wedged(detail: str) -> bool:
    """A probe TIMEOUT (the card hung) or one of CUDA's sticky errors
    means the card is wedged: the process that hit it cannot use the
    card again. A fast nonzero exit without one (no CUDA, no card) is a
    different failure, with a different operator action."""
    low = detail.lower()
    return any(e.lower() in low for e in WEDGE_ERRORS)


class BackendHealth:
    """Probe runner + last-result cache for one process.

    `/healthz?deep=1` calls `probe()` per request (bounded by the
    configured timeout); `last()` serves the cached result to callers
    that want the newest evidence without paying a probe."""

    def __init__(
        self,
        probe_fn: Callable[[float], tuple[bool, str]] | None = None,
        registry: obs_metrics.MetricsRegistry | None = None,
    ):
        self.probe_fn = probe_fn or _default_probe
        r = registry if registry is not None else obs_metrics.REGISTRY
        self._m_probes = r.counter("backend/probes")
        self._m_failures = r.counter("backend/probe_failures")
        self._m_retries = r.counter("backend/probe_retries")
        self._m_wedges = r.counter("backend/wedges")
        self._m_fallbacks = r.counter("backend/fallbacks")
        self._m_seconds = r.histogram("backend/probe_seconds")
        self._m_healthy = r.gauge("backend/healthy")
        self._lock = threading.Lock()
        self._last: dict | None = None

    def probe(
        self,
        timeout_s: float = 60.0,
        retries: int = 0,
        retry_wait_s: float = 0.0,
    ) -> dict:
        """Run the bounded probe (plus up to `retries` retries) and
        return the attempt report:

        {"ok", "platform"|"error", "latency_s", "attempts", "wedged",
         "timeout_s"} — also cached for `last()` and mirrored into the
        `backend/*` metrics + trace stream."""
        attempts = 0
        report: dict = {"ok": False, "timeout_s": float(timeout_s)}
        while True:
            attempts += 1
            self._m_probes.inc()
            if attempts > 1:
                self._m_retries.inc()
            t0 = time.perf_counter()
            ok, detail = self.probe_fn(timeout_s)
            dt = time.perf_counter() - t0
            self._m_seconds.observe(dt)
            report.update(
                ok=bool(ok), latency_s=round(dt, 3), attempts=attempts
            )
            if ok:
                report["platform"] = detail
                report.pop("error", None)
                report["wedged"] = False
                break
            wedged = looks_wedged(detail)
            report.update(error=detail, wedged=wedged)
            self._m_failures.inc()
            if wedged:
                self._m_wedges.inc()
                # a WEDGE is terminal evidence: dump the flight recorder
                # (no-op unless installed) so it leaves a machine-readable
                # artifact, not a log-tail anecdote
                from deepdfa_tpu_torch.obs import flight as obs_flight

                obs_flight.crash_dump("backend_wedge", extra={
                    "error": detail[:500], "attempt": attempts,
                    "timeout_s": float(timeout_s),
                })
            obs_trace.instant(
                "backend_probe_failed", cat="backend",
                error=detail[:200], wedged=wedged, attempt=attempts,
            )
            if attempts > retries:
                break
            if retry_wait_s:
                time.sleep(retry_wait_s)
        self._m_healthy.set(1.0 if report["ok"] else 0.0)
        obs_trace.instant(
            "backend_probe", cat="backend",
            ok=report["ok"], latency_s=report["latency_s"],
            attempts=attempts,
        )
        with self._lock:
            self._last = dict(report)
        return report

    def record_fallback(self, reason: str) -> None:
        """The caller is abandoning the card for the CPU: counted and
        traced."""
        self._m_fallbacks.inc()
        self._m_healthy.set(0.0)
        obs_trace.instant(
            "backend_fallback", cat="backend", reason=reason[:500]
        )
        with self._lock:
            if self._last is not None:
                self._last["fallback"] = True

    def last(self) -> dict | None:
        with self._lock:
            return dict(self._last) if self._last else None


_singleton: BackendHealth | None = None
_singleton_lock = threading.Lock()


def shared() -> BackendHealth:
    """The process-wide BackendHealth (the CLI entry points)."""
    global _singleton
    with _singleton_lock:
        if _singleton is None:
            _singleton = BackendHealth()
        return _singleton


def probe_backend(timeout_s: float = 60.0) -> tuple[bool, str]:
    """Drop-in for `core.backend.probe_default_backend(t, use_cache=False)`
    that also lands the attempt in the `backend/*` metrics."""
    report = shared().probe(timeout_s)
    if report["ok"]:
        return True, report.get("platform", "unknown")
    return False, report.get("error", "probe failed")


def record_fallback(reason: str) -> None:
    shared().record_fallback(reason)


def summary() -> dict:
    """Snapshot of the backend/* counters + the newest probe report (the
    postmortem's `backend` section)."""
    snap = obs_metrics.REGISTRY.snapshot()
    out = {
        k[len("backend/"):]: v
        for k, v in snap.items()
        if k.startswith("backend/")
    }
    last = shared().last()
    if last is not None:
        out["last_probe"] = last
    return out
