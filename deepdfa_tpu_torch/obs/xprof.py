"""On-demand device profiling and sync-free step-time decomposition (the
port of the reference's `deepdfa_tpu/obs/xprof.py`, over
`torch.profiler` and CUDA events).

Three capabilities, all default-off (core/config.py:ObsConfig):

- **XprofController** — a `torch.profiler` capture of a configured step
  window (`obs.xprof_start_step` + `obs.xprof_num_steps`), plus live-run
  triggers: SIGUSR2 or touching `<run_dir>/xprof/TRIGGER` arms a capture
  of the next `xprof_num_steps` steps. Each capture is written as a
  Chrome trace, `<run_dir>/xprof/step-<N>/trace.json`.
- **StepTimer** — per-step device time from two `torch.cuda.Event`s
  recorded around each step's dispatch, read `lag` steps late: by then
  the card has normally finished the step, so `Event.query()` is true
  and the read costs no wait; only when the card is genuinely behind
  does the timer wait on the event (`Event.synchronize`, never a stream
  or device synchronize). Emits `obs/step/*` histograms and, when
  tracing is on, `step_device` spans. On the CPU the step is timed on
  the host clock at dispatch.
- **device_memory_stats()** — the caching allocator's statistics
  (`torch.cuda.memory_stats`) under the reference's keys; {} on the
  CPU.
"""

from __future__ import annotations

import signal
import threading
import time
from collections import deque
from pathlib import Path

from deepdfa_tpu_torch.obs import metrics, trace

#: polling a trigger file stat() every step would be measurable on ms
#: steps; every N steps it is noise
_TRIGGER_POLL_STEPS = 20

_controller: "XprofController | None" = None


def _cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


class XprofController:
    """Start/stop `torch.profiler` captures on step boundaries.

    `on_step(step)` is called by the train loops once per step (before
    dispatch); it is a few comparisons when idle. Window capture fires
    once per run; triggers re-arm (each SIGUSR2 / TRIGGER touch captures
    one window)."""

    def __init__(
        self,
        log_dir: str | Path,
        start_step: int = -1,
        num_steps: int = 5,
        trigger: bool = False,
    ):
        self.log_dir = Path(log_dir)
        self.start_step = int(start_step)
        self.num_steps = max(1, int(num_steps))
        self.trigger_path = self.log_dir / "TRIGGER"
        self._armed = threading.Event()
        self._active_until: int | None = None
        self._profiler = None
        self._out: Path | None = None
        self._window_done = False
        self._captures = 0
        self._prev_handler = None
        self._trigger = bool(trigger)
        if self._trigger:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            if threading.current_thread() is threading.main_thread():
                try:
                    self._prev_handler = signal.signal(signal.SIGUSR2, self._on_signal)
                except (ValueError, OSError):
                    self._prev_handler = None

    @property
    def captures(self) -> int:
        return self._captures

    def _on_signal(self, signum, frame) -> None:
        self._armed.set()

    def _check_trigger(self, step: int) -> bool:
        if self._armed.is_set():
            self._armed.clear()
            return True
        if step % _TRIGGER_POLL_STEPS == 0 and self.trigger_path.exists():
            try:
                self.trigger_path.unlink()
            except OSError:
                pass
            return True
        return False

    def _start(self, step: int, reason: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        out = self.log_dir / f"step-{step:08d}"
        out.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if _cuda_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception:  # a second profiler (external) must not kill the run
            return
        self._profiler, self._out = prof, out
        self._active_until = step + self.num_steps
        self._captures += 1
        metrics.REGISTRY.counter("obs/xprof/captures").inc()
        trace.instant("xprof_capture_start", cat="train", step=step, reason=reason)

    def _stop(self) -> None:
        prof, self._profiler = self._profiler, None
        self._active_until = None
        if prof is None:
            return
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(self._out / "trace.json"))
        except Exception:
            pass

    def on_step(self, step: int) -> None:
        if self._active_until is not None:
            if step >= self._active_until:
                self._stop()
            return
        if self.start_step >= 0 and not self._window_done and step >= self.start_step:
            self._window_done = True
            self._start(step, "window")
            return
        if self._trigger and self._check_trigger(step):
            self._start(step, "trigger")

    def close(self) -> None:
        if self._active_until is not None:
            self._stop()
        if self._prev_handler is not None:
            try:
                signal.signal(signal.SIGUSR2, self._prev_handler)
            except (ValueError, OSError):
                pass
            self._prev_handler = None


def install_controller(
    log_dir: str | Path, start_step: int, num_steps: int, trigger: bool
) -> XprofController:
    """Module-global controller so the loops reach it without new fit()
    parameters (obs.instruments routes on_step here)."""
    global _controller
    if _controller is not None:
        _controller.close()
    _controller = XprofController(
        log_dir, start_step=start_step, num_steps=num_steps, trigger=trigger
    )
    return _controller


def uninstall_controller() -> None:
    global _controller
    if _controller is not None:
        _controller.close()
        _controller = None


def controller_on_step(step: int) -> None:
    if _controller is not None:
        _controller.on_step(step)


class EventWindow:
    """One device-timed window: `start()` before the work is queued,
    `stop()` after; `seconds(wait=...)` reads the time between them.
    On a CUDA device two `torch.cuda.Event`s on the current stream (no
    synchronize: the read waits on the end event only when it has not
    completed, and `wait=False` then returns None); on the CPU the host
    clock."""

    __slots__ = ("_cuda", "_start", "_end", "_t0", "_t1")

    def __init__(self, cuda: bool):
        self._cuda = bool(cuda)
        self._start = self._end = None
        self._t0 = self._t1 = 0.0

    def start(self) -> "EventWindow":
        if self._cuda:
            import torch

            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def stop(self) -> "EventWindow":
        if self._cuda:
            self._end.record()
        else:
            self._t1 = time.perf_counter()
        return self

    def seconds(self, wait: bool = True) -> float | None:
        if not self._cuda:
            return self._t1 - self._t0
        if not self._end.query():
            if not wait:
                return None
            self._end.synchronize()
        return self._start.elapsed_time(self._end) / 1e3


class StepTimer:
    """Lagged step-time decomposition with no synchronize on the happy
    path.

    Per step the loop calls `begin()` right before the step's dispatch
    and `dispatched(...)` right after it. Each step's `EventWindow` is
    queued; once more than `lag` are pending the oldest is read (its end
    event has normally completed by then). `obs/step/seconds` is the
    step's device time, `obs/step/fetch_wait_seconds` the host's wait
    for it (> 0: the card is the bottleneck at that moment),
    `obs/step/dispatch_seconds` the host's dispatch time. Each device
    second also goes to `on_step_seconds` (the efficiency ledger's
    per-signature join)."""

    def __init__(self, lag: int = 1, registry=None, on_step_seconds=None, cuda: bool | None = None):
        self.lag = max(0, int(lag))
        self._r = registry if registry is not None else metrics.REGISTRY
        self._pending: deque = deque()
        self._cuda = _cuda_available() if cuda is None else bool(cuda)
        self._open: EventWindow | None = None
        self._on_step_seconds = on_step_seconds

    def begin(self) -> None:
        self._open = EventWindow(self._cuda).start()

    def dispatched(self, handle=None, dispatch_seconds: float | None = None,
                   site=None) -> None:
        """Close the window `begin()` opened (`handle`, the step's loss,
        is not read: the window's events carry the timing). `site`, if
        given, is passed to `on_step_seconds` with the step's seconds."""
        if dispatch_seconds is not None:
            self._r.histogram("obs/step/dispatch_seconds").observe(dispatch_seconds)
        window, self._open = self._open, None
        if window is None:
            return
        self._pending.append((window.stop(), site))
        if len(self._pending) > self.lag:
            self._read(*self._pending.popleft())

    def _read(self, window: EventWindow, site) -> None:
        t0 = time.perf_counter()
        step_s = window.seconds()
        done = time.perf_counter()
        self._r.histogram("obs/step/fetch_wait_seconds").observe(done - t0)
        self._r.histogram("obs/step/seconds").observe(step_s)
        if self._on_step_seconds is not None:
            if site is None:
                self._on_step_seconds(step_s)
            else:
                self._on_step_seconds(step_s, site)
        if trace.enabled():
            now_us = trace.Tracer.now_us()
            dur_us = step_s * 1e6
            trace.complete_event(
                "step_device", now_us - dur_us, dur_us, cat="train",
                tid=trace.DEVICE_TRACK_TID, track_name="device-steps",
            )

    def drain(self) -> None:
        """Read everything still pending (epoch end)."""
        while self._pending:
            self._read(*self._pending.popleft())


def device_memory_stats() -> dict[str, float]:
    """The caching allocator's statistics for the current CUDA device
    under the reference's keys (bytes_in_use, peak_bytes_in_use,
    bytes_limit: the card's memory); {} on the CPU."""
    if not _cuda_available():
        return {}
    import torch

    try:
        stats = torch.cuda.memory_stats()
        free, total = torch.cuda.mem_get_info()
    except Exception:
        return {}
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(total),
    }
