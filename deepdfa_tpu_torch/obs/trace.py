"""Low-overhead cross-process span/event tracing in the Chrome trace
format (the port's copy of the reference's `deepdfa_tpu/obs/trace.py`,
without the serving layer's flow events and counters, which come with
the operations layer; the event vocabulary and the merge are the
reference's, so a merged trace of the same run names the same spans).

Each PROCESS appends Chrome-trace events to its own
``trace-<pid>.jsonl`` under a shared trace directory; ``merge()`` /
``write_chrome_trace()`` fold every per-process file into one
Perfetto/chrome://tracing-loadable timeline. Timestamps come from
``time.monotonic_ns()``, one system-wide clock, so events from
different processes on the same host line up.

Cross-process forwarding is environment-based: ``enable(...,
export_env=True)`` publishes the trace directory in
``DEEPDFA_OBS_TRACE_DIR``; a child process self-enables on its first
span.

Overhead contract: everything here defaults OFF. A disabled ``span()``
is one module-global load, one flag check, and a shared no-op context
manager.

Event vocabulary (``cat``):

- cat="input":  ``load``/``pack`` (source pulls), ``place`` (H2D),
  ``wait`` (consumer input-starved).
- cat="train":  ``train_step`` (host dispatch), ``step_device``
  (lagged device window, obs/xprof.py:StepTimer).
- cat="resilience": instants — ``train_stall``, ``step_skipped``,
  ``rollback``, ``resumed``, ``preempted``.
- cat="backend": ``backend_probe`` (obs/health.py).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from pathlib import Path

ENV_TRACE_DIR = "DEEPDFA_OBS_TRACE_DIR"

#: compact separators: cheaper dumps and smaller
#: trace files; Chrome/Perfetto do not care about whitespace
_SEP = (",", ":")


class _NullSpan:
    """Shared no-op context manager returned by a disabled span()."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

#: synthetic tid for the reconstructed device-step track: StepTimer
#: emits deliberately BACKDATED windows (ts = dispatch time, observed at
#: the lagged fetch), which on the emitting thread's own track would be
#: rewritten by the per-thread strictly-increasing nudge below — a
#: separate track keeps them placed at their true dispatch times (and
#: renders as its own "device-steps" lane in the viewer)
DEVICE_TRACK_TID = 2**31 - 2

_tracer: "Tracer | None" = None
#: True once the env var has been consulted, so a disabled hot path
#: never re-reads os.environ (and an explicit disable() stays disabled)
_env_checked = False
_init_lock = threading.Lock()

#: optional mirror for instant() events — the flight recorder
#: (obs/flight.py) subscribes here so resilience/backend instants reach
#: its bounded ring WHETHER OR NOT tracing is enabled. Instants are rare
#: (stalls, rollbacks, probes), so the extra call costs nothing on the
#: span hot path; when no mirror is set this is one module-global check.
_instant_mirror = None


def set_instant_mirror(fn) -> None:
    global _instant_mirror
    _instant_mirror = fn

_tls = threading.local()


def _native_id() -> int:
    """threading.get_native_id() cached per thread: on older kernels it
    is an uncached gettid() syscall, which
    at serve-request event rates would dominate the event cost itself."""
    tid = getattr(_tls, "tid", None)
    if tid is None:
        tid = _tls.tid = threading.get_native_id()
    return tid


class Tracer:
    """Per-process event sink: buffered JSONL appends to one file.

    Thread-safe; emits ``process_name``/``thread_name`` metadata events
    (ph="M") the first time a process/thread reports, so merged traces
    are labeled in the viewer. Per-thread timestamps are nudged to be
    strictly increasing (two sub-microsecond events would otherwise tie
    and render order-ambiguously).
    """

    def __init__(
        self,
        directory: str | Path,
        process_name: str | None = None,
        flush_every: int = 64,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.pid = os.getpid()
        self.path = self.directory / f"trace-{self.pid}.jsonl"
        self.flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        self._buf: list[str] = []
        self._file = None
        self._seen_tids: set[int] = set()
        self._last_ts: dict[int, float] = {}
        name = process_name or f"pid-{self.pid}"
        self._emit_raw({
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "ts": 0, "args": {"name": name},
        })

    @staticmethod
    def now_us() -> float:
        return time.monotonic_ns() / 1000.0

    def _emit_raw(self, event: dict) -> None:
        with self._lock:
            self._buf.append(json.dumps(event, default=str, separators=_SEP))
            if len(self._buf) >= self.flush_every:
                self._flush_locked()

    def emit(self, event: dict, track_name: str | None = None) -> None:
        """`event` may pre-set "tid" to land on a synthetic track (named
        by `track_name`); otherwise the emitting thread's tid is used."""
        tid = event.get("tid")
        if tid is None:
            tid = _native_id()
        event["pid"] = self.pid
        event["tid"] = tid
        with self._lock:
            if tid not in self._seen_tids:
                self._seen_tids.add(tid)
                self._buf.append(json.dumps({
                    "name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": tid, "ts": 0,
                    "args": {"name": (
                        track_name or threading.current_thread().name
                    )},
                }))
            # strictly increasing per-thread timestamps: a tie within a
            # thread is possible at sub-us span rates and breaks viewers'
            # ordering; nudging by 1ns-equivalents keeps durations honest
            last = self._last_ts.get(tid, -1.0)
            if event["ts"] <= last:
                event["ts"] = last + 0.001
            self._last_ts[tid] = event["ts"]
            self._buf.append(json.dumps(event, default=str, separators=_SEP))
            if len(self._buf) >= self.flush_every:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf:
            return
        if self._file is None:
            self._file = self.path.open("a")
        self._file.write("\n".join(self._buf) + "\n")
        self._file.flush()
        self._buf.clear()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None


class _Span:
    """Context manager emitting one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: Tracer, name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = Tracer.now_us()
        return self

    def __exit__(self, *exc):
        t1 = Tracer.now_us()
        event = {
            "name": self._name, "cat": self._cat, "ph": "X",
            "ts": self._t0, "dur": max(0.0, t1 - self._t0),
        }
        if self._args:
            event["args"] = self._args
        self._tracer.emit(event)
        return False


# ---------------------------------------------------------------------------
# module API (what the rest of the codebase calls)


def _lazy_init() -> "Tracer | None":
    """Self-enable from the environment exactly once — this is how spawn
    workers and CLI subprocesses join the parent's timeline."""
    global _env_checked
    with _init_lock:
        if _tracer is not None or _env_checked:
            return _tracer
        _env_checked = True
        d = os.environ.get(ENV_TRACE_DIR)
        if d:
            _enable_locked(d)
        return _tracer


def _enable_locked(
    directory: str | Path, process_name: str | None = None
) -> Tracer:
    global _tracer
    _tracer = Tracer(directory, process_name=process_name)
    atexit.register(_tracer.close)
    return _tracer


def enable(
    directory: str | Path,
    process_name: str | None = None,
    export_env: bool = False,
) -> Tracer:
    """Start tracing this process into `directory`. With `export_env`,
    children spawned from here (process pools, CLI subprocesses) inherit
    the directory and self-enable on their first span."""
    global _env_checked
    with _init_lock:
        if _tracer is not None:
            _tracer.close()
        tracer = _enable_locked(directory, process_name)
        _env_checked = True
    if export_env:
        os.environ[ENV_TRACE_DIR] = str(directory)
    return tracer


def disable() -> None:
    """Flush + stop tracing; stays off (env is not re-consulted)."""
    global _tracer, _env_checked
    with _init_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None
        _env_checked = True
    os.environ.pop(ENV_TRACE_DIR, None)


def enabled() -> bool:
    return (_tracer or _lazy_init()) is not None


def span(name: str, cat: str = "app", **args):
    """Context manager timing a block; no-op (shared singleton, no
    allocation) when tracing is off."""
    t = _tracer or _lazy_init()
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, cat, args)


def instant(name: str, cat: str = "app", **args) -> None:
    """A point event (ph="i") — stalls, rollbacks, resume markers."""
    if _instant_mirror is not None:
        try:
            _instant_mirror(name, cat, dict(args) if args else None)
        except Exception:  # the mirror must never cost the event
            pass
    t = _tracer or _lazy_init()
    if t is None:
        return
    event = {
        "name": name, "cat": cat, "ph": "i", "s": "p",
        "ts": Tracer.now_us(),
    }
    if args:
        event["args"] = args
    t.emit(event)


def complete_event(
    name: str,
    ts_us: float,
    dur_us: float,
    cat: str = "app",
    tid: int | None = None,
    track_name: str | None = None,
    args: dict | None = None,
) -> None:
    """Emit a complete ("X") event with an EXPLICIT (possibly backdated)
    timestamp, optionally on a synthetic track — how StepTimer places
    reconstructed device windows at their true dispatch times."""
    t = _tracer or _lazy_init()
    if t is None:
        return
    event: dict = {
        "name": name, "cat": cat, "ph": "X",
        "ts": ts_us, "dur": max(0.0, dur_us),
    }
    if tid is not None:
        event["tid"] = tid
    if args:
        event["args"] = args
    t.emit(event, track_name=track_name)


def flush() -> None:
    if _tracer is not None:
        _tracer.flush()


# ---------------------------------------------------------------------------
# offline merge (what diag and the tests consume)


def merge(directory: str | Path) -> list[dict]:
    """All events from every per-process file, sorted by timestamp.
    Tolerates a torn trailing line (a worker killed mid-flush)."""
    events: list[dict] = []
    for path in sorted(Path(directory).glob("trace-*.jsonl")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    events.sort(key=lambda e: e.get("ts", 0))
    return events


def write_chrome_trace(directory: str | Path, out_path: str | Path) -> int:
    """Fold the per-process JSONL files into one ``{"traceEvents": []}``
    JSON file loadable by Perfetto / chrome://tracing. Returns the event
    count."""
    events = merge(directory)
    Path(out_path).write_text(
        json.dumps({"traceEvents": events, "displayTimeUnit": "ms"})
    )
    return len(events)
