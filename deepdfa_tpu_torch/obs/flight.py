"""Crash flight recorder: bounded in-memory history + postmortem dumps
(the port's copy of the reference's `deepdfa_tpu/obs/flight.py`; the
document format and `validate_postmortem` are the reference's, so either
package validates the other's dump).

The recorder keeps a bounded ring of the last N step records and recent
telemetry instants IN MEMORY, and on any terminal event dumps one
machine-readable `postmortem.json` (atomic, core/ioutil.py) containing:

- the step ring (last N train-step numbers + host timestamps),
- the event ring (cat="resilience"/"backend"/... instants — mirrored
  from obs/trace.py:instant whether or not tracing is enabled),
- the efficiency + device-memory ledger snapshot (obs/ledger.py) when
  the ledger is on — the OOM-forensics payload,
- the backend-health summary (obs/health.py) and the metrics-registry
  snapshot (every tag SCHEMA-declared; `validate_postmortem` checks a
  dumped file).

Dump triggers (train/resilience.py, obs/health.py, the installed
excepthook): watchdog abort (exit 113), SIGTERM preemption, NaN-guard
rollback, backend WEDGE, unhandled exception — classified "oom" when
the exception is `torch.cuda.OutOfMemoryError` (obs/ledger.py:is_oom).

Default OFF (`cfg.obs.flight`): every `note_*`/`crash_dump` call is one
module-global check when not installed. A dump must never mask the
failure that caused it — every writer path swallows its own errors.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from pathlib import Path

from deepdfa_tpu_torch.obs import metrics as obs_metrics, trace as obs_trace

POSTMORTEM_VERSION = 1

#: the trigger vocabulary a valid postmortem must name (validated by
#: validate_postmortem; "manual"/"smoke_test" are the operator/test
#: dumps the serve/scan smokes exercise end to end)
TRIGGERS = (
    "watchdog_abort",
    "sigterm",
    "nan_rollback",
    "backend_wedge",
    "oom",
    "exception",
    "manual",
    "smoke_test",
)

_recorder: "FlightRecorder | None" = None
_lock = threading.Lock()
_prev_excepthook = None


class FlightRecorder:
    """Bounded rings + the atomic postmortem writer for one process."""

    def __init__(
        self,
        path: str | Path,
        max_steps: int = 64,
        max_events: int = 128,
    ):
        self.path = Path(path)
        self.max_steps = max(1, int(max_steps))
        self.max_events = max(1, int(max_events))
        self._steps: deque[dict] = deque(maxlen=self.max_steps)
        self._events: deque[dict] = deque(maxlen=self.max_events)
        self._lk = threading.Lock()
        self.dumps = 0
        self.last_trigger: str | None = None

    def note_step(self, step: int, **info) -> None:
        entry = {"step": int(step), "t_unix": round(time.time(), 3)}
        if info:
            entry.update(info)
        with self._lk:
            self._steps.append(entry)

    def note_event(self, name: str, cat: str = "app", args: dict | None = None) -> None:
        entry = {
            "name": str(name), "cat": str(cat),
            "t_unix": round(time.time(), 3),
        }
        if args:
            # args may carry non-JSON values (arrays); stringify defensively
            entry["args"] = {
                k: (v if isinstance(v, (int, float, str, bool, type(None)))
                    else str(v)[:200])
                for k, v in args.items()
            }
        with self._lk:
            self._events.append(entry)

    def document(self, trigger: str, extra: dict | None = None) -> dict:
        from deepdfa_tpu_torch.obs import ledger as obs_ledger

        with self._lk:
            steps = list(self._steps)
            events = list(self._events)
        doc: dict = {
            "version": POSTMORTEM_VERSION,
            "trigger": str(trigger),
            "t_unix": round(time.time(), 3),
            "pid": os.getpid(),
            "steps": steps,
            "events": events,
        }
        try:
            doc["metrics"] = obs_metrics.REGISTRY.snapshot()
        except Exception:
            doc["metrics"] = {}
        led = obs_ledger.snapshot_or_none()
        if led is not None:
            doc["ledger"] = led
        try:
            from deepdfa_tpu_torch.obs import health as obs_health

            backend = obs_health.summary()
            if backend:
                doc["backend"] = backend
        except Exception:
            pass
        if extra:
            try:
                json.dumps(extra)
                doc["extra"] = extra
            except (TypeError, ValueError):
                doc["extra"] = {"repr": str(extra)[:2000]}
        return doc

    def dump(self, trigger: str, extra: dict | None = None) -> Path | None:
        """Write `postmortem.json` atomically; last dump wins (the file
        always holds ONE complete document). Never raises."""
        try:
            doc = self.document(trigger, extra=extra)
            from deepdfa_tpu_torch.core.ioutil import atomic_write_text

            self.path.parent.mkdir(parents=True, exist_ok=True)
            atomic_write_text(
                self.path, json.dumps({"postmortem": doc}, indent=1)
            )
            self.dumps += 1
            self.last_trigger = str(trigger)
            obs_metrics.REGISTRY.counter("flight/dumps").inc()
            obs_metrics.REGISTRY.counter(f"flight/dumps/{trigger}").inc()
            return self.path
        except Exception:  # a dump must never mask the original failure
            return None


# ---------------------------------------------------------------------------
# module surface


def install(
    path: str | Path,
    max_steps: int = 64,
    max_events: int = 128,
) -> FlightRecorder:
    """Install the process flight recorder: rings start filling (trace
    instants mirror in whether or not tracing is on), and unhandled
    exceptions dump a postmortem through a chained excepthook."""
    global _recorder, _prev_excepthook
    with _lock:
        _recorder = FlightRecorder(
            path, max_steps=max_steps, max_events=max_events
        )
        obs_trace.set_instant_mirror(_recorder.note_event)
        if _prev_excepthook is None:
            _prev_excepthook = sys.excepthook
            sys.excepthook = _excepthook
    return _recorder


def uninstall() -> None:
    global _recorder, _prev_excepthook
    with _lock:
        _recorder = None
        obs_trace.set_instant_mirror(None)
        if _prev_excepthook is not None:
            sys.excepthook = _prev_excepthook
            _prev_excepthook = None


def get() -> FlightRecorder | None:
    return _recorder


def installed() -> bool:
    return _recorder is not None


def note_step(step: int, **info) -> None:
    rec = _recorder
    if rec is not None:
        rec.note_step(step, **info)


def note_event(name: str, cat: str = "app", args: dict | None = None) -> None:
    rec = _recorder
    if rec is not None:
        rec.note_event(name, cat=cat, args=args)


def crash_dump(trigger: str, extra: dict | None = None) -> Path | None:
    """Dump a postmortem for `trigger` (no-op None when the recorder is
    not installed). The one function every terminal path calls."""
    rec = _recorder
    if rec is None:
        return None
    return rec.dump(trigger, extra=extra)


def note_exception(exc: BaseException, where: str = "") -> Path | None:
    """Classify + dump for an exception a runtime component caught but
    considers terminal-worthy evidence (e.g. a batch that died with
    `torch.cuda.OutOfMemoryError` inside the serve batcher): trigger
    "oom" for device out-of-memory, "exception" otherwise."""
    from deepdfa_tpu_torch.obs import ledger as obs_ledger

    rec = _recorder
    if rec is None:
        return None
    trigger = "oom" if obs_ledger.is_oom(exc) else "exception"
    return rec.dump(trigger, extra={
        "error": f"{type(exc).__name__}: {exc}"[:2000],
        **({"where": where} if where else {}),
    })


def _excepthook(exc_type, exc, tb) -> None:
    try:
        note_exception(exc, where="sys.excepthook")
    finally:
        hook = _prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)


# ---------------------------------------------------------------------------
# postmortem validation (scripts/check_obs_schema.py --postmortem)


def validate_postmortem(doc: dict) -> dict:
    """Structural + schema validation of one postmortem document (the
    parsed JSON of a dumped postmortem.json). Checks the format contract
    AND that every metrics tag the dump embeds is declared in
    obs/metrics.py:SCHEMA (a summary/histogram tag maps to its
    `<tag>/count` declaration).
    Returns {"ok", "problems", "trigger", "steps", "events"}."""
    from deepdfa_tpu_torch.obs import metrics

    problems: list[str] = []
    pm = doc.get("postmortem") if isinstance(doc, dict) else None
    if not isinstance(pm, dict):
        return {
            "ok": False,
            "problems": ["missing top-level 'postmortem' object"],
        }
    if pm.get("version") != POSTMORTEM_VERSION:
        problems.append(
            f"version {pm.get('version')!r} != {POSTMORTEM_VERSION}"
        )
    trigger = pm.get("trigger")
    if trigger not in TRIGGERS:
        problems.append(
            f"trigger {trigger!r} not in declared set {TRIGGERS}"
        )
    for key in ("t_unix", "pid"):
        if not isinstance(pm.get(key), (int, float)):
            problems.append(f"{key} missing or non-numeric")
    for ring in ("steps", "events"):
        v = pm.get(ring)
        if not isinstance(v, list) or not all(
            isinstance(e, dict) for e in v
        ):
            problems.append(f"{ring} must be a list of objects")
    metrics_snap = pm.get("metrics")
    if not isinstance(metrics_snap, dict):
        problems.append("metrics snapshot missing")
    else:
        undeclared = sorted(
            tag for tag in metrics_snap
            if not (
                metrics.declared(tag) or metrics.declared(f"{tag}/count")
            )
        )
        for tag in undeclared:
            problems.append(f"undeclared metrics tag: {tag}")
    led = pm.get("ledger")
    if led is not None:
        if not isinstance(led, dict) or not isinstance(
            led.get("sites"), dict
        ):
            problems.append("ledger section present but malformed")
    return {
        "ok": not problems,
        "problems": problems,
        "trigger": trigger,
        "steps": len(pm.get("steps") or []),
        "events": len(pm.get("events") or []),
    }


def validate_postmortem_file(path: str | Path) -> dict:
    path = Path(path)
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return {"ok": False, "problems": [f"unreadable: {e}"]}
    out = validate_postmortem(doc)
    out["path"] = str(path)
    return out
