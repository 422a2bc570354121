"""Preemption-safe, self-healing training runtime (the port of the
reference's `deepdfa_tpu/train/resilience.py`) for the GGNN trainer
(train/loop.py) and the combined trainer (train/combined_loop.py).

- **StepCheckpointer** — step-granular atomic checkpoints of the whole
  training state (`TrainState.state_dict`: the model, the optimiser's
  moments and update counts, the schedule's count, the host step count)
  plus a resume manifest carrying the data-pipeline cursor (epoch
  index, batch position, global step, seed) and the dropout streams'
  seeds. The loops draw no stateful `torch.Generator`: every dropout
  mask (the GGNN's feature dropout, the flash kernels' Philox streams)
  is a function of (seed, step), so the seeds and the step restore them
  all. The state is a `torch.save` written tmp + rename; manifests are
  written tmp+fsync+rename (core/ioutil.py) and a sidecar cursor file
  per checkpoint lets a corrupt manifest be rebuilt from the disk.
- **PreemptionHandler** — SIGTERM/SIGINT set a flag; the loop finishes
  the in-flight step, checkpoints, and raises `Preempted`, which the CLI
  turns into a clean exit (EXIT_PREEMPTED, 143).
- **divergence guard** (host half; the device half is
  `train/state.py:TrainState.apply_gradients_guarded`) — the step
  computes loss/grad-norm finiteness ON THE DEVICE and skips a poisoned
  update there; the runner copies each step's ok flag into pinned host
  memory behind a CUDA event and reads it `guard_lag` steps late, when
  the event has normally completed (no synchronize on the happy path),
  counts skips, and after `max_consecutive_bad` consecutive bad steps
  rolls back to the last-good step checkpoint with an LR cool-down
  (`lr_cooldown` scales the whole update, as the reference's
  `lr_scale`), bounded by `rollback_budget`.
- **Watchdog** — a daemon thread fed by loop heartbeats; when no beat
  lands for `watchdog_timeout_s` (after the first step's grace), it
  writes a stage-attributed diagnostic and a postmortem and aborts
  (EXIT_WATCHDOG, 113) instead of hanging forever.

Resume semantics: batch streams are pure functions of (epoch, seed, data
digest) — the loops fast-forward the stream past the consumed batches,
restore the exact state, and the trajectory continues bit-identically
with the uninterrupted run (tests/test_torch_resilience.py).

Observability: every self-healing event (stall, skip, rollback, resume,
preemption) lands in the unified telemetry stream — cat="resilience"
instants plus `obs/resilience/*` registry counters. No-ops when
telemetry is off.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import signal
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from deepdfa_tpu_torch.core.config import ResilienceConfig
from deepdfa_tpu_torch.core.ioutil import atomic_write_text
from deepdfa_tpu_torch.obs import (
    flight as obs_flight,
    metrics as obs_metrics,
    trace as obs_trace,
)

logger = logging.getLogger(__name__)

#: process exit codes: 128+SIGTERM for a clean preemption exit (what a
#: scheduler that sent the signal expects), and a distinct code for a
#: watchdog abort so wrappers can tell "hung" from "killed"
EXIT_PREEMPTED = 143
EXIT_WATCHDOG = 113


class Preempted(RuntimeError):
    """A preemption signal arrived; the in-flight step was finished and
    (when a checkpointer is attached) the state + resume manifest were
    written before this was raised."""

    def __init__(self, message: str, manifest: Path | None = None):
        super().__init__(message)
        self.manifest = manifest


class DivergenceError(RuntimeError):
    """The divergence guard exhausted its rollback budget."""


@dataclasses.dataclass(frozen=True)
class ResumeCursor:
    """Data-pipeline position a checkpoint corresponds to: the batch
    stream for `epoch` has had `batch_index` batches consumed, and the
    optimizer has taken `step` global steps."""

    epoch: int
    batch_index: int
    step: int


# ---------------------------------------------------------------------------
# preemption


class PreemptionHandler:
    """Installs SIGTERM/SIGINT handlers that set a flag (the loop polls
    it after each step). A SECOND signal restores the previous handlers
    and re-raises, so an operator's double Ctrl-C still kills a run whose
    checkpoint write wedged. Signal handlers are process-global and only
    installable from the main thread; elsewhere this degrades to a
    flag that `trigger()` (the fault harness) can still set."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._previous: dict[int, Any] = {}
        self._triggered = threading.Event()
        self._installed = False

    @property
    def triggered(self) -> bool:
        return self._triggered.is_set()

    def trigger(self) -> None:
        self._triggered.set()

    def _handle(self, signum, frame) -> None:
        if self._triggered.is_set():
            # second signal: get out of the way and re-deliver
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        logger.warning(
            "received %s: finishing the in-flight step, then "
            "checkpointing and exiting cleanly",
            signal.Signals(signum).name,
        )
        self._triggered.set()

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "preemption handler not installed (not the main thread); "
                "only injected triggers will be observed"
            )
            return self
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # not main thread / shutdown
                pass
        self._previous.clear()
        self._installed = False


# ---------------------------------------------------------------------------
# step-granular checkpoints


class StepCheckpointer:
    """Atomic step-granular state checkpoints + resume manifest.

    Layout:

        <directory>/step-00000042/state.pt     torch.save of the state
        <directory>/step-00000042.cursor.json  sidecar written AFTER the
                                               state is complete
        <directory>/resume.json                newest complete checkpoint

    The sidecar is the completeness marker: it is written atomically
    after the state's rename, so a crash mid-save leaves a dir with no
    sidecar, which `latest()`/retention treat as garbage. A corrupt
    `resume.json` is rebuilt from the sidecars actually on disk.
    """

    STATE_FILE = "state.pt"

    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last = max(1, int(keep_last))

    # -- write ---------------------------------------------------------------

    @staticmethod
    def _tag(step: int) -> str:
        return f"step-{step:08d}"

    def save(self, host_state: dict, cursor: ResumeCursor, seed: int = 0,
             reason: str = "periodic", extra: dict | None = None) -> Path:
        """Persist a host state dict (`TrainState.state_dict()`) at
        `cursor`. Returns the resume-manifest path. Idempotent per step
        (overwrites). `extra` rides along in the manifest (the runner
        stores its guard state and the dropout seeds there)."""
        import torch

        tag = self._tag(cursor.step)
        d = self.directory / tag
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f".{self.STATE_FILE}.{os.getpid()}.tmp"
        with tmp.open("wb") as f:
            torch.save(host_state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, d / self.STATE_FILE)
        manifest = {
            "tag": tag,
            "step": int(cursor.step),
            "epoch": int(cursor.epoch),
            "batch_index": int(cursor.batch_index),
            "seed": int(seed),
            "reason": reason,
            "wall_time": time.time(),
            **(extra or {}),
        }
        payload = json.dumps(manifest, indent=2)
        atomic_write_text(self.directory / f"{tag}.cursor.json", payload)
        atomic_write_text(self.directory / "resume.json", payload)
        self._retain()
        return self.directory / "resume.json"

    def _retain(self) -> None:
        complete = sorted(
            p.name[: -len(".cursor.json")]
            for p in self.directory.glob("step-*.cursor.json")
        )
        for tag in complete[: -self.keep_last]:
            shutil.rmtree(self.directory / tag, ignore_errors=True)
            (self.directory / f"{tag}.cursor.json").unlink(missing_ok=True)
        # a dir without a sidecar is an interrupted save: collect it
        # unless it is the newest (a save may be in flight elsewhere)
        dirs = sorted(p.name for p in self.directory.glob("step-*") if p.is_dir())
        for tag in dirs[:-1]:
            if not (self.directory / f"{tag}.cursor.json").exists():
                shutil.rmtree(self.directory / tag, ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def _complete(self, tag: str) -> bool:
        return (self.directory / tag / self.STATE_FILE).is_file()

    def latest(self) -> dict | None:
        """The newest complete checkpoint's manifest, or None. Tolerates
        a corrupt/missing resume.json by rebuilding from the sidecars."""
        path = self.directory / "resume.json"
        if path.exists():
            try:
                m = json.loads(path.read_text())
                if self._complete(m["tag"]):
                    return m
                logger.warning(
                    "resume.json points at missing checkpoint %s; "
                    "rebuilding from on-disk sidecars", m.get("tag"),
                )
            except (json.JSONDecodeError, KeyError, OSError) as e:
                logger.warning(
                    "corrupt resume.json (%s: %s); rebuilding from "
                    "on-disk sidecars", type(e).__name__, e,
                )
        best = None
        for sc in self.directory.glob("step-*.cursor.json"):
            try:
                m = json.loads(sc.read_text())
            except (json.JSONDecodeError, OSError):
                continue
            if not self._complete(m.get("tag", "")):
                continue
            if best is None or m["step"] > best["step"]:
                best = m
        if best is not None:
            atomic_write_text(self.directory / "resume.json", json.dumps(best, indent=2))
        return best

    def restore(self, manifest: dict) -> dict:
        """The host state dict of the checkpoint named by `manifest`."""
        import torch

        return torch.load(self.directory / manifest["tag"] / self.STATE_FILE,
                          map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# watchdog


class Watchdog:
    """Detects a silent train loop: the loop beats before every stage
    transition (input pull, device step); when no beat lands within
    `timeout_s`, the watchdog writes a stage-attributed diagnostic and
    invokes `on_stall` (default: hard process abort — a hung device step
    cannot be unwound from a thread)."""

    def __init__(
        self,
        timeout_s: float,
        on_stall: Callable[[dict], None] | None = None,
        diagnostic_path: str | Path | None = None,
        poll_s: float | None = None,
        first_step_grace_s: float | None = None,
    ):
        """first_step_grace_s: stall threshold until the FIRST completed
        step (`step_done()`): the first step legitimately includes the
        kernels' first build (nvcc, a minute or more), which a
        steady-state timeout would misread as a device hang. None/0 =
        10x timeout_s."""
        self.timeout_s = float(timeout_s)
        self.first_step_grace_s = (
            float(first_step_grace_s)
            if first_step_grace_s
            else 10.0 * self.timeout_s
        )
        self.on_stall = on_stall if on_stall is not None else self._abort
        self.diagnostic_path = (
            Path(diagnostic_path) if diagnostic_path else None
        )
        self.poll_s = poll_s if poll_s is not None else min(
            1.0, max(0.05, self.timeout_s / 4)
        )
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stage = "start"
        self._ctx: dict = {}
        self._stats = None  # optional PipelineStats for the diagnostic
        self._stepped = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fired = False

    def beat(self, stage: str, **ctx) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._stage = stage
            if ctx:
                self._ctx = ctx

    def step_done(self) -> None:
        """A full train step completed: compiles are behind us, drop to
        the steady-state stall threshold."""
        self._stepped = True

    #: stages the steady-state timeout applies to — the in-loop batch
    #: pull and step dispatch. Anything else the loops announce (eval,
    #: checkpoint, epoch-end work) is legitimately long and bounded by
    #: the grace threshold instead, so a long evaluation or a checkpoint
    #: write is not misread as a stall.
    STEADY_STAGES = frozenset({"input", "device"})

    def attach_stats(self, stats) -> None:
        self._stats = stats

    def start(self) -> "Watchdog":
        self.beat("start")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="train-watchdog"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                elapsed = time.monotonic() - self._last
                stage, ctx = self._stage, dict(self._ctx)
                threshold = (
                    self.timeout_s
                    if self._stepped and stage in self.STEADY_STAGES
                    else self.first_step_grace_s
                )
            if elapsed <= threshold:
                continue
            self.fired = True
            diag = self._diagnostic(stage, elapsed, ctx)
            # the stall joins the unified event stream (diag CLI renders
            # it); flush because the default on_stall is os._exit, which
            # skips the tracer's atexit hook
            obs_metrics.REGISTRY.counter(
                "obs/resilience/watchdog_stalls"
            ).inc()
            obs_trace.instant(
                "train_stall", cat="resilience", stage=stage,
                elapsed_s=round(elapsed, 1), **ctx,
            )
            obs_trace.flush()
            # flight recorder (docs/efficiency.md): the postmortem is
            # written BEFORE on_stall because the default on_stall is
            # os._exit — the last N steps + recent instants + ledger
            # must already be on disk when the process dies
            obs_flight.crash_dump("watchdog_abort", extra=diag)
            logger.critical("watchdog: %s", json.dumps(diag))
            if self.diagnostic_path is not None:
                try:
                    atomic_write_text(
                        self.diagnostic_path, json.dumps(diag, indent=2)
                    )
                except OSError:
                    pass
            self.on_stall(diag)
            return

    def _diagnostic(self, stage: str, elapsed: float, ctx: dict) -> dict:
        # stage attribution: "input" = the consumer was pulling the next
        # batch when it went silent (stalled producer / source), "device"
        # = it was inside a train-step dispatch or a result fetch (hung
        # device step or collective)
        diag = {
            "event": "train_stall",
            "stalled_stage": stage,
            "seconds_since_heartbeat": round(elapsed, 1),
            "timeout_s": self.timeout_s,
            **ctx,
        }
        stats = self._stats
        if stats is not None:
            try:
                diag["pipeline"] = stats.record()
            except Exception:  # diagnostics must never mask the stall
                pass
        return diag

    @staticmethod
    def _abort(diag: dict) -> None:
        # flush what we can, then leave: a hung CUDA call cannot be
        # interrupted from a thread, so a hard exit is the only way to
        # return the machine to the scheduler
        print(f"FATAL train stall: {json.dumps(diag)}", flush=True)
        os._exit(EXIT_WATCHDOG)


# ---------------------------------------------------------------------------
# the lagged ok flags


class _LaggedFlag:
    """A step's device ok flag on its way to the host with no sync: on
    the card a non-blocking copy into pinned memory behind a CUDA event
    (read when the event has completed, else after waiting on that event
    alone); on the CPU the flag itself."""

    __slots__ = ("_host", "_event", "_value")

    def __init__(self, ok):
        import torch

        self._value = None
        self._event = None
        if isinstance(ok, torch.Tensor) and ok.is_cuda:
            self._host = torch.empty((), dtype=torch.bool, pin_memory=True)
            self._host.copy_(ok, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = ok

    def value(self) -> bool:
        if self._value is None:
            if self._event is not None and not self._event.query():
                self._event.synchronize()
            self._value = bool(self._host)
        return self._value


# ---------------------------------------------------------------------------
# the runner the loops talk to


class ResilientRunner:
    """One object the fit loops thread their steps through.

    Lifecycle::

        res = ResilientRunner(cfg.train.resilience, run_dir / "checkpoints-torch-step")
        with res:                                   # signals + watchdog
            cursor = res.maybe_resume(state)
            for epoch ...:
                res.attach_stats(stats)
                ...
                res.heartbeat("input"); batch = next(it)
                res.heartbeat("device")
                loss, ok = trainer.train_step_guarded(state, batch, res.lr_scale())
                res.after_step(state, ok, ResumeCursor(...))

    `after_step` is where everything meets: guard bookkeeping (lagged ok
    read, skip counting, rollback), the periodic step checkpoint, and the
    preemption check (raises `Preempted` after saving). The state is the
    live `TrainState`: a resume or a rollback restores into it in place.

    The two fit loops implement this sequence by hand (train/loop.py,
    train/combined_loop.py); when changing the protocol here, update
    both in lockstep.
    """

    def __init__(
        self,
        rcfg: ResilienceConfig,
        directory: str | Path | None = None,
        seed: int = 0,
        on_stall: Callable[[dict], None] | None = None,
        rng: dict | None = None,
    ):
        """`rng`: the seeds the loop's dropout streams are functions of
        (with the step); stored in every manifest and required to match
        on resume."""
        self.rcfg = rcfg
        self.seed = int(seed)
        self.rng = dict(rng or {})
        self.ckpt = (
            StepCheckpointer(directory, keep_last=rcfg.keep_last_k)
            if directory is not None
            else None
        )
        self.guard_active = bool(rcfg.enabled and rcfg.divergence_guard)
        self.handler = PreemptionHandler()
        self.watchdog = (
            Watchdog(
                rcfg.watchdog_timeout_s,
                on_stall=on_stall,
                diagnostic_path=(
                    Path(directory) / "watchdog_diagnostic.json"
                    if directory is not None
                    else None
                ),
                first_step_grace_s=rcfg.watchdog_first_step_grace_s,
            )
            if rcfg.watchdog_timeout_s > 0
            else None
        )
        self._pending: deque[_LaggedFlag] = deque()  # lagged ok flags
        self._consec_bad = 0
        self._lr_scale = 1.0
        # counters surfaced into epoch records
        self.skipped_steps = 0
        self.rollbacks = 0
        self.resumed_from_step = 0

    # -- context management ---------------------------------------------------

    def __enter__(self) -> "ResilientRunner":
        self.handler.install()
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def __exit__(self, *exc) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        self.handler.uninstall()

    # -- loop surface ---------------------------------------------------------

    def heartbeat(self, stage: str, **ctx) -> None:
        if self.watchdog is not None:
            self.watchdog.beat(stage, **ctx)

    def attach_stats(self, stats) -> None:
        if self.watchdog is not None:
            self.watchdog.attach_stats(stats)

    def lr_scale(self) -> float:
        """Effective LR multiplier (cooled down after rollbacks)."""
        return self._lr_scale

    def maybe_resume(self, state: Any) -> ResumeCursor | None:
        """Restore the newest step checkpoint into `state` (a live
        `TrainState`) when auto_resume is on; the cursor, or None."""
        if self.ckpt is None or not self.rcfg.auto_resume or not self.rcfg.enabled:
            return None
        manifest = self.ckpt.latest()
        if manifest is None:
            return None
        if manifest.get("seed", self.seed) != self.seed:
            logger.warning(
                "resume manifest seed %s != run seed %s — refusing to "
                "resume a different run's checkpoint",
                manifest.get("seed"), self.seed,
            )
            return None
        if self.rng and manifest.get("rng", self.rng) != self.rng:
            logger.warning(
                "resume manifest dropout seeds %s != this run's %s — refusing to "
                "resume a different run's checkpoint", manifest.get("rng"), self.rng,
            )
            return None
        state.load_state_dict(self.ckpt.restore(manifest))
        cursor = ResumeCursor(
            epoch=int(manifest["epoch"]),
            batch_index=int(manifest["batch_index"]),
            step=int(manifest["step"]),
        )
        self.resumed_from_step = cursor.step
        obs_metrics.REGISTRY.gauge("obs/resilience/resumed_from_step").set(cursor.step)
        obs_trace.instant(
            "resumed", cat="resilience", step=cursor.step,
            epoch=cursor.epoch, batch_index=cursor.batch_index,
        )
        # guard state survives the restart: a cooled-down LR stays
        # cooled, and rollback_budget bounds rollbacks ACROSS restarts
        guard = manifest.get("guard")
        if guard:
            self._lr_scale = float(guard.get("lr_scale", 1.0))
            self.rollbacks = int(guard.get("rollbacks", 0))
            self.skipped_steps = int(guard.get("skipped_steps", 0))
        logger.info(
            "resumed from %s at step %d (epoch %d, batch %d)",
            manifest["tag"], cursor.step, cursor.epoch, cursor.batch_index,
        )
        return cursor

    def after_step(self, state: Any, ok: Any, cursor: ResumeCursor) -> None:
        """Guard bookkeeping + periodic checkpoint + preemption check.
        A rollback restores into `state` in place; raises `Preempted`
        after a preemption checkpoint, `DivergenceError` past the
        budget."""
        if self.watchdog is not None:
            # a completed step means the first build is done: drop from
            # the first-step grace to the steady-state timeout
            self.watchdog.step_done()
        if self.guard_active and ok is not None:
            self._pending.append(_LaggedFlag(ok))
            if len(self._pending) > max(0, int(self.rcfg.guard_lag)):
                self._consume_ok(self._pending.popleft(), state)
        every = int(self.rcfg.step_checkpoint_every)
        if (
            self.ckpt is not None
            and self.rcfg.enabled
            and every > 0
            and cursor.step % every == 0
            and self._consec_bad == 0
        ):
            self._save(state, cursor, reason="periodic")
        if self.handler.triggered:
            manifest = None
            if self.ckpt is not None:
                # drain the lagged guard flags first so a poisoned
                # trailing step is never enshrined as the resume point
                while self._pending:
                    self._consume_ok(self._pending.popleft(), state)
                manifest = self._save(state, cursor, reason="preempt")
            obs_metrics.REGISTRY.counter("obs/resilience/preemptions").inc()
            obs_trace.instant("preempted", cat="resilience", step=cursor.step,
                              epoch=cursor.epoch)
            obs_trace.flush()
            obs_flight.crash_dump("sigterm", extra={
                "step": cursor.step, "epoch": cursor.epoch,
                "batch_index": cursor.batch_index,
                "manifest": str(manifest) if manifest else None,
            })
            raise Preempted(
                f"preempted at step {cursor.step} "
                f"(epoch {cursor.epoch}, batch {cursor.batch_index})",
                manifest=manifest,
            )

    def finish(self, state: Any, cursor: ResumeCursor) -> None:
        """End-of-run hook: drain lagged guard flags and leave a final
        resume point."""
        while self._pending:
            self._consume_ok(self._pending.popleft(), state)
        if self.ckpt is not None and self.rcfg.enabled:
            self._save(state, cursor, reason="final")

    def record(self) -> dict:
        """Self-healing counters for epoch records."""
        return {
            "resumed_from_step": self.resumed_from_step,
            "skipped_steps": self.skipped_steps,
            "rollbacks": self.rollbacks,
        }

    # -- internals ------------------------------------------------------------

    def _save(self, state: Any, cursor: ResumeCursor, reason: str) -> Path | None:
        # the save (a device-to-host copy of the state, a torch.save) can
        # be long on a big model: announce it so the watchdog applies the
        # grace threshold instead of the per-step timeout
        self.heartbeat("checkpoint", step=cursor.step)
        extra: dict = {"guard": {
            "lr_scale": self._lr_scale,
            "rollbacks": self.rollbacks,
            "skipped_steps": self.skipped_steps,
        }}
        if self.rng:
            extra["rng"] = self.rng
        # the copy to the host orders after the in-flight step: the state
        # captured is the one the step left (the preemption contract)
        return self.ckpt.save(state.state_dict(), cursor, seed=self.seed, reason=reason,
                              extra=extra)

    def _consume_ok(self, flag: _LaggedFlag, state: Any) -> None:
        if flag.value():
            self._consec_bad = 0
            return
        self.skipped_steps += 1
        self._consec_bad += 1
        obs_metrics.REGISTRY.counter("obs/resilience/skipped_steps").inc()
        obs_trace.instant("step_skipped", cat="resilience", consecutive=self._consec_bad)
        logger.warning(
            "divergence guard: non-finite loss/grad — step skipped "
            "(%d consecutive)", self._consec_bad,
        )
        if self._consec_bad < int(self.rcfg.max_consecutive_bad):
            return
        if self.rollbacks >= int(self.rcfg.rollback_budget):
            raise DivergenceError(
                f"divergence guard: {self._consec_bad} consecutive bad "
                f"steps after {self.rollbacks} rollbacks — rollback "
                f"budget exhausted"
            )
        self.rollbacks += 1
        self._lr_scale *= float(self.rcfg.lr_cooldown)
        obs_metrics.REGISTRY.counter("obs/resilience/rollbacks").inc()
        obs_trace.instant("rollback", cat="resilience", rollbacks=self.rollbacks,
                          lr_scale=self._lr_scale)
        obs_flight.crash_dump("nan_rollback", extra={
            "rollbacks": self.rollbacks,
            "skipped_steps": self.skipped_steps,
            "lr_scale": self._lr_scale,
        })
        self._consec_bad = 0
        self._pending.clear()  # flags from the abandoned trajectory
        manifest = self.ckpt.latest() if self.ckpt is not None else None
        if manifest is None:
            logger.warning(
                "divergence guard: no step checkpoint to roll back to — "
                "cooling LR to x%.3g and continuing from current params",
                self._lr_scale,
            )
            return
        # restore can be long on big states: grace threshold, not the
        # per-step timeout, while it runs
        self.heartbeat("checkpoint", step=manifest["step"])
        host_step = state.step
        state.load_state_dict(self.ckpt.restore(manifest))
        # the data cursor runs on: the host step count is the stream's
        state.step = host_step
        logger.warning(
            "divergence guard: rolled back to %s (step %d), LR cooled "
            "to x%.3g (%d/%d rollbacks)",
            manifest["tag"], manifest["step"], self._lr_scale,
            self.rollbacks, int(self.rcfg.rollback_budget),
        )


def make_runner(cfg, directory: str | Path | None, rng: dict | None = None
                ) -> ResilientRunner | None:
    """CLI helper: a runner when `cfg.train.resilience.enabled`, else
    None (the loops then run the default path untouched)."""
    rcfg = cfg.train.resilience
    if not rcfg.enabled:
        return None
    return ResilientRunner(rcfg, directory, seed=cfg.train.seed, rng=rng)


def finite_mean(values) -> float:
    """Mean over the FINITE entries only — guarded runs keep the poisoned
    loss values of skipped steps in their per-step history, but the
    epoch aggregate must not report NaN for an epoch the runtime
    survived cleanly. NaN when nothing was finite."""
    import numpy as np

    a = np.asarray(values, np.float64)
    m = np.isfinite(a)
    return float(a[m].mean()) if m.any() else float("nan")


def skip_first(source, n: int, heartbeat: Callable[[], None] | None = None):
    """Drop the first `n` items of a batch source — the resume
    fast-forward. Applied to the RAW source, before the prefetch
    pipeline, so skipped batches are never placed and never counted in
    PipelineStats/token accounting; preserves the source's
    `source_stage` hint. `heartbeat` is called once per skipped pull."""

    class _Skipped:
        def __init__(self):
            stage = getattr(source, "source_stage", None)
            if stage is not None:
                self.source_stage = stage

        def __iter__(self):
            it = iter(source)
            for _ in range(n):
                if heartbeat is not None:
                    heartbeat()
                if next(it, _SKIP_SENTINEL) is _SKIP_SENTINEL:
                    return
            yield from it

    return _Skipped()


_SKIP_SENTINEL = object()
