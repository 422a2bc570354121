"""Unified run telemetry (the port of the reference's `deepdfa_tpu/obs/`).

- `obs.trace`   — cross-process Chrome-trace spans/events (JSONL).
- `obs.metrics` — process-wide counter/gauge/histogram registry + the
  declared run-log schema (the reference's SCHEMA).
- `obs.xprof`   — on-demand `torch.profiler` capture, device memory
  stats, the CUDA-event step timer.
- `obs.cost`    — the counted FLOPs and bytes of a call: the hand-written
  kernels' work formulas plus FlopCounterMode's aten ops.
- `obs.ledger`  — device efficiency ledger: per-site counted cost,
  warm-up seconds, memory watermarks, rolling per-site MFU.
- `obs.flight`  — crash flight recorder: bounded step/event rings dumped
  as postmortem.json on terminal events.
- `obs.health`  — the bounded backend probe emitting `backend/*` events.

The train loops talk to it through two seams, and with every switch off
the default path is unchanged:

- `session(cfg, run_dir)` — CLI-side context manager that enables
  tracing (exporting the trace dir to child processes), the ledger, the
  flight recorder and the xprof controller per `cfg.obs`.
- `instruments(cfg, device)` — per-fit facade the loops call for step
  spans, the first call of each step signature (the ledger's warm-up
  site), lagged step timing and epoch-record enrichment; a shared no-op
  when nothing is enabled.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

from deepdfa_tpu_torch.obs import cost, flight, ledger, metrics, trace, xprof

#: bump when the shape/meaning of emitted records changes
BENCH_SCHEMA_VERSION = 1


class Instruments:
    """Live per-fit instrumentation: step spans + xprof stepping + the
    ledger's warm-up sites + the lagged step timer + epoch-record
    enrichment."""

    active = True

    def __init__(self, metrics_on: bool, cuda: bool = False):
        self.metrics_on = bool(metrics_on)
        self.cuda = bool(cuda)
        #: the efficiency ledger / flight recorder installed by session()
        #: (or directly by tests); None when off
        self.ledger = ledger.get()
        self.flight = flight.get()
        # the StepTimer exists for metrics OR the ledger: the ledger's
        # rolling per-site MFU is the lagged device-time join
        self.timer = (
            xprof.StepTimer(on_step_seconds=self._step_seconds, cuda=self.cuda)
            if (self.metrics_on or self.ledger is not None)
            else None
        )

    def _step_seconds(self, seconds: float, site=None) -> None:
        led = self.ledger
        if led is None:
            return
        if site is None:
            led.observe_step_seconds(seconds)
        else:
            led.observe_execution(site[0], site[1], seconds)

    def step_span(self, step: int):
        """Wraps one train-step dispatch; also advances the xprof
        controller and the flight recorder's step ring."""
        xprof.controller_on_step(step)
        if self.flight is not None:
            self.flight.note_step(step)
        return trace.span("train_step", cat="train", step=step)

    def run_step(self, step: int, tag: str, signature: str, run, aten_precision: str = "fp32"):
        """One train step `run()` (its result is returned). The first
        call of a (tag, signature) with the ledger on is the site's
        warm-up: counted (obs/cost.py), timed on the wall clock to its
        end (kernel builds included) and booked by `record_compile`, and
        not handed to the step timer. Every other call is timed by the
        StepTimer's events."""
        site = (tag, signature)
        with self.step_span(step):
            led = self.ledger
            if led is not None and not led.has_site(tag, signature):
                led.set_step_site(tag, signature)
                with ledger.PeakMemory(self.cuda) as mem:
                    t0 = time.perf_counter()
                    out, counted = cost.count_cost(run, aten_precision=aten_precision)
                    if self.cuda:
                        import torch

                        torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                led.record_compile(tag, signature, counted, dt, live_bytes=mem.live_bytes)
                return out
            if led is not None:
                led.set_step_site(tag, signature)
            if self.timer is None:
                return run()
            self.timer.begin()
            t0 = time.perf_counter()
            out = run()
            self.timer.dispatched(None, time.perf_counter() - t0, site=site)
            return out

    def observe_pipeline(self, stats) -> None:
        if self.metrics_on:
            metrics.publish_pipeline_stats(stats)

    def finish_epoch(self, record: dict) -> dict:
        """Drain the lagged timer and (when metrics are on) attach the
        registry snapshot + device memory stats to the epoch record."""
        if self.timer is not None:
            self.timer.drain()
        if self.ledger is not None:
            self.ledger.record_memory("epoch")
            record["ledger"] = self.ledger.snapshot()
        if not self.metrics_on:
            return record
        snap = metrics.REGISTRY.snapshot()
        obs_snap = {k[len("obs/"):]: v for k, v in snap.items() if k.startswith("obs/")}
        if obs_snap:
            record["obs"] = obs_snap
        mem = xprof.device_memory_stats() if self.cuda else {}
        if mem:
            record["device_memory"] = mem
        return record


class _NullInstruments:
    """Default-path stand-in: every call is a no-op or runs the step as
    it is; step_span returns the tracer's shared null span."""

    active = False
    metrics_on = False
    timer = None
    ledger = None
    flight = None

    def step_span(self, step: int):
        return trace._NULL_SPAN

    def run_step(self, step, tag, signature, run, aten_precision: str = "fp32"):
        return run()

    def observe_pipeline(self, stats) -> None:
        pass

    def finish_epoch(self, record: dict) -> dict:
        return record


NULL_INSTRUMENTS = _NullInstruments()


def instruments(cfg, device=None) -> "Instruments | _NullInstruments":
    """The loops' entry point. Anything to do? (cfg.obs.metrics on,
    tracing enabled — by session() or the environment — an xprof
    controller, the ledger or the flight recorder installed) -> live
    Instruments; else the shared no-op."""
    ocfg = getattr(cfg, "obs", None)
    metrics_on = bool(ocfg is not None and ocfg.metrics)
    if (
        metrics_on
        or trace.enabled()
        or xprof._controller is not None
        or ledger.enabled()
        or flight.installed()
    ):
        cuda = device is not None and getattr(device, "type", str(device)) == "cuda"
        return Instruments(metrics_on, cuda=cuda)
    return NULL_INSTRUMENTS


@contextlib.contextmanager
def session(cfg, run_dir):
    """CLI-side telemetry lifecycle for one run (`train`,
    `train-combined`, `score`, `serve`). All knobs default off; with
    `obs.trace=true` the per-process JSONL files land under
    `<run_dir>/trace/` (children join via the exported env var) and a
    merged `trace.json` is written at exit."""
    ocfg = getattr(cfg, "obs", None)
    if ocfg is None:
        yield
        return
    trace_dir = None
    if ocfg.trace:
        trace_dir = Path(ocfg.trace_dir) if ocfg.trace_dir else Path(run_dir) / "trace"
        trace.enable(trace_dir, process_name="main", export_env=True)
    if ocfg.xprof_start_step >= 0 or ocfg.xprof_trigger:
        xprof.install_controller(
            Path(run_dir) / "xprof",
            start_step=ocfg.xprof_start_step,
            num_steps=ocfg.xprof_num_steps,
            trigger=ocfg.xprof_trigger,
        )
    # the flight recorder goes in FIRST so an enable-time failure still dumps
    ledger_on = bool(ocfg.ledger)
    flight_on = bool(ocfg.flight)
    if flight_on:
        flight.install(
            Path(run_dir) / "postmortem.json",
            max_steps=ocfg.flight_steps,
            max_events=ocfg.flight_events,
        )
    if ledger_on:
        ledger.enable(ceilings=bool(ocfg.ledger_ceilings))
    try:
        yield
    finally:
        xprof.uninstall_controller()
        if ledger_on:
            ledger.disable()
        if flight_on:
            flight.uninstall()
        if trace_dir is not None:
            trace.disable()
            try:
                trace.write_chrome_trace(trace_dir, Path(trace_dir) / "trace.json")
            except OSError:
                pass


_git_sha: str | None = None


def run_stamp() -> dict:
    """Provenance fields every emitted record carries: record schema
    version, the repo sha the numbers were measured at, and the torch
    that ran them."""
    global _git_sha
    if _git_sha is None:
        import subprocess

        try:
            _git_sha = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=Path(__file__).resolve().parents[2],
                capture_output=True, text=True, timeout=10,
            ).stdout.strip() or "unknown"
        except Exception:
            _git_sha = "unknown"
    try:
        import torch

        torch_version = torch.__version__
    except Exception:
        torch_version = "unknown"
    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "git_sha": _git_sha,
        "torch_version": torch_version,
    }
