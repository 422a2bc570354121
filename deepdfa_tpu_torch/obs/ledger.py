"""Device efficiency ledger (the port of the reference's
`deepdfa_tpu/obs/ledger.py`).

The paper's headline claim is efficiency (Table 5: GFLOPs and
ms-per-example per model). This module is the runtime half of that
accounting:

- **one cost reader** — `read_cost_analysis(counted)` normalizes the
  counted cost of one call (obs/cost.py: the kernels' work formulas plus
  FlopCounterMode's aten ops) to the reference's {"flops",
  "bytes_accessed", "cost_analysis"}. `eval/profiling.py:compiled_cost`
  reads through it, so Table-5 profiling and runtime accounting cannot
  drift.
- **per-signature efficiency sites** keyed by (tag, signature). There is
  no ahead-of-time compile in PyTorch: `record_compile` (the reference's
  name) books a site's warm-up — the first call of a serving rung or of
  a new training signature — with that call's counted cost, its wall
  seconds (the kernel builds included) and its peak device memory.
  Executions report `observe_execution(tag, signature, seconds)` (the
  serving executors per batch, from CUDA events) and the train loops'
  `set_step_site` + `observe_step_seconds` (the sync-free `StepTimer`),
  so the snapshot derives a rolling per-site FLOP/s and its MFU.
- **MFU** reads each site's operations, by type (fp32, bf16, int8),
  against a ceiling of that type: the measured ones
  (`measure_runtime_ceilings`, with `obs.ledger_ceilings`), else the
  card's peaks (`CARD_PEAKS`, chosen by the device's name, the name
  `nvidia-smi` gives); on the CPU, FLOP/s only. MFU = (the site's
  operations over the ceilings) / its measured seconds, per execution.
- **memory ledger** — `record_memory(phase)` keeps per-phase allocator
  watermarks (xprof.device_memory_stats), `record_params(tag, params)`
  the parameter bytes of a model or state dict.
- **OOM forensics** — `is_oom(exc)` recognizes
  `torch.cuda.OutOfMemoryError`, and the flight recorder (obs/flight.py)
  dumps the ledger into postmortem.json when one escapes.

Everything is default OFF (`cfg.obs.ledger`): the module-level wrappers
are one `is None` check when disabled.
"""

from __future__ import annotations

import math
import threading
import time

from deepdfa_tpu_torch.obs import metrics as obs_metrics

#: bump when the snapshot / postmortem "ledger" section shape changes
LEDGER_VERSION = 1

#: the card's peaks (operations/s by type, bytes/s of device memory),
#: by a substring of the device name (`torch.cuda.get_device_name`, as
#: `nvidia-smi` prints it): the H100 SXM's dense figures
CARD_PEAKS = {
    "H100": {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12, "bytes": 3.35e12},
}

#: the measured ceilings' keys by operation type
_MEASURED_KEYS = {"bf16": "matmul_flops_per_sec", "fp32": "matmul_fp32_flops_per_sec"}

_ledger: "EfficiencyLedger | None" = None
_lock = threading.Lock()


# ---------------------------------------------------------------------------
# the ONE cost reader (eval/profiling.compiled_cost is a client)


def read_cost_analysis(counted: dict) -> dict:
    """A counted cost (obs/cost.py:CostCounter.result), normalized:
    {"flops", "bytes_accessed", "flops_by_precision", "cost_analysis":
    {numeric fields}}."""
    return {
        "flops": float(counted.get("flops", 0.0)),
        "bytes_accessed": float(counted.get("bytes_accessed", 0.0)),
        "flops_by_precision": dict(counted.get("flops_by_precision", {})),
        "cost_analysis": {
            k: v for k, v in counted.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        },
    }


def card_peaks(name: str | None = None) -> dict[str, float]:
    """The peaks of the card named `name` (default: CUDA device 0's),
    or {} for a card not in CARD_PEAKS and on a machine without one."""
    if name is None:
        import torch

        if not torch.cuda.is_available():
            return {}
        name = torch.cuda.get_device_name(0)
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return dict(peaks)
    return {}


def is_oom(exc: BaseException) -> bool:
    """Does an exception look like a device out-of-memory? The flight
    recorder uses this to classify a crash as trigger="oom"."""
    try:
        import torch

        if isinstance(exc, torch.cuda.OutOfMemoryError):
            return True
    except Exception:
        pass
    return "out of memory" in f"{type(exc).__name__}: {exc}".lower()


class PeakMemory:
    """Context manager: the peak device memory a call allocated beyond
    what was live when it started (`live_bytes`; 0.0 on the CPU). Resets
    the allocator's peak statistic on entry."""

    def __init__(self, cuda: bool):
        self.cuda = bool(cuda)
        self.live_bytes = 0.0

    def __enter__(self) -> "PeakMemory":
        if self.cuda:
            import torch

            torch.cuda.reset_peak_memory_stats()
            self._base = torch.cuda.memory_allocated()
        return self

    def __exit__(self, *exc) -> bool:
        if self.cuda:
            import torch

            self.live_bytes = float(torch.cuda.max_memory_allocated() - self._base)
        return False


# ---------------------------------------------------------------------------
# the ledger


def _new_site() -> dict:
    return {
        "flops": 0.0,
        "bytes_accessed": 0.0,
        "compile_seconds": 0.0,
        "compiles": 0,
        "live_bytes": 0.0,
        "executions": 0,
        "device_seconds": 0.0,
    }


class EfficiencyLedger:
    """Per-(tag, signature) warm-up + execution accounting for one
    process. Host-side only: call sites hand it the costs and times of
    calls they already made."""

    def __init__(self, registry: obs_metrics.MetricsRegistry | None = None):
        self._r = registry if registry is not None else obs_metrics.REGISTRY
        self._lk = threading.Lock()
        self._sites: dict[tuple[str, str], dict] = {}
        self._by_precision: dict[tuple[str, str], dict] = {}
        self._memory: dict[str, dict[str, float]] = {}
        self._params: dict[str, float] = {}
        #: measured ceilings (matmul FLOP/s by type, gather bytes/s) the
        #: MFU fields are read against; {} = the card's peaks
        self.ceilings: dict[str, float] = {}
        #: the card's peaks (card_peaks), used where no ceiling is measured
        self.peaks: dict[str, float] = {}
        self.errors: list[str] = []
        self.created_unix = time.time()

    # -- warm-up side --------------------------------------------------------

    def record_compile(
        self,
        tag: str,
        signature: str,
        counted: dict | None = None,
        seconds: float = 0.0,
        flops: float | None = None,
        bytes_accessed: float | None = None,
        live_bytes: float | None = None,
    ) -> None:
        """The warm-up of a site: its first call took `seconds` (kernel
        builds included); `counted` (obs/cost.py's result for that call)
        supplies flops/bytes by type; the explicit kwargs override."""
        cost: dict = {}
        if counted is not None:
            try:
                cost = read_cost_analysis(counted)
            except Exception as e:  # accounting must never cost the run
                self._note_error(f"cost[{tag}/{signature}]: {e}")
        f = flops if flops is not None else cost.get("flops", 0.0)
        b = bytes_accessed if bytes_accessed is not None else cost.get("bytes_accessed", 0.0)
        lv = live_bytes or 0.0
        with self._lk:
            site = self._sites.setdefault((tag, signature), _new_site())
            site["compiles"] += 1
            site["compile_seconds"] += float(seconds)
            if f:
                site["flops"] = float(f)
                by = cost.get("flops_by_precision") or {"fp32": float(f)}
                self._by_precision[(tag, signature)] = {
                    p: float(v) for p, v in by.items() if v}
            if b:
                site["bytes_accessed"] = float(b)
            if lv:
                site["live_bytes"] = float(lv)
        base = f"ledger/{tag}/{signature}"
        self._r.counter(f"{base}/compiles").inc()
        self._r.counter(f"{base}/compile_seconds").inc(float(seconds))
        self._r.counter("ledger/compile_seconds_total").inc(float(seconds))
        if f:
            self._r.gauge(f"{base}/flops").set(float(f))
        if b:
            self._r.gauge(f"{base}/bytes_accessed").set(float(b))
        if lv:
            self._r.gauge(f"{base}/live_bytes").set(float(lv))

    def has_site(self, tag: str, signature: str) -> bool:
        with self._lk:
            return (tag, signature) in self._sites

    # -- execution side ------------------------------------------------------

    def observe_execution(self, tag: str, signature: str, seconds: float, n: int = 1) -> None:
        """`n` executions of a site took `seconds` of measured device
        time. Hot-path cost: one lock + three adds."""
        if not (seconds > 0.0) or not math.isfinite(seconds):
            return
        with self._lk:
            site = self._sites.setdefault((tag, signature), _new_site())
            site["executions"] += int(n)
            site["device_seconds"] += float(seconds)

    #: the train loops run ONE signature at a time; the StepTimer join
    #: routes its lagged step seconds to whatever site the loop declared
    def set_step_site(self, tag: str, signature: str) -> None:
        with self._lk:
            self._step_site = (tag, signature)

    _step_site: tuple[str, str] | None = None

    def observe_step_seconds(self, seconds: float) -> None:
        site = self._step_site
        if site is not None:
            self.observe_execution(site[0], site[1], seconds)

    # -- memory side ---------------------------------------------------------

    def record_memory(self, phase: str, stats: dict | None = None) -> None:
        """Fold the current allocator stats into the `phase` watermark
        (max-merge). The CPU reports no stats and the phase is absent;
        `stats` is injectable for tests."""
        if stats is None:
            from deepdfa_tpu_torch.obs import xprof

            stats = xprof.device_memory_stats()
        if not stats:
            return
        with self._lk:
            mark = self._memory.setdefault(phase, {})
            for k, v in stats.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    mark[k] = max(mark.get(k, -math.inf), float(v))
        for k, v in stats.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._r.gauge(f"ledger/memory/{phase}/{k}").set(float(v))

    def record_params(self, tag: str, params) -> float:
        """Parameter bytes of a model (an nn.Module), a state dict or an
        iterable of tensors. Returns the byte count."""
        if hasattr(params, "parameters"):
            leaves = list(params.parameters())
        elif isinstance(params, dict):
            leaves = list(params.values())
        else:
            leaves = list(params)
        total = 0.0
        for leaf in leaves:
            try:
                total += float(leaf.numel() * leaf.element_size())
            except Exception:
                continue
        with self._lk:
            self._params[tag] = total
        self._r.gauge(f"ledger/params/{tag}/bytes").set(total)
        return total

    # -- derived views -------------------------------------------------------

    def _ceiling(self, precision: str) -> float:
        key = _MEASURED_KEYS.get(precision)
        if key and self.ceilings.get(key, 0.0) > 0:
            return float(self.ceilings[key])
        return float(self.peaks.get(precision, 0.0))

    def _ideal_seconds(self, key: tuple[str, str]) -> float | None:
        """The site's operations over the ceiling of their type; None
        where a type with operations has no ceiling."""
        by = self._by_precision.get(key)
        if not by:
            return None
        total = 0.0
        for p, f in by.items():
            c = self._ceiling(p)
            if c <= 0:
                return None
            total += f / c
        return total

    def _site_view(self, key: tuple[str, str], site: dict) -> dict:
        out = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in site.items()}
        by = self._by_precision.get(key)
        if by:
            out["flops_by_precision"] = dict(by)
        secs = site["device_seconds"]
        if secs > 0 and site["executions"]:
            fps = site["flops"] * site["executions"] / secs
            bps = site["bytes_accessed"] * site["executions"] / secs
            if site["flops"]:
                out["flops_per_sec"] = round(fps, 1)
            if site["bytes_accessed"]:
                out["bytes_per_sec"] = round(bps, 1)
            ideal = self._ideal_seconds(key)
            if site["flops"] and ideal is not None:
                out["mfu_vs_measured_ceiling"] = round(ideal * site["executions"] / secs, 6)
            ceil_b = self.ceilings.get("gather_bytes_per_sec", 0.0) or self.peaks.get("bytes", 0.0)
            if site["bytes_accessed"] and ceil_b > 0:
                out["bytes_vs_gather_ceiling"] = round(bps / ceil_b, 6)
        return out

    def snapshot(self) -> dict:
        """The whole ledger as one JSON-able dict — what epoch records,
        serve/scan log records and the postmortem embed (flattens to
        SCHEMA-declared `ledger/*` tags)."""
        with self._lk:
            sites = {key: dict(site) for key, site in self._sites.items()}
            memory = {p: dict(m) for p, m in self._memory.items()}
            params = dict(self._params)
        out: dict = {
            "version": LEDGER_VERSION,
            "sites": {
                f"{tag}/{sig}": self._site_view((tag, sig), site)
                for (tag, sig), site in sites.items()
            },
            "compile_seconds_total": round(
                sum(s["compile_seconds"] for s in sites.values()), 3
            ),
        }
        if self.ceilings:
            out["ceilings"] = {k: v for k, v in self.ceilings.items()
                               if isinstance(v, (int, float))}
        if self.peaks:
            out["peaks"] = dict(self.peaks)
        if memory:
            out["memory"] = memory
        if params:
            out["params"] = params
        if self.errors:
            out["errors"] = list(self.errors)
        return out

    def mfu_record(self) -> dict:
        """{"ledger_mfu": {site: mfu-or-flops/s}, "compile_seconds_total"}:
        the fields a benchmark record carries (SCHEMA's `ledger_mfu/*`;
        a training step's site is `ledger_mfu/train_step/<signature>`)."""
        snap = self.snapshot()
        mfu: dict[str, float] = {}
        for label, view in snap["sites"].items():
            v = view.get("mfu_vs_measured_ceiling")
            if v is None:
                v = view.get("flops_per_sec")
            if isinstance(v, (int, float)):
                mfu[label] = v
        out: dict = {"compile_seconds_total": snap["compile_seconds_total"]}
        if mfu:
            out["ledger_mfu"] = mfu
        return out

    def _note_error(self, msg: str) -> None:
        with self._lk:
            if len(self.errors) < 16:
                self.errors.append(str(msg)[:200])


# ---------------------------------------------------------------------------
# measured runtime ceilings


def measure_runtime_ceilings() -> dict[str, float]:
    """Small measured-ceiling probes on the current device (a second or
    so): dense-matmul FLOP/s in bf16 and fp32 and gather + segment-sum
    bytes/s. A point sample of this moment's card: read a ratio > 1 as a
    probe that sampled a slower window."""
    from deepdfa_tpu_torch.eval import profiling

    out: dict[str, float] = {}
    for key, dtype in (("matmul_flops_per_sec", "bfloat16"),
                       ("matmul_fp32_flops_per_sec", "float32")):
        try:
            m = profiling.measure_matmul_ceiling(n=4096, chain=4, reps=3, dtype=dtype)
            out[key] = m["matmul_tflops_measured"] * 1e12
        except Exception:
            pass
    try:
        g = profiling.measure_gather_bandwidth(rows=16384, dim=128, idx_len=65536, chain=4,
                                               reps=3)
        out["gather_bytes_per_sec"] = g["gather_gbps_measured"] * 1e9
    except Exception:
        pass
    return out


# ---------------------------------------------------------------------------
# module surface (what every call site uses; no-ops when disabled)


def enable(
    ceilings: bool | dict = False,
    registry: obs_metrics.MetricsRegistry | None = None,
    peaks: dict | None = None,
) -> EfficiencyLedger:
    """Install the process ledger. `ceilings=True` runs the measured
    probes once; a dict injects ceilings directly (tests). `peaks`
    defaults to the card's (`card_peaks()`)."""
    global _ledger
    with _lock:
        led = EfficiencyLedger(registry=registry)
        if isinstance(ceilings, dict):
            led.ceilings = dict(ceilings)
        led.peaks = dict(card_peaks() if peaks is None else peaks)
        _ledger = led
    if ceilings is True:
        led.ceilings = measure_runtime_ceilings()
    return led


def disable() -> None:
    global _ledger
    with _lock:
        _ledger = None


def get() -> EfficiencyLedger | None:
    return _ledger


def enabled() -> bool:
    return _ledger is not None


def record_compile(tag, signature, counted=None, seconds=0.0, **kw) -> None:
    led = _ledger
    if led is not None:
        led.record_compile(tag, signature, counted, seconds, **kw)


def observe_execution(tag, signature, seconds, n: int = 1) -> None:
    led = _ledger
    if led is not None:
        led.observe_execution(tag, signature, seconds, n=n)


def set_step_site(tag, signature) -> None:
    led = _ledger
    if led is not None:
        led.set_step_site(tag, signature)


def observe_step_seconds(seconds: float) -> None:
    led = _ledger
    if led is not None:
        led.observe_step_seconds(seconds)


def record_memory(phase: str, stats: dict | None = None) -> None:
    led = _ledger
    if led is not None:
        led.record_memory(phase, stats=stats)


def record_params(tag: str, params) -> None:
    led = _ledger
    if led is not None:
        led.record_params(tag, params)


def snapshot_or_none() -> dict | None:
    led = _ledger
    return led.snapshot() if led is not None else None
