"""Process-wide metrics registry (the port's copy of the reference's
`deepdfa_tpu/obs/metrics.py`): one place every counter reports to,
snapshotted into the run log (`train_log.jsonl`).

Three primitives (counter / gauge / histogram) let any component publish
without threading state through the loops; the loops emit ONE
`record["obs"] = snapshot()` blob per epoch, flattened to `obs/<name>`
tags by `flatten_scalars`.

Naming rules: slash-separated lowercase paths,
`<subsystem>/<metric>[_<unit>]` — e.g. `input/load_seconds`,
`resilience/rollbacks`, `step/seconds`. Every name emitted into a run
log must match a declared pattern in `SCHEMA` below, the reference's
list unchanged (`undeclared_tags` checks a run log against it, and the
tests hold the port's records to the reference's SCHEMA).
"""

from __future__ import annotations

import fnmatch
import math
import threading


class Counter:
    """Monotonic accumulator (float to absorb seconds counters)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class Gauge:
    """Last-write-wins sample."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Streaming count/sum/min/max — enough for p50-free step-time
    summaries without holding samples (snapshot adds a derived mean)."""

    __slots__ = ("name", "count", "sum", "min", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)


class MetricsRegistry:
    """Name -> metric instance; get-or-create, kind-checked."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict[str, float]:
        """Flat {name: value}; histograms expand to /count /mean /max
        (min is rarely load-bearing and would double the tag count)."""
        out: dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Histogram):
                if m.count:
                    out[f"{m.name}/count"] = float(m.count)
                    out[f"{m.name}/mean"] = m.sum / m.count
                    out[f"{m.name}/max"] = m.max
            else:
                out[m.name] = float(m.value)
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: the process-wide registry every component publishes to
REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# the declared run-log schema


#: fnmatch patterns for every scalar tag a train run may emit into
#: train_log.jsonl (and therefore TensorBoard). Adding a new record key
#: without declaring it here fails the tests — that is the point: the schema is reviewed, not accreted.
SCHEMA: tuple[str, ...] = (
    # core loop records
    "epoch", "step", "loss", "train_loss", "epoch_seconds",
    # host stage attribution (docs/input_pipeline.md)
    "host_load_seconds", "host_pack_seconds", "host_place_seconds",
    "input_wait_seconds", "input_wait_fraction",
    # sequence-bucketing observables
    "train_examples_per_sec", "train_tokens_per_sec",
    "real_tokens", "padded_tokens", "padding_waste",
    "warmup_signatures", "warmup_compile_seconds",
    "step_signatures/*/compiles", "step_signatures/*/compile_seconds",
    "step_signatures/*/train_steps", "step_signatures/*/eval_steps",
    "jit_lowerings",
    # validation metrics (metric set varies by task)
    "val_*",
    # self-healing observables (docs/resilience.md)
    "resumed_from_step", "skipped_steps", "rollbacks",
    # the obs registry snapshot (this module): input pipeline mirrors,
    # resilience events, lagged step-time decomposition, logging guards
    "obs/input/load_seconds", "obs/input/pack_seconds",
    "obs/input/place_seconds", "obs/input/wait_seconds",
    "obs/input/produced", "obs/input/consumed",
    "obs/input/real_tokens", "obs/input/padded_tokens", "obs/input/rows",
    "obs/resilience/skipped_steps", "obs/resilience/rollbacks",
    "obs/resilience/preemptions", "obs/resilience/watchdog_stalls",
    "obs/resilience/resumed_from_step",
    "obs/step/seconds/count", "obs/step/seconds/mean",
    "obs/step/seconds/max",
    "obs/step/fetch_wait_seconds/count",
    "obs/step/fetch_wait_seconds/mean", "obs/step/fetch_wait_seconds/max",
    "obs/step/dispatch_seconds/count", "obs/step/dispatch_seconds/mean",
    "obs/step/dispatch_seconds/max",
    "obs/logging/nonfinite_dropped", "obs/logging/flatten_collisions",
    "obs/compile/signatures/*",
    # per-device memory stats (obs/xprof.py; CUDA devices only)
    "device_memory/bytes_in_use", "device_memory/peak_bytes_in_use",
    "device_memory/bytes_limit", "device_memory/largest_alloc_size",
    # xprof capture bookkeeping
    "obs/xprof/captures",
    # -- online inference (deepdfa_tpu/serve/, docs/serving.md) --
    # serve_log.jsonl summary record (score/serve CLI, bench_serve)
    "serve_scored", "serve_failed_requests", "serve_seconds",
    "serve_requests_per_sec", "serve_latency_p50_ms",
    "serve_latency_p99_ms", "serve_batch_occupancy_mean",
    "serve_jit_lowerings", "serve_steady_state_recompiles",
    # pipelined execution (docs/serving.md "Pipelined
    # execution"): the configured depth rides the summary record so
    # check_obs_schema can demand pipeline evidence; bench_serve stamps
    # the serial-vs-pipelined comparison + the device-idle fraction
    "serve_pipeline_depth", "serve_device_idle_fraction",
    "serve_serial_req_per_sec", "serve_pipeline_req_per_sec",
    "serve_pipeline_speedup",
    # the serve registry snapshot (batcher/frontend/registry counters)
    "serve/requests", "serve/rejected", "serve/failed", "serve/batches",
    "serve/compiles", "serve/hot_swaps",
    "serve/cache_hits", "serve/cache_misses",
    "serve/queue_depth",
    "serve/batch_occupancy/count", "serve/batch_occupancy/mean",
    "serve/batch_occupancy/max",
    "serve/latency_seconds/count", "serve/latency_seconds/mean",
    "serve/latency_seconds/max",
    "serve/queue_wait_seconds/count", "serve/queue_wait_seconds/mean",
    "serve/queue_wait_seconds/max",
    "serve/device_seconds/count", "serve/device_seconds/mean",
    "serve/device_seconds/max",
    # pipelined execution stages (serve/batcher.py): in-flight depth +
    # per-stage seconds histograms, FIFO-union device busy/idle
    # counters, overlap seconds, idle-fraction gauge — a reviewed
    # wildcard because histogram suffixes expand per field
    "serve/pipeline/*",
    "serve/frontend_seconds/count", "serve/frontend_seconds/mean",
    "serve/frontend_seconds/max",
    # rolling SLO windows (obs/slo.py, docs/slo.md): the summary record
    # embeds the engine snapshot under "serve_slo" — window labels,
    # stages, and observed status codes are data-dependent, so this is
    # a reviewed wildcard (like obs/compile/signatures/*)
    "serve_slo/*",
    # per-request serve_log.jsonl entries (serve.request_log;
    # server.py:RequestLog) — request_id and the string fields ride in
    # the same entry but only scalars become tags
    "request/status", "request/latency_ms", "request/frontend_ms",
    "request/queue_ms", "request/device_ms", "request/batch_size",
    "request/t_unix",
    # backend health observability (obs/health.py): bounded
    # compile-and-execute probes, wedge/fallback events
    "backend/probes", "backend/probe_failures", "backend/probe_retries",
    "backend/wedges", "backend/fallbacks", "backend/healthy",
    "backend/probe_seconds/count", "backend/probe_seconds/mean",
    "backend/probe_seconds/max",
    # -- whole-repo scanning (deepdfa_tpu/scan/, docs/scanning.md) --
    # scan_log.jsonl summary record (scan CLI, bench_scan)
    "scan_files", "scan_files_reused", "scan_functions", "scan_reused",
    "scan_extracted", "scan_scored", "scan_functions_failed",
    "scan_findings", "scan_seconds", "scan_functions_per_sec",
    "scan_incremental_skip_fraction", "scan_cache_hit_fraction",
    "scan_walk_seconds", "scan_split_seconds", "scan_frontend_seconds",
    "scan_score_seconds", "scan_attribute_seconds", "scan_write_seconds",
    "scan_steady_state_recompiles", "scan_lines_steady_state_recompiles",
    # the scan registry snapshot (scan/scanner.py counters + stage
    # histograms)
    "scan/runs", "scan/files", "scan/files_reused", "scan/files_skipped",
    "scan/functions", "scan/functions_reused", "scan/functions_failed",
    "scan/scored", "scan/findings",
    "scan/walk_seconds/count", "scan/walk_seconds/mean",
    "scan/walk_seconds/max",
    "scan/split_seconds/count", "scan/split_seconds/mean",
    "scan/split_seconds/max",
    "scan/frontend_seconds/count", "scan/frontend_seconds/mean",
    "scan/frontend_seconds/max",
    "scan/score_seconds/count", "scan/score_seconds/mean",
    "scan/score_seconds/max",
    "scan/attribute_seconds/count", "scan/attribute_seconds/mean",
    "scan/attribute_seconds/max",
    "scan/write_seconds/count", "scan/write_seconds/mean",
    "scan/write_seconds/max",
    # served line-level localization (serve/localize.py AOT executables)
    "localize/requests", "localize/batches", "localize/compiles",
    "localize/seconds/count", "localize/seconds/mean",
    "localize/seconds/max",
    # -- two-stage cascaded inference + quantized serving executables
    # (serve/cascade.py, serve/quant.py, docs/cascade.md) --
    # the cascade's registry counters/gauges (escalation accounting,
    # stage-2 timing histogram)
    "serve/cascade_requests", "serve/cascade_escalations",
    "serve/cascade_sheds", "serve/cascade_failures",
    "serve/cascade_escalation_rate",
    "serve/cascade_stage2_seconds/count",
    "serve/cascade_stage2_seconds/mean",
    "serve/cascade_stage2_seconds/max",
    # the serve_record "cascade" section (escalation accounting + the
    # stage-2 recompile census) and the bench_cascade record fields
    # (scripts/bench_cascade.py via bench.py --child-cascade; gated in
    # obs/bench_gate.py) — both under reviewed wildcards because the
    # frontier bench carries per-stage sub-records
    "cascade/*", "cascade_*",
    # quantized-entry observables: the per-entry density/drift stamps
    # (registry info, bench records)
    "quant/*", "quant_*",
    # cascade fields on per-request serve_log entries (which stage
    # decided, the screen's prob, the calibrated prob, shed/degrade
    # markers, per-stage ms)
    "request/stage", "request/stage1_prob", "request/calibrated_prob",
    "request/cascade_shed", "request/cascade_failed",
    "request/cascade_stage1_ms", "request/cascade_stage2_ms",
    # Pallas-fused GGNN step (nn/ggnn_kernel.py, docs/ggnn_kernel.md):
    # trace-time lowering census per batch signature — both the obs
    # registry mirror and the epoch-record blob train loops embed when
    # model.ggnn_kernel is on (signature labels are data-dependent, so
    # this is a reviewed wildcard like obs/compile/signatures/*) —
    # plus the whole-unroll fusion's admission counter
    # (ggnn_kernel/fused_fallbacks: a fused request resolved to
    # per_step because the VMEM residency check or the scan_steps
    # gradient policy said no — the layout knob asked for something
    # the kernel refused, which the counter makes loud)
    "ggnn_kernel/*", "obs/ggnn_kernel/*",
    # measured roofline ceilings (eval/profiling.py probes — matmul
    # TFLOP/s, stream + gather GB/s): every probe mirrors its scalar
    # ceiling into a `roofline/<name>` gauge so obs-enabled runs carry
    # the measured ceiling in the run log next to the throughput it
    # defends (docs/roofline.md, docs/ggnn_kernel.md)
    "roofline/*",
    # device efficiency ledger (obs/ledger.py, docs/efficiency.md):
    # per-(tag, signature) cost-analysis flops/bytes/live-bytes,
    # compile counters, rolling MFU/roofline gauges, per-phase HBM
    # watermarks, per-registry-entry param bytes — tag/signature labels
    # are data-dependent, so this is a reviewed wildcard (like
    # obs/compile/signatures/*); the embedded epoch/serve/scan record
    # section flattens under the same prefix
    "ledger/*",
    # crash flight recorder (obs/flight.py): postmortem dump counters,
    # keyed by trigger
    "flight/*",
    # -- serving fleet (deepdfa_tpu/fleet/, docs/fleet.md) --
    # router/admission registry counters + gauges (request/forward/
    # retry/eject/readmit totals, shed counts by reason/tenant/priority,
    # routable-replica gauges) — tenant labels are data-dependent, so
    # this is a reviewed wildcard (like obs/compile/signatures/*); the
    # fleet_log summary record embeds the same snapshot under "fleet"
    "fleet/*",
    # the router's rolling SLO windows (obs/slo.py engine snapshot in
    # fleet_log summary records)
    "fleet_slo/*",
    # fleet_event lifecycle entries in fleet_log.jsonl (join/eject/
    # readmit/drain_observed/gone; fleet/router.py:EVENTS): scalar
    # fields like t_unix/failures/heartbeat_age_s
    "fleet_event/*",
    # per-request fleet_log entries (router request log; the admission
    # fields beyond the serve request/* set). `request/prob` is the
    # replica's calibrated score echoed into the router's log when the
    # alert engine is on — the drift watch's replay signal
    "request/deadline_ms", "request/priority", "request/retries",
    "request/shed", "request/prob",
    # router HA (fleet/ha.py, docs/fleet.md): takeover/stepdown
    # counters, the active-role gauge, measured failover seconds, and
    # the admission re-seed accounting — plus the scalar fields the
    # takeover/stepdown fleet_event entries carry
    "fleet_ha/*",
    # the fleet_log summary record's admission snapshot (token-bucket
    # levels per tenant + the service-time EWMA) — the re-seed source a
    # restarted/failed-over router restores from; tenant labels are
    # data-dependent, so a reviewed wildcard
    "fleet_admission/*",
    # zero-downtime rollout (fleet/rollout.py, docs/fleet.md): the
    # controller's registry counters (swaps/refusals/halts/rollbacks by
    # event name) and the {"rollout": {...}} fleet_log records' scalar
    # fields (t_unix, drift, checkpoint_step, recompiles, guard stats)
    "rollout/*",
    # pluggable coordination backend (fleet/coord.py): poll-exhaustion
    # and fenced-publish counters, plus the FaultableBackend's injected
    # fault counters (coord/faults/<kind>) the chaos drills assert on
    "coord/*",
    # scheduled chaos drills (fleet/drill.py; DRILL_r* records gated in
    # obs/bench_gate.py:gate_drill): round/failure counters and the
    # record's measured recovery-time fields (drill_failover_s,
    # drill_reseed_s, drill_readmit_s, drill_rollback_s, drill_bound_s)
    "drill/*", "drill_*",
    # predictive autoscaling (fleet/autoscale.py): decision counters by
    # action plus the {"autoscale": {...}} fleet_log records' scalar
    # fields (forecast/capacity rates, ratio, replica counts, stage)
    "autoscale/*", "autoscale_*",
    # fleet telemetry plane (obs/aggregate.py, docs/observability.md):
    # snapshot publish/collect counters, staleness gauges, and trace-
    # shipping accounting — plus the aggregated /metrics families'
    # tags (agg/latency_ms, agg/requests, agg/error_rate, agg/stale,
    # agg/snapshot_age_s) the fleet scrape validator checks
    "agg/*",
    # alert engine (obs/alerts.py, docs/alerts.md): evaluation/
    # transition counters, the firing gauge, and the {"alert": {...}}
    # fleet_log records' scalar fields (observed, threshold, for_s,
    # t_unix); fleet_alert_* covers bench/drill alert stamps
    # (alert_mttd_s rides bench records; drill records carry
    # drill_alert_mttd_s under drill_*)
    "alert/*", "fleet_alert_*", "alert_mttd_s",
    # data flywheel (deepdfa_tpu/flywheel/, docs/flywheel.md):
    # shadow/* = sampler/scorer counters-gauges (samples, dropped,
    # windows, regressions, agreement, prob_drift, lag_s) AND the
    # {"shadow": {...}} fleet_log records' scalar fields (t_unix,
    # samples, agreement, auc_candidate/auc_incumbent, lag_s);
    # shadow_* = the bench_load stamps (shadow_agreement,
    # shadow_sample_lag_s, shadow_overhead_fraction — gated in
    # obs/bench_gate.py); flywheel/* = the promotion controller's
    # counters (decisions by outcome); promotion/* and demotion/* =
    # the {"promotion"/"demotion": {...}} records' scalar fields
    "shadow/*", "shadow_*", "flywheel/*", "promotion/*", "demotion/*",
    # federation + alert-evaluation overhead bound (scripts/
    # bench_load.py interleaved reps; ≤2% ABSOLUTE_UPPER_BOUNDS in
    # obs/bench_gate.py)
    "obs_fleet_overhead_fraction",
    # fleet_log summary + bench_load record fields (scripts/
    # bench_load.py, bench.py --child-fleet; gated in obs/bench_gate.py)
    "fleet_replicas", "fleet_requests_per_sec", "fleet_seconds",
    "fleet_offered_rate_per_sec", "fleet_requests_total",
    "fleet_admitted", "fleet_shed", "fleet_shed_rate",
    "fleet_failed_other", "fleet_p99_overload_ms",
    "fleet_latency_p50_ms", "fleet_warm_requests_per_sec",
    "fleet_steady_state_recompiles", "overload_factor",
    "shed_by_tenant/*",
    # unified sharding layer (parallel/sharding.py, docs/sharding.md):
    # mesh/* = the run's topology stamp (non-collapsed axis sizes,
    # device/process counts, logical shards — publish_mesh gauges and
    # the MULTICHIP record's per-mesh-shape sections); shard/* = the
    # per-mesh-shape per-shard efficiency fields derived from the
    # efficiency ledger in dryrun_multichip (per-shard MFU vs ceiling, HBM
    # watermarks, compile seconds) — axis/shape labels are
    # data-dependent, so both are reviewed wildcards
    "mesh/*", "shard/*",
    # bench-record ledger stamps (bench.py, gated in obs/bench_gate.py):
    # per-site MFU-vs-measured-ceiling map, total AOT compile wall time
    # (lower is better), and the interleaved-reps ledger overhead bound;
    # the train child's stamps carry a train_ prefix so the merged
    # record keeps both children's accounting
    "ledger_mfu/*", "compile_seconds_total",
    "train_ledger_mfu/*", "train_compile_seconds_total",
    "obs_ledger_overhead_fraction",
    # ledger-driven autotuner (deepdfa_tpu/tune/, docs/tuning.md):
    # the serve executors' per-rung real/padded row counters + the
    # process-wide waste gauge (the pow2 blind-spot made visible even
    # with tuning off — rung labels are data-dependent, so a reviewed
    # wildcard), and the bench child's stamps (bench.py --child-tune,
    # gated in obs/bench_gate.py: tuned_ggnn_step_us +
    # tuned_ladder_padding_waste lower-is-better, tune_search_seconds
    # absolute-bounded)
    "serve/ladder_waste", "serve/ladder_real_rows",
    "serve/ladder_padded_rows", "serve/ladder/*",
    "tune/*", "tune_*", "tuned_*",
)


def declared(name: str, schema: tuple[str, ...] = SCHEMA) -> bool:
    """Is a flattened scalar tag covered by the declared schema?"""
    return any(fnmatch.fnmatchcase(name, pat) for pat in schema)


def undeclared_tags(records, schema: tuple[str, ...] = SCHEMA) -> list[str]:
    """Flatten run-log records the exact way RunLogger does and return
    every tag no schema pattern covers (sorted, deduped)."""
    bad: set[str] = set()
    for rec in records:
        for tag in flatten_scalars(rec):
            if not declared(tag, schema):
                bad.add(tag)
    return sorted(bad)


def publish_pipeline_stats(stats, registry: MetricsRegistry = None) -> None:
    """Absorb a PipelineStats epoch into the registry (cumulative across
    epochs — counters, not gauges, so multi-epoch runs aggregate)."""
    r = registry if registry is not None else REGISTRY
    r.counter("obs/input/load_seconds").inc(stats.load_seconds)
    r.counter("obs/input/pack_seconds").inc(stats.pack_seconds)
    r.counter("obs/input/place_seconds").inc(stats.place_seconds)
    r.counter("obs/input/wait_seconds").inc(stats.wait_seconds)
    r.counter("obs/input/produced").inc(stats.produced)
    r.counter("obs/input/consumed").inc(stats.consumed)
    if stats.padded_tokens:
        r.counter("obs/input/real_tokens").inc(stats.real_tokens)
        r.counter("obs/input/padded_tokens").inc(stats.padded_tokens)
        r.counter("obs/input/rows").inc(stats.rows)


# ---------------------------------------------------------------------------
# run-log flattening (the reference's train/logging.py:flatten_scalars)


def flatten_scalars(record: dict, prefix: str = "") -> dict[str, float]:
    """Flatten nested dict records into slash-keyed scalar pairs (the
    ONE place that mapping is defined). A literal ``"a/b"`` key and a
    nested ``{"a": {"b": ...}}`` flatten to the same tag: last write
    wins, and every collision is counted
    (``obs/logging/flatten_collisions``)."""
    out: dict[str, float] = {}
    for k, v in record.items():
        if isinstance(v, dict):
            for fk, fv in flatten_scalars(v, f"{prefix}{k}/").items():
                _put(out, fk, fv)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            _put(out, f"{prefix}{k}", float(v))
    return out


def _put(out: dict[str, float], key: str, value: float) -> None:
    if key in out:
        REGISTRY.counter("obs/logging/flatten_collisions").inc()
    out[key] = value
