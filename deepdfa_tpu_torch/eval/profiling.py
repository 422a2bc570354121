"""FLOPs + latency profiling of a model call (the port of the reference's
`deepdfa_tpu/eval/profiling.py`; the paper's Table 5: GFLOPs and
ms per example, aggregated by `aggregate_report`).

- FLOPs: `compiled_cost` (the reference's name) is the counted cost of
  one call, read through the one cost reader
  (obs/ledger.py:read_cost_analysis over obs/cost.py): the hand-written
  kernels' work formulas plus FlopCounterMode's count of the aten ops
  between them, the same on the CPU and on the card;
- latency: `time_fn`, CUDA events around each call after warm-up on the
  card (the host clock on the CPU);
- records append to jsonl (`ProfileWriter`), and `aggregate_report`
  reproduces the GFLOPs / ms-per-example summary;
- `xprof_trace` wraps `torch.profiler` and writes a Chrome trace whose
  device lanes name the port's CUDA kernels;
- `measure_matmul_ceiling`, `measure_hbm_bandwidth` and
  `measure_gather_bandwidth` measure the current card (a chained
  `torch.matmul`, a streaming update, an `index_select` + segment sum):
  they measure the card and port no kernel.
"""

from __future__ import annotations

import contextlib as _contextlib
import json
import time
from pathlib import Path

import numpy as np


def _cuda_args(args) -> bool:
    import torch

    def walk(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                yield from walk(y)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                yield from walk(getattr(x, name))

    return any(t.is_cuda for a in args for t in walk(a))


def _sync(cuda: bool) -> None:
    if cuda:
        import torch

        torch.cuda.synchronize()


def compiled_cost(fn, *args, ledger_tag: str | None = None,
                  ledger_signature: str | None = None,
                  aten_precision: str = "fp32") -> dict:
    """The counted cost of one call of `fn(*args)`: {"flops",
    "bytes_accessed", "flops_by_precision", "cost_analysis"} through the
    one reader (obs/ledger.py:read_cost_analysis). With `ledger_tag` set
    and the ledger enabled, the call is also booked as a ledger site
    (its cost, wall seconds and peak memory)."""
    from deepdfa_tpu_torch.obs import cost, ledger as obs_ledger

    cuda = _cuda_args(args)
    with obs_ledger.PeakMemory(cuda) as mem:
        t0 = time.perf_counter()
        _, counted = cost.count_cost(fn, *args, aten_precision=aten_precision)
        _sync(cuda)
        dt = time.perf_counter() - t0
    if ledger_tag is not None:
        obs_ledger.record_compile(ledger_tag, ledger_signature or "default", counted, dt,
                                  live_bytes=mem.live_bytes)
    return obs_ledger.read_cost_analysis(counted)


def time_fn(fn, *args, warmup: int = 3, iters: int = 20) -> dict:
    """Steady-state time (seconds) of `fn(*args)` after `warmup` calls:
    on the card the device time between CUDA events around each call
    (the events are read after the last call; no synchronize between
    calls), on the CPU the host clock around each call."""
    import torch

    cuda = _cuda_args(args)
    for _ in range(warmup):
        fn(*args)
    _sync(cuda)
    times = []
    if cuda:
        pairs = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) / 1e3 for s, e in pairs]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    t = np.array(times)
    return {
        "mean_s": float(t.mean()),
        "p50_s": float(np.percentile(t, 50)),
        "p95_s": float(np.percentile(t, 95)),
        "iters": iters,
    }


class ProfileWriter:
    """Append profiling records to a jsonl file (the reference's
    profiledata.jsonl / timedata.jsonl)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: dict) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps(record) + "\n")


def profile_model(fn, args, examples_per_call: int, out_path=None,
                  aten_precision: str = "fp32") -> dict:
    """One-stop profile: FLOPs + latency, normalized per example (Table
    5's record)."""
    cost = compiled_cost(fn, *args, aten_precision=aten_precision)
    timing = time_fn(fn, *args)
    record = {
        "examples_per_call": examples_per_call,
        "gflops_per_call": cost["flops"] / 1e9,
        "gflops_per_example": cost["flops"] / 1e9 / examples_per_call,
        "ms_per_call": timing["mean_s"] * 1e3,
        "ms_per_example": timing["mean_s"] * 1e3 / examples_per_call,
        "p95_ms_per_call": timing["p95_s"] * 1e3,
        "bytes_accessed": cost["bytes_accessed"],
    }
    if out_path is not None:
        ProfileWriter(out_path).write(record)
    return record


def aggregate_report(jsonl_path: str | Path) -> dict:
    """Aggregate a profile jsonl into the Table-5-style summary."""
    records = [
        json.loads(line)
        for line in Path(jsonl_path).read_text().splitlines()
        if line.strip()
    ]
    if not records:
        return {}
    n = sum(r["examples_per_call"] for r in records)
    return {
        "records": len(records),
        "total_examples": n,
        "total_gflops": sum(r["gflops_per_call"] for r in records),
        "avg_gflops_per_example": float(np.mean([r["gflops_per_example"] for r in records])),
        "avg_ms_per_example": float(np.mean([r["ms_per_example"] for r in records])),
    }


@_contextlib.contextmanager
def xprof_trace(log_dir: str | Path):
    """`torch.profiler` over the block (CPU, and CUDA where the card is
    there); writes `<log_dir>/trace.json`, a Chrome trace whose device
    lanes name each kernel launched (the reference's xprof dump)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _roofline_gauge(fields: dict) -> dict:
    """Mirror a probe's scalar ceilings into the obs registry as
    `roofline/<name>` gauges (declared in obs/metrics.py:SCHEMA)."""
    from deepdfa_tpu_torch.obs import metrics as obs_metrics

    for k, v in fields.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            obs_metrics.REGISTRY.gauge(f"roofline/{k}").set(v)
    return fields


def _device():
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _best_rate(run, work: float, reps: int) -> float:
    """work / the fastest of `reps` timed calls of `run` (after one
    warm-up), each bounded by a synchronize on the card."""
    import torch

    cuda = torch.cuda.is_available()
    run()
    _sync(cuda)
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(cuda)
        best = max(best, work / (time.perf_counter() - t0))
    return best


def measure_matmul_ceiling(n: int = 4096, chain: int = 8, reps: int = 3,
                           dtype: str = "bfloat16") -> dict:
    """Measured dense-matmul FLOP/s on the current device: a chain of
    [n, n] @ [n, n] products (`torch.matmul`, TF32 off for float32), the
    densest work the card schedules; the ceiling MFU is read against. A
    point sample of this moment's card, not a bound."""
    import torch

    dt = getattr(torch, dtype)
    dev = _device()
    a = torch.ones((n, n), dtype=dt, device=dev)
    b = torch.ones((n, n), dtype=dt, device=dev)
    inv = 1.0 / n
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def run():
        x = a
        for _ in range(chain):
            x = (x @ b) * inv
        return x

    try:
        best = _best_rate(run, chain * 2 * n ** 3, reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return _roofline_gauge({
        "matmul_tflops_measured": round(best / 1e12, 2),
        "matmul_probe": f"{chain}x({n}x{n}@{n}x{n}) {dtype}",
    })


def measure_hbm_bandwidth(mb: int = 256, chain: int = 8, reps: int = 3) -> dict:
    """Measured streaming device-memory bandwidth (GB/s): a chained
    x = x * c + 1 over a large fp32 array, each link reading and writing
    it whole."""
    import torch

    n = mb * (1 << 20) // 4
    x = torch.ones((n,), dtype=torch.float32, device=_device())

    def run():
        y = x
        for _ in range(chain):
            y = y * 0.999 + 1.0
        return y

    best = _best_rate(run, chain * 2 * n * 4, reps)
    return _roofline_gauge({
        "hbm_gbps_measured": round(best / 1e9, 1),
        "hbm_probe": f"{chain}x stream-rw {mb}MiB f32",
    })


def measure_gather_bandwidth(rows: int = 16384, dim: int = 128, idx_len: int = 65536,
                             chain: int = 8, reps: int = 3) -> dict:
    """Measured gather + sorted segment-sum bandwidth at the GGNN's access
    shape (a [rows, dim] fp32 table, idx_len edges): `index_select` by
    source, then `index_add_` by sorted destination, plus the residual
    update, each link; bytes as the reference counts them."""
    import torch

    dev = _device()
    gen = torch.Generator().manual_seed(0)
    table = torch.ones((rows, dim), dtype=torch.float32, device=dev)
    src = torch.randint(0, rows, (idx_len,), generator=gen).to(dev)
    dst = torch.sort(torch.randint(0, rows, (idx_len,), generator=gen)).values.to(dev)

    def run():
        t = table
        for _ in range(chain):
            msg = t.index_select(0, src)
            t = torch.zeros_like(t).index_add_(0, dst, msg) * (1.0 / idx_len) + t * 0.5
        return t

    link_bytes = (3 * idx_len + 3 * rows) * dim * 4
    best = _best_rate(run, chain * link_bytes, reps)
    return _roofline_gauge({
        "gather_gbps_measured": round(best / 1e9, 1),
        "gather_probe": f"{chain}x gather+sorted-segsum [{rows},{dim}]f32 idx={idx_len}",
    })
