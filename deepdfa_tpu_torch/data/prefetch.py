"""Background batch prefetch (the port's copy of the reference's
`deepdfa_tpu/data/prefetch.py`): host batch assembly and the host-to-
device copy overlap the training step.

A bounded pool of producer threads pulls batches from the source (numpy
packing, which releases the GIL in its heavy parts) and, when a `place`
function is given, places each one on the card in the producer, as the
reference's producers run `jax.device_put`: `DevicePlacer` copies the
batch into page-locked host memory and from there to the card with
`non_blocking=True` on a side CUDA stream, recording an event after the
copy. The consumer (`DevicePlacer.receive`, on the training thread)
makes the training stream wait on that event and `record_stream`s every
tensor onto it, so the caching allocator never hands a batch's memory
out again while a step still reads it. CPU-bound first-epoch packing
goes to processes instead (data/mp_pack.py).

Semantics guarantee: a pure reordering in time. The consumer sees
exactly the same elements in exactly the same order as iterating the
source directly, with any number of producers, so step counts and
losses are unchanged (tests/test_torch_input_pipeline.py).

Stage instrumentation: pass a `PipelineStats` and each stage's wall
time accumulates into it: `load`/`pack` (source pulls, by
`source_stage`), `place` (the host-to-device copy), `wait` (the
consumer blocked on the queue). The train loops report them per epoch.
Each stage is also a cat="input" span of the unified trace
(obs/trace.py; a shared no-op unless tracing is on), named as the
reference names them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Iterable, Iterator, TypeVar

import torch

from deepdfa_tpu_torch.obs import trace as obs_trace

T = TypeVar("T")

#: producer threads poll the stop flag at this period when blocked; the
#: abandon path joins them with a small multiple of it
_POLL = 0.1
_JOIN_TIMEOUT = 2.0


@dataclasses.dataclass
class PipelineStats:
    """Per-stage wall-time counters of the host input pipeline, in
    cumulative seconds summed over producer threads (with overlap they
    can exceed wall-clock):

    - `load_seconds`: reading pre-packed batches (cache replay) — source
      pulls when `source_stage="load"`;
    - `pack_seconds`: live batch assembly — source pulls when
      `source_stage="pack"` (the default);
    - `place_seconds`: the host-to-device copy (pinning and enqueueing);
    - `wait_seconds`: the consumer blocked waiting for the next batch.

    Text-batch consumers call `add_tokens` per batch, so epoch records
    can report real-token throughput and `padding_waste`."""

    load_seconds: float = 0.0
    pack_seconds: float = 0.0
    place_seconds: float = 0.0
    wait_seconds: float = 0.0
    produced: int = 0
    consumed: int = 0
    real_tokens: int = 0
    padded_tokens: int = 0
    rows: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()

    def add(self, stage: str, seconds: float, produced: int = 0) -> None:
        with self._lock:
            setattr(self, f"{stage}_seconds", getattr(self, f"{stage}_seconds") + seconds)
            self.produced += produced

    def add_tokens(self, real: int, padded: int, rows: int = 0) -> None:
        """Account one text batch: `real` non-pad tokens in valid rows,
        `padded` token slots of its static shape, `rows` valid rows."""
        with self._lock:
            self.real_tokens += int(real)
            self.padded_tokens += int(padded)
            self.rows += int(rows)

    def padding_waste(self) -> float:
        """1 - real/padded: the share of computed token slots that hold
        padding (0.0 when no tokens were accounted)."""
        if self.padded_tokens <= 0:
            return 0.0
        return 1.0 - self.real_tokens / self.padded_tokens

    def wait_fraction(self, total_seconds: float) -> float:
        """The share of a consumer's wall-clock spent blocked on input."""
        return self.wait_seconds / total_seconds if total_seconds > 0 else 0.0

    def record(self) -> dict[str, float]:
        out = {
            "load_seconds": round(self.load_seconds, 4),
            "pack_seconds": round(self.pack_seconds, 4),
            "place_seconds": round(self.place_seconds, 4),
            "wait_seconds": round(self.wait_seconds, 4),
            "produced": self.produced,
            "consumed": self.consumed,
        }
        if self.padded_tokens:
            out.update(real_tokens=self.real_tokens, padded_tokens=self.padded_tokens,
                       rows=self.rows, padding_waste=round(self.padding_waste(), 4))
        return out


def prefetch(
    source: Iterable[T],
    size: int = 2,
    place: Callable[[T], Any] | None = None,
    producers: int = 1,
    stats: PipelineStats | None = None,
    source_stage: str = "pack",
) -> Iterator:
    """Iterate `source` through a `size`-deep background pipeline.

    place: optional callable run in a producer thread on each element;
    its result is what the consumer receives. Exceptions from the source
    or from `place` re-raise at the consumer's next pull, in source
    order. `size <= 0` iterates inline (the knob's off position), still
    through `place`.

    producers: worker threads. Source pulls are serialized (one
    iterator); `place` runs concurrently. Output order is the source
    order regardless.

    Abandoning the iterator (break / close) stops and joins the producer
    threads, so no background thread outlives the consumer.
    """
    if source_stage not in ("pack", "load"):
        raise ValueError(f"source_stage={source_stage!r}")
    if stats is None:
        stats = PipelineStats()
    if size <= 0:
        it = iter(source)
        while True:
            t0 = time.perf_counter()
            with obs_trace.span(source_stage, cat="input"):
                try:
                    item = next(it)
                except StopIteration:
                    return
            stats.add(source_stage, time.perf_counter() - t0, produced=1)
            if place is not None:
                t0 = time.perf_counter()
                with obs_trace.span("place", cat="input"):
                    item = place(item)
                stats.add("place", time.perf_counter() - t0)
            stats.consumed += 1
            yield item

    src_iter = iter(source)
    src_lock = threading.Lock()
    cond = threading.Condition()
    buf: dict[int, Any] = {}
    state = {
        "next_in": 0,  # next index a producer will pull (under src_lock)
        "next_out": 0,  # next index the consumer yields (under cond)
        "done_at": None,  # source length once exhausted
        "error": None,  # first failure, re-raised in source order
        "stop": False,
    }
    ahead = max(1, size)

    def producer() -> None:
        while True:
            if state["stop"]:
                return
            # bounded run-ahead, gated at the CLAIM: a claimed item is
            # pulled and placed before it reaches buf, so gating only the
            # insert would let every producer hold one more placed batch
            # beyond the `size` bound
            with cond:
                while (not state["stop"] and state["done_at"] is None
                       and state["error"] is None
                       and state["next_in"] >= state["next_out"] + ahead):
                    cond.wait(_POLL)
            with src_lock:
                if state["stop"] or state["done_at"] is not None or state["error"] is not None:
                    return
                if state["next_in"] >= state["next_out"] + ahead:
                    continue  # another producer claimed the slot: re-wait
                idx = state["next_in"]
                t0 = time.perf_counter()
                try:
                    with obs_trace.span(source_stage, cat="input"):
                        item = next(src_iter)
                except StopIteration:
                    with cond:
                        state["done_at"] = idx
                        cond.notify_all()
                    return
                except BaseException as e:
                    with cond:
                        if state["error"] is None:
                            state["error"] = (idx, e)
                        cond.notify_all()
                    return
                state["next_in"] = idx + 1
                stats.add(source_stage, time.perf_counter() - t0, produced=1)
            if place is not None:
                try:
                    t0 = time.perf_counter()
                    with obs_trace.span("place", cat="input"):
                        item = place(item)
                    stats.add("place", time.perf_counter() - t0)
                except BaseException as e:
                    with cond:
                        if state["error"] is None or state["error"][0] > idx:
                            state["error"] = (idx, e)
                        cond.notify_all()
                    return
            with cond:
                # idx was claimed inside the run-ahead window and next_out
                # only grows, so the insert never needs to wait
                if state["stop"]:
                    return
                buf[idx] = item
                cond.notify_all()

    threads = [threading.Thread(target=producer, daemon=True, name=f"batch-prefetch-{i}")
               for i in range(max(1, int(producers)))]
    for t in threads:
        t.start()

    try:
        while True:
            with obs_trace.span("wait", cat="input"), cond:
                t0 = time.perf_counter()
                while True:
                    nxt = state["next_out"]
                    if nxt in buf:
                        item = buf.pop(nxt)
                        state["next_out"] = nxt + 1
                        cond.notify_all()
                        break
                    # if the failure hit nxt (or earlier), no producer will
                    # ever deliver it: re-raise
                    err = state["error"]
                    if err is not None and err[0] <= nxt:
                        stats.add("wait", time.perf_counter() - t0)
                        raise err[1]
                    if state["done_at"] is not None and nxt >= state["done_at"]:
                        stats.add("wait", time.perf_counter() - t0)
                        return
                    cond.wait(_POLL)
                stats.add("wait", time.perf_counter() - t0)
            stats.consumed += 1
            yield item
    finally:
        state["stop"] = True
        with cond:
            buf.clear()  # drop references so placed batches free promptly
            cond.notify_all()
        for t in threads:
            # a producer blocks only in bounded cond polls or a source
            # pull; a daemon thread stuck in the source dies with the
            # process
            t.join(timeout=_JOIN_TIMEOUT)


@dataclasses.dataclass
class PlacedBatch:
    """A batch whose host-to-device copy was enqueued on a side stream:
    the device batch, the event recorded after its copy, and the pinned
    host batch it was copied from."""

    batch: Any
    event: Any
    host: Any


def _tensors(batch) -> Iterator[torch.Tensor]:
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v)


class DevicePlacer:
    """The `place` of the port's prefetch pipeline for GraphBatch and
    TextBatch, and its consumer half.

    On a CUDA device, `place` (a producer thread) copies the host batch
    into page-locked memory, then to the card with `non_blocking=True`
    on a side stream, and records an event after the copy; `receive`
    (the training thread) makes the current stream wait on that event
    and `record_stream`s each tensor onto it. On the CPU, and for a batch
    whose arrays are tensors already, `place` is `batch.to(device)` and
    `receive` the identity."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, batch):
        if self._stream is None or next(_tensors(batch), None) is not None:
            return batch.to(self.device)  # the CPU, or tensors already placed
        host = batch.pinned()
        with torch.cuda.stream(self._stream):
            moved = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return PlacedBatch(moved, event, host)

    def receive(self, item):
        if not isinstance(item, PlacedBatch):
            return item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(item.event)
        for t in _tensors(item.batch):
            t.record_stream(current)
        return item.batch
