"""Dynamic request batcher over bucket signatures (the reference's
`deepdfa_tpu/serve/batcher.py`).

- a BOUNDED queue with admission control: a full queue raises
  `QueueFull` instead of buffering unbounded latency;
- requests group by bucket key and a chunk holds as many as fit the
  executor's budgets;
- a max-latency flush: a partial batch executes once its oldest request
  has waited `max_batch_delay_s`;
- pipelined execution (`pipeline_depth > 0`): a batch's pack, dispatch
  and fetch stages split, so the host packs and launches the next batch
  while the card runs this one, with at most `pipeline_depth` batches
  dispatched and not yet fetched (`DynamicBatcher`). At every depth the
  scores are bit-identical to depth 0 for the same batches: the same
  kernels run on the same shapes; only the sync point moves. (The flush
  timer forms batches at the host's pace in either drive, and a batch's
  composition moves a score by fp32 reassociation.)

The executors' stages do not sync the card until `fetch`: `pack_chunk`
packs into page-locked host memory on a CUDA device, `dispatch` copies
the batch with `non_blocking=True`, launches the model, copies the
probabilities into a pinned buffer and records a CUDA event
(`DeviceResult`), and `fetch` waits on that event alone, where a
`.cpu()` would wait for the whole stream. The handle keeps the batch's
host buffers and the model it ran alive until then, so a pinned buffer
is never reused under its copy and a hot swap between dispatch and
fetch mixes nothing.

Executors read their model through a callable on every batch (the
registry's `model`), so a hot swap is one reference assignment: a batch
runs the old weights or the new ones, never a mix. `on_batch` is called
once before every executed batch (the registry's hot-swap poll).

Two executors: `GgnnExecutor` (graph requests, all co-batchable; each
chunk pads to the smallest ladder size 1, 2, 4, ..., max_batch_graphs,
or of a tuned rung set, that holds it) and `CombinedExecutor` (text +
graph requests of the combined families, DeepDFA+LineVul or
CodeT5+DeepDFA, grouped by sequence bucket; each chunk pads to its
bucket's full row count).

A request's score does not depend on what it was batched with beyond
fp32 reassociation: padding slots are masked out of every reduction and
per-graph compute is independent.

With the efficiency ledger on (obs/ledger.py, `obs.ledger`) each
executor books its warm-up rungs as sites (`ledger_tag`, "G{size}" or
"T{T}xR{rows}": the warm-up call's counted cost, seconds and peak
memory) and each batch as an execution of its rung, timed by CUDA
events around the model call and read at `fetch`, after its sync.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.data.text import _fit_width, collate, rows_for_bucket, token_lengths
from deepdfa_tpu_torch.graphs.batch import NUM_SUBKEY_FEATS, pack
from deepdfa_tpu_torch.obs import cost as obs_cost, ledger as obs_ledger
from deepdfa_tpu_torch.obs.xprof import EventWindow

logger = logging.getLogger(__name__)

_req_ids = itertools.count()


def new_request_id() -> str:
    """A process-unique request id assigned at ingress ("<pid hex>-<seq
    hex>", the reference's rule): echoed in `/score` responses, score
    rows and serve_log.jsonl entries."""
    return f"{os.getpid():x}-{next(_req_ids):x}"


def model_source(model, device: torch.device) -> Callable[[], torch.nn.Module]:
    """A callable giving the model on every batch: `model` itself when it
    is one (moved to `device` and put in eval mode once), else `model`,
    a callable that already gives an eval-mode module on `device` (the
    registry's `model`)."""
    if isinstance(model, torch.nn.Module):
        module = model.to(device).eval()
        return lambda: module
    return model


class DeviceWindow:
    """FIFO union attribution of device-busy time over dispatch->sync
    windows that may overlap under pipelining (the reference's).

    With batches dispatched back to back, batch i's raw window includes
    time spent queued behind batch i-1 on the card; since fetches sync in
    FIFO order, the busy interval attributable to batch i is
    `[max(submit_i, sync_{i-1}), sync_i]`. At depth 0 `sync_{i-1} <=
    submit_i` always holds and the busy window is the plain
    dispatch->sync time, so one accounting serves both paths. The gap
    `max(0, submit_i - sync_{i-1})` is device-idle time: the overlap gap
    the pipeline exists to close."""

    def __init__(self):
        self.last_sync: float | None = None
        self.busy_s = 0.0
        self.idle_s = 0.0

    def observe(self, t_submit: float, t_sync: float) -> float:
        """Fold one dispatch->sync window in; returns its busy share."""
        last = self.last_sync
        start = t_submit if last is None else max(t_submit, last)
        busy = max(0.0, t_sync - start)
        if last is not None:
            self.idle_s += max(0.0, t_submit - last)
        self.busy_s += busy
        self.last_sync = max(t_sync, last or t_sync)
        return busy

    def idle_fraction(self) -> float | None:
        total = self.busy_s + self.idle_s
        return (self.idle_s / total) if total > 0.0 else None


class DeviceResult:
    """One dispatched batch's outputs on their way to the host. On a
    CUDA device each output is copied into a page-locked host buffer
    with `non_blocking=True` and a CUDA event is recorded after the
    copies; `wait()` waits on that event alone and returns the host
    tensors. `keep` (the batch's host and device buffers, the model)
    stays referenced until then. On the CPU the outputs are the host
    tensors already."""

    def __init__(self, outputs: tuple[torch.Tensor, ...], keep: tuple = ()):
        if outputs[0].is_cuda:
            self._host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                               for o in outputs)
            for h, o in zip(self._host, outputs):
                h.copy_(o, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = outputs, None
        self._keep = keep

    def wait(self) -> tuple[torch.Tensor, ...]:
        if self._event is not None:
            self._event.synchronize()
        self._keep = ()
        return self._host


def _ledger_warm(tag: str, sig: str, device: torch.device, run) -> float:
    """Run one warm-up call `run()`; with the ledger on, counted and
    booked as the site's warm-up. Its wall seconds."""
    if not obs_ledger.enabled():
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    with obs_ledger.PeakMemory(device.type == "cuda") as mem:
        t0 = time.perf_counter()
        _, counted = obs_cost.count_cost(run)
        dt = time.perf_counter() - t0
    obs_ledger.record_compile(tag, sig, counted, dt, live_bytes=mem.live_bytes)
    return dt


def _ledger_window(device: torch.device) -> EventWindow | None:
    """A started device window around a batch's model call when the
    ledger is on."""
    return EventWindow(device.type == "cuda").start() if obs_ledger.enabled() else None


def _ledger_observe(tag: str, handle: DeviceResult) -> None:
    """After a batch's sync: its window's device seconds to the ledger."""
    window = getattr(handle, "ledger_window", None)
    if window is not None:
        obs_ledger.observe_execution(tag, handle.ledger_sig, window.seconds())


def host_batch(batch, device: torch.device):
    """A packed batch as the dispatch stage copies it: in page-locked
    memory for a CUDA device, the numpy arrays otherwise."""
    return batch.pinned() if device.type == "cuda" else batch


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is at queue_limit."""


class RequestTooLarge(ValueError):
    """The request alone exceeds the serving batch budgets."""


@dataclasses.dataclass
class ScoreRequest:
    """One in-flight scoring request (a thread-safe future) and its stage
    attribution: `frontend_s` extraction seconds (measured by the
    caller), `queue_wait_s` from submit to its batch's start, `device_s`
    its batch's dispatch to fetch, `batch_size` how many requests shared
    that batch."""

    payload: Any
    id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    request_id: str = dataclasses.field(default_factory=new_request_id)
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: float | None = None
    error: Exception | None = None
    latency_s: float | None = None
    frontend_s: float | None = None
    queue_wait_s: float | None = None
    device_s: float | None = None
    batch_size: int | None = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def set_result(self, value: float) -> None:
        self.result = value
        self.latency_s = time.monotonic() - self.t_submit
        self._done.set()

    def set_error(self, exc: Exception) -> None:
        self.error = exc
        self.latency_s = time.monotonic() - self.t_submit
        self._done.set()

    def wait(self, timeout: float | None = None) -> float:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not scored in {timeout}s")
        if self.error is not None:
            raise self.error
        return float(self.result)


def percentile(sorted_vals: Sequence[float], p: float) -> float | None:
    """Upper-biased quantile over a pre-sorted sample; None when empty
    (the reference's rule, obs/slo.py)."""
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(p * len(sorted_vals)))]


def _pow2_sizes(max_size: int) -> tuple[int, ...]:
    """The batch-size ladder: 1, 2, 4, ..., max (max included even when
    not a power of two — it is the capacity the scheduler fills to)."""
    sizes = []
    s = 1
    while s < max_size:
        sizes.append(s)
        s *= 2
    sizes.append(max_size)
    return tuple(sorted(set(sizes)))


def _ladder_sizes(ladder: Sequence[int] | None, capacity: int) -> tuple[int, ...]:
    """An executor's rungs (the reference's `_ladder_sizes`): a tuned
    rung set clamped to [1, capacity] with the capacity always present,
    so every legal chunk fits a warmed rung; else the pow2 ladder."""
    capacity = int(capacity)
    if not ladder:
        return _pow2_sizes(capacity)
    rungs = sorted({int(s) for s in ladder if 1 <= int(s) <= capacity})
    if not rungs or rungs[-1] != capacity:
        rungs.append(capacity)
    return tuple(rungs)


class GgnnExecutor:
    """Scores chunks of `GraphSpec`s with a DeepDFA model on one device.

    Capacity is bounded by `max_batch_graphs` AND the packed node/edge
    budgets; each chunk pads to the smallest ladder size >= its row
    count: the pow2 ladder, or the tuned rungs `ladder` (tune/ladder.py,
    clamped to the capacity). `model` is a module, moved to `device`
    (default "cuda", which raises when CUDA is unavailable) and put in
    eval mode, or a callable read on every batch (`model_source`)."""

    def __init__(
        self,
        model: torch.nn.Module | Callable[[], torch.nn.Module],
        node_budget: int,
        edge_budget: int,
        max_batch_graphs: int = 16,
        etypes: bool = False,
        device: str | torch.device | None = None,
        ladder: Sequence[int] | None = None,
        feat_width: int | None = None,
    ):
        self.device = resolve_device(device)
        self._model = model_source(model, self.device)
        self.node_budget = int(node_budget)
        self.edge_budget = int(edge_budget)
        self.sizes = _ladder_sizes(ladder, int(max_batch_graphs))
        self.etypes = bool(etypes)
        # node_feats columns: 4, or 9 for a struct_feats model
        self.feat_width = NUM_SUBKEY_FEATS if feat_width is None else int(feat_width)
        self._warmed: set[int] = set()

    #: the efficiency ledger's site tag of this executor's rungs
    ledger_tag = "serve_score"

    @property
    def model(self) -> torch.nn.Module:
        """The model the next batch runs."""
        return self._model()

    def signatures(self) -> list[tuple[int]]:
        """(graphs,) of every warmed ladder rung."""
        return [(s,) for s in self.sizes]

    # -- grouping ------------------------------------------------------------

    def admit(self, spec) -> None:
        """Reject requests that can never fit a serving batch alone."""
        edges = spec.num_edges + spec.num_nodes  # + self loops
        if spec.num_nodes > self.node_budget or edges > self.edge_budget:
            raise RequestTooLarge(
                f"graph has {spec.num_nodes} nodes / {edges} edges "
                f"(incl. self loops); serving budgets are "
                f"{self.node_budget}/{self.edge_budget} "
                f"(raise serve.node_budget/serve.edge_budget)"
            )

    def bucket_key(self, spec) -> Hashable:
        return "graph"

    def capacity(self, key: Hashable) -> int:
        return self.sizes[-1]

    def fits(self, key: Hashable, chunk: Sequence, spec) -> bool:
        """Would adding `spec` keep the chunk inside the pack budgets?"""
        nodes = sum(s.num_nodes for s in chunk) + spec.num_nodes
        edges = (
            sum(s.num_edges + s.num_nodes for s in chunk)
            + spec.num_edges + spec.num_nodes
        )
        return nodes <= self.node_budget and edges <= self.edge_budget

    def _size_for(self, n: int) -> int:
        for s in self.sizes:
            if s >= n:
                return s
        return self.sizes[-1]

    def warmup(self) -> dict[str, float]:
        """Run every ladder size once on its all-padding batch (the first
        run builds the CUDA kernel); {signature label: seconds}.
        Idempotent."""
        report: dict[str, float] = {}
        for size in self.sizes:
            if size in self._warmed:
                continue
            report[f"G{size}"] = _ledger_warm(
                self.ledger_tag, f"G{size}", self.device,
                lambda: self.fetch(self.dispatch(
                    "graph", (size, host_batch(self._pack(size, []), self.device)), warm=True),
                    size))
            self._warmed.add(size)
        obs_ledger.record_memory("warmup")
        return report

    # -- execution (pack -> dispatch -> fetch) --------------------------------

    def _pack(self, size: int, specs: Sequence):
        return pack(
            list(specs), size, self.node_budget, self.edge_budget,
            feat_width=self.feat_width, etypes=self.etypes,
        )

    def pack_chunk(self, key: Hashable, chunk: Sequence):
        """Host pack into the padded ladder batch (page-locked on a CUDA
        device); (signature label, packed)."""
        size = self._size_for(len(chunk))
        return f"G{size}", (size, host_batch(self._pack(size, chunk), self.device))

    def dispatch(self, key: Hashable, packed, warm: bool = False) -> DeviceResult:
        """Copy the batch to the device and launch the model; returns the
        probabilities' `DeviceResult` without waiting for the device.
        With the ledger on (and not `warm`), the model call is timed."""
        size, batch = packed
        model = self._model()
        b = batch.to(self.device, non_blocking=True)
        window = None if warm else _ledger_window(self.device)
        with torch.inference_mode():
            probs = torch.sigmoid(model(b))
        if window is not None:
            window.stop()
        result = DeviceResult((probs,), keep=(batch, b, model))
        if window is not None:
            result.ledger_window, result.ledger_sig = window, f"G{size}"
        return result

    def fetch(self, handle: DeviceResult, n: int) -> np.ndarray:
        """The sync point: [n] probabilities on the host."""
        out = handle.wait()[0][:n].numpy()
        _ledger_observe(self.ledger_tag, handle)
        return out


class CombinedExecutor:
    """Scores (token_ids, GraphSpec | None) payloads with a
    `CombinedModel` or a `DefectModel` (the T5 family: the reference's
    `is_t5` branch, which changes only the forward) on one device (the
    reference's `CombinedExecutor`). The tokenizer must pad with the
    encoder's pad id (1 for RoBERTa, 0 for T5's frame).

    Requests group by their sequence bucket edge T (the smallest of
    `seq_buckets` >= the real token length); a bucket's signature is
    (T, rows, rows) with rows = rows_for_bucket(T, token_budget), and
    every chunk pads to all `rows` rows, so a request scores on the same
    padded shape alone or co-batched. The budget accounting of `admit`
    and `fits` is `collate`'s, so an admitted chunk degrades no row to
    has_graph=False. The model is moved to `device` (default "cuda",
    which raises when CUDA is unavailable) and put in eval mode, or is a
    callable read on every batch (`model_source`)."""

    def __init__(
        self,
        model: torch.nn.Module | Callable[[], torch.nn.Module],
        tokenizer,
        seq_buckets: Sequence[int],
        token_budget: int,
        node_budget: int,
        edge_budget: int,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self._model = model_source(model, self.device)
        self.tok = tokenizer
        self.buckets = tuple(int(b) for b in seq_buckets)
        if not self.buckets:
            raise ValueError(
                "CombinedExecutor needs data.seq_buckets (the serve bucket "
                "signatures); () has no edges"
            )
        self.token_budget = int(token_budget)
        self.node_budget = int(node_budget)
        self.edge_budget = int(edge_budget)
        self.pad_id = int(self._model().cfg.encoder.pad_token_id)
        if int(tokenizer.pad_id) != self.pad_id:
            raise ValueError(
                f"tokenizer pads with {tokenizer.pad_id}, the encoder masks "
                f"pad_token_id {self.pad_id}"
            )
        self._rows = {T: rows_for_bucket(T, self.token_budget, 1) for T in self.buckets}
        self._warmed: set[int] = set()

    @property
    def model(self) -> torch.nn.Module:
        """The model the next batch runs."""
        return self._model()

    #: the efficiency ledger's site tag of this executor's buckets
    ledger_tag = "serve_combined"

    def ledger_signature(self, key: Hashable, n: int) -> str:
        T = int(key)
        return f"T{T}xR{self._rows[T]}"

    # -- grouping ------------------------------------------------------------

    def admit(self, payload) -> None:
        """Reject requests that can never fit their bucket's batch alone,
        against collate()'s accounting (every one of the bucket's rows
        holds at least the 1-node placeholder)."""
        key = self.bucket_key(payload)  # raises on over-long text
        _, spec = payload
        if spec is not None:
            rows = self._rows[key]
            n_used = rows + spec.num_nodes - 1
            e_used = rows + spec.num_edges + spec.num_nodes - 1
            if n_used > self.node_budget or e_used > self.edge_budget:
                raise RequestTooLarge(
                    f"graph has {spec.num_nodes} nodes / "
                    f"{spec.num_edges + spec.num_nodes} edges (incl. self loops); "
                    f"with the T={key} bucket's {rows} placeholder rows that "
                    f"exceeds budgets {self.node_budget}/{self.edge_budget}"
                )

    def bucket_key(self, payload) -> Hashable:
        ids, _ = payload
        ln = int(token_lengths(np.asarray(ids)[None], self.pad_id)[0])
        for T in self.buckets:
            if ln <= T:
                return T
        raise RequestTooLarge(
            f"token length {ln} exceeds the largest bucket edge {self.buckets[-1]}"
        )

    def capacity(self, key: Hashable) -> int:
        return self._rows[key]

    def fits(self, key: Hashable, chunk: Sequence, payload) -> bool:
        """collate()'s accounting: the bucket's `rows` placeholder slots
        (1 node + 1 self loop each) plus each real graph's excess."""
        rows = self._rows[key]
        n_used = e_used = rows
        for _, spec in list(chunk) + [payload]:
            if spec is not None:
                n_used += spec.num_nodes - 1
                e_used += spec.num_edges + spec.num_nodes - 1
        return n_used <= self.node_budget and e_used <= self.edge_budget

    def signatures(self) -> list[tuple[int, int, int]]:
        """(T, rows, num_graphs) of every bucket."""
        return [(T, self._rows[T], self._rows[T]) for T in self.buckets]

    def _collate(self, T: int, chunk: Sequence):
        rows = self._rows[T]
        if chunk:
            tok = np.stack([_fit_width(ids, T, self.pad_id) for ids, _ in chunk])
        else:
            tok = np.zeros((0, T), np.int32)
        graphs_by_id = {i: spec for i, (_, spec) in enumerate(chunk) if spec is not None}
        return collate(
            tok, [0] * len(chunk), list(range(len(chunk))), graphs_by_id,
            batch_rows=rows, node_budget=self.node_budget,
            edge_budget=self.edge_budget, pad_id=self.pad_id,
        )

    def warmup(self) -> dict[str, float]:
        """Run every bucket once on its all-padding batch (the first run
        builds the CUDA kernels); {signature label: seconds}. Idempotent."""
        report: dict[str, float] = {}
        for T in self.buckets:
            if T in self._warmed:
                continue
            sig = self.ledger_signature(T, 0)
            report[sig] = _ledger_warm(
                self.ledger_tag, sig, self.device,
                lambda: self.fetch(self.dispatch(T, self.pack_chunk(T, [])[1], warm=True),
                                   self._rows[T]))
            self._warmed.add(T)
        obs_ledger.record_memory("warmup")
        return report

    # -- execution (pack -> dispatch -> fetch) --------------------------------

    def pack_chunk(self, key: Hashable, chunk: Sequence):
        """Host collate into the bucket's padded batch (page-locked on a
        CUDA device); (signature label, packed)."""
        T = int(key)
        return self.ledger_signature(key, len(chunk)), (
            T, host_batch(self._collate(T, chunk), self.device))

    def dispatch(self, key: Hashable, packed, warm: bool = False) -> DeviceResult:
        """Copy the batch to the device and launch the model; returns
        P(class 1) per row as a `DeviceResult` without waiting for the
        device. With the ledger on (and not `warm`), the model call is
        timed."""
        T, batch = packed
        b = batch.to(self.device, non_blocking=True)
        model = self._model()
        window = None if warm else _ledger_window(self.device)
        with torch.inference_mode():
            logits = model(b.input_ids, b.graphs, b.has_graph)
            probs = torch.softmax(logits, dim=-1)[:, 1]
        if window is not None:
            window.stop()
        result = DeviceResult((probs,), keep=(batch, b, model))
        if window is not None:
            result.ledger_window, result.ledger_sig = window, self.ledger_signature(T, 0)
        return result

    def fetch(self, handle: DeviceResult, n: int) -> np.ndarray:
        """The sync point: [n] probabilities on the host."""
        out = handle.wait()[0][:n].numpy()
        _ledger_observe(self.ledger_tag, handle)
        return out


class DynamicBatcher:
    """Bounded-queue scheduler over an executor's bucket signatures.

    Two drive modes share the same grouping/flush/execute code:
      - `start()` spawns the scheduler thread (online serving) — batches
        flush when a group is full or its oldest request aged past
        `max_batch_delay_s`;
      - `score_all(payloads)` drives synchronously (offline; full groups
        flush as they fill, the tail force-flushes).

    Pipelined execution (`pipeline_depth > 0`, the reference's): the
    drive side (scheduler thread or offline drain) packs and dispatches
    without syncing, keeping at most `pipeline_depth` dispatched batches
    not yet fetched (backpressure blocks the dispatcher, never deepens
    the window); the FIFO fetch stage syncs results, resolves the
    requests and owns the `device_s` attribution (FIFO-union windows,
    `DeviceWindow`). Online the fetch stage runs on its own thread;
    offline drives sync the oldest batch inline when the window fills.
    Arrival order, grouping and packing are unchanged, so the same
    batches give the depth-0 bits."""

    def __init__(
        self,
        executor,
        queue_limit: int = 256,
        max_batch_delay_s: float = 0.025,
        on_batch: Callable[[], Any] | None = None,
        pipeline_depth: int = 0,
    ):
        self.executor = executor
        self.queue_limit = int(queue_limit)
        self.max_batch_delay_s = float(max_batch_delay_s)
        self.pipeline_depth = max(0, int(pipeline_depth))
        #: called before every executed batch (the registry's hot-swap
        #: poll); a failing hook never fails the batch
        self.on_batch = on_batch
        self._lock = threading.Condition()
        self._pending: "OrderedDict[Hashable, deque[ScoreRequest]]" = OrderedDict()
        self._n_pending = 0
        self._closed = False
        self._thread: threading.Thread | None = None
        #: bounded recent-latency window for host-side quantiles
        self.recent_latencies: deque[float] = deque(maxlen=4096)
        self.batches_run = 0
        self.rejected = 0
        self._occupancy_sum = 0.0
        # -- pipelined execution state (pipeline_depth > 0) ------------------
        #: FIFO of dispatched-but-unsynced batches, synced in submission
        #: order; _n_inflight counts batches whose fetch has not completed
        #: (popped-but-syncing still holds its slot); both under _fetch_cv
        self._inflight: deque = deque()
        self._n_inflight = 0
        self._fetch_cv = threading.Condition()
        self._fetch_thread: threading.Thread | None = None
        self._fetch_stop = False
        #: FIFO-union device-busy attribution shared by both depths
        self._window = DeviceWindow()
        #: plain stage counters (seconds summed over batches): host pack,
        #: dispatch (copy + launch), fetch (the wait on the card), and the
        #: host stage seconds spent while another batch was in flight
        self.pack_s = self.dispatch_s = self.fetch_s = self.overlap_s = 0.0
        self.inflight_peak = 0

    # -- admission -----------------------------------------------------------

    def submit(self, payload, request_id: str | None = None,
               frontend_s: float | None = None) -> ScoreRequest:
        """Enqueue one request; raises QueueFull or RequestTooLarge.
        `request_id` is the ingress id (a fresh one otherwise) and
        `frontend_s` the extraction seconds measured upstream."""
        self.executor.admit(payload)
        key = self.executor.bucket_key(payload)
        req = ScoreRequest(payload)
        if request_id is not None:
            req.request_id = request_id
        req.frontend_s = frontend_s
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._n_pending >= self.queue_limit:
                self.rejected += 1
                raise QueueFull(
                    f"serve queue at limit ({self.queue_limit}); retry later"
                )
            self._pending.setdefault(key, deque()).append(req)
            self._n_pending += 1
            self._lock.notify_all()
        return req

    def mean_occupancy(self) -> float | None:
        """Mean of executed batches' rows / capacity."""
        return self._occupancy_sum / self.batches_run if self.batches_run else None

    def stats(self) -> dict:
        """Queue depth, batches run, rejections, mean occupancy, the
        recent window's latency quantiles and the pipeline's counters
        (the `/stats` body's batcher half)."""
        with self._lock:
            depth = self._n_pending
        with self._fetch_cv:
            in_flight = self._n_inflight
        lat = sorted(self.recent_latencies)
        return {
            "queue_depth": depth,
            "batches": self.batches_run,
            "rejected": self.rejected,
            "batch_occupancy_mean": self.mean_occupancy(),
            "latency_p50_s": percentile(lat, 0.50),
            "latency_p99_s": percentile(lat, 0.99),
            "pipeline_depth": self.pipeline_depth,
            "pipeline_in_flight": in_flight,
            "pipeline_in_flight_peak": self.inflight_peak,
            "pipeline_pack_seconds": self.pack_s,
            "pipeline_dispatch_seconds": self.dispatch_s,
            "pipeline_fetch_seconds": self.fetch_s,
            "pipeline_overlap_seconds": self.overlap_s,
            **{f"pipeline_{k}": v for k, v in self.pipeline_stats().items() if k != "depth"},
        }

    def pipeline_stats(self) -> dict:
        """The device-window attribution at any depth: busy and idle
        seconds between dispatches and syncs, and the idle fraction."""
        return {
            "depth": self.pipeline_depth,
            "device_busy_s": self._window.busy_s,
            "device_idle_s": self._window.idle_s,
            "device_idle_fraction": self._window.idle_fraction(),
        }

    # -- scheduling ----------------------------------------------------------

    def _pop_chunk(self, key: Hashable) -> list[ScoreRequest]:
        """Pop the largest budget-respecting prefix of a group (holding
        the lock); arrival order within the group is preserved."""
        q = self._pending[key]
        cap = self.executor.capacity(key)
        chunk: list[ScoreRequest] = []
        payloads: list = []
        while q and len(chunk) < cap:
            nxt = q[0]
            if payloads and not self.executor.fits(key, payloads, nxt.payload):
                break
            chunk.append(q.popleft())
            payloads.append(chunk[-1].payload)
        if not q:
            del self._pending[key]
        self._n_pending -= len(chunk)
        return chunk

    def _take_ready(self, force: bool = False):
        """(key, None) of the next group to run, or (None, wait_s).

        Full groups flush immediately; otherwise the OLDEST pending
        request's age decides (force skips the wait: offline drain)."""
        now = time.monotonic()
        oldest_key = None
        oldest_t = None
        for key, q in self._pending.items():
            if len(q) >= self.executor.capacity(key):
                return key, None
            t = q[0].t_submit
            if oldest_t is None or t < oldest_t:
                oldest_key, oldest_t = key, t
        if oldest_key is None:
            return None, None
        if force or now - oldest_t >= self.max_batch_delay_s:
            return oldest_key, None
        return None, self.max_batch_delay_s - (now - oldest_t)

    def _begin_batch(self, chunk: list[ScoreRequest]) -> None:
        """Drive-side prologue of both paths: the hot-swap poll and the
        queue-wait attribution."""
        if self.on_batch is not None:
            try:
                self.on_batch()
            except Exception:  # a failed poll must never fail the batch
                logger.exception("on_batch hook failed")
        t0 = time.monotonic()
        for req in chunk:
            req.batch_size = len(chunk)
            req.queue_wait_s = t0 - req.t_submit

    def _pack(self, key: Hashable, chunk: list[ScoreRequest]):
        t0 = time.perf_counter()
        _, packed = self.executor.pack_chunk(key, [r.payload for r in chunk])
        pack_s = time.perf_counter() - t0
        self.pack_s += pack_s
        return packed, pack_s

    def _complete_batch(self, key: Hashable, chunk: list[ScoreRequest], probs,
                        t_submit: float, t_sync: float) -> None:
        """Fetch-side epilogue (the drive thread at depth 0, the fetch
        stage otherwise): the FIFO-union busy share becomes each
        request's `device_s`, then the futures resolve."""
        busy = self._window.observe(t_submit, t_sync)
        self.batches_run += 1
        self._occupancy_sum += len(chunk) / max(1, self.executor.capacity(key))
        for req, p in zip(chunk, probs):
            req.device_s = busy
            req.set_result(float(p))
            self.recent_latencies.append(req.latency_s)

    def _run_batch(self, key: Hashable, chunk: list[ScoreRequest]) -> None:
        """Serial path (pipeline_depth == 0): pack -> dispatch -> fetch
        inline on the drive thread; a failure fails this batch's requests
        and nothing else."""
        self._begin_batch(chunk)
        try:
            packed, _ = self._pack(key, chunk)
            t_submit = time.perf_counter()
            handle = self.executor.dispatch(key, packed)
            td = time.perf_counter()
            probs = self.executor.fetch(handle, len(chunk))
            t_sync = time.perf_counter()
        except Exception as e:  # the scheduler must outlive a bad batch
            for req in chunk:
                req.set_error(e)
            return
        self.dispatch_s += td - t_submit
        self.fetch_s += t_sync - td
        self._complete_batch(key, chunk, probs, t_submit, t_sync)

    # -- pipelined path (pipeline_depth > 0) ---------------------------------

    def _dispatch_batch(self, key: Hashable, chunk: list[ScoreRequest]) -> None:
        """Pipelined drive side: pack + dispatch without syncing. Blocks
        while `pipeline_depth` batches are in flight: the bounded window
        is the backpressure."""
        self._begin_batch(chunk)
        try:
            packed, pack_s = self._pack(key, chunk)
        except Exception as e:
            for req in chunk:
                req.set_error(e)
            return
        # the in-flight slot comes BEFORE the dispatch: dispatched-but-
        # unsynced batches never exceed pipeline_depth. Online the fetch
        # thread frees slots; offline the drive syncs the oldest inline
        if self._fetch_thread is not None:
            with self._fetch_cv:
                while self._n_inflight >= self.pipeline_depth:
                    self._fetch_cv.wait(0.25)
                self._n_inflight += 1
                overlapped = self._n_inflight > 1
                self.inflight_peak = max(self.inflight_peak, self._n_inflight)
        else:
            while True:
                with self._fetch_cv:
                    if self._n_inflight < self.pipeline_depth:
                        self._n_inflight += 1
                        overlapped = self._n_inflight > 1
                        self.inflight_peak = max(self.inflight_peak, self._n_inflight)
                        break
                self._sync_oldest()
        try:
            t_submit = time.perf_counter()
            handle = self.executor.dispatch(key, packed)
            dispatch_s = time.perf_counter() - t_submit
        except Exception as e:
            for req in chunk:
                req.set_error(e)
            with self._fetch_cv:
                self._n_inflight -= 1
                self._fetch_cv.notify_all()
            return
        self.dispatch_s += dispatch_s
        if overlapped:
            # host stage seconds spent while the card held another batch
            self.overlap_s += pack_s + dispatch_s
        with self._fetch_cv:
            self._inflight.append((key, chunk, handle, t_submit))
            self._fetch_cv.notify_all()

    def _sync_oldest(self) -> bool:
        """Fetch + resolve the oldest in-flight batch on the calling
        thread (the offline drive's fetch stage); False if none."""
        with self._fetch_cv:
            if not self._inflight:
                return False
            item = self._inflight.popleft()
        try:
            self._fetch_one(*item)
        finally:
            with self._fetch_cv:
                self._n_inflight -= 1
                self._fetch_cv.notify_all()
        return True

    def _fetch_loop(self) -> None:
        """FIFO fetch stage: sync each dispatched batch in submission
        order and resolve its requests. Exits once stop was asked and
        the in-flight FIFO has drained."""
        while True:
            with self._fetch_cv:
                while not self._inflight and not self._fetch_stop:
                    self._fetch_cv.wait(0.25)
                if not self._inflight:
                    return
                item = self._inflight.popleft()
            try:
                self._fetch_one(*item)
            finally:
                with self._fetch_cv:
                    self._n_inflight -= 1
                    self._fetch_cv.notify_all()

    def _fetch_one(self, key: Hashable, chunk: list[ScoreRequest], handle,
                   t_submit: float) -> None:
        try:
            tf = time.perf_counter()
            probs = self.executor.fetch(handle, len(chunk))
            t_sync = time.perf_counter()
        except Exception as e:
            for req in chunk:
                req.set_error(e)
            return
        self.fetch_s += t_sync - tf
        self._complete_batch(key, chunk, probs, t_submit, t_sync)

    def _ensure_fetch_thread(self) -> None:
        if self._fetch_thread is None:
            self._fetch_stop = False
            self._fetch_thread = threading.Thread(
                target=self._fetch_loop, name="serve-fetch", daemon=True)
            self._fetch_thread.start()

    def _wait_inflight(self, timeout_s: float = 60.0) -> None:
        """Block until every dispatched batch has been fetched and its
        requests resolved (the pipelined half of drain); no-op at depth 0."""
        deadline = time.monotonic() + timeout_s
        with self._fetch_cv:
            while self._n_inflight > 0:
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"{self._n_inflight} pipelined batches still in flight after "
                        f"{timeout_s:.0f}s")
                self._fetch_cv.wait(0.25)

    def _stop_fetch(self) -> None:
        t = self._fetch_thread
        if t is None:
            return
        with self._fetch_cv:
            self._fetch_stop = True
            self._fetch_cv.notify_all()
        t.join(timeout=10)
        self._fetch_thread = None

    def _execute(self, key: Hashable, chunk: list[ScoreRequest]) -> None:
        if self.pipeline_depth > 0:
            self._dispatch_batch(key, chunk)
        else:
            self._run_batch(key, chunk)

    def _drain_once(self, force: bool = False) -> bool:
        """Run at most one batch; True if one ran."""
        with self._lock:
            key, _ = self._take_ready(force=force)
            if key is None:
                return False
            chunk = self._pop_chunk(key)
        if chunk:
            self._execute(key, chunk)
        return bool(chunk)

    def drain(self) -> None:
        """Offline: run batches until the queue is empty; pipelined, also
        until the in-flight window is empty, so every request is resolved
        on return."""
        while True:
            if not self._drain_once(force=True):
                with self._lock:
                    if self._n_pending == 0:
                        break
        if self._fetch_thread is None:
            while self._sync_oldest():
                pass
        self._wait_inflight()

    def score_all(
        self,
        payloads: Sequence,
        request_ids: Sequence[str] | None = None,
        frontend_seconds: Sequence[float] | None = None,
    ) -> list[ScoreRequest]:
        """Synchronously score a payload sequence through the same
        grouping/flush path the online scheduler uses. A full queue
        drains in place; an over-budget payload becomes a failed
        request instead of failing the job. Optional per-payload
        `request_ids`/`frontend_seconds` carry the ingress ids and the
        extraction seconds the caller measured."""
        if self._thread is not None:
            raise RuntimeError(
                "score_all is the offline drive; the scheduler thread is running"
            )
        reqs: list[ScoreRequest] = []
        for i, p in enumerate(payloads):
            rid = request_ids[i] if request_ids is not None else None
            fs = frontend_seconds[i] if frontend_seconds is not None else None
            while True:
                try:
                    reqs.append(self.submit(p, request_id=rid, frontend_s=fs))
                    break
                except QueueFull:
                    self._drain_once(force=True)
                except RequestTooLarge as e:
                    req = ScoreRequest(p)
                    if rid is not None:
                        req.request_id = rid
                    req.frontend_s = fs
                    req.set_error(e)
                    reqs.append(req)
                    break
            while self._drain_once(force=False):
                pass
        self.drain()
        return reqs

    # -- online mode ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        if self.pipeline_depth > 0:
            # online, the scheduler pairs with the FIFO fetch thread
            self._ensure_fetch_thread()
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._closed and self._n_pending == 0:
                    return
                # on close, force-flush what is queued instead of letting
                # submitted requests hang
                key, wait = self._take_ready(force=self._closed)
                chunk = self._pop_chunk(key) if key is not None else None
                if chunk is None:
                    self._lock.wait(timeout=wait if wait is not None else 0.25)
                    continue
            self._execute(key, chunk)

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop accepting requests, score what is queued, stop the
        scheduler thread and, pipelined, the fetch thread once every
        dispatched batch is resolved."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"serve-batcher thread still running after {timeout_s}s"
                )
            self._thread = None
        if self._fetch_thread is not None:
            self._wait_inflight(timeout_s)
            self._stop_fetch()
