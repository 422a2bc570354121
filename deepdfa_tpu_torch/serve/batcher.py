"""Dynamic request batcher over bucket signatures (the reference's
`deepdfa_tpu/serve/batcher.py`, serial path).

- a BOUNDED queue with admission control: a full queue raises
  `QueueFull` instead of buffering unbounded latency;
- requests group by bucket key and a chunk holds as many as fit the
  executor's budgets;
- a max-latency flush: a partial batch executes once its oldest request
  has waited `max_batch_delay_s`.

Two executors: `GgnnExecutor` (graph requests, all co-batchable; each
chunk pads to the smallest ladder size 1, 2, 4, ..., max_batch_graphs,
or of a tuned rung set, that holds it) and `CombinedExecutor` (text +
graph requests of the combined families, DeepDFA+LineVul or
CodeT5+DeepDFA, grouped by sequence bucket; each chunk pads to its
bucket's full row count).

A request's score does not depend on what it was batched with beyond
fp32 reassociation: padding slots are masked out of every reduction and
per-graph compute is independent.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Hashable, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.data.text import _fit_width, collate, rows_for_bucket, token_lengths
from deepdfa_tpu_torch.graphs.batch import NUM_SUBKEY_FEATS, pack

_req_ids = itertools.count()


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is at queue_limit."""


class RequestTooLarge(ValueError):
    """The request alone exceeds the serving batch budgets."""


@dataclasses.dataclass
class ScoreRequest:
    """One in-flight scoring request (a thread-safe future);
    `batch_size` is how many requests shared its batch."""

    payload: Any
    id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    _done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: float | None = None
    error: Exception | None = None
    latency_s: float | None = None
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
    clamped to the capacity). The model is moved to `device` (default
    "cuda", which raises when CUDA is unavailable) and put in eval
    mode."""

    def __init__(
        self,
        model: torch.nn.Module,
        node_budget: int,
        edge_budget: int,
        max_batch_graphs: int = 16,
        etypes: bool = False,
        device: str | torch.device | None = None,
        ladder: Sequence[int] | None = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.node_budget = int(node_budget)
        self.edge_budget = int(edge_budget)
        self.sizes = _ladder_sizes(ladder, int(max_batch_graphs))
        self.etypes = bool(etypes)
        self._warmed: set[int] = set()

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
            t0 = time.perf_counter()
            self.fetch(self.dispatch("graph", (size, self._pack(size, []))), size)
            report[f"G{size}"] = time.perf_counter() - t0
            self._warmed.add(size)
        return report

    # -- execution (pack -> dispatch -> fetch) --------------------------------

    def _pack(self, size: int, specs: Sequence):
        return pack(
            list(specs), size, self.node_budget, self.edge_budget,
            feat_width=NUM_SUBKEY_FEATS, etypes=self.etypes,
        )

    def pack_chunk(self, key: Hashable, chunk: Sequence):
        """Host pack into the padded ladder batch; (signature label,
        packed)."""
        size = self._size_for(len(chunk))
        return f"G{size}", (size, self._pack(size, chunk))

    def dispatch(self, key: Hashable, packed) -> torch.Tensor:
        """Copy the batch to the device and launch the model; returns
        the probabilities without waiting for the device."""
        _, batch = packed
        with torch.inference_mode():
            return torch.sigmoid(self.model(batch.to(self.device)))

    def fetch(self, handle: torch.Tensor, n: int) -> np.ndarray:
        """The sync point: [n] probabilities on the host."""
        return handle[:n].cpu().numpy()


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
    which raises when CUDA is unavailable) and put in eval mode."""

    def __init__(
        self,
        model: torch.nn.Module,
        tokenizer,
        seq_buckets: Sequence[int],
        token_budget: int,
        node_budget: int,
        edge_budget: int,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
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
        self.pad_id = int(model.cfg.encoder.pad_token_id)
        if int(tokenizer.pad_id) != self.pad_id:
            raise ValueError(
                f"tokenizer pads with {tokenizer.pad_id}, the encoder masks "
                f"pad_token_id {self.pad_id}"
            )
        self._rows = {T: rows_for_bucket(T, self.token_budget, 1) for T in self.buckets}
        self._warmed: set[int] = set()

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
            t0 = time.perf_counter()
            self.fetch(self.dispatch(T, (T, self._collate(T, []))), self._rows[T])
            report[self.ledger_signature(T, 0)] = time.perf_counter() - t0
            self._warmed.add(T)
        return report

    # -- execution (pack -> dispatch -> fetch) --------------------------------

    def pack_chunk(self, key: Hashable, chunk: Sequence):
        """Host collate into the bucket's padded batch; (signature
        label, packed)."""
        return self.ledger_signature(key, len(chunk)), (int(key), self._collate(int(key), chunk))

    def dispatch(self, key: Hashable, packed) -> torch.Tensor:
        """Copy the batch to the device and launch the model; returns
        P(class 1) per row without waiting for the device."""
        _, batch = packed
        b = batch.to(self.device)
        with torch.inference_mode():
            logits = self.model(b.input_ids, b.graphs, b.has_graph)
            return torch.softmax(logits, dim=-1)[:, 1]

    def fetch(self, handle: torch.Tensor, n: int) -> np.ndarray:
        """The sync point: [n] probabilities on the host."""
        return handle[:n].cpu().numpy()


class DynamicBatcher:
    """Bounded-queue scheduler over an executor's bucket signatures.

    Two drive modes share the same grouping/flush/execute code:
      - `start()` spawns the scheduler thread (online serving) — batches
        flush when a group is full or its oldest request aged past
        `max_batch_delay_s`;
      - `score_all(payloads)` drives synchronously (offline; full groups
        flush as they fill, the tail force-flushes)."""

    def __init__(
        self,
        executor,
        queue_limit: int = 256,
        max_batch_delay_s: float = 0.025,
    ):
        self.executor = executor
        self.queue_limit = int(queue_limit)
        self.max_batch_delay_s = float(max_batch_delay_s)
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

    # -- admission -----------------------------------------------------------

    def submit(self, payload) -> ScoreRequest:
        """Enqueue one request; raises QueueFull or RequestTooLarge."""
        self.executor.admit(payload)
        key = self.executor.bucket_key(payload)
        req = ScoreRequest(payload)
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

    def _run_batch(self, key: Hashable, chunk: list[ScoreRequest]) -> None:
        """pack -> dispatch -> fetch inline on the drive thread; a failure
        fails this batch's requests and nothing else."""
        for req in chunk:
            req.batch_size = len(chunk)
        try:
            _, packed = self.executor.pack_chunk(key, [r.payload for r in chunk])
            probs = self.executor.fetch(
                self.executor.dispatch(key, packed), len(chunk)
            )
        except Exception as e:  # the scheduler must outlive a bad batch
            for req in chunk:
                req.set_error(e)
            return
        self.batches_run += 1
        self._occupancy_sum += len(chunk) / max(1, self.executor.capacity(key))
        for req, p in zip(chunk, probs):
            req.set_result(float(p))
            self.recent_latencies.append(req.latency_s)

    def _drain_once(self, force: bool = False) -> bool:
        """Run at most one batch; True if one ran."""
        with self._lock:
            key, _ = self._take_ready(force=force)
            if key is None:
                return False
            chunk = self._pop_chunk(key)
        if chunk:
            self._run_batch(key, chunk)
        return bool(chunk)

    def drain(self) -> None:
        """Offline: run batches until the queue is empty."""
        while True:
            if not self._drain_once(force=True):
                with self._lock:
                    if self._n_pending == 0:
                        break

    def score_all(self, payloads: Sequence) -> list[ScoreRequest]:
        """Synchronously score a payload sequence through the same
        grouping/flush path the online scheduler uses. A full queue
        drains in place; an over-budget payload becomes a failed
        request instead of failing the job."""
        if self._thread is not None:
            raise RuntimeError(
                "score_all is the offline drive; the scheduler thread is running"
            )
        reqs: list[ScoreRequest] = []
        for p in payloads:
            while True:
                try:
                    reqs.append(self.submit(p))
                    break
                except QueueFull:
                    self._drain_once(force=True)
                except RequestTooLarge as e:
                    req = ScoreRequest(p)
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
            self._run_batch(key, chunk)

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop accepting requests, score what is queued, stop the
        scheduler thread."""
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
