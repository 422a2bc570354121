"""Served line-level localization for the flagship GGNN family (the port
of the reference's `deepdfa_tpu/serve/localize.py`).

`eval/localize.py:ggnn_score_fn` is the one attribution program: the
offline evaluation calls it directly, and this module runs the same
function over padded batches of the scoring executor's ladder
(serve/batcher.py:GgnnExecutor.sizes), so a served function pads to the
rung it would score at. `warmup()` runs every rung once (the first run
builds the kernels).

Numerics: a function attributed alone is the same bits as the offline
`ggnn_score_fn` at rung 1 on the same checkpoint (the same kernels on the
same shapes). Co-batching keeps the line ranking and moves scores only by
fp32 reduction order: the backward sums across the padded batch in
another order than the forward score path does.

Stages: `_pack_chunk` packs on the host (into page-locked memory on a
CUDA device), `_dispatch` copies the batch without blocking and
launches the attribution, its outputs copied into pinned buffers behind
a CUDA event (serve/batcher.py:DeviceResult), and `_fetch` waits on that
event alone. `attribute` runs the three for one chunk; `attribute_all`
chunks a stream of functions greedily under the pack budgets, serially
at `pipeline_depth` 0 and, above it, software-pipelined as the
reference's drive: the next chunk is packed and dispatched while the
card runs the current one, with at most `pipeline_depth` chunks
dispatched and not yet fetched. The chunking and every chunk's program
are the serial drive's, so the output is bit-identical. Dispatches are
serialized by a lock; fetches wait outside it.

A quantized `tag@int8` entry (the registry's `QuantizedModel`) runs the
attribution on its dequantized weights (serve/quant.py:run_served).
Left out: the reference's `obs` counters and spans (ROADMAP queue A
item 12) and the serve mesh (item 9).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.eval.localize import ggnn_score_fn, node_line_attributions
from deepdfa_tpu_torch.graphs.batch import NUM_SUBKEY_FEATS, pack
from deepdfa_tpu_torch.serve.batcher import DeviceResult, DeviceWindow, host_batch, model_source
from deepdfa_tpu_torch.serve.frontend import Features
from deepdfa_tpu_torch.serve.quant import run_served


class GgnnLocalizer:
    """(prob, ranked [{"line", "score"}]) per function: a graph-level
    `DeepDFA` (a module, or the registry's callable read on every batch)
    attributed by `method` over padded batches of the ladder `sizes` at
    the serve budgets, on `device` (default "cuda", which raises when
    CUDA is unavailable); `attribute_all` keeps up to `pipeline_depth`
    chunks in flight."""

    def __init__(
        self,
        model: torch.nn.Module | Callable[[], torch.nn.Module],
        node_budget: int,
        edge_budget: int,
        sizes: Sequence[int],
        method: str = "saliency",
        n_steps: int = 8,
        top_k: int = 10,
        etypes: bool = False,
        device: str | torch.device | None = None,
        pipeline_depth: int = 0,
        feat_width: int | None = None,
    ):
        self.device = resolve_device(device)
        self._model = model_source(model, self.device)
        self.node_budget = int(node_budget)
        self.edge_budget = int(edge_budget)
        self.sizes = tuple(sorted({int(s) for s in sizes}))
        self.method = method
        self.n_steps = int(n_steps)
        self.top_k = int(top_k)
        self.etypes = bool(etypes)
        self.feat_width = NUM_SUBKEY_FEATS if feat_width is None else int(feat_width)
        ggnn_score_fn(method, None, self.n_steps)  # refuses an unknown method now
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._lock = threading.Lock()  # one dispatch at a time
        self._stats_lock = threading.Lock()
        #: FIFO-union dispatch->sync attribution (serve/batcher.py)
        self._window = DeviceWindow()
        self._warmed: set[int] = set()
        #: functions and batches attributed, and their seconds (pack to
        #: fetch, a wait for another attribution included)
        self.functions = 0
        self.batches = 0
        self.seconds = 0.0

    def warmup(self) -> dict[str, float]:
        """Attribute every rung's all-padding batch once; {signature
        label: seconds}. Idempotent."""
        report: dict[str, float] = {}
        for size in self.sizes:
            if size in self._warmed:
                continue
            t0 = time.perf_counter()
            self._fetch(self._dispatch(size, host_batch(self._pack(size, []), self.device)))
            report[f"L{size}"] = time.perf_counter() - t0
            self._warmed.add(size)
        return report

    def _size_for(self, n: int) -> int:
        for s in self.sizes:
            if s >= n:
                return s
        return self.sizes[-1]

    def fits(self, chunk: Sequence[Features], feats: Features) -> bool:
        """Would adding `feats` keep the chunk inside the ladder and the
        pack budgets (the scoring executor's accounting)?"""
        if len(chunk) + 1 > self.sizes[-1]:
            return False
        nodes = sum(f.spec.num_nodes for f in chunk) + feats.spec.num_nodes
        edges = (sum(f.spec.num_edges + f.spec.num_nodes for f in chunk)
                 + feats.spec.num_edges + feats.spec.num_nodes)
        return nodes <= self.node_budget and edges <= self.edge_budget

    def _pack(self, size: int, specs: Sequence):
        return pack(list(specs), size, self.node_budget, self.edge_budget,
                    feat_width=self.feat_width, etypes=self.etypes)

    def _pack_chunk(self, feats_list: Sequence[Features]):
        """Host pack stage: (ladder size, padded batch, page-locked on a
        CUDA device)."""
        size = self._size_for(len(feats_list))
        return size, host_batch(self._pack(size, [f.spec for f in feats_list]), self.device)

    def _dispatch(self, size: int, batch) -> DeviceResult:
        """Copy + launch without syncing: the (probs [size], node scores
        [node_budget]) `DeviceResult`, holding the model it ran."""
        model = self._model()
        with self._lock:
            b = batch.to(self.device, non_blocking=True)
            probs, scores = run_served(
                model, lambda m, x: ggnn_score_fn(self.method, m, self.n_steps)(x), b)
            return DeviceResult((probs.detach(), scores.detach()), keep=(batch, b, model))

    def _fetch(self, handle: DeviceResult) -> tuple[np.ndarray, np.ndarray]:
        """The sync point: (probs, node scores) on the host."""
        probs, scores = handle.wait()
        return probs.numpy(), scores.numpy()

    def _finish(self, feats_list: Sequence[Features], probs: np.ndarray,
                node_scores: np.ndarray, t0: float, t_submit: float,
                t_sync: float) -> list[tuple[float, list[dict]]]:
        """Fetch-side epilogue: the device window, the node -> line
        mapping per function and the counters."""
        out: list[tuple[float, list[dict]]] = []
        off = 0
        for i, f in enumerate(feats_list):
            n = f.spec.num_nodes
            out.append((float(probs[i]), node_line_attributions(
                node_scores[off:off + n], f.node_lines, top_k=self.top_k)))
            off += n
        seconds = time.perf_counter() - t0
        with self._stats_lock:  # HTTP threads fetch concurrently
            self._window.observe(t_submit, t_sync)
            self.functions += len(feats_list)
            self.batches += 1
            self.seconds += seconds
        return out

    def attribute(self, feats_list: Sequence[Features]) -> list[tuple[float, list[dict]]]:
        """One padded batch over the chunk -> per function (prob, ranked
        lines in its own coordinates). The chunk must respect the budgets
        (`fits`)."""
        if not feats_list:
            return []
        t0 = time.perf_counter()
        size, batch = self._pack_chunk(feats_list)
        t_submit = time.perf_counter()
        probs, node_scores = self._fetch(self._dispatch(size, batch))
        return self._finish(feats_list, probs, node_scores, t0, t_submit, time.perf_counter())

    def attribute_all(self, feats_list: Sequence[Features]) -> list[tuple[float, list[dict]]]:
        """Greedy budget-respecting chunks over a stream of functions;
        the output keeps the input's order. Above `pipeline_depth` 0 the
        drive is software-pipelined (the module's docstring), its output
        the serial drive's bits."""
        chunks: list[list[Features]] = []
        chunk: list[Features] = []
        for f in feats_list:
            if chunk and not self.fits(chunk, f):
                chunks.append(chunk)
                chunk = []
            chunk.append(f)
        if chunk:
            chunks.append(chunk)
        out: list[tuple[float, list[dict]]] = []
        if self.pipeline_depth <= 0:
            for c in chunks:
                out.extend(self.attribute(c))
            return out
        window: deque = deque()

        def sync_oldest() -> None:
            c, handle, t0, t_submit = window.popleft()
            probs, node_scores = self._fetch(handle)
            out.extend(self._finish(c, probs, node_scores, t0, t_submit, time.perf_counter()))

        for c in chunks:
            while len(window) >= self.pipeline_depth:
                sync_oldest()
            t0 = time.perf_counter()
            size, batch = self._pack_chunk(c)
            t_submit = time.perf_counter()
            window.append((c, self._dispatch(size, batch), t0, t_submit))
        while window:
            sync_oldest()
        return out

    def stats(self) -> dict:
        with self._stats_lock:
            return {"functions": self.functions, "batches": self.batches,
                    "seconds": self.seconds, "pipeline_depth": self.pipeline_depth,
                    "device_idle_fraction": self._window.idle_fraction()}
