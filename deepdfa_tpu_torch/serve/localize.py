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

The drive is serial: `attribute_all` chunks a stream of functions
greedily under the pack budgets and attributes chunk after chunk; one
attribution runs on the card at a time. Left out: the reference's
pipelined drive (`serve.pipeline_depth > 0`, ROADMAP queue A item 6, is
refused by the config), its `obs` counters and spans (item 12), the
serve mesh and a quantized `tag@int8` entry (item 6).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.eval.localize import ggnn_score_fn, node_line_attributions
from deepdfa_tpu_torch.graphs.batch import NUM_SUBKEY_FEATS, pack
from deepdfa_tpu_torch.serve.batcher import model_source
from deepdfa_tpu_torch.serve.frontend import Features


class GgnnLocalizer:
    """(prob, ranked [{"line", "score"}]) per function: a graph-level
    `DeepDFA` (a module, or the registry's callable read on every batch)
    attributed by `method` over padded batches of the ladder `sizes` at
    the serve budgets, on `device` (default "cuda", which raises when
    CUDA is unavailable)."""

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
        ggnn_score_fn(method, None, self.n_steps)  # refuses an unknown method now
        self._lock = threading.Lock()  # one attribution on the card at a time
        self._stats_lock = threading.Lock()
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
            self._run(size, self._pack(size, []))
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
                    feat_width=NUM_SUBKEY_FEATS, etypes=self.etypes)

    def _pack_chunk(self, feats_list: Sequence[Features]):
        """Host pack: (ladder size, padded batch)."""
        size = self._size_for(len(feats_list))
        return size, self._pack(size, [f.spec for f in feats_list])

    def _run(self, size: int, batch) -> tuple[np.ndarray, np.ndarray]:
        """(probs [size], node scores [node_budget]) on the host."""
        run = ggnn_score_fn(self.method, self._model(), self.n_steps)
        with self._lock:
            probs, scores = run(batch.to(self.device))
            return probs.cpu().numpy(), scores.cpu().numpy()

    def attribute(self, feats_list: Sequence[Features]) -> list[tuple[float, list[dict]]]:
        """One padded batch over the chunk -> per function (prob, ranked
        lines in its own coordinates). The chunk must respect the budgets
        (`fits`)."""
        if not feats_list:
            return []
        t0 = time.perf_counter()
        size, batch = self._pack_chunk(feats_list)
        probs, node_scores = self._run(size, batch)
        out: list[tuple[float, list[dict]]] = []
        off = 0
        for i, f in enumerate(feats_list):
            n = f.spec.num_nodes
            out.append((float(probs[i]), node_line_attributions(
                node_scores[off:off + n], f.node_lines, top_k=self.top_k)))
            off += n
        seconds = time.perf_counter() - t0
        with self._stats_lock:
            self.functions += len(feats_list)
            self.batches += 1
            self.seconds += seconds
        return out

    def attribute_all(self, feats_list: Sequence[Features]) -> list[tuple[float, list[dict]]]:
        """Greedy budget-respecting chunks over a stream of functions,
        attributed in order; the output keeps the input's order."""
        out: list[tuple[float, list[dict]]] = []
        chunk: list[Features] = []
        for f in feats_list:
            if chunk and not self.fits(chunk, f):
                out.extend(self.attribute(chunk))
                chunk = []
            chunk.append(f)
        out.extend(self.attribute(chunk))
        return out

    def stats(self) -> dict:
        with self._stats_lock:
            return {"functions": self.functions, "batches": self.batches,
                    "seconds": self.seconds}
