"""Request preprocessing for online inference (the port's copy of the
reference's `deepdfa_tpu/serve/frontend.py`).

Raw C/C++ source -> model-ready `GraphSpec`, through exactly the path
`cli extract` takes (`data/pipeline.py:extract_graph` + `to_graph_spec`
against the run's vocabularies), so a served function is featurized as
the training corpus was.

A content-keyed feature cache (sha256 of the source + the feature spec,
gtype and vocabulary identity, the reference's key) sits in front of
the parser: repeat functions skip the frontend. Failures are cached too:
a function the parser cannot handle stays unparseable until its bytes
change.

Left out: the reference's pooled Joern route (`SessionPool`,
`_joern_cpg`): neither machine has Joern, and `serve.use_joern=true` is
refused (core/config.py:refuse_unported_serving). The reference's
process-wide metrics histogram is plain counters here: the cache's
`hits`/`misses`, the preprocessor's `failures`, `extractions` and
`frontend_seconds`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import Any

import numpy as np


class FrontendError(ValueError):
    """The function could not be turned into a model graph."""


@dataclasses.dataclass(frozen=True)
class Features:
    """One cached extraction: the batchable GraphSpec plus the per-node
    source lines (1-based, in the function's own coordinates)."""

    spec: Any  # GraphSpec
    node_lines: np.ndarray  # [n] int32


class FeatureCache:
    """Bounded content-keyed LRU for extraction results (0 entries
    disables); `hits` and `misses` count lookups."""

    def __init__(self, max_entries: int = 1024):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str):
        """(hit, value); value may be None (a cached failure)."""
        with self._lock:
            if self.max_entries and key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return True, self._entries[key]
            self.misses += 1
            return False, None

    def put(self, key: str, value) -> None:
        if not self.max_entries:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: the process-wide store `shared_cache` hands out; safe to share across
#: configs because every key pins the feature spec, gtype and vocabulary
_SHARED_CACHE: FeatureCache | None = None
_SHARED_LOCK = threading.Lock()


def shared_cache(max_entries: int = 1024) -> FeatureCache:
    """The one process-wide FeatureCache, created on first use; a caller
    asking for more capacity grows it (never shrinks it)."""
    global _SHARED_CACHE
    with _SHARED_LOCK:
        if _SHARED_CACHE is None:
            _SHARED_CACHE = FeatureCache(max_entries)
        elif int(max_entries) > _SHARED_CACHE.max_entries:
            _SHARED_CACHE.max_entries = int(max_entries)
        return _SHARED_CACHE


class RequestPreprocessor:
    """source text -> GraphSpec, cached and timed. `cache` joins an
    existing store (the serving path passes `shared_cache(...)`); None
    keeps a private one of `cache_entries`."""

    def __init__(self, cfg, vocabs, cache_entries: int = 1024,
                 cache: FeatureCache | None = None):
        feat = cfg.data.feat
        self.cfg = cfg
        self.vocabs = vocabs
        self.gtype = cfg.data.gtype
        self.struct_feats = bool(feat.struct_feats)
        self.max_defs = feat.max_defs
        self.cache = cache if cache is not None else FeatureCache(cache_entries)
        self._lock = threading.Lock()
        self.failures = 0
        self.extractions = 0
        self.frontend_seconds = 0.0
        # the reference's key: every knob that changes the extracted bytes,
        # the vocabulary content included ("joern=False": the built-in
        # parser, the only route here)
        self._key_suffix = (
            f"|{feat.name}|{self.gtype}|joern=False|vocab={self._vocab_digest()}"
        )

    def _vocab_digest(self) -> str:
        payload = json.dumps(
            {k: v.to_json() for k, v in sorted(self.vocabs.items())}, sort_keys=True
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def content_key(self, code: str) -> str:
        return hashlib.sha256(code.encode("utf-8", "replace")).hexdigest() + self._key_suffix

    def features(self, code: str, request_id: int = -1):
        """GraphSpec for one function; raises FrontendError on functions
        the frontend cannot handle (cached either way)."""
        return self.features_full(code, request_id).spec

    def features_full(self, code: str, request_id: int = -1) -> Features:
        """GraphSpec + per-node source lines; `features` is the spec-only
        view of the same cache entry."""
        key = self.content_key(code)
        hit, cached = self.cache.get(key)
        if hit:
            if cached is None:
                self._count_failure()
                raise FrontendError("unparseable function (cached)")
            return cached
        t0 = time.perf_counter()
        try:
            feats = self._extract(code, request_id)
        finally:
            with self._lock:
                self.extractions += 1
                self.frontend_seconds += time.perf_counter() - t0
        self.cache.put(key, feats)
        if feats is None:
            self._count_failure()
            raise FrontendError("function could not be parsed into a CFG graph")
        return feats

    def _count_failure(self) -> None:
        with self._lock:
            self.failures += 1

    def _extract(self, code: str, request_id: int) -> Features | None:
        from deepdfa_tpu_torch.data.pipeline import extract_graph, to_graph_spec

        eg = extract_graph(code, request_id, max_defs=self.max_defs, gtype=self.gtype,
                           struct_feats=self.struct_feats)
        if eg is None:
            return None
        return Features(to_graph_spec(eg, self.vocabs), eg.node_lines.copy())

    def stats(self) -> dict:
        with self._lock:
            return {"failures": self.failures, "extractions": self.extractions,
                    "frontend_seconds": self.frontend_seconds}
