"""Request preprocessing for online inference (the port's copy of the
reference's `deepdfa_tpu/serve/frontend.py`).

Raw C/C++ source -> model-ready `GraphSpec`, through exactly the path
`cli extract` takes (`data/pipeline.py:graph_from_cpg` + `to_graph_spec`
against the run's vocabularies), so a served function is featurized as
the training corpus was.

Two parser routes share that path:
  - the built-in frontend parser (default; no JVM);
  - a pooled Joern session (`serve.use_joern`): a bounded pool of
    `frontend/joern_session.py` sessions (`serve.joern_pool_size`, each
    command bounded by `serve.joern_timeout_s`, each session with its own
    bounded restart), checked out per request and replaced when one
    fails. Without a `joern` binary on PATH the route raises; it never
    falls back to the built-in parser.

A content-keyed feature cache (sha256 of the source + the feature spec,
gtype, route and vocabulary identity, the reference's key) sits in front
of both routes: repeat functions skip the frontend. Failures are cached
too: a function the parser cannot handle stays unparseable until its
bytes change. The reference's process-wide metrics histogram is plain
counters here: the cache's `hits`/`misses`, the preprocessor's
`failures`, `extractions` and `frontend_seconds`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import tempfile
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable

import numpy as np

logger = logging.getLogger(__name__)


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


class SessionPool:
    """Bounded pool of frontend sessions (Joern JVMs; anything with
    close() in tests).

    Sessions are created lazily up to `size`, checked out exclusively,
    and replaced (closed, and recreated at a later checkout) when the
    borrower saw an exception; `replaced` counts those. The session's own
    restart (JoernSession.max_restarts) handles transient hangs; the pool
    handles sessions that died for good."""

    def __init__(self, factory: Callable[[int], Any], size: int = 1):
        self.factory = factory
        self.size = max(1, int(size))
        # one condition guards both the free list and the creation
        # budget: a discard frees creation capacity (not a queued
        # session), so a waiter re-checks both when notified
        self._cond = threading.Condition()
        self._free: list[Any] = []
        self._created = 0
        self._next_id = 0
        self.replaced = 0
        self._closed = False

    def _checkout(self):
        with self._cond:
            while True:
                if self._closed:
                    raise RuntimeError("session pool is closed")
                if self._free:
                    return self._free.pop()
                if self._created < self.size:
                    self._created += 1
                    self._next_id += 1
                    worker_id = self._next_id - 1
                    break
                self._cond.wait()
        # construct outside the lock (a Joern JVM takes seconds to start)
        try:
            return self.factory(worker_id)
        except Exception:
            with self._cond:
                self._created -= 1
                self._cond.notify()
            raise

    def session(self):
        """Context manager: checkout, yield, return, or discard on error."""
        pool = self

        class _Lease:
            def __enter__(self):
                self.s = pool._checkout()
                return self.s

            def __exit__(self, exc_type, exc, tb):
                if exc_type is None:
                    pool._return(self.s)
                else:
                    # the borrower's exception propagates; the session
                    # leaves the pool
                    pool._discard(self.s)
                return False

        return _Lease()

    def _return(self, s) -> None:
        with self._cond:
            self._free.append(s)
            self._cond.notify()

    def _discard(self, s) -> None:
        try:
            s.close()
        except Exception:
            pass
        with self._cond:
            self._created -= 1
            self.replaced += 1
            self._cond.notify()  # creation capacity freed: wake a waiter

    def close(self) -> None:
        with self._cond:
            self._closed = True
            free, self._free = self._free, []
            self._cond.notify_all()
        for s in free:
            try:
                s.close()
            except Exception:
                pass


class RequestPreprocessor:
    """source text -> GraphSpec, cached, timed and parser-routed. `cache`
    joins an existing store (the serving path passes `shared_cache(...)`);
    None keeps a private one of `cache_entries`. `use_joern` routes
    extraction through `joern_pool`, or, when none is given, through a
    pool of `serve.joern_pool_size` JoernSessions that this preprocessor
    creates (and `close` closes); it raises FrontendError when no
    `joern` binary is on PATH."""

    def __init__(self, cfg, vocabs, use_joern: bool = False,
                 joern_pool: SessionPool | None = None, cache_entries: int = 1024,
                 cache: FeatureCache | None = None):
        feat = cfg.data.feat
        self.cfg = cfg
        self.vocabs = vocabs
        self.gtype = cfg.data.gtype
        self.struct_feats = bool(feat.struct_feats)
        self.max_defs = feat.max_defs
        self.cache = cache if cache is not None else FeatureCache(cache_entries)
        self.use_joern = bool(use_joern)
        self.pool = joern_pool
        if self.use_joern and self.pool is None:
            from deepdfa_tpu_torch.frontend import joern_session

            if not joern_session.available():
                raise FrontendError("serve.use_joern=true but no `joern` binary on PATH")
            scfg = cfg.serve
            self.pool = SessionPool(
                lambda i: joern_session.JoernSession(worker_id=i, timeout=scfg.joern_timeout_s),
                size=scfg.joern_pool_size,
            )
        self._lock = threading.Lock()
        self.failures = 0
        self.extractions = 0
        self.frontend_seconds = 0.0
        # the reference's key: every knob that changes the extracted bytes,
        # the parser route and the vocabulary content included
        self._key_suffix = (
            f"|{feat.name}|{self.gtype}|joern={self.use_joern}|vocab={self._vocab_digest()}"
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
        from deepdfa_tpu_torch.data.pipeline import extract_graph, graph_from_cpg, to_graph_spec

        if self.use_joern:
            cpg = self._joern_cpg(code)
            eg = None if cpg is None else graph_from_cpg(
                cpg, request_id, max_defs=self.max_defs, gtype=self.gtype,
                struct_feats=self.struct_feats)
        else:
            eg = extract_graph(code, request_id, max_defs=self.max_defs, gtype=self.gtype,
                               struct_feats=self.struct_feats)
        if eg is None:
            return None
        return Features(to_graph_spec(eg, self.vocabs), eg.node_lines.copy())

    def _joern_cpg(self, code: str):
        """One pooled session round trip: tmp file -> export -> Cpg, or
        None when the export cannot be read."""
        from deepdfa_tpu_torch.frontend.joern_io import load_joern_cpg

        with self.pool.session() as sess:
            with tempfile.TemporaryDirectory(prefix="serve-joern-") as d:
                src = Path(d) / "request.c"
                src.write_text(code)
                sess.import_code(src)
                sess.export_cpg_json(src)  # writes <src>.{nodes,edges}.json
                try:
                    return load_joern_cpg(src)
                except (OSError, ValueError) as e:
                    logger.warning("joern export unreadable: %s", e)
                    return None

    def stats(self) -> dict:
        with self._lock:
            return {"failures": self.failures, "extractions": self.extractions,
                    "frontend_seconds": self.frontend_seconds}

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
