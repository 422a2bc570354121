"""Multiprocess packing producer (the port's copy of the reference's
`deepdfa_tpu/data/mp_pack.py`): first-epoch batch packing spread over a
process pool.

Packing (graphs/batch.py:pack) is GIL-bound numpy slicing, so a
prefetch thread cannot scale it; this module runs it on a spawn process
pool. The parent runs the cheap sequential planner
(`plan_shard_bucket_batches`, `plan_bucketed_batches`), the workers run
`pack_plan` / `collate_plan` on the plans, and the arrays come back
through POSIX shared memory: one copy into the segment in the worker and
one out of it in the parent, never a pickle of array bytes through a
pipe. Order and content are bit-identical to the inline batcher (the
same plans, the same packing function; tests/test_torch_input_pipeline.py).

Spawn only: the workers get the corpus once at pool construction, the
worker entry points are module-level, and nothing needs fork semantics,
which would corrupt a process where CUDA has started.

Scope: the cold path (the first epoch of a new cache key). Later epochs
replay the packed-batch cache (data/packed_cache.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import multiprocessing as mp
import os
from collections import deque
from multiprocessing import shared_memory
from pathlib import Path
from typing import Iterable, Iterator, Sequence

import numpy as np

from deepdfa_tpu_torch.core.config import PAD_ID_BY_FAMILY
from deepdfa_tpu_torch.data.text import (
    TEXT_ARRAY_FIELDS as _TEXT_FIELDS,
    TextBatch,
    TextBatchPlan,
    collate_plan,
    lengths_for,
    plan_bucketed_batches,
)
from deepdfa_tpu_torch.graphs.batch import (
    ARRAY_FIELDS as _ARRAY_FIELDS,
    BatchPlan,
    GraphBatch,
    GraphSpec,
    pack_plan,
    plan_shard_bucket_batches,
)

# worker-process globals, set once by the pool initializer (spawn ships
# them with the initargs pickle once per worker, not per task)
_WORKER: dict = {}

#: segments are named "<_SHM_PREFIX>-<parent pid>-<packer token>-..." so
#: the parent can sweep leftovers it never received (a terminated pool
#: discards queued results); the prefix differs from the reference's, so
#: neither package's sweep touches the other's segments
_SHM_PREFIX = "dfapackt"
_SHM_DIR = Path("/dev/shm")
_PACKER_TOKENS = itertools.count()


def _init_worker(graphs: Sequence[GraphSpec], add_self_loops: bool,
                 shm_prefix: str = "") -> None:
    _WORKER["graphs"] = graphs
    _WORKER["add_self_loops"] = add_self_loops
    _WORKER["shm_prefix"] = shm_prefix
    _WORKER["seq"] = 0


def _shm_create(size: int) -> shared_memory.SharedMemory:
    name = None
    if _WORKER.get("shm_prefix"):
        _WORKER["seq"] += 1
        name = f"{_WORKER['shm_prefix']}{os.getpid()}-{_WORKER['seq']}"
    try:
        # track=False (3.13+): the PARENT owns the segment's lifetime
        # (attach, copy out, unlink); the worker's resource tracker must
        # not unlink it
        return shared_memory.SharedMemory(name=name, create=True, size=size, track=False)
    except TypeError:
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        return shm


def _sweep_prefix(prefix: str) -> int:
    """Unlink every segment under `prefix` (linux /dev/shm); the number
    removed."""
    if not _SHM_DIR.is_dir():
        return 0
    n = 0
    for p in _SHM_DIR.glob(f"{prefix}*"):
        try:
            p.unlink()
            n += 1
        except OSError:
            pass
    return n


def _sweep_stale() -> int:
    """Collect segments of packer parents that are gone (a hard crash);
    segments of this process and of live ones are never touched."""
    if not _SHM_DIR.is_dir():
        return 0
    n = 0
    for p in _SHM_DIR.glob(f"{_SHM_PREFIX}-*"):
        try:
            owner = int(p.name.split("-")[1])
        except (IndexError, ValueError):
            continue
        if owner == os.getpid():
            continue
        try:
            os.kill(owner, 0)
            continue  # owner alive
        except ProcessLookupError:
            pass  # owner gone: the segment is garbage
        except OSError:
            continue  # e.g. EPERM: alive, another user
        try:
            p.unlink()
            n += 1
        except OSError:
            pass
    return n


def _write_shm(leaves) -> tuple[str, list]:
    """Copy (name, array) leaves into one fresh segment; (segment name,
    manifest). OSError when no segment can be made (/dev/shm full):
    callers then pickle the batch."""
    total = sum(a.nbytes for _, a in leaves)
    shm = _shm_create(max(1, total))
    manifest = []
    off = 0
    for name, a in leaves:
        dst = np.ndarray(a.shape, dtype=a.dtype, buffer=shm.buf, offset=off)
        dst[...] = a
        manifest.append((name, str(a.dtype), a.shape, off))
        off += a.nbytes
    name = shm.name
    shm.close()
    return name, manifest


def _pack_one(plan: BatchPlan):
    """Worker entry: pack one plan and hand the arrays back through
    shared memory: ("shm", name, manifest, num_graphs), or ("pickle",
    batch) when no segment can be made."""
    batch = pack_plan(_WORKER["graphs"], plan, _WORKER["add_self_loops"])
    leaves = [(name, np.ascontiguousarray(getattr(batch, name)))
              for name in _ARRAY_FIELDS if getattr(batch, name) is not None]
    try:
        name, manifest = _write_shm(leaves)
    except OSError:
        return ("pickle", batch)
    return ("shm", name, manifest, int(batch.num_graphs))


def _init_text_worker(token_ids_by_id, labels_by_id, graphs_by_id, pad_id: int,
                      shm_prefix: str = "") -> None:
    _WORKER["token_ids"] = token_ids_by_id
    _WORKER["labels"] = labels_by_id
    _WORKER["graphs_by_id"] = graphs_by_id
    _WORKER["pad_id"] = pad_id
    _WORKER["shm_prefix"] = shm_prefix
    _WORKER["seq"] = 0


def _collate_text_one(plan: TextBatchPlan):
    """Worker entry for bucketed text plans: `collate_plan`, its leaves
    and the nested GraphBatch's ("graphs."-prefixed) through one
    segment."""
    batch = collate_plan(plan, _WORKER["token_ids"], _WORKER["labels"],
                         _WORKER["graphs_by_id"], _WORKER["pad_id"])
    leaves = [(name, np.ascontiguousarray(np.asarray(getattr(batch, name))))
              for name in _TEXT_FIELDS]
    g = batch.graphs
    leaves += [(f"graphs.{name}", np.ascontiguousarray(np.asarray(v)))
               for name in _ARRAY_FIELDS if (v := getattr(g, name)) is not None]
    try:
        name, manifest = _write_shm(leaves)
    except OSError:
        return ("pickle", batch)
    return ("shm", name, manifest, int(g.num_graphs))


def _discard_shm(name: str) -> None:
    """Unlink a segment whose contents will never be received."""
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    shm.close()
    try:
        shm.unlink()
    except FileNotFoundError:
        pass


def _read_shm_arrays(name: str, manifest) -> dict[str, np.ndarray]:
    """Copy every manifest leaf out of a segment, then unlink it."""
    shm = shared_memory.SharedMemory(name=name)
    try:
        return {fname: np.ndarray(tuple(shape), dtype=np.dtype(dtype), buffer=shm.buf,
                                  offset=off).copy()
                for fname, dtype, shape, off in manifest}
    finally:
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass


def _receive(result) -> GraphBatch:
    if result[0] == "pickle":
        return result[1]
    _, name, manifest, num_graphs = result
    arrays = _read_shm_arrays(name, manifest)
    return GraphBatch(**{n: arrays.get(n) for n in _ARRAY_FIELDS}, num_graphs=num_graphs)


def _receive_text(result) -> TextBatch:
    if result[0] == "pickle":
        return result[1]
    _, name, manifest, num_graphs = result
    arrays = _read_shm_arrays(name, manifest)
    graphs = {k[len("graphs."):]: v for k, v in arrays.items() if k.startswith("graphs.")}
    return TextBatch(**{n: arrays.get(n) for n in _TEXT_FIELDS},
                     graphs=GraphBatch(**{n: graphs.get(n) for n in _ARRAY_FIELDS},
                                       num_graphs=num_graphs))


class _PoolPacker:
    """The spawn-pool mechanics the packers share. The pool starts
    lazily, on the first `pack` that needs it, so a run whose epochs all
    replay the packed-batch cache never spawns a worker. Use as a
    context manager, or call close()."""

    _init_fn = None
    _task_fn = None
    _receive_fn = None

    def __init__(self, workers: int | None = None):
        self.workers = workers if workers is not None else (os.cpu_count() or 1)
        self._pool = None
        # a namespace of this packer's: close() may sweep it whole
        # without touching a sibling packer's live segments
        self._shm_prefix = f"{_SHM_PREFIX}-{os.getpid()}-{next(_PACKER_TOKENS)}-"

    def _init_args(self) -> tuple:
        raise NotImplementedError

    def _pack_inline(self, item):
        raise NotImplementedError

    def _get_pool(self):
        if self._pool is None and self.workers > 1:
            _sweep_stale()
            self._pool = mp.get_context("spawn").Pool(
                self.workers, initializer=type(self)._init_fn,
                initargs=(*self._init_args(), self._shm_prefix))
        return self._pool

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
            # terminate() discarded queued results and killed mid-pack
            # workers; their segments are unreachable now
            _sweep_prefix(self._shm_prefix)

    def _drain(self, pending) -> None:
        """Receive and unlink every outstanding shared-memory result (the
        consumer abandoned `pack` mid-stream)."""
        for r in pending:
            try:
                result = r.get()
            except Exception:
                continue
            if result[0] == "shm":
                _discard_shm(result[1])

    def pack(self, plans: Iterable) -> Iterator:
        """Pack plans across the pool, yielding in plan order. At most
        2 * workers plans are outstanding, so the pool never races an
        epoch ahead of a training-paced consumer."""
        pool = self._get_pool()
        if pool is None:
            for plan in plans:
                yield self._pack_inline(plan)
            return
        window = 2 * self.workers
        it = iter(plans)
        pending: deque = deque()
        task = type(self)._task_fn
        receive = type(self)._receive_fn

        def fill() -> None:
            while len(pending) < window:
                plan = next(it, None)
                if plan is None:
                    return
                pending.append(pool.apply_async(task, (plan,)))

        try:
            fill()
            while pending:
                result = pending.popleft().get()
                fill()  # keep the workers fed while the consumer trains
                yield receive(result)
        except BaseException:
            self._drain(pending)
            raise


class MpPacker(_PoolPacker):
    """A reusable spawn-pool packer bound to one GraphSpec corpus;
    `shard_bucket_batches` can be called every epoch."""

    _init_fn = staticmethod(_init_worker)
    _task_fn = staticmethod(_pack_one)
    _receive_fn = staticmethod(_receive)

    def __init__(self, graphs: Iterable[GraphSpec], workers: int | None = None,
                 add_self_loops: bool = True):
        super().__init__(workers)
        self.graphs = graphs if isinstance(graphs, Sequence) else list(graphs)
        self.add_self_loops = add_self_loops

    def _init_args(self) -> tuple:
        return (self.graphs, self.add_self_loops)

    def _pack_inline(self, plan: BatchPlan) -> GraphBatch:
        return pack_plan(self.graphs, plan, self.add_self_loops)

    def shard_bucket_batches(
        self,
        num_graphs: int,
        node_budget: int,
        edge_budget: int,
        oversized: str = "drop",
        stats: dict | None = None,
        select: Sequence[int] | None = None,
    ) -> Iterator[GraphBatch]:
        """`graphs.shard_bucket_batches` over this corpus, packed on the
        pool: the same plans, the same batches. `select` restricts (and
        orders) the pass to corpus indices, e.g. an epoch's undersample
        selection, without shipping the graphs again: plans are made over
        the selection, then mapped back to corpus indices."""
        if select is None:
            src = self.graphs
        else:
            select = [int(i) for i in select]
            src = [self.graphs[i] for i in select]
        plans = plan_shard_bucket_batches(src, num_graphs, node_budget, edge_budget,
                                          self.add_self_loops, oversized, stats)
        if select is not None:
            plans = (dataclasses.replace(p, indices=tuple(select[i] for i in p.indices))
                     for p in plans)
        yield from self.pack(plans)


def mp_shard_bucket_batches(
    graphs: Sequence[GraphSpec],
    num_graphs: int,
    node_budget: int,
    edge_budget: int,
    add_self_loops: bool = True,
    oversized: str = "drop",
    stats: dict | None = None,
    workers: int | None = None,
) -> Iterator[GraphBatch]:
    """One pass over the corpus on a pool of its own; prefer a long-lived
    MpPacker when packing every epoch."""
    with MpPacker(graphs, workers, add_self_loops) as packer:
        yield from packer.shard_bucket_batches(num_graphs, node_budget, edge_budget,
                                               oversized, stats)


class TextMpPacker(_PoolPacker):
    """The spawn-pool collater of bucketed TextBatch streams: the parent
    plans (`data/text.py:plan_bucketed_batches`), the workers run
    `collate_plan`, and each batch comes back through one segment (its
    own leaves and its GraphBatch's). Bit-identical to inline collation."""

    _init_fn = staticmethod(_init_text_worker)
    _task_fn = staticmethod(_collate_text_one)
    _receive_fn = staticmethod(_receive_text)

    def __init__(self, token_ids_by_id, labels_by_id, graphs_by_id,
                 pad_id: int = PAD_ID_BY_FAMILY["roberta"], workers: int | None = None):
        super().__init__(workers)
        self.token_ids_by_id = dict(token_ids_by_id)
        self.labels_by_id = dict(labels_by_id)
        self.graphs_by_id = dict(graphs_by_id)
        self.pad_id = int(pad_id)

    def _init_args(self) -> tuple:
        return (self.token_ids_by_id, self.labels_by_id, self.graphs_by_id, self.pad_id)

    def _pack_inline(self, plan: TextBatchPlan) -> TextBatch:
        return collate_plan(plan, self.token_ids_by_id, self.labels_by_id, self.graphs_by_id,
                            self.pad_id)

    def bucketed_batches(
        self,
        example_ids: Sequence[int],
        buckets: Sequence[int],
        token_budget: int,
        num_shards: int,
        node_budget: int,
        edge_budget: int,
        lengths: Sequence[int] | None = None,
        stats: dict | None = None,
    ) -> Iterator[TextBatch]:
        """`data.text.bucketed_collate_batches` over the bound corpus,
        collated on the pool; `example_ids` restricts (and orders) the
        pass."""
        if lengths is None:
            lengths = lengths_for(self.token_ids_by_id, example_ids, self.pad_id)
        plans = plan_bucketed_batches(lengths, example_ids, buckets, token_budget, num_shards,
                                      node_budget, edge_budget, stats=stats)
        yield from self.pack(plans)
