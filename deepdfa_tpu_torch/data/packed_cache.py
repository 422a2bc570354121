"""Persistent packed-batch cache (the port's copy of the reference's
`deepdfa_tpu/data/packed_cache.py`): fully packed GraphBatch and TextBatch
streams replayed zero-copy from disk.

The packed stream is a pure function of (batcher schema, budgets,
selection, source graphs), so it is written once and every later epoch
and re-run with the same configuration replays it from flat, mmap-able
`.npy` files, past the frontend, the packer and the store's inflate.

Layout (one directory per cache key), the reference's own:

    <root>/<key>/b00000.node_feats.npy      one flat .npy per (batch, field)
    <root>/<key>/b00000.graphs.edge_src.npy a TextBatch's graph fields
    <root>/<key>/manifest.json              written LAST: its presence
                                            marks the entry complete

Every array is stored with the reference's leading logical-shard axis
(size 1: the port trains one logical shard), so an entry either package
wrote replays in the other bit for bit, and `cache_key` is the
reference's function of the same inputs. The key is a sha256 over
`SCHEMA_VERSION`, every packing parameter, a digest of the source
(`GraphStore.digest()`, `corpus_digest()`, `text_corpus_digest()`) and
the vocabulary digest: a re-extraction, a budget change or a schema bump
changes the key, and stale entries are only orphaned (`prune` collects
them).

Replay is bit-identical to direct packing (tests/test_torch_input_
pipeline.py), so training numerics are unchanged. The manifest records
each file's size and sha256; replay checks the sizes every time and the
digests once a process, and quarantines a damaged entry before packing
it again.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np

from deepdfa_tpu_torch.core.ioutil import with_retries
from deepdfa_tpu_torch.data.text import TEXT_ARRAY_FIELDS as _TEXT_FIELDS
from deepdfa_tpu_torch.data.text import TextBatch
from deepdfa_tpu_torch.graphs.batch import ARRAY_FIELDS as _ARRAY_FIELDS
from deepdfa_tpu_torch.graphs.batch import GraphBatch, GraphSpec

#: bump on ANY change to pack/plan semantics that alters the packed bytes
#: for identical inputs; it is part of every cache key
SCHEMA_VERSION = 1

logger = logging.getLogger(__name__)

#: entry dirs whose content digests this process has verified; later
#: epochs replay with size checks only
_VERIFIED: set[str] = set()


class CacheCorruption(RuntimeError):
    """An entry failed size or digest verification (a killed writer, bit
    rot); `get_or_pack` quarantines it and packs cold."""


def _file_digest(path: Path, chunk: int = 1 << 20) -> tuple[int, str]:
    """(size, sha256) of a file's bytes, streamed."""
    h = hashlib.sha256()
    size = 0
    with path.open("rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            size += len(b)
            h.update(b)
    return size, h.hexdigest()


def cache_key(batcher: Mapping[str, object], source_digest: str, vocab_digest: str = "") -> str:
    """Content hash of one packed-batch stream. `batcher`: every
    parameter that shapes it (num_shards, num_graphs, budgets,
    add_self_loops, oversized, the selection's epoch and seed, ...),
    JSON-serializable; its order does not matter."""
    payload = json.dumps(
        {"schema": SCHEMA_VERSION, "batcher": dict(sorted(batcher.items())),
         "source": source_digest, "vocab": vocab_digest},
        sort_keys=True, default=str,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def corpus_digest(specs: Sequence[GraphSpec]) -> str:
    """Content digest of an in-memory GraphSpec corpus: every array's
    bytes, so any feature, label or edge edit invalidates."""
    h = hashlib.sha256()
    h.update(len(specs).to_bytes(8, "little"))
    for g in specs:
        h.update(int(g.graph_id).to_bytes(8, "little", signed=True))
        h.update(np.float64(g.label).tobytes())
        for f in dataclasses.fields(g):
            v = getattr(g, f.name)
            if not isinstance(v, np.ndarray):
                continue
            a = np.ascontiguousarray(v)
            h.update(f.name.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def text_corpus_digest(token_ids_by_id: Mapping[int, np.ndarray],
                       labels_by_id: Mapping[int, int]) -> str:
    """Content digest of a tokenized corpus (ids in sorted order): every
    row's bytes and label, so any re-tokenization or label edit
    invalidates."""
    h = hashlib.sha256()
    h.update(len(token_ids_by_id).to_bytes(8, "little"))
    for i in sorted(token_ids_by_id):
        a = np.ascontiguousarray(np.asarray(token_ids_by_id[i]))
        h.update(int(i).to_bytes(8, "little", signed=True))
        h.update(int(labels_by_id[i]).to_bytes(8, "little", signed=True))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _save(path: Path, value) -> None:
    """One field, with the reference's leading logical-shard axis."""
    np.save(path, np.asarray(value)[None])


class PackedBatchCache:
    """A directory of packed-batch streams addressed by cache key.

    max_entries bounds the directory: finalizing an entry evicts the
    least recently USED ones beyond the limit (`replay` touches the
    manifest, so the eval split's entry never ages out). None =
    unbounded."""

    def __init__(self, root: str | Path, max_entries: int | None = None,
                 io_retries: int = 2, io_backoff_s: float = 0.05):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_entries = max_entries
        self.io_retries = int(io_retries)
        self.io_backoff_s = float(io_backoff_s)

    def entry_dir(self, key: str) -> Path:
        return self.root / key

    def has(self, key: str) -> bool:
        """True when a COMPLETE entry exists (the manifest comes last)."""
        return (self.entry_dir(key) / "manifest.json").is_file()

    # -- write ---------------------------------------------------------------

    def write_through(self, key: str, batches: Iterable) -> Iterator:
        """Yield `batches` unchanged while persisting them. The entry
        becomes visible (manifest, then an atomic directory rename) only
        once the stream is exhausted; on any error the partial spill is
        removed and the error propagates."""
        tmp = Path(tempfile.mkdtemp(prefix=f".{key}-", dir=self.root))
        meta: list[dict] = []
        try:
            for i, batch in enumerate(batches):
                meta.append(self._save_batch(tmp, i, batch))
                yield batch
            self._finalize(tmp, key, meta)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _save_batch(self, d: Path, i: int, batch) -> dict:
        if isinstance(batch, TextBatch):
            for name in _TEXT_FIELDS:
                _save(d / f"b{i:05d}.{name}.npy", getattr(batch, name))
            g = batch.graphs
            gfields = []
            for name in _ARRAY_FIELDS:
                v = getattr(g, name)
                if v is None:
                    continue
                gfields.append(name)
                _save(d / f"b{i:05d}.graphs.{name}.npy", v)
            return {"kind": "text", "num_graphs": int(g.num_graphs),
                    "fields": list(_TEXT_FIELDS), "graph_fields": gfields}
        fields = []
        for name in _ARRAY_FIELDS:
            v = getattr(batch, name)
            if v is None:
                continue
            fields.append(name)
            _save(d / f"b{i:05d}.{name}.npy", v)
        return {"num_graphs": int(batch.num_graphs), "fields": fields}

    def _finalize(self, tmp: Path, key: str, meta: list[dict]) -> None:
        files = {p.name: dict(zip(("size", "sha256"), _file_digest(p)))
                 for p in sorted(tmp.glob("*.npy"))}
        (tmp / "manifest.json").write_text(json.dumps(
            {"schema": SCHEMA_VERSION, "key": key, "n_batches": len(meta), "batches": meta,
             "files": files}))
        try:
            os.replace(tmp, self.entry_dir(key))
        except OSError:
            # a concurrent writer finished the same key first: identical
            # content by construction, so ours goes
            shutil.rmtree(tmp, ignore_errors=True)
            if not self.has(key):
                raise
        self._evict(keep=key)

    def _evict(self, keep: str) -> None:
        if self.max_entries is None:
            return
        entries = []
        for k in self.keys():
            if k == keep:
                continue
            try:
                entries.append(((self.entry_dir(k) / "manifest.json").stat().st_mtime, k))
            except OSError:
                continue  # concurrently pruned
        for _, k in sorted(entries)[: max(0, len(entries) + 1 - self.max_entries)]:
            shutil.rmtree(self.entry_dir(k), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def _verify(self, d: Path, manifest: Mapping) -> None:
        """Sizes on every replay, content digests once a process, against
        the manifest (an entry without "files" is not checked)."""
        files = manifest.get("files")
        if files is None:
            return
        for name, rec in files.items():
            try:
                size = (d / name).stat().st_size
            except OSError as e:
                raise CacheCorruption(f"{name}: {e}") from e
            if size != rec["size"]:
                raise CacheCorruption(
                    f"{name}: size {size} != recorded {rec['size']} (truncated write-out?)")
        if str(d) in _VERIFIED:
            return
        for name, rec in files.items():
            _, digest = _file_digest(d / name)
            if digest != rec["sha256"]:
                raise CacheCorruption(
                    f"{name}: content digest mismatch ({digest[:12]} != {rec['sha256'][:12]})")
        _VERIFIED.add(str(d))

    def replay(self, key: str, mmap: bool = True) -> Iterator:
        """Iterate a complete entry, its arrays read-only mmap views by
        default (zero-copy until the device copy). The manifest's "kind"
        picks TextBatch or GraphBatch; the leading logical-shard axis
        (size 1) is dropped."""
        d = self.entry_dir(key)
        manifest_path = d / "manifest.json"
        try:
            manifest = with_retries(lambda: json.loads(manifest_path.read_text()),
                                    retries=self.io_retries, backoff_s=self.io_backoff_s,
                                    what=f"cache manifest read {key}")
        except FileNotFoundError:
            raise
        except (json.JSONDecodeError, OSError) as e:
            raise CacheCorruption(f"manifest.json: {e}") from e
        if manifest.get("schema") != SCHEMA_VERSION:
            raise ValueError(f"cache entry {key} has schema {manifest.get('schema')}, "
                             f"expected {SCHEMA_VERSION}: key derivation is broken")
        self._verify(d, manifest)
        try:
            os.utime(manifest_path)  # the LRU stamp _evict reads
        except OSError:
            pass  # read-only cache dir: eviction degrades to write order
        mode = "r" if mmap else None

        def load(path: Path):
            try:
                a = with_retries(lambda: np.load(path, mmap_mode=mode), retries=self.io_retries,
                                 backoff_s=self.io_backoff_s, what=f"cache read {path.name}")
            except FileNotFoundError:
                raise  # concurrent eviction: get_or_pack rebuilds
            except (ValueError, EOFError, OSError) as e:
                raise CacheCorruption(f"{path.name}: {e}") from e
            if a.ndim < 1 or a.shape[0] != 1:
                raise ValueError(
                    f"{path.name}: an entry of {a.shape[0] if a.ndim else 0} logical shards; "
                    "the port replays one (data parallelism comes with the multi-device "
                    "slice, ROADMAP queue A, item 9)")
            return a[0]

        for i, m in enumerate(manifest["batches"]):
            arrays = {name: load(d / f"b{i:05d}.{name}.npy") for name in m["fields"]}
            if m.get("kind") == "text":
                garrays = {name: load(d / f"b{i:05d}.graphs.{name}.npy")
                           for name in m["graph_fields"]}
                yield TextBatch(**{n: arrays.get(n) for n in _TEXT_FIELDS},
                                graphs=GraphBatch(**{n: garrays.get(n) for n in _ARRAY_FIELDS},
                                                  num_graphs=m["num_graphs"]))
                continue
            yield GraphBatch(**{n: arrays.get(n) for n in _ARRAY_FIELDS},
                             num_graphs=m["num_graphs"])

    def get_or_pack(self, key: str, builder: Callable[[], Iterable],
                    mmap: bool = True) -> Iterator:
        """Replay `key` when warm; otherwise build through `builder()`
        and persist write-through. Either way the consumer sees the
        stream `builder()` would give."""
        if self.has(key):
            return self._replay_or_rebuild(key, builder, mmap)
        return self.write_through(key, builder())

    def _replay_or_rebuild(self, key: str, builder: Callable[[], Iterable],
                           mmap: bool) -> Iterator:
        """Replay, rebuilding if the entry vanishes (a concurrent prune)
        or fails verification (quarantined first), and resuming after the
        batches already yielded."""
        n = 0
        try:
            for batch in self.replay(key, mmap=mmap):
                yield batch
                n += 1
            return
        except FileNotFoundError:
            pass
        except CacheCorruption as e:
            dest = self.quarantine(key)
            logger.warning("packed cache entry %s corrupt (%s); quarantined to %s and "
                           "repacking cold", key, e, dest)
        for i, batch in enumerate(self.write_through(key, builder())):
            if i >= n:
                yield batch

    # -- maintenance ---------------------------------------------------------

    #: quarantined entries kept for post-mortem (newest first)
    QUARANTINE_KEEP = 4

    def quarantine(self, key: str) -> Path | None:
        """Move a corrupt entry aside (a bounded number kept); the
        quarantine path, or None when it was gone or could not move."""
        d = self.entry_dir(key)
        _VERIFIED.discard(str(d))
        if not d.exists():
            return None
        qroot = self.root / "quarantine"
        qroot.mkdir(exist_ok=True)
        dest = qroot / f"{key}-{os.getpid()}-{time.time_ns()}"
        try:
            os.replace(d, dest)
        except OSError:
            shutil.rmtree(d, ignore_errors=True)
            return None

        def quarantined_at(p: Path) -> int:
            # os.replace keeps the entry's mtime: order by the name's stamp
            try:
                return int(p.name.rsplit("-", 1)[-1])
            except ValueError:
                return 0

        for p in sorted(qroot.iterdir(), key=quarantined_at)[: -self.QUARANTINE_KEEP]:
            shutil.rmtree(p, ignore_errors=True)
        return dest

    def keys(self) -> list[str]:
        # dot-prefixed dirs are spills in progress
        return sorted(p.name for p in self.root.iterdir()
                      if p.is_dir() and not p.name.startswith(".")
                      and (p / "manifest.json").is_file())

    #: a dot-prefixed spill younger than this is assumed live (another
    #: process mid write_through); older ones are collected
    SPILL_TTL_SECONDS = 6 * 3600.0

    def prune(self, keep: Iterable[str] = ()) -> int:
        """Remove entries not in `keep`, and abandoned spills; the number
        of directories removed."""
        keep = set(keep)
        n = 0
        for p in self.root.iterdir():
            if not p.is_dir():
                continue
            if p.name.startswith("."):
                try:
                    age = time.time() - p.stat().st_mtime
                except OSError:
                    continue
                if age < self.SPILL_TTL_SECONDS:
                    continue
            elif p.name in keep:
                continue
            shutil.rmtree(p, ignore_errors=True)
            n += 1
        return n
