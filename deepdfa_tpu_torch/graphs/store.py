"""Graph stores (the port's copy of the reference's
`deepdfa_tpu/graphs/store.py`, without its memory-mapped reading).

A store is a directory of `graphs-*.npz` shards, each holding ragged
graphs in concatenated form with offset tables. The port's `extract`
(`python -m deepdfa_tpu_torch.cli extract`) writes them with
`GraphStore.write`, member for member as the reference's `extract` does,
and either package reads the other's.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from deepdfa_tpu_torch.graphs.batch import (
    _BIT_FIELDS,
    NUM_SUBKEY_FEATS,
    GraphSpec,
    bit_width,
    edge_typed,
)

_VERSION = 1


def save_shard(
    path: str | Path, graphs: Sequence[GraphSpec], compressed: bool = True
) -> None:
    """Write one shard; `compressed=False` stores the npz members raw
    (zip STORED), which the reference can memory-map."""
    node_counts = np.array([g.num_nodes for g in graphs], np.int64)
    edge_counts = np.array([g.num_edges for g in graphs], np.int64)
    extra = {}
    if bit_width(graphs) is not None:
        for f in _BIT_FIELDS:
            extra[f] = np.concatenate([getattr(g, f) for g in graphs]).astype(np.float32)
    if graphs and edge_typed(graphs):
        extra["edge_type"] = np.concatenate([g.edge_type for g in graphs]).astype(np.int32)

    def cat(field: str, empty: np.ndarray) -> np.ndarray:
        return np.concatenate([getattr(g, field) for g in graphs]) if graphs else empty

    (np.savez_compressed if compressed else np.savez)(
        path,
        version=np.int64(_VERSION),
        **extra,
        graph_ids=np.array([g.graph_id for g in graphs], np.int64),
        labels=np.array([g.label for g in graphs], np.float32),
        node_offsets=np.concatenate([[0], np.cumsum(node_counts)]),
        edge_offsets=np.concatenate([[0], np.cumsum(edge_counts)]),
        node_feats=cat("node_feats", np.zeros((0, NUM_SUBKEY_FEATS), np.int32)),
        node_vuln=cat("node_vuln", np.zeros((0,), np.int32)),
        edge_src=cat("edge_src", np.zeros((0,), np.int32)),
        edge_dst=cat("edge_dst", np.zeros((0,), np.int32)),
    )


def load_shard(path: str | Path) -> list[GraphSpec]:
    with np.load(path) as z:
        return _specs_from_arrays({k: z[k] for k in z.files}, path)


def _specs_from_arrays(z: dict[str, np.ndarray], path) -> list[GraphSpec]:
    if int(z["version"]) != _VERSION:
        raise ValueError(f"unsupported shard version {z['version']} at {path}")
    no, eo = z["node_offsets"], z["edge_offsets"]
    has_bits = _BIT_FIELDS[0] in z
    has_etypes = "edge_type" in z
    out = []
    for i in range(len(z["graph_ids"])):
        extra = (
            {f: np.asarray(z[f][no[i]:no[i + 1]], np.float32) for f in _BIT_FIELDS}
            if has_bits else {}
        )
        if has_etypes:
            extra["edge_type"] = np.asarray(z["edge_type"][eo[i]:eo[i + 1]], np.int32)
        out.append(GraphSpec(
            graph_id=int(z["graph_ids"][i]),
            node_feats=np.asarray(z["node_feats"][no[i]:no[i + 1]], np.int32),
            node_vuln=np.asarray(z["node_vuln"][no[i]:no[i + 1]], np.int32),
            edge_src=np.asarray(z["edge_src"][eo[i]:eo[i + 1]], np.int32),
            edge_dst=np.asarray(z["edge_dst"][eo[i]:eo[i + 1]], np.int32),
            label=float(z["labels"][i]),
            **extra,
        ))
    return out


def file_digest(path: str | Path, chunk: int = 1 << 20) -> str:
    """sha256 of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


class GraphStore:
    """A directory of npz shards addressable by graph_id."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)

    def shard_paths(self) -> list[Path]:
        return sorted(self.directory.glob("graphs-*.npz"))

    def write(
        self,
        graphs: Sequence[GraphSpec],
        shard_size: int = 4096,
        tag: str | None = None,
        compressed: bool = True,
    ) -> int:
        """Write npz shards into the directory (made if missing); returns
        their count. Concurrent writers must pass distinct `tag`s (e.g.
        the job-array shard id): untagged numbering counts the files
        already there."""
        self.directory.mkdir(parents=True, exist_ok=True)
        prefix = f"graphs-{tag}-" if tag else "graphs-"
        existing = len(list(self.directory.glob(f"{prefix}*.npz")))
        n = 0
        for i in range(0, len(graphs), shard_size):
            save_shard(self.directory / f"{prefix}{existing + n:05d}.npz",
                       graphs[i:i + shard_size], compressed=compressed)
            n += 1
        return n

    def iter_graphs(self) -> Iterator[GraphSpec]:
        for p in self.shard_paths():
            yield from load_shard(p)

    def load_all(self) -> dict[int, GraphSpec]:
        return {g.graph_id: g for g in self.iter_graphs()}

    def digest(self) -> str:
        """Content hash over every shard (name + bytes)."""
        h = hashlib.sha256()
        for p in self.shard_paths():
            h.update(p.name.encode())
            h.update(file_digest(p).encode())
        return h.hexdigest()
