"""Reading a graph store (the port's copy of the reading half of the
reference's `deepdfa_tpu/graphs/store.py`).

A store is a directory of `graphs-*.npz` shards, each holding ragged
graphs in concatenated form with offset tables, as the reference's
`extract` writes them. Writing stores stays with the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from deepdfa_tpu_torch.graphs.batch import _BIT_FIELDS, GraphSpec

_VERSION = 1


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


class GraphStore:
    """A directory of npz shards addressable by graph_id (read only)."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)

    def shard_paths(self) -> list[Path]:
        return sorted(self.directory.glob("graphs-*.npz"))

    def iter_graphs(self) -> Iterator[GraphSpec]:
        for p in self.shard_paths():
            yield from load_shard(p)

    def load_all(self) -> dict[int, GraphSpec]:
        return {g.graph_id: g for g in self.iter_graphs()}
