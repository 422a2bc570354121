"""The port's share of the typed configuration.

It reads the same JSON files as the JAX package (`configs/*.json`,
`config.json` in a run dir) and keeps the sections this port runs: the
feature spec and batch budgets of `data`, all of `model`, and the
batcher fields of `serve`. Field names and defaults are the reference's
(`deepdfa_tpu/core/config.py`), so one file configures both packages.
Keys of sections the port does not run yet (training, observability,
fleet, the frontend) are read past; the JAX package validates them.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

ALL_SUBKEYS = ("api", "datatype", "literal", "operator")


@dataclass(frozen=True)
class FeatureSpec:
    """Which abstract-dataflow subkeys feed the model and vocab limits.

    input_dim per subkey table = limit_all + 2: index 0 = "node is not a
    definition", 1 = UNKNOWN hash, 2.. = the limit_all most frequent
    train hashes."""

    subkeys: tuple[str, ...] = ALL_SUBKEYS
    limit_all: int | None = 1000
    limit_subkeys: int | None = 1000
    max_defs: int | None = None
    struct_feats: bool = False

    def __post_init__(self):
        object.__setattr__(self, "subkeys", tuple(sorted(set(self.subkeys))))

    @property
    def input_dim(self) -> int:
        if self.limit_all is None:
            raise ValueError(
                "input_dim is undefined for an unlimited vocab (limit_all=None); "
                "size the embedding from the built vocab instead"
            )
        return self.limit_all + 2


@dataclass(frozen=True)
class ModelConfig:
    """GGNN architecture; the reference's fields and defaults.

    On a CUDA device every GGNN step runs the hand-written kernel
    (nn/ggnn_kernel.py), whatever `ggnn_kernel` says; on the CPU it runs
    the kernel's plain PyTorch version. `ggnn_kernel` and `scan_steps`
    choose between XLA lowerings in the reference, the block knobs its
    VMEM tiling; they are read past here (the CUDA kernel's tiling is
    fixed, nn/ggnn_kernel.py:block_sizes). The other kernel knobs keep
    their names: the variants this slice has not ported raise
    NotImplementedError."""

    hidden_dim: int = 32
    n_steps: int = 5
    n_etypes: int = 1
    scan_steps: bool = False
    num_output_layers: int = 3
    concat_all_absdf: bool = True
    struct_feats: bool = False
    label_style: str = "graph"
    encoder_mode: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    ggnn_kernel: bool = False
    ggnn_kernel_scatter: str = "auto"
    ggnn_kernel_accum: str = "fp32"
    ggnn_kernel_unroll: str = "per_step"
    ggnn_kernel_block_nodes: int = 0
    ggnn_kernel_block_edges: int = 0

    def __post_init__(self):
        if self.ggnn_kernel_accum not in ("fp32", "bf16", "int8"):
            raise ValueError(f"unknown ggnn_kernel_accum {self.ggnn_kernel_accum!r}")
        if self.ggnn_kernel_accum != "fp32":
            raise NotImplementedError(
                f"ggnn_kernel_accum={self.ggnn_kernel_accum!r}: the bf16/int8 "
                "message policies of the GGNN step kernel come with a later "
                "slice of the port (ROADMAP queue A, kernel 1 variants)"
            )
        if self.ggnn_kernel_unroll not in ("per_step", "fused"):
            raise ValueError(f"unknown ggnn_kernel_unroll {self.ggnn_kernel_unroll!r}")
        if self.ggnn_kernel_unroll == "fused":
            raise NotImplementedError(
                "ggnn_kernel_unroll='fused': the whole-unroll GGNN kernel "
                "comes with a later slice of the port (ROADMAP queue A, kernel 2)"
            )
        if self.ggnn_kernel_scatter not in ("auto", "fold", "mxu"):
            raise ValueError(
                f"unknown ggnn_kernel_scatter {self.ggnn_kernel_scatter!r}"
            )
        if self.ggnn_kernel_scatter == "mxu":
            raise NotImplementedError(
                "ggnn_kernel_scatter='mxu': the one-hot matmul scatter comes "
                "with a later slice of the port; the CUDA kernel sums each "
                "node's dst-sorted edge run in edge order (the 'fold' order)"
            )


@dataclass(frozen=True)
class BatchConfig:
    """Static-shape batching budgets."""

    graphs_per_batch: int = 256
    max_nodes_per_graph: int = 512
    node_budget: int = 16384
    edge_budget: int = 65536


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "bigvul"
    feat: FeatureSpec = field(default_factory=FeatureSpec)
    gtype: str = "cfg"
    batch: BatchConfig = field(default_factory=BatchConfig)


@dataclass(frozen=True)
class ServeConfig:
    """The dynamic batcher's knobs (serve/batcher.py)."""

    # bounded request queue; submissions beyond this raise QueueFull
    queue_limit: int = 256
    # a partial batch executes once its oldest request waited this long
    max_batch_delay_ms: float = 25.0
    # largest serve batch; the executor warms the pow2 ladder up to it
    max_batch_graphs: int = 16
    # packed-batch budgets for serving; 0 = inherit data.batch.*
    node_budget: int = 0
    edge_budget: int = 0
    # > 0 overlaps host work with the device in the reference; the port
    # runs the serial path (0) only in this slice
    pipeline_depth: int = 0


@dataclass(frozen=True)
class Config:
    run_name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)


def serve_budgets(cfg: Config) -> tuple[int, int]:
    """(node_budget, edge_budget) of serving: serve.* or data.batch.*."""
    return (
        cfg.serve.node_budget or cfg.data.batch.node_budget,
        cfg.serve.edge_budget or cfg.data.batch.edge_budget,
    )


def _nested_dataclass(cls: type, field_name: str) -> type | None:
    t = typing.get_type_hints(cls).get(field_name)
    return t if dataclasses.is_dataclass(t) else None


def from_dict(d: dict[str, Any]) -> Config:
    """Build a Config from the reference's JSON layout, reading the
    fields the port has and passing over the rest."""

    def resolve(cls, dd):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in dd:
                continue
            v = dd[f.name]
            nested = _nested_dataclass(cls, f.name)
            if nested is not None and isinstance(v, dict):
                v = resolve(nested, v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    return resolve(Config, d)


def load(path: str | Path) -> Config:
    return from_dict(json.loads(Path(path).read_text()))
