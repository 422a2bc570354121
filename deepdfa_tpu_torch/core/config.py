"""The port's share of the typed configuration.

It reads the same JSON files as the JAX package (`configs/*.json`,
`config.json` in a run dir) and keeps the sections this port runs: the
feature spec, batch budgets, split and sampling fields and the text
buckets (`seq_buckets`, `token_budget`) of `data`, all of
`model`, the batcher fields of `serve`, and the one-card training fields
of `train` (optimiser, schedule, checkpoint cadence, the mesh and the
resilience switch, which must say "one card, off", and the
`debug_nans`/`enable_checks` sanitizer switches, which must be off),
the `obs` switches (which must be off) and the autotuner's `tune`
section. Field names and defaults are the reference's (`deepdfa_tpu/core/config.py`), so one
file configures both packages. Keys the port does not run yet (the
rest of observability, fleet, the frontend, the prefetch pipeline and
`train.step_cache_entries`, which sizes the reference's cache of
compiled steps) are read past; the JAX package validates them.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

ALL_SUBKEYS = ("api", "datatype", "literal", "operator")

#: pad-token id per encoder family: the one convention shared by the text
#: collater's padding (data/text.py) and the encoders' attention-mask
#: derivation (`input_ids != pad`, models/transformer.py). RoBERTa vocabs
#: put <pad> at 1, the T5 frame at 0.
PAD_ID_BY_FAMILY = {"roberta": 1, "t5": 0}


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

    @property
    def name(self) -> str:
        """The artifact name of this spec (graph-store directories)."""
        sk = "_".join(sorted(self.subkeys))
        base = (
            f"_ABS_DATAFLOW_{sk}_all_limitall_{self.limit_all}"
            f"_limitsubkeys_{self.limit_subkeys}"
        )
        if self.max_defs is not None:
            base += f"_maxdefs_{self.max_defs}"
        if self.struct_feats:
            base += "_struct"
        return base


@dataclass(frozen=True)
class ModelConfig:
    """GGNN architecture; the reference's fields and defaults.

    On a CUDA device every GGNN step runs the hand-written kernels
    (nn/ggnn_kernel.py) and on the CPU their plain PyTorch versions,
    whatever `ggnn_kernel` says. As in the reference, `ggnn_kernel` gates
    the kernel's knobs: with it, `ggnn_kernel_accum` (fp32 | bf16 | int8
    message policy), `ggnn_kernel_scatter` (auto | fold | mxu; auto is
    fold, as off the TPU in the reference), `ggnn_kernel_unroll`
    (per_step | fused, the whole-unroll kernel) and
    `ggnn_kernel_block_edges` act; without it the steps run fp32, fold,
    per step, the reference's lax function. `ggnn_kernel_block_edges` is
    the mxu scatter's edge block (0: 512, shrunk to divide the edge
    budget, nn/ggnn_kernel.py:edge_block): under int8 mxu it changes the
    numbers, as in the reference; under fold it is layout only (the CUDA
    fold walks CSR runs and has no edge blocks). `ggnn_kernel_block_nodes`
    is the reference's VMEM node tile and is read past here (the CUDA
    kernels' node tile is fixed, nn/ggnn_kernel.py:block_sizes).
    `scan_steps` enters the fused admission rule."""

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
        if self.ggnn_kernel_unroll not in ("per_step", "fused"):
            raise ValueError(f"unknown ggnn_kernel_unroll {self.ggnn_kernel_unroll!r}")
        if self.ggnn_kernel_scatter not in ("auto", "fold", "mxu"):
            raise ValueError(
                f"unknown ggnn_kernel_scatter {self.ggnn_kernel_scatter!r}"
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
    split: str = "fixed"  # fixed | random | fixed+random seed schemes
    seed: int = 0
    undersample: bool = True  # epoch-wise 1:1 undersampling of negatives
    batch: BatchConfig = field(default_factory=BatchConfig)
    # sequence-length buckets of the combined (text + graph) path: a row
    # pads to the smallest edge >= its real token length; () = none
    seq_buckets: tuple[int, ...] = ()
    # tokens per bucketed batch: a bucket of edge T holds
    # token_budget // T rows (data/text.py:rows_for_bucket)
    token_budget: int = 8192


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
class OptimConfig:
    name: str = "adamw"  # adamw | adam | sgd
    learning_rate: float = 1e-3
    weight_decay: float = 1e-2
    warmup_frac: float = 0.0
    grad_clip_norm: float = 0.0  # 0 = off
    b1: float = 0.9
    b2: float = 0.999


@dataclass(frozen=True)
class MeshConfig:
    """The reference's device mesh. The port trains on one card: every
    axis must resolve to 1 (`one_card`)."""

    dp: int = -1  # -1 = all remaining devices: 1 on one card
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    fsdp: int = 1
    num_shards: int = 0  # logical data shards; 0 = dp


@dataclass(frozen=True)
class ResilienceConfig:
    """Only the switch: the resilient runtime comes with a later slice."""

    enabled: bool = False


@dataclass(frozen=True)
class ObsConfig:
    """The reference's telemetry switches (its `obs` section). The port
    has no instruments yet; a trainer refuses a config that turns one on."""

    trace: bool = False
    metrics: bool = False
    xprof_start_step: int = -1
    xprof_trigger: bool = False
    ledger: bool = False
    ledger_ceilings: bool = False
    flight: bool = False

    @property
    def enabled(self) -> bool:
        return (self.trace or self.metrics or self.xprof_start_step >= 0 or self.xprof_trigger
                or self.ledger or self.ledger_ceilings or self.flight)


@dataclass(frozen=True)
class TrainConfig:
    max_epochs: int = 25
    eval_every_epochs: int = 1
    checkpoint_every_epochs: int = 25
    checkpoint_keep_last: int = 0  # 0 = keep every epoch checkpoint
    monitor: str = "val_loss"  # checkpoint-selection metric
    monitor_mode: str = "min"
    seed: int = 1
    pos_weight: float | None = None  # None = derived from train labels
    log_every_steps: int = 50
    # feature-identity dropout: with this probability per node, known
    # abstract-dataflow buckets map to UNKNOWN (train/loop.py)
    feat_unknown_dropout: float = 0.0
    # the reference's jax sanitizers (NaN checks, invariant checks): the
    # port has no counterpart yet and refuses them when set
    debug_nans: bool = False
    enable_checks: bool = False
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)


@dataclass(frozen=True)
class TuneConfig:
    """The reference's autotuner section (its `TuneConfig`): `enabled`
    makes `train` fold the matching tuned.json record into the config
    (tune/cache.py:apply_to_config); `path` (None: <storage>/tuned.json),
    the ladder budgets, the compile-seconds budget and the timing reps
    drive `cli tune`."""

    enabled: bool = False
    path: str | None = None
    max_rungs: int = 6
    max_seq_buckets: int = 6
    compile_budget_s: float = 120.0
    reps: int = 3


@dataclass(frozen=True)
class Config:
    run_name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    tune: TuneConfig = field(default_factory=TuneConfig)


def one_card(mesh: MeshConfig) -> int:
    """The data-parallel size of `mesh` on the port's one card: 1, or
    NotImplementedError for a mesh that needs more than one device or
    several logical shards per batch."""
    if mesh.dp not in (-1, 1) or mesh.num_shards not in (0, 1) or any(
        getattr(mesh, a) != 1 for a in ("tp", "sp", "pp", "ep", "fsdp")
    ):
        raise NotImplementedError(
            f"train.mesh={mesh}: the port trains on one card (dp -1 or 1, "
            "every other axis and num_shards 1); data parallelism comes "
            "with a later slice (ROADMAP queue A)"
        )
    return 1


def refuse_unported_training(cfg: Config) -> None:
    """NotImplementedError for the training options the port does not
    run: a mesh beyond one card, `train.resilience.enabled`, the
    `train.debug_nans`/`train.enable_checks` sanitizers and any `obs`
    instrument."""
    one_card(cfg.train.mesh)
    for name in ("debug_nans", "enable_checks"):
        if getattr(cfg.train, name):
            raise NotImplementedError(
                f"train.{name}: the reference's jax sanitizer has no counterpart in the "
                "port yet (ROADMAP queue C); set it to false"
            )
    if cfg.train.resilience.enabled:
        raise NotImplementedError(
            "train.resilience.enabled: the resilient runtime (guarded step, step "
            "checkpoints, resume) comes with a later slice of the port (ROADMAP queue A)"
        )
    if cfg.obs.enabled:
        raise NotImplementedError(
            f"obs={cfg.obs}: the telemetry instruments come with a later slice of the "
            "port (ROADMAP queue A, item 10)"
        )


#: relation count each gtype produces (the reference's pipeline.extract_graph)
GTYPE_ETYPES = {"cfg": 1, "pdg": 1, "cfg+dep": 3}


def validate(cfg: Config) -> None:
    """Cross-field checks at config load (the reference's `validate`):
    the GGNN's relation count must match the edge-relation set of
    `data.gtype`, or a typed store fed to a single-relation model (or the
    other way round) would route messages wrongly."""
    want = GTYPE_ETYPES.get(cfg.data.gtype)
    if want is None:
        raise ValueError(f"unknown data.gtype {cfg.data.gtype!r}")
    if cfg.model.n_etypes != want:
        raise ValueError(
            f"model.n_etypes={cfg.model.n_etypes} does not match "
            f"data.gtype={cfg.data.gtype!r} (needs n_etypes={want})"
        )


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


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return list(cfg)
    return cfg


def to_json(cfg: Config, path: str | Path | None = None) -> str:
    s = json.dumps(to_dict(cfg), indent=2)
    if path is not None:
        Path(path).write_text(s)
    return s


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply `a.b.c=value` overrides (values parsed as JSON, else kept
    as strings) to the fields the port reads, with the reference's type
    rules: an unknown key raises KeyError; a value of another type than
    the field's raises TypeError (an int widens to a float, a bool is
    never an int); a section takes only a JSON object, merged into it; a
    field whose value is None takes only valid JSON."""
    d = to_dict(cfg)
    for ov in overrides:
        key, eq, raw = ov.partition("=")
        if not eq:
            raise ValueError(f"override must be key=value, got {ov!r}")
        try:
            val = json.loads(raw)
            parsed_json = True
        except json.JSONDecodeError:
            val = raw
            parsed_json = False
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            if not isinstance(node, dict) or p not in node:
                raise KeyError(f"unknown config key: {key}")
            node = node[p]
        if not isinstance(node, dict) or parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        old = node[parts[-1]]
        if isinstance(old, dict):
            if not isinstance(val, dict):
                raise TypeError(f"override {key}={raw!r}: {key} is a config section; override "
                                "its fields one by one or pass a JSON object")
            node[parts[-1]] = {**old, **val}
            continue
        if old is None and not parsed_json:
            raise TypeError(f"override {key}={raw!r} is not valid JSON; quote strings "
                            f"explicitly (e.g. {key}='\"text\"')")
        if old is not None and val is not None and not isinstance(val, type(old)):
            if isinstance(old, float) and isinstance(val, int) and not isinstance(val, bool):
                val = float(val)
            else:
                raise TypeError(f"override {key}={raw!r}: expected {type(old).__name__}, "
                                f"got {type(val).__name__}")
        elif isinstance(val, bool) != isinstance(old, bool) and None not in (old, val):
            raise TypeError(f"override {key}={raw!r}: expected {type(old).__name__}, "
                            f"got {type(val).__name__}")
        node[parts[-1]] = val
    return from_dict(d)
