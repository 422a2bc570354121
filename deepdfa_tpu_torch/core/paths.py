"""Storage layout (the port's own copy of the reference's
`deepdfa_tpu/core/paths.py`): one rooted, env-overridable tree.

    <root>/
      processed/<dataset>/  examples, splits, vocabularies, graph stores
      cache/<dataset>/      packed-batch cache entries (packed/, packed-text/)
      runs/<run-name>/      config.json, logs, checkpoints-torch/ and
                            checkpoints-combined-torch/

The root is `$DEEPDFA_TPU_STORAGE`, else `storage/` at the repository
root. Each helper creates its directory.
"""

from __future__ import annotations

import os
from pathlib import Path

_ENV_VAR = "DEEPDFA_TPU_STORAGE"
#: a run's checkpoint directories: the GGNN's (`cli train`) and the
#: combined and t5 families' (`cli train-combined`)
CHECKPOINTS_DIR = "checkpoints-torch"
COMBINED_CHECKPOINTS_DIR = "checkpoints-combined-torch"
#: the resilient runtime's step checkpoints of each (train/resilience.py)
STEP_CHECKPOINTS_DIR = "checkpoints-torch-step"
COMBINED_STEP_CHECKPOINTS_DIR = "checkpoints-combined-torch-step"


def storage_root() -> Path:
    root = os.environ.get(_ENV_VAR)
    return Path(root) if root else Path(__file__).resolve().parents[2] / "storage"


def _sub(kind: str, name: str | None = None) -> Path:
    p = storage_root() / kind
    if name is not None:
        p = p / name
    p.mkdir(parents=True, exist_ok=True)
    return p


def processed_dir(dataset: str) -> Path:
    return _sub("processed", dataset)


def cache_dir(dataset: str) -> Path:
    return _sub("cache", dataset)


def runs_dir(run_name: str) -> Path:
    return _sub("runs", run_name)


def graphs_dirname(cfg) -> str:
    """The graph store's directory name for the config's feature spec and
    gtype; the flagship gtype "cfg" keeps the unsuffixed name."""
    suffix = "" if cfg.data.gtype == "cfg" else f"_gtype_{cfg.data.gtype}"
    return f"graphs{cfg.data.feat.name}{suffix}"
