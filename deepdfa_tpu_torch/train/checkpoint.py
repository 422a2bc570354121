"""Checkpoints with best-metric selection (the semantics of the
reference's `deepdfa_tpu/train/checkpoint.py:CheckpointManager`, in a
torch-native format).

Each tag is a directory holding `state.pt`, a `torch.save` of the
model's state dict (and of whatever else the caller hands `save`). A
json manifest records `best`, `last` and the history of (tag, step,
metrics); `monitor` and `mode` pick the best, which is also copied to
`best/`. The manifest is written atomically (core/ioutil.py); a
corrupt one is rebuilt from the tag directories on disk. `keep_last`
bounds the tagged directories a run keeps (`best` and the last tag are
always kept). Restoring an orbax checkpoint of the JAX package is not
this module's work.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Any

import torch

from deepdfa_tpu_torch.core.ioutil import atomic_write_text

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(
        self,
        directory: str | Path,
        monitor: str = "val_loss",
        mode: str = "min",
        keep_last: int | None = None,
    ):
        """keep_last: retain only the newest N tagged checkpoints (`best`
        is exempt); None/0 = unbounded."""
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.keep_last = int(keep_last) if keep_last else 0
        self._manifest_path = self.directory / "manifest.json"
        self._manifest: dict[str, Any] = {"best": None, "last": None, "history": []}
        if self._manifest_path.exists():
            try:
                self._manifest = json.loads(self._manifest_path.read_text())
            except (json.JSONDecodeError, OSError) as e:
                logger.warning("corrupt checkpoint manifest %s (%s); rebuilding "
                               "from the tag directories", self._manifest_path, e)
                self._manifest = self._rebuild_manifest()
                self._write_manifest()

    def _rebuild_manifest(self) -> dict[str, Any]:
        """Tags in name order with unknown metrics; with no recorded
        metric the next save wins the best comparison (the safe way)."""
        history = [{"tag": t, "step": -1, "metrics": {}}
                   for t in self.available_tags() if t != "best"]
        best = ({"tag": "best", "step": -1, "metrics": {}}
                if (self.directory / "best").is_dir() else None)
        return {"best": best, "last": history[-1] if history else None, "history": history}

    def _write_manifest(self) -> None:
        atomic_write_text(self._manifest_path, json.dumps(self._manifest, indent=2))

    def _is_better(self, value: float) -> bool:
        best = self._manifest["best"]
        prev = None if best is None else best["metrics"].get(self.monitor)
        if prev is None:
            return True
        return value < prev if self.mode == "min" else value > prev

    def _write(self, tag: str, state: Any) -> None:
        path = self.directory / tag
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / f".{STATE_FILE}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path / STATE_FILE)

    def save(self, tag: str, state: Any, metrics: dict[str, float], step: int) -> bool:
        """Save `state` (a state dict, or a dict of them) under `tag`;
        update the best and last pointers. Returns whether it is best."""
        self._write(tag, state)
        entry = {"tag": tag, "step": step, "metrics": metrics}
        self._manifest["history"].append(entry)
        self._manifest["last"] = entry
        is_best = self.monitor in metrics and self._is_better(metrics[self.monitor])
        if is_best:
            self._write("best", state)
            self._manifest["best"] = entry
        self._retain()
        self._write_manifest()
        return is_best

    def _retain(self) -> None:
        if not self.keep_last:
            return
        tags: list[str] = []
        for e in self._manifest["history"]:
            if e["tag"] not in tags:
                tags.append(e["tag"])
        keep = set(tags[-self.keep_last:])
        if self._manifest.get("last"):
            keep.add(self._manifest["last"]["tag"])
        for tag in tags:
            if tag not in keep and (self.directory / tag).is_dir():
                shutil.rmtree(self.directory / tag, ignore_errors=True)

    def restore(self, tag: str, map_location: Any = "cpu") -> Any:
        """What `save` stored under `tag` (tensors on `map_location`)."""
        path = self.directory / tag / STATE_FILE
        if not path.exists():
            avail = self.available_tags()
            raise FileNotFoundError(
                f"no checkpoint tag {tag!r} under {self.directory}"
                + (f"; available: {avail}" if avail else " (empty dir)")
            )
        return torch.load(path, map_location=map_location, weights_only=True)

    def available_tags(self) -> list[str]:
        """Checkpoint directories on disk (manifest-independent)."""
        return sorted(p.name for p in self.directory.iterdir() if p.is_dir())

    def best_metrics(self) -> dict[str, float] | None:
        best = self._manifest["best"]
        return None if best is None else dict(best["metrics"])
