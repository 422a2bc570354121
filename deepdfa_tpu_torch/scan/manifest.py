"""Persistent scan manifest: the incremental-rescan ledger
(docs/scanning.md).

Two keyed layers, both pruned to what the latest scan actually saw:

- `files[rel]` — {sha256, functions: [{key, name, start_line,
  end_line}]}: an unchanged file (same content hash) reuses its split
  without re-reading function boundaries;
- `functions[key]` — {ok, prob, error?, lines?}: the per-function scan
  result, keyed by the frontend CONTENT KEY (sha256 of the function's
  source + the feat-spec/gtype/parser identity,
  `RequestPreprocessor.content_key`), so a function reuses its score
  wherever it moves — across lines, files, or renames.

The manifest is pinned to a model identity (config digest, vocab
digest, checkpoint step, attribution method): any identity drift drops
every entry — content-keyed reuse must never serve scores from a
different checkpoint or feature recipe. Writes are atomic
(core/ioutil.py), so a killed scan leaves the previous complete
manifest, never a truncated one.

The port's copy of the JAX package's `deepdfa_tpu/scan/manifest.py`.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from deepdfa_tpu_torch.core.ioutil import atomic_write_text

logger = logging.getLogger(__name__)

MANIFEST_VERSION = 1


class ScanManifest:
    """Content-keyed per-function scan state for one (repo, model)."""

    def __init__(self, path: str | Path, identity: dict):
        self.path = Path(path)
        self.identity = dict(identity)
        self.files: dict[str, dict] = {}
        self.functions: dict[str, dict] = {}
        #: True when an on-disk manifest with a MATCHING identity was
        #: loaded (the incremental-reuse precondition)
        self.resumed = False

    @classmethod
    def load(cls, path: str | Path, identity: dict) -> "ScanManifest":
        m = cls(path, identity)
        path = Path(path)
        if not path.exists():
            return m
        try:
            raw = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("scan manifest %s unreadable (%s); cold scan",
                           path, e)
            return m
        if raw.get("version") != MANIFEST_VERSION:
            logger.warning(
                "scan manifest %s has version %s (want %s); cold scan",
                path, raw.get("version"), MANIFEST_VERSION,
            )
            return m
        if raw.get("identity") != m.identity:
            drift = sorted(
                k for k in set(raw.get("identity", {})) | set(m.identity)
                if raw.get("identity", {}).get(k) != m.identity.get(k)
            )
            logger.warning(
                "scan manifest %s was written under a different model "
                "identity (%s changed); cold scan", path, drift,
            )
            return m
        files = raw.get("files")
        functions = raw.get("functions")
        if isinstance(files, dict) and isinstance(functions, dict):
            m.files = files
            m.functions = functions
            m.resumed = True
        return m

    def file_functions(self, rel: str, sha256: str) -> list[dict] | None:
        """The recorded function spans for an UNCHANGED file — None when
        the file is new, changed, or any of its functions is missing a
        result (a crashed previous scan), in which case the caller
        re-splits."""
        entry = self.files.get(rel)
        if not entry or entry.get("sha256") != sha256:
            return None
        fns = entry.get("functions", [])
        if any(f.get("key") not in self.functions for f in fns):
            return None
        return fns

    def record_file(self, rel: str, sha256: str, fns: list[dict]) -> None:
        self.files[rel] = {"sha256": sha256, "functions": fns}

    def result(self, key: str) -> dict | None:
        return self.functions.get(key)

    def record_result(self, key: str, result: dict) -> None:
        self.functions[key] = result

    def prune(self, seen_files: set[str], seen_keys: set[str]) -> None:
        """Keep only what this scan saw — the manifest mirrors the repo
        state, it is not an unbounded score archive."""
        self.files = {
            r: v for r, v in self.files.items() if r in seen_files
        }
        self.functions = {
            k: v for k, v in self.functions.items() if k in seen_keys
        }

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(self.path, json.dumps({
            "version": MANIFEST_VERSION,
            "identity": self.identity,
            "files": self.files,
            "functions": self.functions,
        }))
