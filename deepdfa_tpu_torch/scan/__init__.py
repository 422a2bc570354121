"""Whole-repo incremental scanning (the port's copy of the JAX package's
`deepdfa_tpu/scan/`).

`cli scan <repo>` walks a repository, splits every C/C++ source into
function definitions (scan/walker.py), scores each through the serving
frontend and batcher on the card, optionally attributes per-line
vulnerability scores (serve/localize.py), and writes findings as JSONL
and SARIF 2.1.0 (scan/sarif.py). A persistent content-keyed manifest
(scan/manifest.py) makes a re-scan of an edited repo touch only the
changed functions.
"""

from deepdfa_tpu_torch.scan.manifest import ScanManifest
from deepdfa_tpu_torch.scan.sarif import sarif_report, validate_sarif
from deepdfa_tpu_torch.scan.scanner import RepoScanner, run_scan_smoke
from deepdfa_tpu_torch.scan.walker import (
    FunctionSpan,
    SourceFile,
    split_functions,
    walk_repo,
)

__all__ = [
    "FunctionSpan",
    "RepoScanner",
    "ScanManifest",
    "SourceFile",
    "run_scan_smoke",
    "sarif_report",
    "split_functions",
    "validate_sarif",
    "walk_repo",
]
