"""The port stands alone: `deepdfa_tpu_torch` and `chip_smoke.py` load no
`jax`, `flax` or `deepdfa_tpu` module, because the machine with the card
has none of them; and `chip_smoke.py` refuses to run without a card or
without the package beside it."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "deepdfa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "deepdfa_tpu")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import deepdfa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    deepdfa_tpu_torch.__path__, "deepdfa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
new = sorted(set(sys.modules) - before)
print(json.dumps({"modules": names, "new": new}))
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {
        "deepdfa_tpu_torch.core.config", "deepdfa_tpu_torch.graphs.batch",
        "deepdfa_tpu_torch.nn.cuda_build", "deepdfa_tpu_torch.nn.ggnn_kernel",
        "deepdfa_tpu_torch.nn.embedding", "deepdfa_tpu_torch.nn.mlp",
        "deepdfa_tpu_torch.nn.gnn", "deepdfa_tpu_torch.models.deepdfa",
        "deepdfa_tpu_torch.models.convert", "deepdfa_tpu_torch.serve.batcher",
        "deepdfa_tpu_torch.serve.driver", "deepdfa_tpu_torch.graphs.store",
        "deepdfa_tpu_torch.train.losses", "deepdfa_tpu_torch.train.state",
        "deepdfa_tpu_torch.train.sampler", "deepdfa_tpu_torch.train.metrics",
        "deepdfa_tpu_torch.train.checkpoint", "deepdfa_tpu_torch.train.loop",
        "deepdfa_tpu_torch.cli", "deepdfa_tpu_torch.nn.flash_attention",
        "deepdfa_tpu_torch.data.tokenizer", "deepdfa_tpu_torch.data.text",
        "deepdfa_tpu_torch.models.transformer", "deepdfa_tpu_torch.models.combined",
        "deepdfa_tpu_torch.data.examples", "deepdfa_tpu_torch.train.combined_loop",
        "deepdfa_tpu_torch.train.transfer", "deepdfa_tpu_torch.nn.dropout",
        "deepdfa_tpu_torch.models.t5", "deepdfa_tpu_torch.tune.kernel",
        "deepdfa_tpu_torch.tune.ladder", "deepdfa_tpu_torch.tune.cache",
        "deepdfa_tpu_torch.tune.driver",
    }
    assert expected <= set(report["modules"])
    assert [m for m in report["new"] if _forbidden(m)] == []


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module)
    return found


def test_no_source_imports_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "kernel_trial.py")]
    assert len(files) > 13
    bad = {str(f.relative_to(ROOT)): sorted(m for m in _imports(f) if _forbidden(m))
           for f in files}
    assert {f: m for f, m in bad.items() if m} == {}


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, the script exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run for real")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        res = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
            text=True, timeout=300,
        )
        assert res.returncode != 0, res.stdout
        assert '"ok": true' not in res.stdout
        assert "CUDA" in res.stderr or "cuda" in res.stderr
