"""The port stands alone: `deepdfa_tpu_torch` and `chip_smoke.py` load no
`jax`, `flax`, `ml_dtypes` or `deepdfa_tpu` module, nor `pandas`, `regex`,
`tokenizers` or `transformers`, because the machine with the card has
none of them; and `chip_smoke.py` refuses to run without a card or
without the package beside it."""

import ast
import functools
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
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "deepdfa_tpu")
#: host libraries the reference uses that the card's machine lacks (or
#: may lack: tensorboard); the port imports them only where it calls them
ABSENT_ON_CARD = ("pandas", "regex", "tokenizers", "transformers", "nni", "tensorboard",
                  "tensorflow")

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
    return module.split(".")[0] in FORBIDDEN + ABSENT_ON_CARD


@functools.lru_cache(maxsize=1)
def _import_report() -> dict:
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
        text=True, timeout=300, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_every_module_loads_no_jax():
    report = _import_report()
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
        "deepdfa_tpu_torch.tune.driver", "deepdfa_tpu_torch.frontend",
        "deepdfa_tpu_torch.frontend.tokens", "deepdfa_tpu_torch.frontend.preproc",
        "deepdfa_tpu_torch.frontend.cpg", "deepdfa_tpu_torch.frontend.parser",
        "deepdfa_tpu_torch.frontend.reaching", "deepdfa_tpu_torch.frontend.deps",
        "deepdfa_tpu_torch.frontend.absdf", "deepdfa_tpu_torch.frontend.vocab",
        "deepdfa_tpu_torch.data.diffs", "deepdfa_tpu_torch.data.pipeline",
        "deepdfa_tpu_torch.data.readers", "deepdfa_tpu_torch.data.synthetic",
        "deepdfa_tpu_torch.core.paths", "deepdfa_tpu_torch.core.ioutil",
        "deepdfa_tpu_torch.serve.frontend", "deepdfa_tpu_torch.serve.registry",
        "deepdfa_tpu_torch.serve.cascade", "deepdfa_tpu_torch.serve.server",
        "deepdfa_tpu_torch.eval.calibrate", "deepdfa_tpu_torch.eval.codebleu",
        "deepdfa_tpu_torch.models.t5_gen", "deepdfa_tpu_torch.train.gen_loop",
        "deepdfa_tpu_torch.train.clone_loop", "deepdfa_tpu_torch.native",
        "deepdfa_tpu_torch.native.build", "deepdfa_tpu_torch.serve.quant",
        "deepdfa_tpu_torch.serve.localize", "deepdfa_tpu_torch.data.prefetch",
        "deepdfa_tpu_torch.data.mp_pack", "deepdfa_tpu_torch.data.packed_cache",
        "deepdfa_tpu_torch.frontend.structfeat", "deepdfa_tpu_torch.scan",
        "deepdfa_tpu_torch.scan.walker", "deepdfa_tpu_torch.scan.manifest",
        "deepdfa_tpu_torch.scan.sarif", "deepdfa_tpu_torch.scan.scanner",
        "deepdfa_tpu_torch.nn.setops", "deepdfa_tpu_torch.nn.bitprop",
        "deepdfa_tpu_torch.parallel", "deepdfa_tpu_torch.parallel.moe",
        "deepdfa_tpu_torch.eval.dfg_parity", "deepdfa_tpu_torch.testing.faults",
        "deepdfa_tpu_torch.train.resilience", "deepdfa_tpu_torch.frontend.joern_io",
        "deepdfa_tpu_torch.frontend.joern_session", "deepdfa_tpu_torch.frontend.typeinfo",
        "deepdfa_tpu_torch.frontend.fidelity", "deepdfa_tpu_torch.frontend.tokenise",
        "deepdfa_tpu_torch.eval.ivdetect", "deepdfa_tpu_torch.eval.coverage",
        "deepdfa_tpu_torch.eval.trivial_baseline", "deepdfa_tpu_torch.train.logging",
        "deepdfa_tpu_torch.train.nni_bridge", "deepdfa_tpu_torch.train.tuning",
        "deepdfa_tpu_torch.train.experiments", "deepdfa_tpu_torch.data.tokenizer_training",
        "deepdfa_tpu_torch.testing.joern_stub",
    }
    assert expected <= set(report["modules"])
    assert [m for m in report["new"] if _forbidden(m)] == []


def test_importing_every_module_loads_no_pandas_or_regex():
    """The readers parse csv without pandas, the BPE tokenizer
    pre-tokenizes without `regex`, and no module needs `tokenizers` or
    `transformers` (the HF weight import reads a plain state dict)."""
    report = _import_report()
    assert "deepdfa_tpu_torch.data.readers" in report["modules"]
    assert [m for m in report["new"] if m.split(".")[0] in ABSENT_ON_CARD] == []


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module)
    return found


#: the one module that may import each optional host package, inside the
#: function that needs it (the reference's lazy imports); everywhere else
#: they are as forbidden as JAX
OPTIONAL_AT_CALL_SITE = {
    "deepdfa_tpu_torch/data/tokenizer_training.py": "tokenizers",
    "deepdfa_tpu_torch/train/nni_bridge.py": "nni",
}


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    found = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found.add(node.module)
    return found


def test_no_source_imports_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "kernel_trial.py")]
    assert len(files) > 13
    bad = {}
    for f in files:
        rel = str(f.relative_to(ROOT))
        optional = OPTIONAL_AT_CALL_SITE.get(rel)
        lazy_ok = {m for m in _imports(f) - _top_level_imports(f)
                   if optional is not None and m.split(".")[0] == optional}
        bad[rel] = sorted(m for m in _imports(f) - lazy_ok if _forbidden(m))
    assert {f: m for f, m in bad.items() if m} == {}


def test_native_library_is_the_ports_own():
    """The native lexer and solver build from the port's own copy of the
    C++ source, into build/deepdfa_tpu_torch/, and the copy includes
    nothing of the JAX package."""
    from deepdfa_tpu_torch.native import build

    assert build.SRC == PACKAGE / "native" / "src" / "native.cpp"
    assert build.library_path().parent == ROOT / "build" / "deepdfa_tpu_torch"
    assert build.library_path().name.startswith("libdeepdfa_native-")
    source = build.SRC.read_text()
    includes = [ln for ln in source.splitlines() if ln.startswith("#include")]
    assert includes and all("<" in ln and "deepdfa" not in ln for ln in includes)
    ref = (ROOT / "deepdfa_tpu" / "native" / "src" / "native.cpp").read_text()
    # byte for byte below the header comment
    assert source[source.index("#include"):] == ref[ref.index("#include"):]
    probe = ("import sys; from deepdfa_tpu_torch import native; "
             "assert native.available(); native.lex_c_native('int x;'); "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'flax', 'deepdfa_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


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
