"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each library `<name>` is one `csrc/*.cu` source with a plain C interface,
compiled on its own into `build/deepdfa_tpu_torch/lib<name>-<hash>.so`
under the repo root, a directory that `.gitignore` lists. A library is
`csrc/<name>.cu` unless `VARIANTS` names another source and the macros
it is built with: `flash_attention_causal` is `flash_attention.cu` built
with `FLASH_CAUSAL=1` (the causal instances of the flash kernels), so
the two halves of that source compile in parallel. A source may include
the headers beside it (`csrc/*.cuh`). The hash covers the source, those
headers and the compiler flags, so an edited source or header builds
anew and an unchanged one loads from the cache. Nothing is built when the module is
imported: `load` builds at first use, `build` builds a set of libraries
with one nvcc process each, all started together.

The sources include no PyTorch headers, which keeps a build to seconds;
the wrappers pass device pointers and the current stream as integers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepdfa_tpu_torch"
#: Hopper with its architecture-specific features (sm_90a); -Xptxas -v
#: reports registers, shared memory and spills into the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: library -> (source stem, extra nvcc flags), where they differ from
#: (the library's name, none)
VARIANTS = {"flash_attention_causal": ("flash_attention", ("-DFLASH_CAUSAL=1",))}
#: every kernel library of the package
SOURCES = ("ggnn_step", "ggnn_bwd", "flash_attention", "flash_attention_causal")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); the "
        "CUDA kernels build only on a machine with the CUDA toolkit"
    )


def _source_and_flags(name: str) -> tuple[Path, tuple[str, ...]]:
    stem, extra = VARIANTS.get(name, (name, ()))
    return CSRC_DIR / f"{stem}.cu", (*NVCC_FLAGS, *extra)


def library_path(name: str) -> Path:
    src, flags = _source_and_flags(name)
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every library in `names` that is missing, one nvcc per
    library, all started together. Returns per library {"cached",
    "seconds", "log"}, `log` holding ptxas's report."""
    report: dict[str, dict] = {}
    started = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                log = out.with_suffix(".log")
                report[name] = {
                    "cached": True, "seconds": 0.0,
                    "log": log.read_text() if log.exists() else "",
                }
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            src, flags = _source_and_flags(name)
            cmd = [nvcc(), *flags, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            started[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in started.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name} (exit {proc.returncode}):\n"
                    f"{stdout}{stderr}"
                )
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(stdout + stderr)
            report[name] = {
                "cached": False,
                "seconds": time.perf_counter() - t0,
                "log": stdout + stderr,
            }
    finally:
        for proc, tmp, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
