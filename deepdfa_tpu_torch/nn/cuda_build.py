"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its
own into `build/deepdfa_tpu_torch/lib<name>-<hash>.so` under the repo
root, a directory that `.gitignore` lists. The hash covers the source
and the compiler flags, so an edited source builds anew and an
unchanged one loads from the cache. Nothing is built when the module is
imported: `load` builds at first use, `build` builds a set of sources
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
#: every kernel source of the package
SOURCES = ("ggnn_step", "ggnn_bwd")

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


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every source in `names` whose library is missing, one
    nvcc per source, all started together. Returns per source
    {"cached", "seconds", "log"}, `log` holding ptxas's report."""
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
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )
            started[name] = (proc, tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in started.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
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
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
