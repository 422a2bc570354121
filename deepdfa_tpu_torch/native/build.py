"""Build the port's native host library with g++ (`-O2 -shared -fPIC
-std=c++17`) from `native/src/native.cpp`, the port's own copy of the
reference's C++ source.

Usage: python -m deepdfa_tpu_torch.native.build [--force]

The library lands in `build/deepdfa_tpu_torch/` under the repo root (a
directory that `.gitignore` lists) as `libdeepdfa_native-<hash>.so`,
the hash covering the source and the flags, as `nn/cuda_build.py` names
the CUDA libraries: an edited source builds anew, an unchanged one
loads from the cache. The build is atomic (a temporary file in the same
directory, then `os.replace`), since spawned `extract` workers may all
build and load it at the same moment. The ctypes loader
(`deepdfa_tpu_torch.native`) builds at first use.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepdfa_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def compiler() -> str | None:
    """g++ on PATH, or None."""
    return shutil.which("g++")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdeepdfa_native-{digest}.so"


def build(force: bool = False) -> Path:
    """The library's path, compiling it first when it is missing (or
    `force`). Raises RuntimeError without g++, and with the compiler's
    stderr when the compile fails."""
    out = library_path()
    if out.exists() and not force:
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native lexer and solver build with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed building {SRC} (exit {res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        Path(tmp).unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    print(f"built {build(force='--force' in sys.argv)}")
