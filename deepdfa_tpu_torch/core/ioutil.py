"""Durable small-file writes (the port's copy of the reference's
`deepdfa_tpu/core/ioutil.py:atomic_write_text`), shared by the checkpoint
manifest (train/checkpoint.py) and `tuned.json` (tune/cache.py), which
the serving registry polls while they are rewritten.

A crash mid-`write_text` would leave a truncated file that poisons every
later read, so the text goes to a temporary file beside the target, is
fsynced, and is renamed into place; the directory is fsynced too, so
the rename survives a power loss. A reader sees the old complete
content or the new one.
"""

from __future__ import annotations

import os
from pathlib import Path


def fsync_dir(directory: str | Path) -> None:
    """fsync a directory so a rename inside it is durable (a no-op where
    a directory cannot be opened or fsynced)."""
    try:
        fd = os.open(str(directory), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str | Path, text: str) -> None:
    """`Path.write_text` that never leaves a partial file: tmp + fsync +
    rename + fsync of the directory."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with tmp.open("w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
