"""Durable small-file writes (the port's copy of the reference's
`deepdfa_tpu/core/ioutil.py:atomic_write_text`), shared by the checkpoint
manifest (train/checkpoint.py) and `tuned.json` (tune/cache.py), which
the serving registry polls while they are rewritten.

A crash mid-`write_text` would leave a truncated file that poisons every
later read, so the text goes to a temporary file beside the target, is
fsynced, and is renamed into place; the directory is fsynced too, so
the rename survives a power loss. A reader sees the old complete
content or the new one.

`with_retries` (the reference's, for the packed-batch cache's reads,
data/packed_cache.py) re-runs an I/O operation that failed with a
transient OSError, with exponential backoff, a bounded number of times.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")


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


def with_retries(
    fn: Callable[[], T],
    retries: int = 2,
    backoff_s: float = 0.05,
    exceptions: tuple[type[BaseException], ...] = (OSError,),
    no_retry: tuple[type[BaseException], ...] = (FileNotFoundError,),
    what: str = "io operation",
) -> T:
    """Run `fn` with up to `retries` retries on `exceptions`, sleeping
    `backoff_s * 2**attempt` between attempts; the final failure
    propagates unchanged. `no_retry` carves out subclasses that propagate
    at once: by default FileNotFoundError, which means absence (a
    concurrently evicted cache entry), not a transient blip."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            if isinstance(e, no_retry) or attempt >= retries:
                raise
            delay = backoff_s * (2**attempt)
            logger.warning("%s failed (%s: %s); retry %d/%d in %.3fs",
                           what, type(e).__name__, e, attempt + 1, retries, delay)
            time.sleep(delay)
            attempt += 1
