"""Host-side PRNG discipline (the port's copy of the reference's
`deepdfa_tpu/core/prng.py:host_rng` and `hashstr`).

The reference's `root_key` and `fold_name` build JAX keys; the port's
counterpart is a `torch.Generator` seeded from the run's integer seed
(`torch.Generator().manual_seed(seed)`, as the trainers' `init_state`
does) and the integer seeds `nn/dropout.py:fold_seed` folds per step,
so it has no copy of them. Host-side (numpy) randomness for sampling
and shuffling derives from the same integer seed, so runs are
reproducible end to end.
"""

from __future__ import annotations

import hashlib

import numpy as np


def host_rng(seed: int, name: str = "") -> np.random.Generator:
    h = int.from_bytes(hashlib.sha256(f"{seed}:{name}".encode()).digest()[:8], "little")
    return np.random.default_rng(h)


def hashstr(s: str) -> int:
    """Stable 8-byte string hash for vocab bucketing and artifact naming."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "little")
