"""Dropout seeds and the plain (hidden-state) dropout of the transformer
path.

The reference threads `jax.random` keys: `split` gives each consumer its
own key and `_dropout` draws a Bernoulli mask from it. The port threads
64-bit integer seeds instead. `fold_seed(seed, *path)` derives the seed
of a sub-consumer (a layer, a dropout site) from its parent and a path
of small integers; the attention-probs dropout hands its seed to the
flash kernel (Philox bits, `nn/flash_attention.py`), and every other
site draws its mask with `dropout`, from a `torch.Generator` built from
the seed on each call. A mask is therefore a function of (seed, shape,
device): a layer recomputed under `torch.utils.checkpoint` draws the
same masks as its first run, with no generator state to restore. The
numbers differ from the reference's threefry stream (same rule, same
rate); the tests hold the math with dropout off or with explicit bits.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_seed(seed: int, *path: int) -> int:
    """A 64-bit seed derived from `seed` and the integer `path` (a
    SeedSequence hash: distinct paths give unrelated seeds)."""
    words = np.random.SeedSequence([int(seed), *map(int, path)]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1]) << 32)


def dropout(x: torch.Tensor, rate: float, seed: int | None) -> torch.Tensor:
    """The reference's `_dropout`: keep each element with probability
    1 - rate and scale it by 1 / (1 - rate); no-op without a seed or at
    rate 0. The mask comes from a generator on x's device seeded by
    `seed`, built anew on every call."""
    if seed is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
