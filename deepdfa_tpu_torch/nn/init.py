"""Seeded weight initializers with Flax's defaults (`nn.Dense`'s
lecun_normal kernels and zero biases, `nn.Embed`'s fan-in normal), drawn
from an explicit `torch.Generator`. The draws differ from JAX's for the
same seed; parity tests load Flax weights through models/convert.py."""

from __future__ import annotations

import torch

#: stddev of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def truncated_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        torch.nn.init.trunc_normal_(
            w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
        )
    return w
