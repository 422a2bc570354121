"""Output head: stacked Dense+ReLU ending in `out_features` logits (the
reference's `deepdfa_tpu/nn/mlp.py`): num_layers layers, hidden width
equal to the input width.

`Dense` is `nn.Linear` with Flax's `nn.Dense` conventions: a lecun-normal
weight, a zero bias, parameters stored in `param_dtype`, and the input,
weight and bias promoted to one dtype before the product, as Flax's
`promote_dtype` does (a bfloat16 layer on fp32 input computes in fp32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepdfa_tpu_torch.nn.init import truncated_normal_


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, dtype=param_dtype)

    def init_flax(self, generator: torch.Generator | None = None) -> None:
        """Flax's initializers, drawn from `generator` (nn.Linear's own
        `reset_parameters` stays the construction-time draw)."""
        truncated_normal_(self.weight, self.in_features, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class OutputHead(nn.Module):
    def __init__(self, in_features: int, num_layers: int, out_features: int = 1,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            setattr(self, f"dense_{i}", Dense(in_features, out_features if last else in_features,
                                              param_dtype))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for i in range(self.num_layers):
            getattr(self, f"dense_{i}").init_flax(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x
