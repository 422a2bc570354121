"""Output head: stacked Linear+ReLU ending in `out_features` logits (the
reference's `deepdfa_tpu/nn/mlp.py`): num_layers layers, hidden width
equal to the input width."""

from __future__ import annotations

import torch
from torch import nn

from deepdfa_tpu_torch.nn.init import truncated_normal_


class OutputHead(nn.Module):
    def __init__(self, in_features: int, num_layers: int, out_features: int = 1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            setattr(self, f"dense_{i}", nn.Linear(in_features, out_features if last else in_features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for i in range(self.num_layers):
            layer = getattr(self, f"dense_{i}")
            truncated_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x
