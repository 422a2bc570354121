"""Flax DeepDFA parameters -> the port's `state_dict`.

The input is the reference model's variables, `{"params": {...}}` (or
the bare params dict) with numpy arrays as leaves. Embedding tables and
the GGNN's weights keep their layout (the CUDA kernel reads the
reference's [in, out] kernels as they are); the per-etype Dense
subtrees stack into one [T, d, d] tensor; Dense layers that become
`nn.Linear` are transposed to [out, in].
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def from_jax_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    p = tree["params"] if "params" in tree else tree
    unknown = set(p) - {"embedding", "ggnn", "pooling", "head"}
    if unknown:
        raise KeyError(
            f"parameter subtrees the port has no module for: {sorted(unknown)}"
        )
    sd: dict[str, torch.Tensor] = {}
    for name, sub in p["embedding"].items():
        sd[f"embedding.{name}.weight"] = _t(sub["embedding"])

    g = p["ggnn"]
    etypes = sorted(
        (k for k in g if re.fullmatch(r"etype_\d+", k)), key=lambda k: int(k[6:])
    )
    sd["ggnn.etype_kernel"] = torch.stack([_t(g[k]["kernel"]) for k in etypes])
    sd["ggnn.etype_bias"] = torch.stack([_t(g[k]["bias"]) for k in etypes])
    gru = g["GRUCell_0"]
    sd["ggnn.gru.input_kernel"] = _t(gru["input_proj"]["kernel"])
    sd["ggnn.gru.input_bias"] = _t(gru["input_proj"]["bias"])
    sd["ggnn.gru.hidden_kernel"] = _t(gru["hidden_proj"]["kernel"])
    sd["ggnn.gru.hidden_bias"] = _t(gru["hidden_proj"]["bias"])

    if "pooling" in p:
        gate = p["pooling"]["gate_nn"]
        sd["pooling.gate_nn.weight"] = _t(gate["kernel"]).T.contiguous()
        sd["pooling.gate_nn.bias"] = _t(gate["bias"])
    for name, dense in p.get("head", {}).items():
        sd[f"head.{name}.weight"] = _t(dense["kernel"]).T.contiguous()
        sd[f"head.{name}.bias"] = _t(dense["bias"])
    return sd
