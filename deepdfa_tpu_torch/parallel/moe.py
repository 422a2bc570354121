"""Mixture-of-experts FFN on one device (the port of the reference's
`deepdfa_tpu/parallel/moe.py`: `MoEConfig`, `init_moe_params`,
`capacity`, `_route`, `_expert_compute`, `moe_ffn`).

Static-shape formulation (Mesh-TensorFlow / Switch style), as the
reference's:

- router: logits [N, E] -> top-k experts per token, gates softmax-
  renormalized over the chosen k;
- capacity C = ceil(k * N / E * capacity_factor), over all N rows
  (padded ones included); within one expert, tokens claim slots in
  arrival order and overflow tokens are dropped for that expert (the
  residual path carries them);
- dispatch [N, E, C] one-hot gathers the expert inputs in one einsum;
  combine = dispatch * gate scatters the expert outputs back.

Determinism and ties, where torch differs from XLA: the top-k is a
stable descending sort, so equal logits (identical [CLS] rows, such as a
serving bucket's padded rows) pick the lower expert index, as
`jax.lax.top_k` does (`torch.topk` promises no order on the card); the
slot positions are a cumsum of exact integers; the einsums are matmuls,
the same bits on every run. The reference's expert-parallel forms
(`moe_stage_forward`, `moe_ffn_ep`, `moe_param_specs`) are multi-device
work, ROADMAP queue A item 9.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

PARAM_NAMES = ("router", "w1", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    hidden_size: int
    intermediate_size: int
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


def init_moe_params(cfg: MoEConfig, generator: torch.Generator | None = None) -> dict:
    """The reference's initializers (normal * 0.02, zero biases), fp32,
    drawn from `generator` (the draws differ from jax.random's)."""
    d, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    std = 0.02

    def normal(*shape):
        return torch.randn(shape, generator=generator) * std

    return {"router": normal(d, e), "w1": normal(e, d, f), "b1": torch.zeros(e, f),
            "w2": normal(e, f, d), "b2": torch.zeros(e, d)}


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    return max(1, math.ceil(cfg.top_k * n_tokens / cfg.num_experts * cfg.capacity_factor))


def _promoted(*xs: torch.Tensor) -> list[torch.Tensor]:
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _one_hot(index: torch.Tensor, size: int, dtype: torch.dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: an index outside [0, size) gives a zero row."""
    return (index[..., None] == torch.arange(size, device=index.device)).to(dtype)


def top_k_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[N, k] indices of the k largest logits per row, ties to the lower
    index (`jax.lax.top_k`)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


def _route(cfg: MoEConfig, router_w: torch.Tensor, x: torch.Tensor, cap: int):
    """dispatch [N, E, C] {0,1} in x's dtype, combine [N, E, C] and the
    load-balancing aux loss."""
    e = cfg.num_experts
    logits = torch.matmul(*_promoted(x, router_w))  # [N, E]
    probs = torch.softmax(logits, dim=-1)
    top_idx = top_k_indices(logits, cfg.top_k)
    chosen_i = _one_hot(top_idx, e, torch.int64).sum(1)  # [N, E] exact
    chosen = chosen_i.to(x.dtype)
    gates = probs * chosen
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # slot per expert: arrival-order position among its tokens, 0-based
    position = torch.cumsum(chosen_i, dim=0) * chosen_i - chosen_i
    keep = chosen * (position < cap).to(x.dtype)
    dispatch = keep[:, :, None] * _one_hot(position, cap, x.dtype)
    combine = dispatch * gates[:, :, None]
    # switch-style load balancing: fraction of tokens per expert x mean
    # router probability per expert, scaled by E
    frac = chosen.float().mean(0).to(x.dtype)
    aux = e * torch.sum(frac * probs.mean(0))
    return dispatch, combine, aux


def _expert_compute(w1, b1, w2, b2, dispatch, combine, x):
    """Gather -> per-expert FFN (tanh gelu, `jax.nn.gelu`'s default) ->
    scatter, each product in the promoted dtype of its operands."""
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)
    a, w = _promoted(expert_in, w1)
    h = F.gelu(torch.einsum("ecd,edf->ecf", a, w) + b1[:, None, :], approximate="tanh")
    h, w = _promoted(h, w2)
    expert_out = torch.einsum("ecf,efd->ecd", h, w) + b2[:, None, :]
    out, c = _promoted(expert_out, combine)
    return torch.einsum("ecd,nec->nd", out, c)


def moe_ffn(cfg: MoEConfig, params: Mapping[str, torch.Tensor], x: torch.Tensor,
            cap: int | None = None):
    """Dense-math MoE forward on one device. x: [N, D] -> ([N, D], aux)."""
    if cap is None:
        cap = capacity(cfg, x.shape[0])
    dispatch, combine, aux = _route(cfg, params["router"], x, cap)
    out = _expert_compute(params["w1"], params["b1"], params["w2"], params["b2"],
                          dispatch, combine, x)
    return out, aux


class MoE(nn.Module):
    """The MoE block's parameters (`router`, `w1`, `b1`, `w2`, `b2`, fp32,
    the reference's names and layout) and `moe_ffn` over them."""

    def __init__(self, cfg: MoEConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        for name, value in init_moe_params(cfg, generator).items():
            setattr(self, name, nn.Parameter(value))

    def params(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def forward(self, x: torch.Tensor, cap: int | None = None):
        return moe_ffn(self.cfg, self.params(), x, cap)


def moe_stage_forward(*args, **kwargs):
    """The reference's expert-parallel stage: multi-device, not ported."""
    raise NotImplementedError("moe_stage_forward: expert parallelism over an ep mesh comes "
                              "with the multi-device slice of the port (ROADMAP queue A, item 9)")


def moe_ffn_ep(*args, **kwargs):
    """The reference's expert-parallel MoE: multi-device, not ported."""
    raise NotImplementedError("moe_ffn_ep: expert parallelism over an ep mesh comes with the "
                              "multi-device slice of the port (ROADMAP queue A, item 9)")


def moe_param_specs(*args, **kwargs):
    """The reference's ep PartitionSpecs: multi-device, not ported."""
    raise NotImplementedError("moe_param_specs: expert sharding comes with the multi-device "
                              "slice of the port (ROADMAP queue A, item 9)")
