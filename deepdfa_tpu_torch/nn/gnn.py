"""Graph network modules over padded `GraphBatch`es (the reference's
`deepdfa_tpu/nn/gnn.py`).

- `GatedGraphConv`: one path, `nn/ggnn_kernel.py:ggnn_propagate`. Every
  step is the step kernel on a CUDA device and its plain PyTorch version
  on the CPU; with gradients enabled each step is a `GgnnStep`, whose
  backward runs the two backward kernels (or their plain versions).
  `use_kernel` (the reference's switch between its lax path and its
  Pallas kernel) gates the kernel's knobs as the reference does: only
  with it does the module pass `accum`, `scatter`, `block_edges` and
  `unroll` on; without it the steps run fp32, fold and per step, the
  reference's lax function. Weights
  keep the reference's [in, out] layout, which the kernels read
  directly.
- pooling: masked segment softmax; padded node slots belong to the dummy
  segment `num_graphs`, which is sliced off. The segment reductions and
  the per-node gathers are one-hot products over num_graphs + 1
  segments — deterministic on the card, forward and backward, where
  `index_add_` and an indexed gather's backward would sum with float
  atomics.
"""

from __future__ import annotations

import torch
from torch import nn

from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.nn import ggnn_kernel
from deepdfa_tpu_torch.nn.init import truncated_normal_


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """Masked softmax within segments; masked slots get weight 0. An
    empty segment keeps the finfo.min floor and a zero denominator
    becomes 1, so the all-padding batch stays finite."""
    neg = torch.finfo(scores.dtype).min
    scores = torch.where(mask, scores, torch.full_like(scores, neg))
    onehot = segment_ids[None, :] == torch.arange(
        num_segments, device=segment_ids.device
    )[:, None]  # [S, N]
    oh = onehot.to(scores.dtype)
    smax = torch.where(onehot, scores[None, :], torch.full_like(scores, neg)[None, :])
    smax = smax.amax(dim=1)
    # per-node gathers as one-hot products too (exact: one nonzero term
    # each), so their backward is a matmul and not an atomic scatter
    ex = torch.exp(scores - oh.T @ smax)
    ex = torch.where(mask, ex, torch.zeros_like(ex))
    denom = oh @ ex
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return ex / (oh.T @ denom)


def attention_pool(
    gate: torch.Tensor,
    feat: torch.Tensor,
    node_graph: torch.Tensor,
    node_mask: torch.Tensor,
    num_graphs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gated-attention readout core: ([G, D] pooled, [N] attention)."""
    attn = segment_softmax(gate, node_graph, node_mask, num_graphs + 1)
    onehot = node_graph[None, :] == torch.arange(
        num_graphs + 1, device=node_graph.device
    )[:, None]
    pooled = onehot.to(feat.dtype) @ (attn[:, None] * feat)
    return pooled[:num_graphs], attn


class GRUCell(nn.Module):
    """torch.nn.GRUCell's update with the reference's parameter layout:
    input/hidden projections [features, 3 * features] ([in, out]), gates
    in r, z, n order."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features
        self.input_kernel = nn.Parameter(torch.empty(features, 3 * features))
        self.input_bias = nn.Parameter(torch.zeros(3 * features))
        self.hidden_kernel = nn.Parameter(torch.empty(features, 3 * features))
        self.hidden_bias = nn.Parameter(torch.zeros(3 * features))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        truncated_normal_(self.input_kernel, self.features, generator)
        truncated_normal_(self.hidden_kernel, self.features, generator)
        nn.init.zeros_(self.input_bias)
        nn.init.zeros_(self.hidden_bias)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return ggnn_kernel.gru_cell(
            x, h, self.input_kernel, self.hidden_kernel,
            self.input_bias, self.hidden_bias,
        )


class GatedGraphConv(nn.Module):
    """Gated Graph Convolution with DGL-parity semantics: per step
    a_v = sum_{(u,v)} W_t h_u + b_t, h_v = GRU(a_v, h_v), weights shared
    across steps, one transform per edge type. Inputs narrower than
    `out_features` are zero-padded. `accum` (fp32 | bf16 | int8),
    `scatter` (auto | fold | mxu; the reference's `kernel_scatter`),
    `block_edges` (the mxu edge block; the reference's
    `kernel_block_edges`, 0 = 512) and `unroll` (per_step | fused) act
    only under `use_kernel`; `scan_steps` enters the fused admission
    rule."""

    def __init__(self, out_features: int, n_steps: int, n_etypes: int = 1, *,
                 use_kernel: bool = False, accum: str = "fp32", scatter: str = "auto",
                 block_edges: int = 0, unroll: str = "per_step", scan_steps: bool = False):
        super().__init__()
        self.out_features = out_features
        self.n_steps = n_steps
        self.n_etypes = n_etypes
        self.use_kernel = use_kernel
        self.accum = accum
        self.scatter = scatter
        self.block_edges = block_edges
        self.unroll = unroll
        self.scan_steps = scan_steps
        self.etype_kernel = nn.Parameter(torch.empty(n_etypes, out_features, out_features))
        self.etype_bias = nn.Parameter(torch.zeros(n_etypes, out_features))
        self.gru = GRUCell(out_features)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for t in range(self.n_etypes):
            truncated_normal_(self.etype_kernel.data[t], self.out_features, generator)
        nn.init.zeros_(self.etype_bias)
        self.gru.reset_parameters(generator)

    def forward(self, batch: GraphBatch, feat: torch.Tensor) -> torch.Tensor:
        if self.n_etypes != 1 and batch.edge_type is None:
            raise ValueError(
                f"n_etypes={self.n_etypes} needs edge-type ids on the "
                "batch (GraphSpec.edge_type)"
            )
        if self.n_etypes == 1 and batch.edge_type is not None:
            raise ValueError(
                "batch carries edge-type ids but n_etypes=1; set "
                "model.n_etypes to the relation count (cfg+dep: 3)"
            )
        width = feat.shape[-1]
        if width > self.out_features:
            raise ValueError(f"input dim {width} > out_features {self.out_features}")
        if width < self.out_features:
            feat = nn.functional.pad(feat, (0, self.out_features - width))
        gru = self.gru
        return ggnn_kernel.ggnn_propagate(
            self.etype_kernel, self.etype_bias,
            gru.input_kernel, gru.hidden_kernel, gru.input_bias, gru.hidden_bias,
            feat, batch.edge_src, batch.edge_dst, batch.edge_mask,
            batch.edge_type, n_steps=self.n_steps, n_etypes=self.n_etypes,
            accum=self.accum if self.use_kernel else "fp32",
            scatter=self.scatter if self.use_kernel else "fold",
            block_edges=self.block_edges if self.use_kernel else 0,
            unroll=self.unroll if self.use_kernel else "per_step",
            scan_steps=self.scan_steps,
        )


class GlobalAttentionPooling(nn.Module):
    """Gated attention readout: gate = softmax_over_graph(gate_nn(h));
    out_g = sum_v gate_v * h_v (DGL's, with identity feat_nn)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.gate_nn = nn.Linear(in_features, 1)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        truncated_normal_(self.gate_nn.weight, self.gate_nn.in_features, generator)
        nn.init.zeros_(self.gate_nn.bias)

    def forward(self, batch: GraphBatch, feat: torch.Tensor) -> torch.Tensor:
        gate = self.gate_nn(feat)[:, 0]
        pooled, _ = attention_pool(
            gate, feat, batch.node_graph, batch.node_mask, batch.num_graphs
        )
        return pooled
