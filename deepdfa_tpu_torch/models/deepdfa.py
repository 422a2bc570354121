"""The DeepDFA model: abstract-dataflow GGNN graph classifier (the
reference's `deepdfa_tpu/models/deepdfa.py`).

  node idx --4x Embed--> feat_embed (4*H)
           --GatedGraphConv n_steps--> ggnn_out (4*H)
  concat [ggnn_out, feat_embed] (8*H)
  label_style == "graph": GlobalAttentionPooling -> [G, 8*H]
  encoder_mode: return that embedding (out_dim = 8*H)
  else: OutputHead -> logits

The flagship (hidden 32, concat_all_absdf, n_steps 5, input_dim 1002)
has 375,938 parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from deepdfa_tpu_torch.core.config import ModelConfig
from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.nn import (
    AbstractDataflowEmbedding,
    GatedGraphConv,
    GlobalAttentionPooling,
    OutputHead,
)


class DeepDFA(nn.Module):
    def __init__(
        self,
        input_dim: int,
        hidden_dim: int = 32,
        n_steps: int = 5,
        n_etypes: int = 1,
        num_output_layers: int = 3,
        concat_all_absdf: bool = True,
        label_style: str = "graph",
        encoder_mode: bool = False,
        generator: torch.Generator | None = None,
        *,
        scan_steps: bool = False,
        ggnn_kernel: bool = False,
        ggnn_kernel_accum: str = "fp32",
        ggnn_kernel_scatter: str = "auto",
        ggnn_kernel_block_edges: int = 0,
        ggnn_kernel_unroll: str = "per_step",
    ):
        """`generator` seeds the initial weights (Flax's initializers,
        torch's draws). The GGNN knobs are the reference's: `accum`,
        `scatter`, `block_edges` and `unroll` act only with `ggnn_kernel`
        (nn/gnn.py:GatedGraphConv);
        the combined families build their graph encoder without them, so
        it runs fp32 per step, as in the reference."""
        super().__init__()
        if label_style.startswith("dataflow_solution"):
            raise NotImplementedError(
                f"label_style={label_style!r}: the bit-propagation head "
                "(nn/bitprop.py) comes with a later slice of the port"
            )
        if label_style not in ("graph", "node"):
            raise ValueError(f"unknown label_style {label_style!r}")
        self.hidden_dim = hidden_dim
        self.label_style = label_style
        self.encoder_mode = encoder_mode
        self.embedding = AbstractDataflowEmbedding(
            input_dim, hidden_dim, concat_all=concat_all_absdf
        )
        width = self.embedding.out_dim
        self.ggnn = GatedGraphConv(
            width, n_steps, n_etypes, use_kernel=ggnn_kernel, accum=ggnn_kernel_accum,
            scatter=ggnn_kernel_scatter, block_edges=ggnn_kernel_block_edges,
            unroll=ggnn_kernel_unroll, scan_steps=scan_steps,
        )
        if label_style == "graph":
            self.pooling = GlobalAttentionPooling(2 * width)
        if not encoder_mode:
            self.head = OutputHead(2 * width, num_output_layers)
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, cfg: ModelConfig, input_dim: int, **overrides) -> "DeepDFA":
        if cfg.struct_feats:
            raise NotImplementedError(
                "model.struct_feats: the structural channels come with the "
                "frontend slice of the port"
            )
        if cfg.param_dtype != "float32" or cfg.compute_dtype != "float32":
            raise NotImplementedError(
                "the port runs fp32 only in this slice "
                f"(param_dtype={cfg.param_dtype}, compute_dtype={cfg.compute_dtype})"
            )
        kw = dict(
            input_dim=input_dim,
            hidden_dim=cfg.hidden_dim,
            n_steps=cfg.n_steps,
            n_etypes=cfg.n_etypes,
            num_output_layers=cfg.num_output_layers,
            concat_all_absdf=cfg.concat_all_absdf,
            label_style=cfg.label_style,
            encoder_mode=cfg.encoder_mode,
            scan_steps=cfg.scan_steps,
            ggnn_kernel=cfg.ggnn_kernel,
            ggnn_kernel_accum=cfg.ggnn_kernel_accum,
            ggnn_kernel_scatter=cfg.ggnn_kernel_scatter,
            ggnn_kernel_block_edges=cfg.ggnn_kernel_block_edges,
            ggnn_kernel_unroll=cfg.ggnn_kernel_unroll,
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def out_dim(self) -> int:
        """Width of the encoder embedding."""
        return 2 * self.embedding.out_dim

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for child in self.children():
            child.reset_parameters(generator)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """Logits [G] (graph) or [N] (node); the embedding
        [G or N, out_dim] in encoder mode."""
        feat_embed = self.embedding(batch.node_feats)
        ggnn_out = self.ggnn(batch, feat_embed)
        out = torch.cat([ggnn_out, feat_embed], dim=-1)
        if self.label_style == "graph":
            out = self.pooling(batch, out)
        if self.encoder_mode:
            return out
        return self.head(out)[..., 0]
