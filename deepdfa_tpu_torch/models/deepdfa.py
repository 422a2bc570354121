"""The DeepDFA model: abstract-dataflow GGNN graph classifier (the
reference's `deepdfa_tpu/models/deepdfa.py`).

  node idx --4x Embed (+5 struct tables)--> feat_embed (4*H, or 9*H)
           --GatedGraphConv n_steps--> ggnn_out (same width)
  concat [ggnn_out, feat_embed] (8*H, or 18*H)
  label_style == "graph": GlobalAttentionPooling -> [G, 8*H]
  encoder_mode: return that embedding (out_dim = 8*H)
  else: OutputHead -> logits

The dataflow_solution_{in,out} styles supervise per-node reaching-
definitions bitvectors of width `max_defs` (the extraction's
`data.feat.max_defs`): `BitvectorPropagation` (nn/bitprop.py) runs
n_steps of the relu union with a learned kill gate over the type-0
(cfg) edges, the features become [ggnn_out, feat_embed, gen, kill,
bp_in, bp_out] and the head emits [N, max_defs] logits (encoder_mode:
those features).

`param_dtype` (the reference's `model.param_dtype`) is the dtype the
parameters are created and stored in, except the bit propagation's
gate, which the reference keeps fp32. The GGNN computes in fp32 from
them (nn/gnn.py); the embedding rows come out in `param_dtype` and the
pooling and head compute in the promoted dtype, fp32 here, as Flax
does. The reference's `model.compute_dtype` is read nowhere there, and
the port accepts it the same way, with no effect.

The flagship (hidden 32, concat_all_absdf, n_steps 5, input_dim 1002)
has 375,938 parameters; with `struct_feats` (the flagship recipe of
scripts/train_flagship.py) the GGNN runs at 9 * 32 = 288.
"""

from __future__ import annotations

import torch
from torch import nn

from deepdfa_tpu_torch.core.config import ModelConfig
from deepdfa_tpu_torch.frontend.structfeat import STRUCT_VOCAB
from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.nn import (
    AbstractDataflowEmbedding,
    GatedGraphConv,
    GlobalAttentionPooling,
    OutputHead,
)
from deepdfa_tpu_torch.nn.bitprop import BitvectorPropagation

LABEL_STYLES = ("graph", "node", "dataflow_solution_in", "dataflow_solution_out")


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16", ...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"unknown floating dtype {name!r}")
    return dt


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
        struct_feats: bool = False,
        scan_steps: bool = False,
        ggnn_kernel: bool = False,
        ggnn_kernel_accum: str = "fp32",
        ggnn_kernel_scatter: str = "auto",
        ggnn_kernel_block_edges: int = 0,
        ggnn_kernel_unroll: str = "per_step",
        max_defs: int | None = None,
        param_dtype: str | torch.dtype = torch.float32,
    ):
        """`generator` seeds the initial weights (Flax's initializers,
        torch's draws). `max_defs` is the bit width of the
        dataflow_solution_* styles (the reference infers it from the
        first batch). The GGNN knobs are the reference's: `accum`,
        `scatter`, `block_edges` and `unroll` act only with `ggnn_kernel`
        (nn/gnn.py:GatedGraphConv);
        the combined families build their graph encoder without them, so
        it runs fp32 per step, as in the reference."""
        super().__init__()
        if label_style not in LABEL_STYLES:
            raise ValueError(f"unknown label_style {label_style!r}")
        self.dataflow = label_style.startswith("dataflow_solution")
        if self.dataflow and not max_defs:
            raise ValueError(f"label_style={label_style!r} needs max_defs, the bit width "
                             "of the extraction (data.feat.max_defs)")
        dtype = torch_dtype(param_dtype)
        self.hidden_dim = hidden_dim
        self.label_style = label_style
        self.encoder_mode = encoder_mode
        self.struct_feats = struct_feats
        self.param_dtype = dtype
        self.embedding = AbstractDataflowEmbedding(
            input_dim, hidden_dim, concat_all=concat_all_absdf,
            struct_vocab=STRUCT_VOCAB if struct_feats else (), param_dtype=dtype,
        )
        width = self.embedding.out_dim
        self.ggnn = GatedGraphConv(
            width, n_steps, n_etypes, use_kernel=ggnn_kernel, accum=ggnn_kernel_accum,
            scatter=ggnn_kernel_scatter, block_edges=ggnn_kernel_block_edges,
            unroll=ggnn_kernel_unroll, scan_steps=scan_steps, param_dtype=dtype,
        )
        head_in, head_out = 2 * width, 1
        if self.dataflow:
            # the reference's propagation: relu union, learned gate
            self.bitprop = BitvectorPropagation(n_steps, union_type="relu", learned_gate=True,
                                                width=width)
            head_in, head_out = 2 * width + 4 * max_defs, max_defs
        elif label_style == "graph":
            self.pooling = GlobalAttentionPooling(2 * width, dtype)
        if not encoder_mode:
            self.head = OutputHead(head_in, num_output_layers, head_out, dtype)
        self.reset_parameters(generator)

    @classmethod
    def from_config(cls, cfg: ModelConfig, input_dim: int, **overrides) -> "DeepDFA":
        """`cfg.compute_dtype` is read nowhere, as in the reference; a
        dataflow style takes `max_defs` among the overrides."""
        kw = dict(
            input_dim=input_dim,
            hidden_dim=cfg.hidden_dim,
            n_steps=cfg.n_steps,
            n_etypes=cfg.n_etypes,
            num_output_layers=cfg.num_output_layers,
            concat_all_absdf=cfg.concat_all_absdf,
            label_style=cfg.label_style,
            encoder_mode=cfg.encoder_mode,
            struct_feats=cfg.struct_feats,
            scan_steps=cfg.scan_steps,
            ggnn_kernel=cfg.ggnn_kernel,
            ggnn_kernel_accum=cfg.ggnn_kernel_accum,
            ggnn_kernel_scatter=cfg.ggnn_kernel_scatter,
            ggnn_kernel_block_edges=cfg.ggnn_kernel_block_edges,
            ggnn_kernel_unroll=cfg.ggnn_kernel_unroll,
            param_dtype=cfg.param_dtype,
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
        """Logits [G] (graph), [N] (node) or [N, max_defs] (dataflow);
        the embedding [G or N, out_dim] in encoder mode (the dataflow
        styles: the head's input features)."""
        feat_embed = self.embedding(batch.node_feats)
        ggnn_out = self.ggnn(batch, feat_embed)
        # torch.cat promotes, as jnp.concatenate does: bf16 rows join the
        # fp32 GGNN state in fp32
        out = torch.cat([ggnn_out, feat_embed], dim=-1)
        if self.dataflow:
            if batch.node_gen is None:
                raise ValueError(f"label_style={self.label_style} needs bit labels; "
                                 "extract the corpus with max_defs set")
            # reaching definitions is a CFG fixpoint: on typed graphs the
            # propagation rides only the type-0 (cfg) edges
            edge_mask = batch.edge_mask
            if batch.edge_type is not None:
                edge_mask = edge_mask & (batch.edge_type == 0)
            bp_in, bp_out = self.bitprop(batch.node_gen, batch.node_kill, batch.edge_src,
                                         batch.edge_dst, edge_mask, node_feats=feat_embed)
            out = torch.cat([out, batch.node_gen, batch.node_kill, bp_in, bp_out], dim=-1)
            return out if self.encoder_mode else self.head(out)
        if self.label_style == "graph":
            out = self.pooling(batch, out)
        if self.encoder_mode:
            return out
        return self.head(out)[..., 0]
