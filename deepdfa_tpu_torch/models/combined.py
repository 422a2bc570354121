"""Combined transformer + graph classifier, the DeepDFA+LineVul family
(the port of the reference's `deepdfa_tpu/models/combined.py`).

    input_ids --RobertaEncoder--> hidden [B, T, D] --> [CLS] hidden[:, 0]
    graphs ----DeepDFA (encoder mode)--> pooled [B, 8*graph_hidden_dim],
               zeroed on rows whose has_graph is False
    with moe_experts > 0: [CLS] += MoE([CLS]) (a residual expert block)
    concat [CLS, graph] --> dense --> tanh --> out --> logits [B, classes]

(LineVul's RobertaClassificationHead over [CLS] concatenated with the
DeepDFA embedding.) Rounding points follow the reference: the encoder
runs in its activation dtype; the fp32 graph embedding is cast to that
dtype before the concatenation, and the head, whose parameters are
fp32, promotes the row to fp32. The graph encoder is the port's DeepDFA,
whose GGNN steps are the step kernel on a CUDA device.

Dropout, as in the reference, runs where `forward` is given a
`dropout_key` (a 64-bit seed): fold (0,) seeds the encoder, fold (1,)
the head, whose two sites (before the dense layer, after the tanh) take
(1,) and (2,) of it, at `head_dropout` (`head_logits`, `:141-151`).
Without a key the function is the same in either module mode.

The MoE adapter (`moe_experts > 0`, parallel/moe.py) is the reference's
residual block on the [CLS] row: cls + moe_out, which promotes a bf16
row to fp32 (the MoE's parameters are fp32), so the graph embedding then
joins it in fp32, as in the reference; `forward(..., with_aux=True)`
returns the load-balancing aux loss with the logits (0 without MoE).

Not ported (raise `NotImplementedError`): the pipeline, expert and
sequence/tensor-parallel paths.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.models.deepdfa import DeepDFA
from deepdfa_tpu_torch.models.transformer import RobertaEncoder, TransformerConfig, _normal_
from deepdfa_tpu_torch.nn.dropout import dropout, fold_seed
from deepdfa_tpu_torch.parallel.moe import MoE, MoEConfig


@dataclasses.dataclass(frozen=True)
class CombinedConfig:
    """The reference's fields and defaults."""

    encoder: TransformerConfig
    graph_hidden_dim: int = 32
    graph_n_steps: int = 5
    graph_input_dim: int = 1002
    num_classes: int = 2
    head_dropout: float = 0.1
    use_graph: bool = True
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_aux_weight: float = 0.01

    @property
    def graph_out_dim(self) -> int:
        return 8 * self.graph_hidden_dim  # concat_all_absdf encoder out_dim

    @property
    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(hidden_size=self.encoder.hidden_size,
                         intermediate_size=self.encoder.intermediate_size,
                         num_experts=self.moe_experts, top_k=self.moe_top_k)


class CombinedModel(nn.Module):
    """Encoder (no pooler), encoder-mode DeepDFA (when `use_graph`), the
    MoE adapter (when `moe_experts`) and the classification head.
    `generator` seeds the initial weights."""

    def __init__(self, cfg: CombinedConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder.hidden_size
        self.encoder = RobertaEncoder(cfg.encoder, with_pooler=False, generator=generator)
        if cfg.use_graph:
            self.graph = DeepDFA(
                cfg.graph_input_dim, cfg.graph_hidden_dim, cfg.graph_n_steps,
                num_output_layers=0, concat_all_absdf=True, label_style="graph",
                encoder_mode=True, generator=generator,
            )
        in_dim = d + (cfg.graph_out_dim if cfg.use_graph else 0)
        self.head_dense = nn.Linear(in_dim, d)
        self.head_out = nn.Linear(d, cfg.num_classes)
        for lin in (self.head_dense, self.head_out):
            _normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
        if cfg.moe_experts:
            self.moe = MoE(cfg.moe_cfg, generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        graph_batch: GraphBatch | None = None,
        has_graph: torch.Tensor | None = None,
        *,
        dropout_key=None,
        sp_axis: str | None = None,
        tp_axis: str | None = None,
        position_offset: int = 0,
        pp_axis: str | None = None,
        ep_axis: str | None = None,
        inputs_embeds: torch.Tensor | None = None,
        remat: bool = True,
        with_aux: bool = False,
    ):
        """[B, T] ids (+ a GraphBatch of B graphs aligned with the rows)
        -> logits [B, num_classes] in fp32; dropout with a `dropout_key`;
        `inputs_embeds` and `remat` go to `RobertaEncoder.encode` (the
        attribution hook: without a key the head runs without dropout).
        `with_aux`: (logits, the MoE's aux loss, 0 without MoE)."""
        if pp_axis is not None or ep_axis is not None:
            raise NotImplementedError(
                "pp_axis / ep_axis: pipeline and expert parallelism come with the "
                "multi-device slice of the port (ROADMAP queue A, item 9)"
            )
        k_enc = k_head = None
        if dropout_key is not None:
            k_enc, k_head = fold_seed(dropout_key, 0), fold_seed(dropout_key, 1)
        hidden = self.encoder.encode(
            input_ids, dropout_key=k_enc, sp_axis=sp_axis, tp_axis=tp_axis,
            position_offset=position_offset, inputs_embeds=inputs_embeds, remat=remat,
        )
        x = hidden[:, 0, :]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.moe_experts:
            moe_out, aux = self.moe(x)
            x = x + moe_out  # residual: dropped tokens pass through
        if self.cfg.use_graph:
            if graph_batch is None:
                raise ValueError(
                    "CombinedConfig.use_graph=True needs a graph_batch (text-only: "
                    "use_graph=False, which sizes the head without the graph block)"
                )
            graph_vec = self.graph(graph_batch)  # [B, 8H] fp32
            if has_graph is not None:
                graph_vec = graph_vec * has_graph[:, None].to(graph_vec.dtype)
            x = torch.cat([x, graph_vec.to(x.dtype)], dim=-1)
        logits = self.head_logits(x, k_head)
        return (logits, aux) if with_aux else logits

    def head_logits(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        """RobertaClassificationHead: dropout -> dense -> tanh -> dropout
        -> out; x [B, in_dim] in the activation dtype, logits in fp32."""
        rate = self.cfg.head_dropout
        x = dropout(x, rate, None if seed is None else fold_seed(seed, 1))
        x = torch.tanh(self.head_dense(x.float()))
        x = dropout(x, rate, None if seed is None else fold_seed(seed, 2))
        return self.head_out(x)
