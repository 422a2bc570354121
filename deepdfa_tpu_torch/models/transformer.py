"""RoBERTa-family transformer encoder (the port of the reference's
`deepdfa_tpu/models/transformer.py`).

HF-roberta numerics as in the reference: learned positions with
RoBERTa's pad-offset ids (`cumsum(mask) * mask + pad_id`), post-LN
residual blocks, erf GELU, LayerNorm in fp32 whatever the activation
dtype. Parameters are fp32; each layer casts its parameters to the
activation dtype (`TransformerConfig.dtype`) when it runs, LayerNorm
scales included, as the reference does (`encoder_layer`, `:273-275`),
and the embedding sum and its LayerNorm run in fp32 before the cast.

Layout. Weights keep the reference's [in, out] orientation; the
per-head q/k/v kernels [D, H, Dh] are fused into one [D, 3*H*Dh]
product whose output is viewed as [B, T, 3, H, Dh], so q, k and v reach
the attention as [B, H, T, Dh] strided views without a copy, and the
kernel's [B, T, H, Dh] output feeds the output projection as it lies.
`models/convert.py:from_jax_encoder_params` maps the reference's
stacked parameter tree onto this module.

Attention follows `attn_impl` (`nn/flash_attention.py:resolve_impl`):
on a CUDA tensor "auto" and "flash" launch the flash kernels (kernel 5
forward, kernels 6 and 7 backward, through `FlashAttention`) and raise
where they cannot tile the shape, and "xla" is the plain PyTorch
version, asked for by name; on the CPU every route is the plain version.

Dropout follows the reference: it runs where `encode` is given a
`dropout_key`, whatever the module's mode. The key is a 64-bit seed
(`nn/dropout.py`): the embedding LayerNorm output, each layer's
attention output and FFN output are dropped by `dropout` (a generator
built from the site's seed on each call) and the attention probs inside
the flash kernel (Philox bits from the layer's seed), at
`dropout_rate`. With `remat` (the reference's default) and gradients
on, each layer runs under `torch.utils.checkpoint` (non-reentrant,
`nn/flash_attention.py:remat_layer`), as the reference's `remat_wrap`
puts it under `jax.checkpoint`; the recomputation draws the same masks
because every mask is a function of its seed. `remat_policy="full"`
replays the whole layer in the backward, "attn_saved" keeps the flash
kernel's (o, lse) across the checkpoint so the replay launches no
forward kernel (the same gradients, to the bit). Sequence and tensor
parallelism (`sp_axis`, `tp_axis`, `sp_variant="ulysses"`) raise
`NotImplementedError`.

`params_from_hf_torch` reads a Hugging Face `RobertaModel` state_dict
(codebert-base's layout) into this module.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from deepdfa_tpu_torch.core.config import PAD_ID_BY_FAMILY
from deepdfa_tpu_torch.models.convert import from_jax_encoder_params, hf_roberta_tree
from deepdfa_tpu_torch.nn.dropout import dropout, fold_seed
from deepdfa_tpu_torch.nn.flash_attention import (
    attention_plain,
    dropout_bits,
    flash_attention,
    remat_layer,
    resolve_impl,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's fields and defaults (codebert-base width)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = PAD_ID_BY_FAMILY["roberta"]
    layer_norm_eps: float = 1e-5
    dropout_rate: float = 0.1
    dtype: str = "float32"  # activation dtype: float32 | bfloat16
    sp_variant: str = "ring"
    remat: bool = True  # checkpoint each layer when gradients are on
    attn_impl: str = "auto"  # auto | xla | flash
    remat_policy: str = "full"  # full | attn_saved

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown activation dtype {self.dtype!r} (float32 | bfloat16)")
        if self.attn_impl not in ("auto", "xla", "flash"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.remat_policy not in ("full", "attn_saved"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.sp_variant not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_variant {self.sp_variant!r}")
        if self.sp_variant != "ring":
            raise NotImplementedError(
                f"sp_variant={self.sp_variant!r}: sequence-parallel attention comes "
                "with the multi-device slice of the port (ROADMAP queue A, item 9)"
            )
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not a multiple of num_heads {self.num_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        base = dict(
            vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position_embeddings=66,
        )
        base.update(kw)
        return cls(**base)


def _normal_(w: torch.Tensor, generator: torch.Generator | None, std: float = 0.02):
    """The reference's init: a normal of stddev 0.02 (drawn on the CPU
    from `generator` when one is given, so a seed gives the same weights
    whatever device the module lives on)."""
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) * std)
    return w


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """LayerNorm in fp32 whatever x's dtype, cast back to it."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


class Embeddings(nn.Module):
    """Token + position + type embeddings and their LayerNorm."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.position = nn.Parameter(torch.empty(cfg.max_position_embeddings, d))
        self.token_type = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
        self.ln_scale = nn.Parameter(torch.ones(d))
        self.ln_bias = nn.Parameter(torch.zeros(d))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for w in (self.word, self.position, self.token_type):
            _normal_(w, generator)
        nn.init.ones_(self.ln_scale)
        nn.init.zeros_(self.ln_bias)

    def forward(self, input_ids: torch.Tensor, position_offset: int = 0,
                seed: int | None = None, rows: torch.Tensor | None = None) -> torch.Tensor:
        """`rows` ([B, T, D] fp32), when given, stands in for the word
        gather (the attribution hook, eval/localize.py); positions, token
        type and the LayerNorm stay."""
        cfg = self.cfg
        top = input_ids.shape[1] + position_offset + cfg.pad_token_id
        if top > cfg.max_position_embeddings - 1:
            raise ValueError(
                f"sequence length {input_ids.shape[1]} (+ position offset "
                f"{position_offset}) needs position ids up to {top}, but the "
                f"learned position table has only {cfg.max_position_embeddings} "
                f"rows (RoBERTa ids run pad_token_id+1 .. pad_token_id+T): lower "
                f"the bucket edge or grow the table"
            )
        mask = (input_ids != cfg.pad_token_id).to(torch.int64)
        pos = (torch.cumsum(mask, dim=-1) + position_offset) * mask + cfg.pad_token_id
        word = F.embedding(input_ids, self.word) if rows is None else rows
        x = word + F.embedding(pos, self.position) + self.token_type[0]
        x = _layer_norm(x, self.ln_scale, self.ln_bias, cfg.layer_norm_eps)
        x = dropout(x, cfg.dropout_rate, seed)  # fp32, before the cast, as the reference
        return x.to(cfg.torch_dtype)


class EncoderLayer(nn.Module):
    """One post-LN transformer layer (HF roberta semantics)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.wqkv = nn.Parameter(torch.empty(d, 3 * d))  # [in, q | k | v], heads inside
        self.bqkv = nn.Parameter(torch.zeros(3 * d))
        self.wo = nn.Parameter(torch.empty(d, d))  # [H*Dh, D]
        self.bo = nn.Parameter(torch.zeros(d))
        self.ln1_scale = nn.Parameter(torch.ones(d))
        self.ln1_bias = nn.Parameter(torch.zeros(d))
        self.w1 = nn.Parameter(torch.empty(d, f))
        self.b1 = nn.Parameter(torch.zeros(f))
        self.w2 = nn.Parameter(torch.empty(f, d))
        self.b2 = nn.Parameter(torch.zeros(d))
        self.ln2_scale = nn.Parameter(torch.ones(d))
        self.ln2_bias = nn.Parameter(torch.zeros(d))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for w in (self.wqkv, self.wo, self.w1, self.w2):
            _normal_(w, generator)
        for b in (self.bqkv, self.bo, self.b1, self.b2, self.ln1_bias, self.ln2_bias):
            nn.init.zeros_(b)
        nn.init.ones_(self.ln1_scale)
        nn.init.ones_(self.ln2_scale)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        """x [B, T, D] in the activation dtype; attn_mask [B, T] bool;
        `seed` (the layer's dropout seed) turns dropout on. Its three
        sites take the reference's split of the layer key: 1 the
        attention output, 2 the FFN output, 3 the attention probs."""
        cfg = self.cfg
        rate = cfg.dropout_rate if seed is not None else 0.0
        s_out, s_ffn, s_att = ((None,) * 3 if seed is None
                               else (fold_seed(seed, i) for i in (1, 2, 3)))
        dt = x.dtype
        p = {name: w.to(dt) for name, w in self.named_parameters(recurse=False)}
        B, T, D = x.shape
        H, Dh = cfg.num_heads, cfg.head_dim
        qkv = (torch.matmul(x, p["wqkv"]) + p["bqkv"]).view(B, T, 3, H, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, Dh]
        if resolve_impl(cfg.attn_impl, T, Dh, cuda=x.is_cuda) == "flash":
            ctx = flash_attention(q, k, v, attn_mask, dropout_rate=rate, seed=s_att)
        else:
            bits = dropout_bits(s_att, B, H, T, T, x.device) if rate > 0.0 else None
            ctx, _ = attention_plain(q, k, v, attn_mask, dropout_rate=rate, bits=bits)
        out = torch.matmul(ctx.transpose(1, 2).reshape(B, T, H * Dh), p["wo"]) + p["bo"]
        out = dropout(out, rate, s_out)
        x = _layer_norm(x + out, p["ln1_scale"], p["ln1_bias"], cfg.layer_norm_eps)
        h = F.gelu(torch.matmul(x, p["w1"]) + p["b1"])  # erf GELU
        h = torch.matmul(h, p["w2"]) + p["b2"]
        h = dropout(h, rate, s_ffn)
        return _layer_norm(x + h, p["ln2_scale"], p["ln2_bias"], cfg.layer_norm_eps)


class RobertaEncoder(nn.Module):
    """Embeddings, `num_layers` encoder layers and (with `with_pooler`)
    the tanh [CLS] pooler. `generator` seeds the initial weights."""

    def __init__(self, cfg: TransformerConfig, with_pooler: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.with_pooler = with_pooler
        if with_pooler:
            d = cfg.hidden_size
            self.pooler_w = nn.Parameter(torch.empty(d, d))
            self.pooler_b = nn.Parameter(torch.zeros(d))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.embeddings.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        if self.with_pooler:
            _normal_(self.pooler_w, generator)
            nn.init.zeros_(self.pooler_b)

    def embed(self, input_ids: torch.Tensor, position_offset: int = 0,
              seed: int | None = None, inputs_embeds: torch.Tensor | None = None
              ) -> torch.Tensor:
        """[B, T] ids -> [B, T, D] embeddings in the activation dtype
        (dropped with `seed` when one is given); `inputs_embeds` replaces
        the word gather."""
        return self.embeddings(input_ids, position_offset, seed, inputs_embeds)

    def encode(
        self,
        input_ids: torch.Tensor,
        attn_mask: torch.Tensor | None = None,
        *,
        dropout_key=None,
        sp_axis: str | None = None,
        tp_axis: str | None = None,
        position_offset: int = 0,
        inputs_embeds: torch.Tensor | None = None,
        remat: bool = True,
    ) -> torch.Tensor:
        """[B, T] int ids -> [B, T, D] hidden states. `dropout_key` (a
        64-bit seed) turns dropout on: the embedding takes seed (0,),
        layer i seed (1, i) folded from it (`nn/dropout.py:fold_seed`).
        `inputs_embeds` ([B, T, D] fp32) replaces the word gather, and
        `remat=False` runs the layers plainly with gradients on: the
        attribution forward (eval/localize.py), which differentiates
        with respect to those rows, as the reference's `_roberta_forward`
        scans its plain layers."""
        if sp_axis is not None or tp_axis is not None:
            raise NotImplementedError(
                "sp_axis / tp_axis: sequence and tensor parallelism come with the "
                "multi-device slice of the port (ROADMAP queue A, item 9)"
            )
        cfg = self.cfg
        remat = remat and cfg.remat and torch.is_grad_enabled()
        if attn_mask is None:
            attn_mask = input_ids != cfg.pad_token_id
        seeded = dropout_key is not None
        x = self.embed(input_ids, position_offset, fold_seed(dropout_key, 0) if seeded else None,
                       inputs_embeds)
        for i, layer in enumerate(self.layers):
            seed = fold_seed(dropout_key, 1, i) if seeded else None
            if remat:
                x = remat_layer(layer, x, attn_mask, seed, policy=cfg.remat_policy)
            else:
                x = layer(x, attn_mask, seed)
        return x

    forward = encode

    def cls_pool(self, hidden: torch.Tensor) -> torch.Tensor:
        """[CLS] (position 0) through the tanh pooler -> [B, D]."""
        if not self.with_pooler:
            raise ValueError("this encoder was built without its pooler (with_pooler=False)")
        cls = hidden[:, 0, :]
        return torch.tanh(cls @ self.pooler_w.to(cls.dtype) + self.pooler_b.to(cls.dtype))


def params_from_hf_torch(cfg: TransformerConfig, state_dict) -> dict[str, torch.Tensor]:
    """A Hugging Face torch `RobertaModel` state_dict (keys with a
    `'roberta.'` prefix or none) -> a `RobertaEncoder` state_dict with its
    pooler (zeros when the state dict has none), through the reference's
    key map (`models/convert.py:hf_roberta_tree`)."""
    return from_jax_encoder_params(hf_roberta_tree(cfg, state_dict))
