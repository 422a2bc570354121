"""T5-family encoder and the CodeT5+DeepDFA defect classifier (the port of
the reference's `deepdfa_tpu/models/t5.py`, one device).

T5 numerics as in the reference: RMS layer norm in fp32 (no mean, no
bias), pre-norm residual blocks, bias-free projections, NO 1/sqrt(d)
attention scaling (`scale=1.0`), ReLU FFN, a final RMS norm, and the
bucketed bidirectional relative-position bias computed once per forward
and shared by every layer. Parameters are fp32; each layer casts them to
the activation dtype (`T5Config.dtype`) when it runs, as the reference
does (`encoder_layer`, `:254-310`).

Layout. The per-head q/k/v kernels [D, H, Dh] of the reference are fused
into one [D, 3*H*Dh] product whose output is viewed as [B, T, 3, H, Dh],
so q, k and v reach the attention as [B, H, T, Dh] strided views, as in
`models/transformer.py`; `models/convert.py:from_jax_t5_params` maps the
reference's stacked tree onto this module.

The relative-position bias. `relative_position_buckets` is computed on
the host in fp32 (numpy), as the reference's `jnp.log` and int cast do,
and cached per length. The [H, T, T] bias is the product
rel_bias^T [H, 32] @ one_hot(buckets) [32, T*T]: exact in fp32 (one
nonzero term per element), and its gradient is a product too, where a
gather's backward would scatter with float atomics on the card (the
port's training path repeats bit for bit). The bias is cast to the
activation dtype, as the reference does (`encoder_rel_bias`, `:188`), so
its gradient sums the layers' dbias in that dtype.

Attention follows `attn_impl` (`nn/flash_attention.py:resolve_impl`):
on a CUDA tensor "auto" and "flash" launch the flash kernels
with the bias (kernels 5-8 through `FlashAttention`), and "xla" is the
plain version, asked for by name; on the CPU every route is the plain
version. As in the reference, there is no attention-probs dropout
(`_attention`, `:146-153`): dropout runs where `encode` gets a
`dropout_key`, at the embedding, after each layer's attention and FFN
(seeds (1,) and (2,) folded from the layer's) and after the final norm.
With `remat` and gradients on, each layer runs under
`torch.utils.checkpoint` (non-reentrant, `nn/flash_attention.py:
remat_layer`); every mask is a function of its seed, so the replay draws
the same masks. `remat_policy="attn_saved"` keeps the flash kernel's (o,
lse) across the checkpoint, so the replay launches no forward kernel.

`params_from_hf_torch` reads a Hugging Face `T5EncoderModel` / `T5Model`
state_dict (codet5-base's layout) into the encoder.

Not ported (raise `NotImplementedError`): sequence and tensor
parallelism (`sp_axis`, `tp_axis`, `sp_variant="ulysses"`) and the
pipeline (`pp_axis`).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepdfa_tpu_torch.core.config import PAD_ID_BY_FAMILY
from deepdfa_tpu_torch.graphs.batch import GraphBatch
from deepdfa_tpu_torch.models.convert import from_jax_t5_params, hf_t5_tree
from deepdfa_tpu_torch.models.deepdfa import DeepDFA
from deepdfa_tpu_torch.models.transformer import _DTYPES, _normal_
from deepdfa_tpu_torch.nn.dropout import dropout, fold_seed
from deepdfa_tpu_torch.nn.flash_attention import (
    attention_plain,
    flash_attention,
    remat_layer,
    resolve_impl,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """The reference's fields and defaults (codet5-base width)."""

    vocab_size: int = 32100
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    ffn_size: int = 3072
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    dropout_rate: float = 0.1
    eos_token_id: int = 2
    pad_token_id: int = PAD_ID_BY_FAMILY["t5"]
    #: an optional bound on T (the relative bias itself has none): the
    #: combined CLI sets it to --max-length, so a misconfigured bucket
    #: edge fails loudly
    max_sequence_length: int | None = None
    dtype: str = "float32"  # activation dtype: float32 | bfloat16
    remat: bool = True  # checkpoint each layer when gradients are on
    sp_variant: str = "ring"
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

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        base = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, head_dim=16,
                    ffn_size=128)
        base.update(kw)
        return cls(**base)


def relative_position_buckets(q_pos, k_pos, num_buckets: int, max_distance: int,
                              bidirectional: bool = True) -> np.ndarray:
    """T5 relative-position bucketing, [Tq, Tk] int32, in numpy with the
    reference's fp32 log and int cast (`:115-143`): bidirectional is the
    encoder's scheme (half the buckets for each direction), otherwise the
    decoder's (all buckets over the past)."""
    rel = np.asarray(k_pos, np.int64)[None, :] - np.asarray(q_pos, np.int64)[:, None]
    if bidirectional:
        nb = num_buckets // 2
        out = np.where(rel > 0, nb, 0)
        n = np.abs(rel)
    else:
        nb = num_buckets
        out = np.zeros_like(rel)
        n = np.maximum(-rel, 0)
    max_exact = nb // 2
    is_small = n < max_exact
    log_ratio = np.log(np.maximum(n, 1).astype(np.float32) / np.float32(max_exact))
    log_denom = np.float32(np.log(max_distance / max_exact))
    large = max_exact + (log_ratio / log_denom * np.float32(nb - max_exact)).astype(np.int32)
    large = np.minimum(large, nb - 1)
    return (out + np.where(is_small, n, large)).astype(np.int32)


_onehot_lock = threading.Lock()
_onehot_cache: dict[tuple, torch.Tensor] = {}


def bucket_one_hot(T: int, num_buckets: int, max_distance: int,
                   device: torch.device, bidirectional: bool = True) -> torch.Tensor:
    """[num_buckets, T*T] fp32 one-hot of a [T, T] bucket table, the
    encoder's (`bidirectional`) or the decoder's, cached per (T, buckets,
    distance, device, bidirectional); built outside inference mode, so a
    cached table serves training passes too."""
    key = (int(T), num_buckets, max_distance, torch.device(device), bool(bidirectional))
    with _onehot_lock, torch.inference_mode(False), torch.no_grad():
        oh = _onehot_cache.get(key)
        if oh is None:
            pos = np.arange(T)
            buckets = torch.from_numpy(
                relative_position_buckets(pos, pos, num_buckets, max_distance,
                                          bidirectional).reshape(-1)
            ).to(device=device, dtype=torch.int64)
            oh = (torch.arange(num_buckets, device=device)[:, None] == buckets[None, :]).float()
            _onehot_cache[key] = oh
        return oh


def encoder_rel_bias(cfg: T5Config, rel_bias: torch.Tensor, T: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The encoder's shared [H, T, T] relative-position bias in `dtype`
    (contiguous): rel_bias^T @ one_hot(buckets), the single-device case
    of the reference's `encoder_rel_bias` (`:182-188`)."""
    oh = bucket_one_hot(T, cfg.rel_buckets, cfg.rel_max_distance, rel_bias.device)
    H = rel_bias.shape[1]
    return (rel_bias.t() @ oh).view(H, T, T).to(dtype)


def decoder_rel_bias(cfg: T5Config, rel_bias: torch.Tensor, T: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The decoder's shared [H, T, T] unidirectional relative-position
    bias in `dtype` (contiguous): rel_bias^T @ one_hot(decoder buckets),
    the product form of the reference's `rel_bias[buckets]` gather in
    `decode_train` (its gradient is a product too, not a scatter)."""
    oh = bucket_one_hot(T, cfg.rel_buckets, cfg.rel_max_distance, rel_bias.device,
                        bidirectional=False)
    H = rel_bias.shape[1]
    return (rel_bias.t() @ oh).view(H, T, T).to(dtype)


def attend(cfg: T5Config, q, k, v, kv_mask, bias=None, causal: bool = False) -> torch.Tensor:
    """T5 attention (scale 1.0): the flash kernels where `attn_impl`
    resolves to them, else the plain version."""
    Tq, Tk, Dh = q.shape[2], k.shape[2], q.shape[3]
    if resolve_impl(cfg.attn_impl, Tq, Dh, Tk=Tk, cuda=q.is_cuda) == "flash":
        return flash_attention(q, k, v, kv_mask, scale=1.0, bias=bias, causal=causal)
    return attention_plain(q, k, v, kv_mask, scale=1.0, bias=bias, causal=causal)[0]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """T5's RMS norm in fp32 whatever x's dtype, cast back to it."""
    y = x.float()
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + eps) * scale.float()
    return y.to(x.dtype)


class T5Layer(nn.Module):
    """One pre-RMSNorm T5 encoder layer (HF t5 semantics)."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        d, hd, f = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.ffn_size
        self.wqkv = nn.Parameter(torch.empty(d, 3 * hd))  # [in, q | k | v], heads inside
        self.wo = nn.Parameter(torch.empty(hd, d))  # [H*Dh, D]
        self.ln1 = nn.Parameter(torch.ones(d))
        self.wi = nn.Parameter(torch.empty(d, f))
        self.wo_ffn = nn.Parameter(torch.empty(f, d))
        self.ln2 = nn.Parameter(torch.ones(d))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The reference's init (`init_params`, `:71-91`): normals of
        stddev (D*Dh)^-1/2 (q), D^-1/2 (k, v, wi), (H*Dh)^-1/2 (wo),
        F^-1/2 (wo_ffn); norms at 1."""
        cfg = self.cfg
        d, hd, f = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.ffn_size
        with torch.no_grad():
            for i, std in enumerate(((d * cfg.head_dim) ** -0.5, d ** -0.5, d ** -0.5)):
                self.wqkv[:, i * hd:(i + 1) * hd].copy_(
                    torch.randn((d, hd), generator=generator) * std)
        _normal_(self.wo, generator, hd ** -0.5)
        _normal_(self.wi, generator, d ** -0.5)
        _normal_(self.wo_ffn, generator, f ** -0.5)
        nn.init.ones_(self.ln1)
        nn.init.ones_(self.ln2)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor, bias: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        """x [B, T, D] in the activation dtype; attn_mask [B, T] bool; bias
        [H, T, T] in the activation dtype; `seed` (the layer's dropout
        seed) turns dropout on: (1,) after the attention, (2,) after the
        FFN, the reference's split of the layer key."""
        cfg = self.cfg
        rate = cfg.dropout_rate if seed is not None else 0.0
        s_att, s_ffn = (None, None) if seed is None else (fold_seed(seed, 1), fold_seed(seed, 2))
        dt = x.dtype
        p = {name: getattr(self, name).to(dt) for name in ("wqkv", "wo", "wi", "wo_ffn")}
        B, T, _ = x.shape
        H, Dh = cfg.num_heads, cfg.head_dim
        h = rms_norm(x, self.ln1, cfg.layer_norm_eps)  # the fp32 scale, as the reference
        qkv = torch.matmul(h, p["wqkv"]).view(B, T, 3, H, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, T, Dh]
        ctx = attend(cfg, q, k, v, attn_mask, bias=bias)
        out = torch.matmul(ctx.transpose(1, 2).reshape(B, T, H * Dh), p["wo"])
        x = x + dropout(out, rate, s_att)
        h = torch.relu(torch.matmul(rms_norm(x, self.ln2, cfg.layer_norm_eps), p["wi"]))
        h = torch.matmul(h, p["wo_ffn"])
        return x + dropout(h, rate, s_ffn)


class T5Encoder(nn.Module):
    """Word embedding, relative-position table, `num_layers` layers and
    the final RMS norm. `generator` seeds the initial weights."""

    def __init__(self, cfg: T5Config, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.rel_bias = nn.Parameter(torch.empty(cfg.rel_buckets, cfg.num_heads))
        self.layers = nn.ModuleList(T5Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.hidden_size))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _normal_(self.word, generator, 1.0)
        _normal_(self.rel_bias, generator, 0.1)
        for layer in self.layers:
            layer.reset_parameters(generator)
        nn.init.ones_(self.final_ln)

    def encode(
        self,
        input_ids: torch.Tensor,
        attn_mask: torch.Tensor | None = None,
        *,
        dropout_key=None,
        sp_axis: str | None = None,
        tp_axis: str | None = None,
        inputs_embeds: torch.Tensor | None = None,
        remat: bool = True,
    ) -> torch.Tensor:
        """[B, T] int ids -> [B, T, D] final hidden states (after the final
        RMS norm). `dropout_key` (a 64-bit seed)
        turns dropout on: the embedding takes seed (0,), layer i (1, i),
        the final norm's output (2,). `inputs_embeds` ([B, T, D]) replaces
        the word gather (the reference's hook, `encode`, `:314`), and
        `remat=False` runs the layers plainly with gradients on (the
        attribution forward, eval/localize.py)."""
        if sp_axis is not None or tp_axis is not None:
            raise NotImplementedError(
                "sp_axis / tp_axis: sequence and tensor parallelism come with the "
                "multi-device slice of the port (ROADMAP queue A, item 9)"
            )
        cfg = self.cfg
        T = input_ids.shape[1]
        if cfg.max_sequence_length is not None and T > cfg.max_sequence_length:
            raise ValueError(
                f"sequence length {T} exceeds max_sequence_length={cfg.max_sequence_length} "
                "— lower the bucket edge (data.seq_buckets) / max_length or raise the "
                "configured bound"
            )
        remat = remat and cfg.remat and torch.is_grad_enabled()
        if attn_mask is None:
            attn_mask = input_ids != cfg.pad_token_id
        dt = cfg.torch_dtype
        x = (F.embedding(input_ids, self.word) if inputs_embeds is None else inputs_embeds).to(dt)
        seeded = dropout_key is not None and cfg.dropout_rate > 0.0
        rate = cfg.dropout_rate if seeded else 0.0
        x = dropout(x, rate, fold_seed(dropout_key, 0) if seeded else None)
        bias = encoder_rel_bias(cfg, self.rel_bias, T, dt)  # once, outside the checkpoints
        for i, layer in enumerate(self.layers):
            seed = fold_seed(dropout_key, 1, i) if seeded else None
            if remat:
                x = remat_layer(layer, x, attn_mask, bias, seed, policy=cfg.remat_policy)
            else:
                x = layer(x, attn_mask, bias, seed)
        x = rms_norm(x, self.final_ln, cfg.layer_norm_eps)
        return dropout(x, rate, fold_seed(dropout_key, 2) if seeded else None)

    forward = encode


def eos_pool(cfg: T5Config, hidden: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """[B, D]: the hidden state at each row's LAST eos token, or at the
    last position where a row has none (the reference's `eos_pool`,
    `:393-404`; CodeT5's get_t5_vec). A one-hot product, so its gradient
    is a product too (no indexed scatter)."""
    is_eos = input_ids == cfg.eos_token_id
    T = input_ids.shape[1]
    last = T - 1 - torch.argmax(torch.flip(is_eos, dims=[1]).to(torch.int32), dim=1)
    idx = torch.where(is_eos.any(dim=1), last, torch.full_like(last, T - 1))
    onehot = (torch.arange(T, device=hidden.device)[None, :] == idx[:, None]).to(hidden.dtype)
    return torch.bmm(onehot[:, None, :], hidden)[:, 0, :]


@dataclasses.dataclass(frozen=True)
class DefectConfig:
    """The reference's fields and defaults; `graph_n_steps` is the 5 GGNN
    steps its `make_graph_encoder_for` fixes."""

    encoder: T5Config
    graph_hidden_dim: int = 32
    graph_input_dim: int = 1002
    num_classes: int = 2
    use_graph: bool = True
    graph_n_steps: int = 5

    @property
    def graph_out_dim(self) -> int:
        return 8 * self.graph_hidden_dim


class DefectModel(nn.Module):
    """CodeT5+DeepDFA: T5 encoder, last-eos pooling, the encoder-mode
    DeepDFA (when `use_graph`) and one Linear to the logits, no head
    dropout (CodeT5/models.py:125-192). The call signature is the
    combined model's, so the executor and the trainer take either.
    `generator` seeds the initial weights."""

    def __init__(self, cfg: DefectConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Encoder(cfg.encoder, generator=generator)
        if cfg.use_graph:
            self.graph = DeepDFA(
                cfg.graph_input_dim, cfg.graph_hidden_dim, cfg.graph_n_steps,
                num_output_layers=0, concat_all_absdf=True, label_style="graph",
                encoder_mode=True, generator=generator,
            )
        in_dim = cfg.encoder.hidden_size + (cfg.graph_out_dim if cfg.use_graph else 0)
        self.head = nn.Linear(in_dim, cfg.num_classes)
        _normal_(self.head.weight, generator)
        nn.init.zeros_(self.head.bias)

    def forward(
        self,
        input_ids: torch.Tensor,
        graph_batch: GraphBatch | None = None,
        has_graph: torch.Tensor | None = None,
        *,
        dropout_key=None,
        sp_axis: str | None = None,
        tp_axis: str | None = None,
        pp_axis: str | None = None,
        inputs_embeds: torch.Tensor | None = None,
        remat: bool = True,
    ) -> torch.Tensor:
        """[B, T] ids (+ a GraphBatch of B graphs aligned with the rows)
        -> logits [B, num_classes] in fp32 (`defect_forward`,
        `:533-597`); dropout with a `dropout_key`; `inputs_embeds` and
        `remat` go to `T5Encoder.encode`."""
        if pp_axis is not None:
            raise NotImplementedError(
                "pp_axis: the pipeline comes with the multi-device slice of the port "
                "(ROADMAP queue A, item 9)"
            )
        hidden = self.encoder.encode(input_ids, dropout_key=dropout_key, sp_axis=sp_axis,
                                     tp_axis=tp_axis, inputs_embeds=inputs_embeds, remat=remat)
        vec = eos_pool(self.cfg.encoder, hidden, input_ids)
        if self.cfg.use_graph:
            if graph_batch is None:
                raise ValueError("DefectConfig.use_graph=True needs a graph_batch")
            gvec = self.graph(graph_batch)  # [B, 8H] fp32
            if has_graph is not None:
                gvec = gvec * has_graph[:, None].to(gvec.dtype)
            vec = torch.cat([vec, gvec.to(vec.dtype)], dim=-1)
        return self.head(vec.float())


def params_from_hf_torch(cfg: T5Config, state_dict) -> dict[str, torch.Tensor]:
    """A Hugging Face torch `T5EncoderModel` / `T5Model` state_dict -> a
    `T5Encoder` state_dict, through the reference's key map
    (`models/convert.py:hf_t5_tree`)."""
    return from_jax_t5_params(hf_t5_tree(cfg, state_dict))
