"""T5 encoder-decoder for generation and clone detection (the port of the
reference's `deepdfa_tpu/models/t5_gen.py`, one device): CodeT5's
`run_gen.py` / `run_multi_gen.py` model and `run_clone.py`'s CloneModel.

The decoder follows the reference: pre-RMSNorm layers of causal
self-attention with T5's unidirectional relative-position bias (shared by
every layer, no 1/sqrt(d) scaling), cross-attention over the encoder's
states without a bias, a ReLU FFN, a final RMS norm, and the LM head tied
to the shared embedding with HF's d_model**-0.5 rescale (an untied
`lm_head` when the parameters carry one, without the rescale). Teacher
forcing shifts the targets right with the pad id as the start token; the
loss masks pad targets.

Layout. As in `models/t5.py`, the reference's per-head kernels are fused:
each decoder layer holds `wqkv` [D, 3*H*Dh] (self q | k | v), `cq` [D,
H*Dh], `ckv` [D, 2*H*Dh] (cross k | v), `wo`/`co` [H*Dh, D], `wi`, `wo_ffn`
and the norms `ln1`, `lnc`, `ln2`; `models/convert.py:from_jax_gen_params`
maps the reference's stacked tree onto it.

Attention in `decode_train` follows `attn_impl`: on a CUDA tensor the
self-attention launches the causal, biased flash kernels (kernels 5-8,
`flash_attention(..., bias=, causal=True)`) over `dec_mask`, and the
cross-attention the rectangular unbiased ones (Tq = target length, Tk =
source length) over the source mask; on the CPU both are the plain
versions. There is no dropout on attention probabilities, as in the
reference. Dropout runs where a `dropout_key` is given: the encoder takes
seed (0,), the decoder (1,), and inside the decoder the embedding (0,),
layer i (1, i) with (1,), (2,), (3,) after its self-attention,
cross-attention and FFN, and the final norm's output (2,). With `remat`
and gradients on, each decoder layer runs under `torch.utils.checkpoint`,
as the encoder's layers do, under the encoder config's `remat_policy`
("attn_saved" keeps both flash calls' (o, lse) across the checkpoint).
`gen_params_from_hf_torch` reads a Hugging Face
`T5ForConditionalGeneration` state_dict into a `T5Seq2Seq`.

Incremental decoding (`_decode_step`, `beam_search`, `greedy_decode`)
keeps the reference's KV-cached attention in plain PyTorch (the reference
runs XLA attention there, no Pallas kernel): the same masking with the
dtype's finfo.min, the same fp32 beam scores with -1e9 for dead beams, and
top-K by a stable descending sort, so equal candidates rank by index as
`jax.lax.top_k` ranks them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepdfa_tpu_torch.models.convert import from_jax_gen_params, hf_gen_tree
from deepdfa_tpu_torch.models.t5 import (
    T5Config,
    T5Encoder,
    attend,
    decoder_rel_bias,
    eos_pool,
    relative_position_buckets,
    rms_norm,
)
from deepdfa_tpu_torch.models.transformer import _normal_
from deepdfa_tpu_torch.nn.dropout import dropout, fold_seed
from deepdfa_tpu_torch.nn.flash_attention import remat_layer

#: the reference's score of a dead beam
NEG_SCORE = -1e9


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """The reference's fields and defaults."""

    encoder: T5Config
    num_decoder_layers: int | None = None  # default: as many as the encoder
    max_target_length: int = 128
    beam_size: int = 5
    length_penalty: float = 1.0

    @property
    def n_dec_layers(self) -> int:
        if self.num_decoder_layers is None:
            return self.encoder.num_layers
        return self.num_decoder_layers


class T5DecoderLayer(nn.Module):
    """One pre-RMSNorm T5 decoder layer: causal self-attention with the
    shared bias, cross-attention, FFN."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        d, hd, f = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.ffn_size
        self.wqkv = nn.Parameter(torch.empty(d, 3 * hd))
        self.wo = nn.Parameter(torch.empty(hd, d))
        self.ln1 = nn.Parameter(torch.ones(d))
        self.cq = nn.Parameter(torch.empty(d, hd))
        self.ckv = nn.Parameter(torch.empty(d, 2 * hd))
        self.co = nn.Parameter(torch.empty(hd, d))
        self.lnc = nn.Parameter(torch.ones(d))
        self.wi = nn.Parameter(torch.empty(d, f))
        self.wo_ffn = nn.Parameter(torch.empty(f, d))
        self.ln2 = nn.Parameter(torch.ones(d))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """The reference's stddevs (`init_gen_params`, `:62-97`): (D*Dh)^-1/2
        for the queries, D^-1/2 for keys, values and wi, (H*Dh)^-1/2 for the
        output projections, F^-1/2 for wo_ffn; norms at 1."""
        cfg = self.cfg
        d, hd, f = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.ffn_size
        q_std, kv_std = (d * cfg.head_dim) ** -0.5, d ** -0.5
        with torch.no_grad():
            for i, std in enumerate((q_std, kv_std, kv_std)):
                self.wqkv[:, i * hd:(i + 1) * hd].copy_(
                    torch.randn((d, hd), generator=generator) * std)
            self.cq.copy_(torch.randn((d, hd), generator=generator) * q_std)
            self.ckv.copy_(torch.randn((d, 2 * hd), generator=generator) * kv_std)
        _normal_(self.wo, generator, hd ** -0.5)
        _normal_(self.co, generator, hd ** -0.5)
        _normal_(self.wi, generator, d ** -0.5)
        _normal_(self.wo_ffn, generator, f ** -0.5)
        for ln in (self.ln1, self.lnc, self.ln2):
            nn.init.ones_(ln)

    def forward(self, x, dec_mask, bias, enc_h, enc_mask, seed: int | None = None):
        """x [B, T, D] and enc_h [B, S, D] in the activation dtype; dec_mask
        [B, T] and enc_mask [B, S] bool; bias [H, T, T] in the activation
        dtype; `seed` turns dropout on after each of the three blocks."""
        cfg = self.cfg
        rate = cfg.dropout_rate if seed is not None else 0.0
        seeds = [None] * 3 if seed is None else [fold_seed(seed, i) for i in (1, 2, 3)]
        dt = x.dtype
        p = {n: getattr(self, n).to(dt) for n in ("wqkv", "wo", "cq", "ckv", "co", "wi",
                                                 "wo_ffn")}
        B, T, _ = x.shape
        S = enc_h.shape[1]
        H, Dh = cfg.num_heads, cfg.head_dim
        eps = cfg.layer_norm_eps

        h = rms_norm(x, self.ln1, eps)
        qkv = torch.matmul(h, p["wqkv"]).view(B, T, 3, H, Dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ctx = attend(cfg, q, k, v, dec_mask, bias=bias, causal=True)
        out = torch.matmul(ctx.transpose(1, 2).reshape(B, T, H * Dh), p["wo"])
        x = x + dropout(out, rate, seeds[0])

        h = rms_norm(x, self.lnc, eps)
        q = torch.matmul(h, p["cq"]).view(B, T, H, Dh).transpose(1, 2)
        kv = torch.matmul(enc_h, p["ckv"]).view(B, S, 2, H, Dh)
        k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
        ctx = attend(cfg, q, k, v, enc_mask)
        out = torch.matmul(ctx.transpose(1, 2).reshape(B, T, H * Dh), p["co"])
        x = x + dropout(out, rate, seeds[1])

        h = torch.relu(torch.matmul(rms_norm(x, self.ln2, eps), p["wi"]))
        h = torch.matmul(h, p["wo_ffn"])
        return x + dropout(h, rate, seeds[2])


class T5Decoder(nn.Module):
    """The decoder's relative-position table, layers, final norm and, for
    untied checkpoints, its own `lm_head` [V, D]."""

    def __init__(self, cfg: T5Config, n_layers: int, untied_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = nn.Parameter(torch.empty(cfg.rel_buckets, cfg.num_heads))
        self.layers = nn.ModuleList(T5DecoderLayer(cfg) for _ in range(n_layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.hidden_size))
        self.lm_head = (nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
                        if untied_head else None)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        _normal_(self.rel_bias, generator, 0.1)
        for layer in self.layers:
            layer.reset_parameters(generator)
        nn.init.ones_(self.final_ln)
        if self.lm_head is not None:
            _normal_(self.lm_head, generator, 1.0)


class T5Seq2Seq(nn.Module):
    """Encoder, decoder and the (tied or untied) LM head of a GenConfig.
    `generator` seeds the initial weights; `untied_head` adds the
    decoder's own `lm_head` (a checkpoint with tie_word_embeddings off)."""

    def __init__(self, cfg: GenConfig, generator: torch.Generator | None = None,
                 untied_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Encoder(cfg.encoder, generator=generator)
        self.decoder = T5Decoder(cfg.encoder, cfg.n_dec_layers, untied_head)
        self.decoder.reset_parameters(generator)

    def forward(self, source_ids, target_ids, *, dropout_key=None):
        return seq2seq_logits(self, source_ids, target_ids, dropout_key=dropout_key)


# ---------------------------------------------------------------------------
# teacher-forced decoding (training, perplexity)


def shift_right(cfg: T5Config, target_ids: torch.Tensor) -> torch.Tensor:
    """HF T5 `_shift_right`: decoder inputs = [pad] + target[:-1]."""
    start = torch.full_like(target_ids[:, :1], cfg.pad_token_id)
    return torch.cat([start, target_ids[:, :-1]], dim=1)


def _lm_logits(model: T5Seq2Seq, x: torch.Tensor) -> torch.Tensor:
    """Decoder states [..., D] -> vocab logits [..., V] in x's dtype: the
    untied lm_head when the model has one, else the shared embedding with
    the d_model**-0.5 rescale (HF applies it only when tied)."""
    head = model.decoder.lm_head
    if head is None:
        x = x * (model.cfg.encoder.hidden_size ** -0.5)
        head = model.encoder.word
    return torch.matmul(x, head.to(x.dtype).t())


def decode_train(model: T5Seq2Seq, dec_input_ids, dec_mask, enc_hidden, enc_mask,
                 dropout_key=None, return_hidden: bool = False) -> torch.Tensor:
    """[B, T] decoder inputs -> [B, T, V] LM logits (teacher-forced), or
    with `return_hidden` the [B, T, D] states after the final norm (what
    the clone head pools)."""
    ecfg = model.cfg.encoder
    dt = ecfg.torch_dtype
    dec = model.decoder
    seeded = dropout_key is not None and ecfg.dropout_rate > 0.0
    rate = ecfg.dropout_rate if seeded else 0.0
    x = F.embedding(dec_input_ids, model.encoder.word).to(dt)
    x = dropout(x, rate, fold_seed(dropout_key, 0) if seeded else None)
    T = dec_input_ids.shape[1]
    bias = decoder_rel_bias(ecfg, dec.rel_bias, T, dt)  # once, outside the checkpoints
    enc_h = enc_hidden.to(dt)
    remat = ecfg.remat and torch.is_grad_enabled()
    for i, layer in enumerate(dec.layers):
        seed = fold_seed(dropout_key, 1, i) if seeded else None
        if remat:
            x = remat_layer(layer, x, dec_mask, bias, enc_h, enc_mask, seed,
                            policy=ecfg.remat_policy)
        else:
            x = layer(x, dec_mask, bias, enc_h, enc_mask, seed)
    x = rms_norm(x, dec.final_ln, ecfg.layer_norm_eps)
    x = dropout(x, rate, fold_seed(dropout_key, 2) if seeded else None)
    return x if return_hidden else _lm_logits(model, x)


def seq2seq_logits(model: T5Seq2Seq, source_ids, target_ids, dropout_key=None):
    """The full teacher-forced pass: encode the source, decode the shifted
    targets (every decoder position attends; pad targets are masked in
    the loss)."""
    ecfg = model.cfg.encoder
    k_enc = k_dec = None
    if dropout_key is not None:
        k_enc, k_dec = fold_seed(dropout_key, 0), fold_seed(dropout_key, 1)
    enc_mask = source_ids != ecfg.pad_token_id
    enc_hidden = model.encoder.encode(source_ids, enc_mask, dropout_key=k_enc)
    dec_in = shift_right(ecfg, target_ids)
    dec_mask = torch.ones_like(dec_in, dtype=torch.bool)
    return decode_train(model, dec_in, dec_mask, enc_hidden, enc_mask, dropout_key=k_dec)


def token_ce(logits: torch.Tensor, target_ids: torch.Tensor) -> torch.Tensor:
    """[B, T] fp32 cross-entropy of each target token."""
    V = logits.shape[-1]
    return F.cross_entropy(logits.float().reshape(-1, V), target_ids.reshape(-1).long(),
                           reduction="none").view(target_ids.shape)


def seq2seq_loss(model: T5Seq2Seq, source_ids, target_ids, dropout_key=None):
    """(mean CE over non-pad target tokens, token count)."""
    logits = seq2seq_logits(model, source_ids, target_ids, dropout_key)
    mask = (target_ids != model.cfg.encoder.pad_token_id).float()
    n_tok = mask.sum().clamp(min=1.0)
    return (token_ce(logits, target_ids) * mask).sum() / n_tok, n_tok


# ---------------------------------------------------------------------------
# incremental decoding with a KV cache, beam search


def _precompute_cross_kv(model: T5Seq2Seq, enc_hidden: torch.Tensor):
    """Cross-attention K and V once per sequence: ([L, N, H, S, Dh], same)."""
    ecfg = model.cfg.encoder
    dt = ecfg.torch_dtype
    enc_h = enc_hidden.to(dt)
    N, S, _ = enc_h.shape
    ks, vs = [], []
    for layer in model.decoder.layers:
        kv = torch.matmul(enc_h, layer.ckv.to(dt)).view(N, S, 2, ecfg.num_heads, -1)
        ks.append(kv[:, :, 0].transpose(1, 2))
        vs.append(kv[:, :, 1].transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def _step_bias(model: T5Seq2Seq, Tmax: int) -> torch.Tensor:
    """[Tmax, H, Tmax]: row t is the bias of query t over keys 0..Tmax-1
    (decoder buckets), in the activation dtype."""
    ecfg = model.cfg.encoder
    pos = np.arange(Tmax)
    buckets = torch.from_numpy(relative_position_buckets(
        pos, pos, ecfg.rel_buckets, ecfg.rel_max_distance, bidirectional=False)).long()
    table = model.decoder.rel_bias[buckets.to(model.decoder.rel_bias.device)]  # [T, T, H]
    return table.to(ecfg.torch_dtype).transpose(1, 2)


def _decode_step(model: T5Seq2Seq, tokens, t: int, cache_k, cache_v, cross_k, cross_v,
                 enc_mask, bias: torch.Tensor | None = None):
    """One cached decoder step: ([N, V] fp32 logits, caches). tokens [N]
    is each row's input token, `t` the position written; cache_k/v [L, N,
    H, Tmax, Dh] are updated in place at t; cross_k/v [L, N, H, S, Dh];
    enc_mask [N, S]. `bias` is `_step_bias`'s table (built if None)."""
    ecfg = model.cfg.encoder
    dt = ecfg.torch_dtype
    dec = model.decoder
    H, Dh = ecfg.num_heads, ecfg.head_dim
    eps = ecfg.layer_norm_eps
    Tmax = cache_k.shape[3]
    if bias is None:
        bias = _step_bias(model, Tmax)
    b_t = bias[t]  # [H, Tmax]
    neg = torch.finfo(dt).min
    self_ok = (torch.arange(Tmax, device=tokens.device) <= t)[None, None]  # [1, 1, Tmax]
    cross_ok = enc_mask.to(torch.bool)[:, None]  # [N, 1, S]
    x = F.embedding(tokens, model.encoder.word).to(dt)  # [N, D]
    for i, layer in enumerate(dec.layers):
        h = rms_norm(x, layer.ln1, eps)
        q, k_new, v_new = torch.matmul(h, layer.wqkv.to(dt)).view(-1, 3, H, Dh).unbind(1)
        cache_k[i, :, :, t] = k_new
        cache_v[i, :, :, t] = v_new
        s = torch.einsum("nhk,nhtk->nht", q, cache_k[i]) + b_t[None]
        s = torch.where(self_ok, s, neg)
        ctx = torch.einsum("nht,nhtk->nhk", torch.softmax(s, dim=-1), cache_v[i])
        x = x + torch.matmul(ctx.reshape(ctx.shape[0], -1), layer.wo.to(dt))

        h = rms_norm(x, layer.lnc, eps)
        q = torch.matmul(h, layer.cq.to(dt)).view(-1, H, Dh)
        s = torch.einsum("nhk,nhsk->nhs", q, cross_k[i])
        s = torch.where(cross_ok, s, neg)
        ctx = torch.einsum("nhs,nhsk->nhk", torch.softmax(s, dim=-1), cross_v[i])
        x = x + torch.matmul(ctx.reshape(ctx.shape[0], -1), layer.co.to(dt))

        h = torch.relu(torch.matmul(rms_norm(x, layer.ln2, eps), layer.wi.to(dt)))
        x = x + torch.matmul(h, layer.wo_ffn.to(dt))
    x = rms_norm(x, dec.final_ln, eps)
    return _lm_logits(model, x).float(), cache_k, cache_v


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, equal
    values in index order (`jax.lax.top_k`'s tie rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model: T5Seq2Seq, source_ids: torch.Tensor, beam_size: int | None = None,
                max_length: int | None = None) -> torch.Tensor:
    """Beam-search decode: [B, S] source ids -> [B, max_length] token ids.

    The reference's algorithm step for step: only beam 0 is live at step
    0; finished beams continue on the pad token with frozen scores; the
    loop ends when every beam of every row has emitted EOS or at
    max_length; the final ranking divides each beam's log-prob by
    length**length_penalty, finished beams first."""
    cfg = model.cfg
    ecfg = cfg.encoder
    K = beam_size or cfg.beam_size
    Tmax = max_length or cfg.max_target_length
    B, S = source_ids.shape
    L, H, Dh = cfg.n_dec_layers, ecfg.num_heads, ecfg.head_dim
    pad, eos, V = ecfg.pad_token_id, ecfg.eos_token_id, ecfg.vocab_size
    dev = source_ids.device
    dt = ecfg.torch_dtype

    enc_mask = source_ids != pad
    enc_hidden = model.encoder.encode(source_ids, enc_mask)
    enc_mask_b = enc_mask.repeat_interleave(K, dim=0)
    cross_k, cross_v = _precompute_cross_kv(model, enc_hidden.repeat_interleave(K, dim=0))
    bias = _step_bias(model, Tmax)

    N = B * K
    seqs = torch.full((B, K, Tmax), pad, dtype=torch.int64, device=dev)
    scores = torch.full((B, K), NEG_SCORE, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    tokens = torch.full((N,), pad, dtype=torch.int64, device=dev)
    cache_k = torch.zeros((L, N, H, Tmax, Dh), dtype=dt, device=dev)
    cache_v = torch.zeros_like(cache_k)
    pad_only = torch.full((V,), NEG_SCORE, dtype=torch.float32, device=dev)
    pad_only[pad] = 0.0
    rows = torch.arange(B, device=dev)[:, None] * K

    for t in range(Tmax):
        if bool(done.all()):
            break
        logits, cache_k, cache_v = _decode_step(model, tokens, t, cache_k, cache_v, cross_k,
                                                cross_v, enc_mask_b, bias)
        logp = torch.log_softmax(logits, dim=-1).view(B, K, V)
        logp = torch.where(done[..., None], pad_only, logp)
        cand = (scores[..., None] + logp).view(B, K * V)
        scores, flat = top_k_stable(cand, K)
        origin = torch.div(flat, V, rounding_mode="floor")
        tok = flat % V
        seqs = torch.gather(seqs, 1, origin[..., None].expand(B, K, Tmax))
        seqs[:, :, t] = tok
        done = torch.gather(done, 1, origin) | (tok == eos)
        row = (rows + origin).reshape(-1)
        cache_k = cache_k[:, row]
        cache_v = cache_v[:, row]
        tokens = tok.reshape(-1)

    lengths = (seqs != pad).sum(-1).float()
    norm = lengths.clamp(min=1.0) ** cfg.length_penalty
    final = scores / norm + torch.where(done, 0.0, NEG_SCORE)
    final = torch.where(done.any(-1, keepdim=True), final, scores / norm)
    best = torch.argmax(final, dim=1)
    return seqs[torch.arange(B, device=dev), best]


def greedy_decode(model: T5Seq2Seq, source_ids: torch.Tensor,
                  max_length: int | None = None) -> torch.Tensor:
    """Greedy decoding: beam search with one beam."""
    return beam_search(model, source_ids, beam_size=1, max_length=max_length)


def trim_at_eos(ids, eos_id: int, pad_id: int = 0) -> list[list[int]]:
    """Host side: cut each row at its first EOS and drop pads."""
    out = []
    for row in np.asarray(ids):
        toks = []
        for t in row.tolist():
            if t == eos_id:
                break
            if t != pad_id:
                toks.append(t)
        out.append(toks)
    return out


# ---------------------------------------------------------------------------
# clone detection (CodeT5/models.py:64-123 CloneModel, run_clone.py)


@dataclasses.dataclass(frozen=True)
class CloneConfig:
    """Pairwise clone classifier over the seq2seq stack: each code of a
    pair runs through encoder and decoder (decoder inputs = the shifted
    source), the last-eos decoder state is pooled, and the pair's
    concatenated vectors go through Linear(2D, D) -> tanh -> Linear(D, 2)."""

    encoder: T5Config
    num_classes: int = 2


class CloneModel(nn.Module):
    def __init__(self, cfg: CloneConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.seq2seq = T5Seq2Seq(GenConfig(encoder=cfg.encoder), generator=generator)
        D = cfg.encoder.hidden_size
        self.dense = nn.Linear(2 * D, D)
        self.out = nn.Linear(D, cfg.num_classes)
        _normal_(self.dense.weight, generator, 0.02)
        _normal_(self.out.weight, generator, 0.02)
        nn.init.zeros_(self.dense.bias)
        nn.init.zeros_(self.out.bias)

    def forward(self, pair_ids, *, dropout_key=None):
        return clone_forward(self, pair_ids, dropout_key=dropout_key)


def clone_vec(model: CloneModel, source_ids, dropout_key=None) -> torch.Tensor:
    """[N, D]: the last-eos decoder state of each code (a row)."""
    s2s = model.seq2seq
    ecfg = s2s.cfg.encoder
    k_enc = k_dec = None
    if dropout_key is not None:
        k_enc, k_dec = fold_seed(dropout_key, 0), fold_seed(dropout_key, 1)
    mask = source_ids != ecfg.pad_token_id
    enc_hidden = s2s.encoder.encode(source_ids, mask, dropout_key=k_enc)
    hidden = decode_train(s2s, shift_right(ecfg, source_ids), mask, enc_hidden, mask,
                          dropout_key=k_dec, return_hidden=True)
    return eos_pool(ecfg, hidden, source_ids)


def clone_forward(model: CloneModel, pair_ids, dropout_key=None) -> torch.Tensor:
    """[B, 2, T] code pairs -> [B, num_classes] fp32 logits."""
    B, two, T = pair_ids.shape
    vec = clone_vec(model, pair_ids.reshape(B * two, T), dropout_key=dropout_key)
    x = torch.tanh(model.dense(vec.float().reshape(B, -1)))
    return model.out(x)


def gen_params_from_hf_torch(cfg: GenConfig, state_dict) -> dict[str, torch.Tensor]:
    """A Hugging Face torch `T5ForConditionalGeneration` state_dict -> a
    `T5Seq2Seq` state_dict (with `decoder.lm_head` when the checkpoint's
    head is untied: build the model with `untied_head=True` for it),
    through the reference's key map (`models/convert.py:hf_gen_tree`)."""
    return from_jax_gen_params(hf_gen_tree(cfg, state_dict))
