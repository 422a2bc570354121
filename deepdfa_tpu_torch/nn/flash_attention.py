"""Flash attention on Hopper: the wrappers of `csrc/flash_attention.cu`
(forward with in-kernel dropout and an additive score bias, backward dq,
dk/dv and dbias), their plain PyTorch versions, the `FlashAttention`
autograd Function and the dispatch helpers of the reference's
`deepdfa_tpu/nn/flash_attention.py`.

Kernel 5 of the port replaces the TPU kernel `_fwd_kernel` (launched by
`_fwd_call`), kernels 6, 7 and 8 replace `_dq_kernel`, `_dkv_kernel` and
`_dbias_kernel` (the pallas_calls of `_bwd_call`). For q [B, H, Tq, D]
and k, v [B, H, Tk, D] in fp32 or bf16, a kv mask [B, Tk] (False =
padding), an optional bias [H, Tq, Tk] broadcast over the batch (T5's
relative-position bias) and the causal option (Tq == Tk: query i sees
keys j <= i only, the reference's `_block_ok`; T5's decoder
self-attention) the forward returns

    o   [B, H, Tq, D] in q's dtype: dropout(softmax(q k^T * scale +
        bias)) v over the real keys, with p cast to v's dtype before the
        p.v product; the bias is added unscaled, in fp32; dropout scales
        the numerator only, the softmax denominator stays undropped
        (`_fwd_kernel`, `:199-208`);
    lse [B, H, Tq, 1] fp32: the log-sum-exp of the masked scores.

Scores of padded keys are -1e30 and their probabilities 0; the softmax
sum is floored at FLT_MIN, so a query whose keys are all padding (the
filler rows of a partly full batch) gets o = 0 and a finite lse; its
gradients are 0, and padded keys add nothing to dbias. dbias [H, Tq, Tk]
is the batch sum of ds = p (dp - delta) in fp32; `flash_bwd` and
`FlashAttention` return it cast to the bias's dtype (`_flash_bwd`,
`:600-602`).

Dropout bits. `dropout_bits(seed, B, H, Tq, Tk)` is a pure function of
(seed, b, h, row, col): Philox4x32-10 keyed by the 64-bit seed, counter
(col // 4, row, b*H + h, 0), whose four words are columns 4c .. 4c+3.
`keep = bits < keep_threshold(rate)` (the reference's
`_Params.keep_threshold`). The CUDA kernels compute the same bits in
registers, so the forward, dq, dk/dv, dbias and the plain versions draw
one mask whatever their tiling. These are not the reference's bits (it
seeds the TPU PRNG per 512 x 512 block); parity with the reference goes
through `debug_bits`, explicit [B, H, Tq, Tk] uint32 bits, as its own
tests do. `debug_bits` is for CPU tensors only.

`flash_fwd`, `flash_dq`, `flash_dkv`, `flash_dbias` and `flash_bwd`
launch the CUDA kernels for tensors on a CUDA device and run the plain
versions for tensors on the CPU; there is no other route and no fallback
from one to the other. `LAUNCHES`, `DQ_LAUNCHES`, `DKV_LAUNCHES` and
`DBIAS_LAUNCHES` count kernel launches, causal or not. The causal
instances live in a second build of the same source
(`flash_attention_causal`, `nn/cuda_build.py`); they skip the tiles above
the diagonal by loop bound, and dbias writes zeros there. With causal and
padded keys a query can have no live key: it gets o = 0 and a finite lse,
as an all-padding row does (the reference's flash path; its XLA path
averages such a row instead).

Bound on the card, at the flagship training call (B 16, H 12, T 512,
D 64, bf16): the forward moves q, k, v and o once, ~50 MB (0.015 ms at
3.35 TB/s), plus a bf16 bias's 6.3 MB, for 12.9 GFLOP (0.013 ms at 989
TFLOP/s); dq does 3 products (19.3 GFLOP, 0.0195 ms) on ~64 MB (0.019
ms); dk/dv 4 (25.8 GFLOP, 0.026 ms) on ~76 MB (0.023 ms); dbias 2 (12.9
GFLOP) on ~70 MB including its fp32 output (0.021 ms, bytes bind). The
kernels stream tiles through shared memory, so no T x T matrix but the
bias and dbias reaches device memory; the source's header has the rest
of the design. `flash_work` and `flash_bwd_work` are those counts as
formulas of a call's shapes and live (query, key) pairs (`live_pairs`):
the wrappers report them to an open count (obs/cost.py) at each launch,
the plain versions on the CPU in the kernels' place, and the card's
bounds are computed from them.

Layer checkpoints (`remat_layer`). Under remat_policy "full" a
checkpointed layer replays its whole forward in the backward, kernel 5
included. Under "attn_saved" (the reference's `remat_wrap`, which saves
only the flash kernel's `attn_ctx` and `attn_lse` across
`jax.checkpoint`) each `FlashAttention` call of the layer's forward keeps
its (o, lse) in a stash that the checkpoint's recompute context hands
back: the replay recomputes q, k and v from the layer's input but takes
o and lse from the stash and launches nothing. The kernel is
deterministic, so both policies give the same gradients to the bit.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch.utils.checkpoint import checkpoint

from deepdfa_tpu_torch.core import sanitize
from deepdfa_tpu_torch.nn import cuda_build
from deepdfa_tpu_torch.nn.ggnn_kernel import _on_cuda, _stream
from deepdfa_tpu_torch.obs import cost

#: kernel launches since the process started (or since a caller reset
#: them), counted where each kernel is launched and nowhere else
LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0
DBIAS_LAUNCHES = 0
_launch_lock = threading.Lock()

#: the reference's additive mask value and softmax-sum floor
NEG_BIG = -1e30
TINY = torch.finfo(torch.float32).tiny
#: widest head the kernels take (csrc/flash_attention.cu: kMaxD)
MAX_HEAD_DIM = 128

# ---------------------------------------------------------------------------
# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", SC 2011) on int64 tensors holding uint32 values

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * b, for a < 2^32
    and b int64 in [0, 2^32), without overflowing int64: b is split
    into 16-bit halves, each partial product < 2^48."""
    x = (b >> 16) * a
    y = (b & 0xFFFF) * a
    hi = (x + (y >> 16)) >> 16
    lo = (((x & 0xFFFF) << 16) + y) & _MASK32
    return hi, lo


def philox4x32_10(counter, key) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of `counter` (four uint32 words: int64 tensors that
    broadcast together, or ints) under `key` (two uint32 words): the four
    output words as int64 tensors in [0, 2^32)."""
    c = [torch.as_tensor(w, dtype=torch.int64) & _MASK32 for w in counter]
    k0, k1 = (int(w) & _MASK32 for w in key)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return tuple(c)


def seed_words(seed: int) -> tuple[int, int]:
    """The Philox key (lo, hi) of a 64-bit seed."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"dropout seed {seed} is not a 64-bit unsigned integer")
    return seed & _MASK32, seed >> 32


def dropout_bits(seed: int, B: int, H: int, Tq: int, Tk: int,
                 device: str | torch.device = "cpu") -> torch.Tensor:
    """[B, H, Tq, Tk] int64 bits in [0, 2^32) of element (b, h, row, col):
    word col % 4 of Philox4x32-10 at counter (col // 4, row, b*H + h, 0)
    under the seed's key. What the CUDA kernels draw in registers."""
    groups = (Tk + 3) // 4
    dev = torch.device(device)
    bh = torch.arange(B * H, dtype=torch.int64, device=dev).view(B, H, 1, 1)
    row = torch.arange(Tq, dtype=torch.int64, device=dev).view(1, 1, Tq, 1)
    col = torch.arange(groups, dtype=torch.int64, device=dev).view(1, 1, 1, groups)
    words = philox4x32_10((col, row, bh, 0), seed_words(seed))
    shape = (B, H, Tq, groups)
    bits = torch.stack([w.expand(shape) for w in words], dim=-1)
    return bits.reshape(B, H, Tq, 4 * groups)[..., :Tk]


def keep_threshold(dropout_rate: float) -> int:
    """uint32 threshold: keep = bits < threshold, P(keep) = 1 - rate."""
    return min(int(round((1.0 - dropout_rate) * 2.0**32)), 2**32 - 1)


def _check_rate(dropout_rate: float) -> float:
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate {rate} must be in [0, 1)")
    return rate


def _keep(bits: torch.Tensor, dropout_rate: float) -> torch.Tensor:
    return bits.to(torch.int64) < keep_threshold(dropout_rate)


def _plain_bits(q, k, dropout_rate, seed, debug_bits):
    """The bits a plain version drops with: debug_bits, else the seed's
    Philox bits; None without dropout."""
    if dropout_rate <= 0.0:
        return None
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    if debug_bits is not None:
        if tuple(debug_bits.shape) != (B, H, Tq, Tk):
            raise ValueError(f"debug_bits {tuple(debug_bits.shape)} must be [B, H, Tq, Tk] = "
                             f"{(B, H, Tq, Tk)}")
        return debug_bits
    if seed is None:
        raise ValueError("flash attention: dropout needs a seed (or debug_bits)")
    return dropout_bits(seed, B, H, Tq, Tk, q.device)


# ---------------------------------------------------------------------------
# plain versions

def _masked_scores(q, k, kv_mask, scale: float, bias, causal: bool = False):
    """(live mask [B, 1, 1 or Tq, Tk], fp32 scores q k^T * scale + bias
    with dead pairs at NEG_BIG): the reference's `_scores` over
    `_block_ok`'s mask (a real key, and with causal col <= row)."""
    ok = kv_mask.to(torch.bool)[:, None, None, :]
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        rows = torch.arange(Tq, device=q.device)[:, None]
        ok = ok & (torch.arange(Tk, device=q.device)[None, :] <= rows)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    return ok, torch.where(ok, s, NEG_BIG)


def attention_plain(q, k, v, kv_mask, scale: float | None = None,
                    dropout_rate: float = 0.0, bits: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, causal: bool = False):
    """Kernel 5's function in plain PyTorch: (o, lse).

    The reference's one-block form (`block_k = Tk`): scores and sums in
    fp32, the bias [H, Tq, Tk] added unscaled before the mask, p
    (dropped and scaled by 1/keep_prob where `bits` say so, the
    denominator undropped) cast to v's dtype before p.v with an fp32
    sum, o cast back to q's dtype. `causal` ANDs col <= row into the key
    mask."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    ok, s = _masked_scores(q, k, kv_mask, scale, bias, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(TINY)
    pv = p
    if _check_rate(dropout_rate) > 0.0:
        if bits is None:
            raise ValueError("attention_plain: dropout needs its bits")
        pv = torch.where(_keep(bits, dropout_rate), p * (1.0 / (1.0 - dropout_rate)), 0.0)
    acc = torch.matmul(pv.to(v.dtype).float(), v.float())
    return (acc / l_safe).to(q.dtype), m + torch.log(l_safe)


def attention_bwd_plain(q, k, v, kv_mask, o, lse, do, scale: float | None = None,
                        dropout_rate: float = 0.0, bits: torch.Tensor | None = None,
                        bias: torch.Tensor | None = None, causal: bool = False):
    """Kernels 6, 7 and 8 in plain PyTorch: (dq, dk, dv) in q's dtype and
    dbias [H, Tq, Tk] in fp32 (None without a bias).

    The math of the reference's `_dq_kernel`, `_dkv_kernel` and
    `_dbias_kernel` with its rounding points: p = exp(s - lse) masked
    first; dp = do v^T, dropped and scaled like p; ds = p (dp - delta)
    with delta = rowsum(do o) in fp32; ds cast to k's (q's) dtype before
    ds.k (ds^T.q), the dropped p cast to do's dtype before p^T.do; dq and
    dk scaled at the end; dbias the batch sum of ds, unscaled (0 above
    the diagonal with `causal`)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    ok, s = _masked_scores(q, k, kv_mask, scale, bias, causal)
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    pv = p
    if _check_rate(dropout_rate) > 0.0:
        if bits is None:
            raise ValueError("attention_bwd_plain: dropout needs its bits")
        keep = _keep(bits, dropout_rate)
        inv = 1.0 / (1.0 - dropout_rate)
        pv = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = p * (dp - delta)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(pv.to(do.dtype).float().transpose(-1, -2), do.float())
    dbias = None if bias is None else ds.sum(dim=0)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias


# ---------------------------------------------------------------------------
# the CUDA library

_lib_lock = threading.Lock()
_libs: dict[bool, ctypes.CDLL] = {}


# ---------------------------------------------------------------------------
# work formulas: (operations, bytes) of each kernel's call, for the card's
# bounds and the counted cost (obs/cost.py)


def flash_work(B: int, H: int, Tq: int, Tk_live: list, D: int, itemsize: int,
               extra_bytes: int = 0, pairs: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one kernel 5 call: 4*H*D operations per
    live (query, key) pair (q.k and p.v; a padded key, or with causal a
    key after its query, needs none); `pairs` counts them over the batch
    (default Tq * sum(Tk_live)); bytes: q, k, v read and o written once,
    the mask and lse, and `extra_bytes` (a bias read once)."""
    flops = 4 * H * D * (Tq * sum(Tk_live) if pairs is None else pairs)
    Tk = max(list(Tk_live) + [1])
    nbytes = (itemsize * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * Tk + 4 * B * H * Tq
              + extra_bytes)
    return flops, nbytes


def flash_bwd_work(B: int, H: int, Tq: int, Tk_live: list, D: int, itemsize: int,
                   products: int, out_tokens: int, extra_bytes: int = 0,
                   pairs: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one backward kernel: `products` matrix
    products of 2*H*Tq*D operations per live key of each row (dq: s, dp,
    ds.k = 3; dk/dv: s, dp, p.do, ds.q = 4; dbias: s, dp = 2); bytes: q,
    k, v, do read and the gradients' `out_tokens` rows of [B, H, ., D]
    written once (dq: Tq; dk, dv: 2 Tk; dbias: 0), lse, delta and the
    mask, and `extra_bytes` (a bias read once, dbias written once);
    `pairs` as for `flash_work`."""
    flops = 2 * products * H * D * (Tq * sum(Tk_live) if pairs is None else pairs)
    Tk = max(list(Tk_live) + [1])
    nbytes = (itemsize * B * H * D * (2 * Tq + 2 * Tk + out_tokens) + 8 * B * H * Tq
              + 4 * B * Tk + extra_bytes)
    return flops, nbytes


def live_pairs(kv_mask: torch.Tensor, Tq: int, causal: bool) -> int:
    """(query, key) pairs that a call computes, over the batch: each real
    key j of a row pairs with every query, or with causal with queries
    j .. Tq-1."""
    m = kv_mask.cpu().to(torch.int64)
    if not causal:
        return int(m.sum()) * Tq
    return int((m * torch.arange(m.shape[1], 0, -1)).sum())


#: (products, output rows) of each backward kernel, Tq and Tk given
_BWD_SHAPE = {"flash_dq": lambda Tq, Tk: (3, Tq), "flash_dkv": lambda Tq, Tk: (4, 2 * Tk),
              "flash_dbias": lambda Tq, Tk: (2, 0)}


def _report(kernels, q, k, kv_mask, bias, causal: bool) -> None:
    """Report one call of each of `kernels` (flash_fwd or the backward
    kernels) to the open counts; reads the live keys from the device."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    lens = kv_mask.sum(-1).cpu().tolist()
    pairs = live_pairs(kv_mask, Tq, causal)
    itemsize = q.element_size()
    bias_bytes = 0 if bias is None else bias.element_size() * H * Tq * Tk
    precision = "bf16" if itemsize == 2 else "fp32"
    for kernel in kernels:
        if kernel == "flash_fwd":
            flops, nbytes = flash_work(B, H, Tq, lens, D, itemsize, bias_bytes, pairs)
        else:
            products, out_tokens = _BWD_SHAPE[kernel](Tq, Tk)
            extra = bias_bytes + (4 * H * Tq * Tk if kernel == "flash_dbias" else 0)
            flops, nbytes = flash_bwd_work(B, H, Tq, lens, D, itemsize, products, out_tokens,
                                           extra, pairs)
        cost.report(kernel, flops, nbytes, precision)


def _library(causal: bool = False) -> ctypes.CDLL:
    """The loaded, typed library of csrc/flash_attention.cu (built at
    first use): its non-causal instances, or with `causal` the causal
    build (`flash_attention_causal`)."""
    with _lib_lock:
        lib = _libs.get(causal)
        if lib is None:
            lib = cuda_build.load("flash_attention_causal" if causal else "flash_attention")
            p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
            drop = [i, u, f, ctypes.c_ulonglong]  # on, threshold, 1/keep_prob, seed
            bias = [p, i]  # the bias (or NULL) and whether it is bf16
            lib.flash_fwd.argtypes = [p] * 6 + bias + [i] * 5 + [f, i, i] + drop + [p, p]
            lib.flash_dq.argtypes = [p] * 8 + bias + [i] * 5 + [f, i, i] + drop + [p, p]
            lib.flash_dkv.argtypes = [p] * 9 + bias + [i] * 5 + [f, i, i] + drop + [p, p]
            lib.flash_dbias.argtypes = ([p] * 7 + bias + [p, p] + [i] * 5 + [f, i, i] + drop
                                        + [p, p])
            for fn in (lib.flash_fwd, lib.flash_dq, lib.flash_dkv, lib.flash_dbias):
                fn.restype = i
            lib.flash_fwd_error_string.argtypes = [i]
            lib.flash_fwd_error_string.restype = ctypes.c_char_p
            lib.flash_fwd_max_head_dim.argtypes = []
            lib.flash_fwd_max_head_dim.restype = i
            lib.flash_fwd_tile_rows.argtypes = [i]
            lib.flash_fwd_tile_rows.restype = i
            lib.flash_causal.argtypes = []
            lib.flash_causal.restype = i
            lib.flash_dbias_workspace_floats.argtypes = [i] * 6
            lib.flash_dbias_workspace_floats.restype = ctypes.c_longlong
            if lib.flash_fwd_max_head_dim() != MAX_HEAD_DIM:
                raise RuntimeError(
                    f"csrc/flash_attention.cu takes heads up to "
                    f"{lib.flash_fwd_max_head_dim()}; MAX_HEAD_DIM says {MAX_HEAD_DIM}"
                )
            if lib.flash_causal() != int(causal):
                raise RuntimeError(f"the flash library loaded for causal={causal} holds "
                                   f"causal={bool(lib.flash_causal())} instances")
            _libs[causal] = lib
        return lib


def _check_shapes(q, k, v, kv_mask, what: str = "flash_fwd", bias=None, causal: bool = False
                  ) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k and v must be [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if tuple(k.shape) != (B, H, Tk, D) or tuple(v.shape) != (B, H, Tk, D):
        raise ValueError(
            f"{what}: k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"[B={B}, H={H}, Tk, D={D}]"
        )
    if tuple(kv_mask.shape) != (B, Tk):
        raise ValueError(f"{what}: kv_mask {tuple(kv_mask.shape)} must be [B={B}, Tk={Tk}]")
    if min(B, H, Tq, Tk, D) <= 0:
        raise ValueError(f"{what}: empty problem {tuple(q.shape)} x Tk={Tk}")
    if bias is not None and tuple(bias.shape) != (H, Tq, Tk):
        raise ValueError(f"{what}: bias {tuple(bias.shape)} must be [H={H}, Tq={Tq}, Tk={Tk}] "
                         "(broadcast over the batch)")
    if causal and Tq != Tk:
        raise ValueError(f"{what}: causal needs Tq == Tk (got {Tq} vs {Tk})")
    return B, H, Tq, Tk, D


def _tensor_core(x) -> bool:
    """The tensor-core instance takes this problem: bf16, D % 16 == 0."""
    return x.dtype == torch.bfloat16 and x.shape[-1] % 16 == 0


def _aligned(x) -> bool:
    return x.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in x.stride()[:3])


def _check_card(what: str, q, k, v, kv_mask, extra=()) -> None:
    """What every kernel of the module takes on the card, or raise (with
    `enable_checks`, also the key mask's shape against k's)."""
    if sanitize.checks_on() and tuple(kv_mask.shape) != (k.shape[0], k.shape[2]):
        raise ValueError(f"enable_checks: {what}: kv_mask {tuple(kv_mask.shape)} does not "
                         f"cover k's {(k.shape[0], k.shape[2])} keys")
    for name, x in (("k", k), ("v", v), ("kv_mask", kv_mask), *extra):
        if x.device != q.device:
            raise ValueError(f"{what}: {name} is on {x.device}, not {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: q is {q.dtype}; the kernel takes float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share a dtype ({q.dtype}, {k.dtype}, {v.dtype})")
    if kv_mask.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"{what}: kv_mask is {kv_mask.dtype}; needs bool or int32")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or min(x.stride()) < 0:
            raise ValueError(f"{what}: {name}'s last dimension must be contiguous")
    D = q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} > {MAX_HEAD_DIM}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{what}: B*H = {q.shape[0] * q.shape[1]} > 65535 (the grid's y extent)")
    if _tensor_core(q):
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not _aligned(x):
                raise ValueError(
                    f"{what}: bf16 {name} (D={D}) must be 16-byte aligned with "
                    f"strides that are multiples of 8 elements for the tensor-core "
                    f"kernel; it is at byte {x.data_ptr() % 16} mod 16 with strides "
                    f"{tuple(x.stride())} (pass a .contiguous() copy)"
                )


def _bias_args(what: str, q, bias) -> tuple[list, list]:
    """The kernels' bias arguments: ([pointer or None, is_bf16], [head
    stride, row stride]). The bias is [H, Tq, Tk] in q's dtype or fp32,
    on q's device, any non-negative strides with the last one 1."""
    if bias is None:
        return [None, 0], [0, 0]
    if bias.device != q.device:
        raise ValueError(f"{what}: bias is on {bias.device}, not {q.device}")
    if bias.dtype not in (q.dtype, torch.float32):
        raise TypeError(f"{what}: bias is {bias.dtype}; the kernel takes q's dtype "
                        f"({q.dtype}) or float32")
    if bias.stride(-1) != 1 or min(bias.stride()) < 0:
        raise ValueError(f"{what}: the bias's last dimension must be contiguous")
    return [bias.data_ptr(), int(bias.dtype == torch.bfloat16)], list(bias.stride()[:2])


def _refuse_debug_bits(debug_bits, what: str) -> None:
    if debug_bits is not None:
        raise ValueError(f"{what}: debug_bits is a CPU testing hook; the kernel draws its "
                         "own Philox bits from the seed")


def _drop_args(dropout_rate: float, seed, what: str) -> list:
    """The kernels' dropout arguments (on, threshold, 1/keep_prob, seed)."""
    if dropout_rate <= 0.0:
        return [0, 0, 1.0, 0]
    if seed is None:
        raise ValueError(f"{what}: dropout needs a seed")
    return [1, keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate), int(seed)]


def _bthd(B, T, H, D, like) -> torch.Tensor:
    """A [B, H, T, D] view of a new [B, T, H, D] buffer."""
    return torch.empty((B, T, H, D), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {lib.flash_fwd_error_string(rc).decode()} "
            f"(cudaError {rc})"
        )


def _scale(scale, D) -> float:
    return float(D) ** -0.5 if scale is None else float(scale)


def _strides(*xs) -> list:
    return [s for x in xs for s in x.stride()[:3]]


def flash_fwd(q, k, v, kv_mask, *, scale: float | None = None, dropout_rate: float = 0.0,
              seed: int | None = None, debug_bits: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, causal: bool = False):
    """Kernel 5: (o [B, H, Tq, D], lse [B, H, Tq, 1] fp32).

    CPU tensors run `attention_plain` (with `debug_bits` if given, else
    the seed's Philox bits); CUDA tensors launch the kernel on the
    current stream or raise. q, k and v may be strided views (any batch,
    head and token strides) whose last dimension is contiguous; o is a
    [B, H, Tq, D] view of a [B, Tq, H, D] buffer. `bias` [H, Tq, Tk] (q's
    dtype or fp32, last dimension contiguous) is added to the scaled
    scores; `causal` (Tq == Tk) launches the causal instance.

    The kernel instance follows from dtype and head width alone: bf16
    with D a multiple of 16 takes the tensor-core (mma.sync) instance,
    which needs 16-byte aligned q, k, v and strides that are multiples
    of 8 elements (anything else raises); fp32, and bf16 at other head
    widths, take the FMA instance."""
    global LAUNCHES
    B, H, Tq, Tk, D = _check_shapes(q, k, v, kv_mask, bias=bias, causal=causal)
    rate = _check_rate(dropout_rate)
    if not _on_cuda("flash_fwd", q.device):
        with cost.plain():
            out = attention_plain(q, k, v, kv_mask, scale, rate,
                                  _plain_bits(q, k, rate, seed, debug_bits), bias, causal)
        if cost.counting():
            _report(("flash_fwd",), q, k, kv_mask, bias, causal)
        return out
    _check_card("flash_fwd", q, k, v, kv_mask)
    _refuse_debug_bits(debug_bits, "flash_fwd")
    bias_args, bias_strides = _bias_args("flash_fwd", q, bias)
    drop = _drop_args(rate, seed, "flash_fwd")
    lib = _library(causal)
    mask = kv_mask.to(torch.int32).contiguous()
    o = _bthd(B, Tq, H, D, q)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, o) + bias_strides
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *bias_args, B, H, Tq, Tk, D, _scale(scale, D),
            int(q.dtype == torch.bfloat16), int(_tensor_core(q)), *drop,
            (ctypes.c_longlong * 14)(*strides), _stream(q.device),
        )
    _raise_on(lib, rc, "flash_fwd")
    sanitize.after_launch("flash_fwd", q.device)
    with _launch_lock:
        LAUNCHES += 1
    if cost.counting():
        _report(("flash_fwd",), q, k, kv_mask, bias, causal)
    return o, lse


def _bwd_operands(what, q, k, v, kv_mask, lse, delta, do, bias, causal):
    """The backward kernels' common checks; (mask int32, lse, delta and do
    as the kernels take them, the bias arguments). do is copied once
    where it is not row-contiguous, or (tensor-core instance) off the
    16-byte grid."""
    B, H, Tq, Tk, D = _check_shapes(q, k, v, kv_mask, what, bias, causal)
    _check_card(what, q, k, v, kv_mask, (("lse", lse), ("delta", delta), ("do", do)))
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.numel() != B * H * Tq:
            raise ValueError(f"{what}: {name} must be fp32 [B, H, Tq, 1]")
    if tuple(do.shape) != (B, H, Tq, D) or do.dtype != q.dtype:
        raise ValueError(f"{what}: do {tuple(do.shape)} {do.dtype} must be q's shape and dtype")
    if do.stride(-1) != 1 or min(do.stride()) < 0 or (_tensor_core(q) and not _aligned(do)):
        do = do.contiguous()
    return (kv_mask.to(torch.int32).contiguous(), lse.contiguous(), delta.contiguous(), do,
            *_bias_args(what, q, bias))


def _refuse_cpu(what: str, device) -> None:
    if not _on_cuda(what, device):
        raise ValueError(f"{what} launches the CUDA kernel; on the CPU use attention_bwd_plain")


def flash_dq(q, k, v, kv_mask, lse, delta, do, *, scale: float | None = None,
             dropout_rate: float = 0.0, seed: int | None = None,
             bias: torch.Tensor | None = None, causal: bool = False):
    """Kernel 6 on CUDA tensors: dq [B, H, Tq, D] in q's dtype (a view of
    a [B, Tq, H, D] buffer), from the forward's lse and delta =
    rowsum(do * o) (fp32, [B, H, Tq, 1]) and the forward's bias. Raises
    on CPU tensors: the plain version of the whole backward is
    `attention_bwd_plain`."""
    global DQ_LAUNCHES
    _refuse_cpu("flash_dq", q.device)
    rate = _check_rate(dropout_rate)
    mask, lse, delta, do, bias_args, bias_strides = _bwd_operands(
        "flash_dq", q, k, v, kv_mask, lse, delta, do, bias, causal)
    drop = _drop_args(rate, seed, "flash_dq")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    lib = _library(causal)
    dq = _bthd(B, Tq, H, D, q)
    strides = _strides(q, k, v, do, dq) + bias_strides
    with torch.cuda.device(q.device):
        rc = lib.flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), do.data_ptr(), dq.data_ptr(), *bias_args, B, H, Tq, Tk, D,
            _scale(scale, D), int(q.dtype == torch.bfloat16), int(_tensor_core(q)), *drop,
            (ctypes.c_longlong * 17)(*strides), _stream(q.device),
        )
    _raise_on(lib, rc, "flash_dq")
    sanitize.after_launch("flash_dq", q.device)
    with _launch_lock:
        DQ_LAUNCHES += 1
    if cost.counting():
        _report(("flash_dq",), q, k, kv_mask, bias, causal)
    return dq


def flash_dkv(q, k, v, kv_mask, lse, delta, do, *, scale: float | None = None,
              dropout_rate: float = 0.0, seed: int | None = None,
              bias: torch.Tensor | None = None, causal: bool = False):
    """Kernel 7 on CUDA tensors: (dk, dv) [B, H, Tk, D] in q's dtype
    (views of [B, Tk, H, D] buffers). Arguments as for `flash_dq`."""
    global DKV_LAUNCHES
    _refuse_cpu("flash_dkv", q.device)
    rate = _check_rate(dropout_rate)
    mask, lse, delta, do, bias_args, bias_strides = _bwd_operands(
        "flash_dkv", q, k, v, kv_mask, lse, delta, do, bias, causal)
    drop = _drop_args(rate, seed, "flash_dkv")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    lib = _library(causal)
    dk, dv = _bthd(B, Tk, H, D, q), _bthd(B, Tk, H, D, q)
    strides = _strides(q, k, v, do, dk, dv) + bias_strides
    with torch.cuda.device(q.device):
        rc = lib.flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), do.data_ptr(), dk.data_ptr(), dv.data_ptr(), *bias_args,
            B, H, Tq, Tk, D, _scale(scale, D), int(q.dtype == torch.bfloat16),
            int(_tensor_core(q)), *drop, (ctypes.c_longlong * 20)(*strides), _stream(q.device),
        )
    _raise_on(lib, rc, "flash_dkv")
    sanitize.after_launch("flash_dkv", q.device)
    with _launch_lock:
        DKV_LAUNCHES += 1
    if cost.counting():
        _report(("flash_dkv",), q, k, kv_mask, bias, causal)
    return dk, dv


def flash_dbias(q, k, v, kv_mask, lse, delta, do, bias, *, scale: float | None = None,
                dropout_rate: float = 0.0, seed: int | None = None, causal: bool = False):
    """Kernel 8 on CUDA tensors: dbias [H, Tq, Tk] fp32, the batch sum of
    ds = p (dp - delta) (contiguous). A block owns a (head, q tile, key
    tile) and a run of the batch's rows; where a head has few tiles, both
    instances cut the batch into runs (the library picks the cut and says
    how much workspace its [slices, H, Tq, Tk] partials take), and a
    second launch sums the partials in slice order. Each block loops over
    its rows of the batch in order, so the sum takes the same bits on every
    run, with no atomics. Arguments as for `flash_dq`; the
    bias is required (the scores are recomputed with it). With `causal`,
    the tiles wholly above the diagonal are written as zeros."""
    global DBIAS_LAUNCHES
    _refuse_cpu("flash_dbias", q.device)
    if bias is None:
        raise ValueError("flash_dbias: needs the forward's bias")
    rate = _check_rate(dropout_rate)
    mask, lse, delta, do, bias_args, bias_strides = _bwd_operands(
        "flash_dbias", q, k, v, kv_mask, lse, delta, do, bias, causal)
    drop = _drop_args(rate, seed, "flash_dbias")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    lib = _library(causal)
    dbias = torch.empty((H, Tq, Tk), dtype=torch.float32, device=q.device)
    mma = _tensor_core(q)
    floats = lib.flash_dbias_workspace_floats(B, H, Tq, Tk, D, int(mma))
    work = torch.empty(floats, dtype=torch.float32, device=q.device) if floats else None
    strides = _strides(q, k, v, do) + bias_strides
    with torch.cuda.device(q.device):
        rc = lib.flash_dbias(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), do.data_ptr(), *bias_args, dbias.data_ptr(),
            None if work is None else work.data_ptr(), B, H, Tq, Tk, D,
            _scale(scale, D), int(q.dtype == torch.bfloat16), int(mma), *drop,
            (ctypes.c_longlong * 14)(*strides), _stream(q.device),
        )
    _raise_on(lib, rc, "flash_dbias")
    sanitize.after_launch("flash_dbias", q.device)
    with _launch_lock:
        DBIAS_LAUNCHES += 1
    if cost.counting():
        _report(("flash_dbias",), q, k, kv_mask, bias, causal)
    return dbias


def flash_bwd(q, k, v, kv_mask, o, lse, do, *, scale: float | None = None,
              dropout_rate: float = 0.0, seed: int | None = None,
              debug_bits: torch.Tensor | None = None, bias: torch.Tensor | None = None,
              with_dbias: bool = True, causal: bool = False):
    """The backward of `flash_fwd`: (dq, dk, dv) in q's dtype and dbias
    [H, Tq, Tk] fp32 (None without a bias, or with `with_dbias` off).

    CPU tensors run `attention_bwd_plain`. On CUDA tensors delta =
    rowsum(do * o) is a plain fp32 reduction (the reference computes it
    outside any kernel too, `_flash_bwd`), then kernel 6 (dq), kernel 7
    (dk, dv) and, with a bias, kernel 8 (dbias) launch on the current
    stream."""
    rate = _check_rate(dropout_rate)
    if not _on_cuda("flash_bwd", q.device):
        _check_shapes(q, k, v, kv_mask, "flash_bwd", bias, causal)
        with cost.plain():
            dq, dk, dv, dbias = attention_bwd_plain(q, k, v, kv_mask, o, lse, do, scale, rate,
                                                    _plain_bits(q, k, rate, seed, debug_bits),
                                                    bias, causal)
        if cost.counting():
            _report(("flash_dq", "flash_dkv")
                    + (("flash_dbias",) if bias is not None and with_dbias else ()),
                    q, k, kv_mask, bias, causal)
        return dq, dk, dv, dbias if with_dbias else None
    _refuse_debug_bits(debug_bits, "flash_bwd")
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    kw = {"scale": scale, "dropout_rate": rate, "seed": seed, "causal": causal}
    dq = flash_dq(q, k, v, kv_mask, lse, delta, do, bias=bias, **kw)
    dk, dv = flash_dkv(q, k, v, kv_mask, lse, delta, do, bias=bias, **kw)
    dbias = None
    if bias is not None and with_dbias:
        dbias = flash_dbias(q, k, v, kv_mask, lse, delta, do, bias, **kw)
    return dq, dk, dv, dbias


class FlashAttention(torch.autograd.Function):
    """o = flash attention of (q, k, v) with the kernels' backward.

    Saves q, k, v, the mask, the bias, o and lse (and the seed, an int,
    and the causal flag):
    the backward recomputes p from lse and redraws the dropout mask from
    the seed, as the reference's custom VJP does (`_flash_fwd`,
    `_flash_bwd`). The bias's cotangent is computed only when the bias
    needs a gradient, and is cast to its dtype."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, bias, scale, dropout_rate, seed, debug_bits,
                causal=False):
        stash = getattr(_stash_state, "stash", None)
        if stash is not None and stash.replay:
            o, lse = stash.take()  # an attn_saved replay: no launch
        else:
            o, lse = flash_fwd(q, k, v, kv_mask, scale=scale, dropout_rate=dropout_rate,
                               seed=seed, debug_bits=debug_bits, bias=bias, causal=causal)
            if stash is not None:
                stash.keep(o, lse)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse, bias, debug_bits)
        ctx.scale, ctx.dropout_rate, ctx.seed, ctx.causal = scale, dropout_rate, seed, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse, bias, bits = ctx.saved_tensors
        dq, dk, dv, dbias = flash_bwd(q, k, v, kv_mask, o, lse, do, scale=ctx.scale,
                                      dropout_rate=ctx.dropout_rate, seed=ctx.seed,
                                      debug_bits=bits, bias=bias,
                                      with_dbias=ctx.needs_input_grad[4], causal=ctx.causal)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, None, dbias, None, None, None, None, None


_stash_state = threading.local()


class _AttnStash:
    """The (o, lse) of each FlashAttention forward of one checkpointed
    layer, in call order. `keep` records them in the layer's forward,
    `take` hands them back in its replay (each replay starts from the
    first)."""

    def __init__(self):
        self.saved: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.replay = False
        self.cursor = 0

    def keep(self, o: torch.Tensor, lse: torch.Tensor) -> None:
        self.saved.append((o.detach(), lse.detach()))

    def take(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.cursor >= len(self.saved):
            raise RuntimeError("attn_saved replay: the layer's replay made more flash "
                               f"calls than its forward ({len(self.saved)})")
        o, lse = self.saved[self.cursor]
        self.cursor += 1
        return o.detach(), lse.detach()


class _StashMode:
    """Context manager: FlashAttention calls in this thread record into
    (or, with `replay`, take from) `stash`."""

    def __init__(self, stash: _AttnStash, replay: bool):
        self.stash, self.replay = stash, replay

    def __enter__(self):
        self._outer = getattr(_stash_state, "stash", None)
        self.stash.replay = self.replay
        self.stash.cursor = 0
        _stash_state.stash = self.stash
        return self.stash

    def __exit__(self, *exc):
        _stash_state.stash = self._outer
        return False


def _attn_saved_contexts():
    stash = _AttnStash()
    return _StashMode(stash, replay=False), _StashMode(stash, replay=True)


REMAT_POLICIES = ("full", "attn_saved")


def remat_layer(layer, *args, policy: str = "full"):
    """`layer(*args)` under a non-reentrant `torch.utils.checkpoint`
    without RNG state (every dropout mask is a function of its seed, so
    the replay draws it again). "full" replays the whole layer in the
    backward; "attn_saved" keeps each flash call's (o, lse) and the
    replay takes them instead of launching kernel 5 (the plain route,
    `attn_impl="xla"`, has no kernel to skip and replays as "full")."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} (one of {REMAT_POLICIES})")
    kw = {"context_fn": _attn_saved_contexts} if policy == "attn_saved" else {}
    return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def flash_attention(
    q,
    k,
    v,
    kv_mask,
    *,
    scale: float | None = None,
    dropout_rate: float = 0.0,
    seed: int | None = None,
    bias=None,
    causal: bool = False,
    debug_bits: torch.Tensor | None = None,
):
    """The reference's `flash_attention`: o [B, H, Tq, D], differentiable
    in q, k, v and the bias through `FlashAttention` (kernels 5-8 on the
    card).

    `seed` (a 64-bit int) seeds the in-kernel dropout; `debug_bits`
    (CPU only) replaces its bits, as the reference's testing hook does.
    `bias` [H, Tq, Tk] is an additive score bias broadcast over the batch
    (T5's relative positions), added unscaled. `causal` masks keys after
    each query (Tq == Tk, else ValueError, as the reference raises)."""
    rate = _check_rate(dropout_rate)
    if rate > 0.0 and seed is None and debug_bits is None:
        raise ValueError("flash_attention: dropout needs a seed")
    return FlashAttention.apply(q, k, v, kv_mask, bias, scale, rate, seed, debug_bits, causal)


def flash_shape_ok(Tq: int, head_dim: int, Tk: int | None = None) -> bool:
    """Can the CUDA kernels take this problem? They tile queries and keys
    in 64-row blocks (16 and 32 in the FMA instances) and mask the ragged
    tail themselves, so any Tq, Tk >= 1 qualify; the head must be
    1..MAX_HEAD_DIM wide. A biased call has the same rule: the kernels
    stage the bias a 64-row or 64-key tile at a time, or read a lane's
    elements from device memory (through the L2, where the [H, Tq, Tk]
    bias stays across the batch), so no sequence cap follows from it.
    The reference caps biased calls at T = 4096 because its kernels hold
    a [block_q, T] bias strip in the TPU's VMEM; the port's limit is the
    device memory the caller's bias (H * Tq * Tk elements) and dbias (as
    many fp32) take."""
    Tk = Tq if Tk is None else Tk
    return min(Tq, Tk) >= 1 and 1 <= head_dim <= MAX_HEAD_DIM


def resolve_impl(attn_impl: str, Tq: int, head_dim: int, *, Tk: int | None = None,
                 cuda: bool = True) -> str:
    """"auto" / "xla" / "flash" -> "flash" or "xla". "xla" is
    `attention_plain`, asked for by name. "flash" on a shape the kernel
    cannot tile raises, as in the reference. "auto" is "flash" for
    tensors on a CUDA device (`cuda`), raising where the kernel cannot
    take the shape: on the card attention launches the kernel or raises,
    never the plain version unasked. For CPU tensors "auto" takes the
    reference's rule (plain where the kernel cannot tile); both routes
    run the plain versions there."""
    if attn_impl == "xla":
        return "xla"
    if attn_impl not in ("auto", "flash"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if flash_shape_ok(Tq, head_dim, Tk):
        return "flash"
    if attn_impl == "auto" and not cuda:
        return "xla"
    raise ValueError(
        f"attn_impl={attn_impl!r} cannot tile Tq={Tq}, Tk={Tk or Tq}, "
        f"head_dim={head_dim} on the card (the CUDA kernel "
        f"takes heads up to {MAX_HEAD_DIM} wide); ask for attn_impl='xla' to run "
        f"the plain version"
    )
