"""Flash attention on Hopper, forward: the wrapper of
`csrc/flash_attention.cu`, its plain PyTorch version, and the dispatch
helpers of the reference's `deepdfa_tpu/nn/flash_attention.py`.

Kernel 5 of the port replaces the TPU kernel `_fwd_kernel` (launched by
`_fwd_call`). For q [B, H, Tq, D] and k, v [B, H, Tk, D] in fp32 or bf16
and a kv mask [B, Tk] (False = padding) it returns

    o   [B, H, Tq, D] in q's dtype: softmax(q k^T * scale) v over the
        real keys, with p cast to v's dtype before the p.v product;
    lse [B, H, Tq, 1] fp32: the log-sum-exp of the masked scores.

Scores of padded keys are -1e30 and their probabilities 0; the softmax
sum is floored at FLT_MIN, so a query whose keys are all padding (the
filler rows of a partly full batch) gets o = 0 and a finite lse.

`flash_fwd` launches the CUDA kernel for tensors on a CUDA device and
runs `attention_plain` for tensors on the CPU; there is no other route
and no fallback from one to the other. `LAUNCHES` counts kernel
launches. Dropout, an additive bias and the causal mask (the reference's
training and T5 options) are not ported: `flash_attention` raises
`NotImplementedError` for them.

Bound on the card. At the flagship call (B 16, H 12, T 512, D 64, bf16)
the kernel moves q, k, v and o once, ~50 MB (0.015 ms at 3.35 TB/s),
for 12.9 GFLOP (0.013 ms at 989 TFLOP/s): bytes bind. The kernel
streams k/v through shared memory in 64-key tiles with the online
softmax, so the T x T scores never reach device memory; the source's
header has the rest of the design.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deepdfa_tpu_torch.nn import cuda_build
from deepdfa_tpu_torch.nn.ggnn_kernel import _on_cuda, _stream

#: kernel launches since the process started (or since a caller reset
#: them), counted where the kernel is launched and nowhere else
LAUNCHES = 0
_launch_lock = threading.Lock()

#: the reference's additive mask value and softmax-sum floor
NEG_BIG = -1e30
TINY = torch.finfo(torch.float32).tiny
#: widest head the kernel takes (csrc/flash_attention.cu: kMaxD)
MAX_HEAD_DIM = 128


def attention_plain(q, k, v, kv_mask, scale: float | None = None):
    """The kernel's function in plain PyTorch: (o, lse).

    The reference's one-block form (`block_k = Tk`): scores and sums in
    fp32, p cast to v's dtype before p.v with an fp32 sum, o cast back
    to q's dtype."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else float(scale)
    ok = kv_mask.to(torch.bool)[:, None, None, :]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(ok, s, NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(TINY)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l_safe).to(q.dtype), m + torch.log(l_safe)


# ---------------------------------------------------------------------------
# the CUDA library

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The loaded, typed library of csrc/flash_attention.cu (built at
    first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load("flash_attention")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_fwd.argtypes = [p] * 6 + [i] * 5 + [ctypes.c_float, i, i, p, p]
            lib.flash_fwd.restype = i
            lib.flash_fwd_error_string.argtypes = [i]
            lib.flash_fwd_error_string.restype = ctypes.c_char_p
            lib.flash_fwd_max_head_dim.argtypes = []
            lib.flash_fwd_max_head_dim.restype = i
            if lib.flash_fwd_max_head_dim() != MAX_HEAD_DIM:
                raise RuntimeError(
                    f"csrc/flash_attention.cu takes heads up to "
                    f"{lib.flash_fwd_max_head_dim()}; MAX_HEAD_DIM says {MAX_HEAD_DIM}"
                )
            _lib = lib
        return _lib


def _check_shapes(q, k, v, kv_mask) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd: q, k and v must be [B, H, T, D]")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if tuple(k.shape) != (B, H, Tk, D) or tuple(v.shape) != (B, H, Tk, D):
        raise ValueError(
            f"flash_fwd: k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"[B={B}, H={H}, Tk, D={D}]"
        )
    if tuple(kv_mask.shape) != (B, Tk):
        raise ValueError(f"flash_fwd: kv_mask {tuple(kv_mask.shape)} must be [B={B}, Tk={Tk}]")
    if min(B, H, Tq, Tk, D) <= 0:
        raise ValueError(f"flash_fwd: empty problem {tuple(q.shape)} x Tk={Tk}")
    return B, H, Tq, Tk, D


def flash_fwd(q, k, v, kv_mask, *, scale: float | None = None):
    """Kernel 5: (o [B, H, Tq, D], lse [B, H, Tq, 1] fp32).

    CPU tensors run `attention_plain`; CUDA tensors launch the kernel on
    the current stream or raise. q, k and v may be strided views (any
    batch, head and token strides) whose last dimension is contiguous;
    o is a [B, H, Tq, D] view of a [B, Tq, H, D] buffer.

    The kernel instance follows from dtype and head width alone: bf16
    with D a multiple of 16 takes the tensor-core (mma.sync) instance,
    which needs 16-byte aligned q, k, v and strides that are multiples
    of 8 elements (anything else raises); fp32, and bf16 at other head
    widths, take the FMA instance."""
    global LAUNCHES
    B, H, Tq, Tk, D = _check_shapes(q, k, v, kv_mask)
    if not _on_cuda("flash_fwd", q.device):
        return attention_plain(q, k, v, kv_mask, scale)
    for name, x in (("k", k), ("v", v), ("kv_mask", kv_mask)):
        if x.device != q.device:
            raise ValueError(f"flash_fwd: {name} is on {x.device}, not {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_fwd: q is {q.dtype}; the kernel takes float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd: q, k, v must share a dtype ({q.dtype}, {k.dtype}, {v.dtype})")
    if kv_mask.dtype not in (torch.bool, torch.int32):
        raise TypeError(f"flash_fwd: kv_mask is {kv_mask.dtype}; needs bool or int32")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or min(x.stride()) < 0:
            raise ValueError(f"flash_fwd: {name}'s last dimension must be contiguous")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd: head dim {D} > {MAX_HEAD_DIM}")
    if B * H > 65535:
        raise ValueError(f"flash_fwd: B*H = {B * H} > 65535 (the grid's y extent)")
    lib = _library()
    mask = kv_mask.to(torch.int32).contiguous()
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device)
    strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
    use_mma = q.dtype == torch.bfloat16 and D % 16 == 0
    if use_mma:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
                raise ValueError(
                    f"flash_fwd: bf16 {name} (D={D}) must be 16-byte aligned with "
                    f"strides that are multiples of 8 elements for the tensor-core "
                    f"kernel; it is at byte {x.data_ptr() % 16} mod 16 with strides "
                    f"{tuple(x.stride())} (pass a .contiguous() copy)"
                )
    scale = float(D) ** -0.5 if scale is None else float(scale)
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, Tq, Tk, D, scale, int(q.dtype == torch.bfloat16),
            int(use_mma), (ctypes.c_longlong * 12)(*strides), _stream(q.device),
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: {lib.flash_fwd_error_string(rc).decode()} "
            f"(cudaError {rc})"
        )
    with _launch_lock:
        LAUNCHES += 1
    return o, lse


def flash_attention(
    q,
    k,
    v,
    kv_mask,
    *,
    scale: float | None = None,
    dropout_rate: float = 0.0,
    seed=None,
    bias=None,
    causal: bool = False,
):
    """The reference's `flash_attention` at inference: o [B, H, Tq, D].

    Dropout, an additive score bias and the causal mask raise
    `NotImplementedError`: their kernels come with the training and T5
    slices of the port."""
    if dropout_rate > 0.0 or seed is not None:
        raise NotImplementedError(
            "flash_attention dropout: the in-kernel (Philox) probs dropout comes "
            "with the combined-training slice of the port (ROADMAP queue B, kernel 5)"
        )
    if bias is not None:
        raise NotImplementedError(
            "flash_attention bias: the additive score bias (T5 relative "
            "positions) comes with the T5 slice of the port"
        )
    if causal:
        raise NotImplementedError(
            "flash_attention causal: the causal mask comes with the T5 slice of the port"
        )
    return flash_fwd(q, k, v, kv_mask, scale=scale)[0]


def flash_shape_ok(Tq: int, head_dim: int, Tk: int | None = None, biased: bool = False) -> bool:
    """Can the CUDA kernel take this problem? It tiles queries in 64-row
    blocks and keys in 64-key tiles and masks the ragged tail itself,
    so any Tq, Tk >= 1 qualify; the head must be 1..MAX_HEAD_DIM wide.
    A biased call is never tileable: the bias is not ported."""
    Tk = Tq if Tk is None else Tk
    return not biased and min(Tq, Tk) >= 1 and 1 <= head_dim <= MAX_HEAD_DIM


def resolve_impl(attn_impl: str, Tq: int, head_dim: int, *, Tk: int | None = None,
                 biased: bool = False, cuda: bool = True) -> str:
    """"auto" / "xla" / "flash" -> "flash" or "xla". "xla" is
    `attention_plain`, asked for by name. "flash" on a shape the kernel
    cannot tile raises, as in the reference. "auto" is "flash" for
    tensors on a CUDA device (`cuda`), raising where the kernel cannot
    take the shape: on the card attention launches the kernel or raises,
    never the plain version unasked. For CPU tensors "auto" takes the
    reference's rule (plain where the kernel cannot tile); both routes
    run `attention_plain` there."""
    if attn_impl == "xla":
        return "xla"
    if attn_impl not in ("auto", "flash"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    if flash_shape_ok(Tq, head_dim, Tk, biased):
        return "flash"
    if attn_impl == "auto" and not cuda:
        return "xla"
    raise ValueError(
        f"attn_impl={attn_impl!r} cannot tile Tq={Tq}, Tk={Tk or Tq}, "
        f"head_dim={head_dim}, biased={biased} on the card (the CUDA kernel "
        f"takes heads up to {MAX_HEAD_DIM} wide and no bias); ask for "
        f"attn_impl='xla' to run the plain version"
    )
