"""Differentiable set operations for bitvector dataflow propagation (the
port of the reference's `deepdfa_tpu/nn/setops.py`): unions of soft
bitvectors, where each node state is a (0..1)-valued membership vector
and message aggregation is set union rather than sum.

  simple_union(a, b) = a + b - a*b   (probabilistic OR)
  relu_union(a, b)   = 1 - relu(1 - (a + b))  (= min(a + b, 1))

`segment_union` folds the chosen union over each destination's incoming
messages: the simple union as one segment sum of log(clip(1 - x, 1e-30,
1)) (U_i x_i = 1 - prod_i (1 - x_i)), the relu union as a clipped
segment sum.

The segment sums run in one fixed order, so the card gives the same bits
on every run, forward and backward (an `index_add_`, and the backward of
an indexed gather, would sum with float atomics there). `gather_sum` is
that sum over a CSR layout (`csr_layout`): on a CUDA tensor it launches
`csrc/setops.cu` (counted in `LAUNCHES`), on a CPU tensor it runs
`gather_sum_plain`, the same additions in the same order. `GatherSum`
makes it differentiable with the transposed layout, which is the same
kernel over the other sort of the edges. `gather_sum_work` gives its
operations and bytes, which the wrapper reports to an open count
(obs/cost.py) at each call and the card's bound is computed from.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deepdfa_tpu_torch.core import sanitize
from deepdfa_tpu_torch.nn import cuda_build
from deepdfa_tpu_torch.obs import cost

#: gather_sum kernel launches since the process started (or a reset)
LAUNCHES = 0
_launch_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def launch_counts() -> dict[str, int]:
    return {"LAUNCHES": LAUNCHES}


def reset_launch_counts() -> None:
    global LAUNCHES
    with _launch_lock:
        LAUNCHES = 0


def simple_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b - a * b


def relu_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.relu(1.0 - (a + b))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip`: a maximum, then a minimum, whose gradients split in
    half at a tie, as JAX's do (torch.clamp passes the whole gradient
    at a bound)."""
    x = torch.maximum(x, x.new_tensor(lo))
    return torch.minimum(x, x.new_tensor(hi))


def log_keep(x: torch.Tensor) -> torch.Tensor:
    """log(clip(1 - x, 1e-30, 1)): the simple union's summand."""
    return torch.log(_clip(1.0 - x, 1e-30, 1.0))


def csr_layout(keys: torch.Tensor, valid: torch.Tensor, n: int,
               values: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx, ptr), int32 on the keys' device, with no host sync: the
    valid entries grouped by key in their original order (a stable sort
    keyed n where invalid), ptr [n + 1] each key's run; idx holds
    `values` (default: the entry's position) in that order."""
    key = torch.where(valid, keys.long(), torch.full_like(keys, n, dtype=torch.long))
    order = torch.argsort(key, stable=True)
    nodes = torch.arange(n + 1, device=keys.device, dtype=torch.long)
    ptr = torch.searchsorted(key[order], nodes, out_int32=True)
    idx = order if values is None else values.long()[order]
    return idx.to(torch.int32).contiguous(), ptr.contiguous()


def gather_sum_plain(y: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """out[v] = sum_{j in ptr[v]:ptr[v+1]} y[idx[j]], summed from 0 in j
    order: the kernel's additions, rank by rank over every run."""
    n = ptr.shape[0] - 1
    start = ptr[:-1].long()
    deg = ptr[1:].long() - start
    out = torch.zeros((n,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    for k in range(int(deg.max()) if n else 0):
        live = deg > k
        rows = y[idx.long()[torch.where(live, start + k, torch.zeros_like(start))]]
        out = out + torch.where(live[:, None], rows, torch.zeros_like(rows))
    return out


def gather_sum_work(n: int, e_live: int, b: int) -> tuple[int, int]:
    """(operations, bytes) of one fixed-order segment sum: e_live * b
    fp32 additions; y and the output [n, b] f32, idx [e_live] and ptr
    [n + 1] int32, each moved once."""
    return e_live * b, 4 * (2 * n * b + e_live + n + 1)


def _report(y: torch.Tensor, ptr: torch.Tensor) -> None:
    cost.report("gather_sum", *gather_sum_work(ptr.shape[0] - 1, int(ptr[-1]), y.shape[1]))


def _library() -> ctypes.CDLL:
    global _lib
    with _launch_lock:
        if _lib is None:
            lib = cuda_build.load("setops")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.setops_gather_sum_f32.argtypes = [p, p, p, p, i, i, p]
            lib.setops_gather_sum_f32.restype = i
            lib.setops_error_string.argtypes = [i]
            lib.setops_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def gather_sum(y: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """[n, b] f32 fixed-order segment sums of y's rows (`gather_sum_plain`'s
    function). CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream or raise."""
    global LAUNCHES
    if y.device.type == "cpu":
        with cost.plain():
            out = gather_sum_plain(y, idx, ptr)
        if cost.counting():
            _report(y, ptr)
        return out
    if y.device.type != "cuda":
        raise ValueError(f"gather_sum runs on cuda or cpu, not {y.device}")
    if y.dim() != 2 or y.dtype != torch.float32 or not y.is_contiguous():
        raise TypeError(f"gather_sum: y must be a contiguous 2-d float32 tensor, got "
                        f"{y.dtype} {tuple(y.shape)}")
    for name, x in (("idx", idx), ("ptr", ptr)):
        if x.device != y.device or x.dtype != torch.int32 or not x.is_contiguous():
            raise TypeError(f"gather_sum: {name} must be contiguous int32 on {y.device}")
    n, b = ptr.shape[0] - 1, y.shape[1]
    if sanitize.checks_on():
        live = sanitize.check_pointer("gather_sum", "ptr", ptr, idx.shape[0])
        sanitize.check_index("gather_sum", "idx", idx, y.shape[0], live)
    out = torch.empty((n, b), dtype=torch.float32, device=y.device)
    lib = _library()
    with torch.cuda.device(y.device):
        rc = lib.setops_gather_sum_f32(
            y.data_ptr(), idx.data_ptr(), ptr.data_ptr(), out.data_ptr(), n, b,
            torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_sum kernel launch failed: "
                           f"{lib.setops_error_string(rc).decode()} (cudaError {rc})")
    sanitize.after_launch("gather_sum", y.device)
    with _launch_lock:
        LAUNCHES += 1
    if cost.counting():
        _report(y, ptr)
    return out


class GatherSum(torch.autograd.Function):
    """`gather_sum(y, idx, ptr)` with its transpose as the backward:
    dy = gather_sum(g, t_idx, t_ptr), where (t_idx, t_ptr) group every
    row of y by the outputs it reaches."""

    @staticmethod
    def forward(ctx, y, idx, ptr, t_idx, t_ptr):
        ctx.save_for_backward(t_idx, t_ptr)
        return gather_sum(y.contiguous(), idx, ptr)

    @staticmethod
    def backward(ctx, g):
        t_idx, t_ptr = ctx.saved_tensors
        return gather_sum(g.contiguous(), t_idx, t_ptr), None, None, None, None


def edge_runs(edge_src: torch.Tensor, edge_dst: torch.Tensor, edge_mask: torch.Tensor,
              n: int) -> tuple[torch.Tensor, ...]:
    """The four CSR tensors of a node-level union over the live edges
    (any order): each node's in-edges in edge order (src of each, by
    dst) and, for the backward, its out-edges (dst of each, by src):
    (idx, ptr, t_idx, t_ptr)."""
    live = edge_mask.bool()
    idx, ptr = csr_layout(edge_dst, live, n, values=edge_src)
    t_idx, t_ptr = csr_layout(edge_src, live, n, values=edge_dst)
    return idx, ptr, t_idx, t_ptr


def node_union(out: torch.Tensor, runs: tuple[torch.Tensor, ...],
               union_type: str = "simple") -> torch.Tensor:
    """`segment_union(out[edge_src], 0, edge_dst, edge_mask)` for
    node-level states [N, D] over `edge_runs`' layout. The union's
    summand is elementwise, so it is taken per node before the gather;
    the live edges' terms are the reference's, in the same order."""
    if union_type == "simple":
        return 1.0 - torch.exp(GatherSum.apply(log_keep(out), *runs))
    if union_type == "relu":
        return 1.0 - torch.relu(1.0 - GatherSum.apply(out, *runs))
    raise ValueError(f"unknown union_type {union_type}")


def segment_union(
    messages: torch.Tensor,
    init: torch.Tensor,
    segment_ids: torch.Tensor,
    mask: torch.Tensor,
    union_type: str = "simple",
) -> torch.Tensor:
    """Fold a union over each segment's messages: messages [E, D], init
    [N, D], segment_ids [E] (any order), mask [E]; a masked message
    contributes the union's identity, as in the reference."""
    if union_type not in ("simple", "relu"):
        raise ValueError(f"unknown union_type {union_type}")
    n, e = init.shape[0], messages.shape[0]
    x = messages * mask.to(messages.dtype)[:, None]
    idx, ptr = csr_layout(segment_ids, torch.ones_like(mask, dtype=torch.bool), n)
    # the transpose: message e's row is read by its own segment alone
    t_idx = segment_ids.to(torch.int32).contiguous()
    t_ptr = torch.arange(e + 1, dtype=torch.int32, device=x.device)
    if union_type == "simple":
        prod = torch.exp(GatherSum.apply(log_keep(x), idx, ptr, t_idx, t_ptr))
        return 1.0 - (1.0 - init) * prod
    s = GatherSum.apply(x, idx, ptr, t_idx, t_ptr)
    return 1.0 - torch.relu(1.0 - (init + s))
