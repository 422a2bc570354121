"""The GGNN on Hopper, forward and backward: the wrappers of
`csrc/ggnn_step.cu` and `csrc/ggnn_bwd.cu`, their plain PyTorch
versions, the `GgnnStep` and `GgnnUnroll` autograd Functions and
`ggnn_propagate`, the port of the reference's
`deepdfa_tpu/nn/ggnn_kernel.py` (the "fold" and "mxu" scatters).

One step computes, for every node v of the padded batch,

    a_v  = sum_t sum_{e: dst_e = v} w_{t,e} * msg_t(h_{src_e})
    h'_v = GRU(a_v, h_v)

with w_{t,e} = edge_mask_e * [edge_type_e == t] and the message under
the policy `accum` (the reference's `_edge_messages`):

    fp32: h_src @ Wm_t + bm_t
    bf16: bf16(h_src) @ bf16(Wm_t) + bm_t, the products summed in fp32
    int8: (q(h_src) @ Wq_t) * s(h_src) * ws_t + bm_t, with rows quantized
          per row (`quant_rows`) and Wm_t per output channel (`quant_wm`)

The aggregate and the GRU are fp32 under every policy. The scatter sums
the messages into a: "fold" sums each node's in-edges in edge order;
"mxu" (the reference's one-hot product per edge block) sums them per
node within each block of `block_e` edges (`edge_block`), the blocks in
ascending order, and under int8 first requantizes each block's messages
per column, ms = max|msg| * (1/127), q = clip(rint(msg / ms), -127,
127), adding float(sum q) * ms: a different function, whose numbers
depend on `block_e`. Its backward, as
the reference's `_step_bwd` splits it, is straight-through for the
policies (fp32 on h and Wm, from the policy's aggregate a):

    B3 `gru_bwd`: the GRU's backward from the saved (h, a) -> da,
       dh_gru and the GRU's four parameter cotangents;
    B4 `dmsg`: the transposed message, dh_msg_u = sum over the edges
       leaving u of w * (da_dst @ Wm_t^T);
    then dWm_t = sum_e w * h_src^T da_dst and dbm_t = sum_e w * da_dst as
    an index_select and a matmul (the reference's einsums).

`unroll="fused"` runs every step in one launch of kernel 2
(`ggnn_fused`), admitted by `resolve_unroll`; its backward
(`GgnnUnroll`, the reference's `_unroll_bwd`) walks the chain of step
inputs in reverse through kernel 1, B3 and B4.

Each wrapper (`ggnn_step`, `ggnn_fused`, `gru_bwd`, `dmsg`) launches its
CUDA kernel for tensors on a CUDA device and runs its plain PyTorch
version for tensors on the CPU; there is no other route and no fallback
from one to the other. `launch_counts()` names every counter: kernel
1's per (scatter, policy) (`LAUNCHES`, `BF16_LAUNCHES`, `INT8_LAUNCHES`,
`MXU_LAUNCHES`, `MXU_BF16_LAUNCHES`, `MXU_INT8_LAUNCHES`; of them
`AGGREGATE_LAUNCHES` writing the aggregate), kernel 2's per scatter
(`FUSED_LAUNCHES`, `FUSED_MXU_LAUNCHES`; of them `FUSED_CHAIN_LAUNCHES`
with the chain), `GRU_BWD_LAUNCHES`, `DMSG_LAUNCHES`, and
`FUSED_FALLBACKS`, the fused unrolls `resolve_unroll` refused.

The work formulas (`step_work`, `policy_step_work`, `fused_work`,
`mxu_work`, `gru_bwd_work`, `dmsg_work`) give each kernel's operations
and bytes from its shapes and live edges. Under an open count
(obs/cost.py) every wrapper reports them at each launch, and on the CPU
runs its plain version where the count cannot see its aten ops; the
card's bounds (`chip_smoke.py`) are computed from the same formulas.

The fold forward aggregates sum(coef * row) and sum(w) per node first
and applies the policy's Wm_t, bm_t once per node; B4 likewise sums
w * da_dst over each node's src run and applies Wm_t^T once per node,
adding into the dh that B3 wrote. Both are reassociations of the
reference's per-edge transform, covered by the fp32 tolerances of the
tests. The mxu forward computes every edge's message, as the reference
does; under int8 on the card's integer tensor cores, exactly (the
products are integers below 2^24), from a [T, out, in] copy of the
quantized transform that the wrapper makes each call. Weights keep the
reference's [in, out] layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
import threading

import torch
from torch.autograd.function import once_differentiable

from deepdfa_tpu_torch.core import sanitize
from deepdfa_tpu_torch.nn import cuda_build
from deepdfa_tpu_torch.obs import cost

logger = logging.getLogger(__name__)

#: kernel launches since the process started (or since a caller reset
#: them); each is counted where its kernel is launched and nowhere else
LAUNCHES = 0  # ggnn_step, accum="fp32" (the fold scatter unless named)
BF16_LAUNCHES = 0  # ggnn_step, accum="bf16"
INT8_LAUNCHES = 0  # ggnn_step, accum="int8"
MXU_LAUNCHES = 0  # ggnn_step, scatter="mxu", accum="fp32"
MXU_BF16_LAUNCHES = 0  # ggnn_step, scatter="mxu", accum="bf16"
MXU_INT8_LAUNCHES = 0  # ggnn_step, scatter="mxu", accum="int8" (with its pre-pass)
AGGREGATE_LAUNCHES = 0  # of those six, the ones writing the aggregate (a backward follows)
FUSED_LAUNCHES = 0  # ggnn_fused (kernel 2), fold, any policy
FUSED_MXU_LAUNCHES = 0  # ggnn_fused, mxu, any policy
FUSED_CHAIN_LAUNCHES = 0  # of those two, the ones writing the chain
GRU_BWD_LAUNCHES = 0  # gru_bwd (B3)
DMSG_LAUNCHES = 0  # dmsg (B4)
#: unroll="fused" requests that ran per step (resolve_unroll's fallbacks)
FUSED_FALLBACKS = 0
_launch_lock = threading.Lock()

#: the message policies and their numbers in csrc/ggnn_step.cu
POLICIES = {"fp32": 0, "bf16": 1, "int8": 2}
#: the scatters and their numbers in csrc/ggnn_step.cu
SCATTERS = {"fold": 0, "mxu": 1}
_STEP_COUNTER = {
    ("fold", "fp32"): "LAUNCHES", ("fold", "bf16"): "BF16_LAUNCHES",
    ("fold", "int8"): "INT8_LAUNCHES", ("mxu", "fp32"): "MXU_LAUNCHES",
    ("mxu", "bf16"): "MXU_BF16_LAUNCHES", ("mxu", "int8"): "MXU_INT8_LAUNCHES",
}
_FUSED_COUNTER = {"fold": "FUSED_LAUNCHES", "mxu": "FUSED_MXU_LAUNCHES"}

#: relative drift bound of accum="int8" against fp32 (the reference's
#: INT8_DRIFT_BOUND, pinned equal in the tests); bf16's is 5e-2 too
INT8_DRIFT_BOUND = 5e-2

#: the fused kernel's residency budget for CPU tensors, which run the
#: plain loop: the H100's 50 MB L2, so the CPU admits what the card does.
#: On a CUDA device the budget is that device's L2 (`fused_budget_bytes`).
#: Tests shrink it to watch the fallback.
CPU_BUDGET_BYTES = 50 * 2**20

#: nodes per thread block and the widest d the kernels take
#: (csrc/ggnn_step.cu: kTileNodes, the GGNN_CASE list)
NODE_TILE = 64
MAX_WIDTH = 288


#: the reference's default edge block (`block_sizes`: 512-edge tiles)
DEFAULT_BLOCK_EDGES = 512


def block_sizes(node_budget: int) -> tuple[int, int]:
    """(nodes per thread block, thread blocks) of one step launch.

    The reference tiled nodes and edges into VMEM blocks; here the node
    tile is fixed by the kernel (one warp per 8 nodes, 8 warps). The
    fold scatter does not block edges at all — each node walks its own
    CSR run; the mxu scatter cuts those runs at `edge_block`'s
    boundaries."""
    return NODE_TILE, -(-int(node_budget) // NODE_TILE)


def pick_block(total: int, target: int) -> int:
    """The reference's `_pick_block`: the largest divisor of `total` in
    (target // 8, target], preferring `target`; `total` itself (one
    block) when `total <= target` or no such divisor exists."""
    total = int(total)
    if total <= target:
        return max(total, 1)
    for cand in range(target, max(target // 8, 1), -1):
        if total % cand == 0:
            return cand
    return total


def edge_block(edge_budget: int, block_edges: int = 0) -> int:
    """Edges per block of the mxu scatter, as the reference sizes its
    edge tile (`block_sizes`' second half): `block_edges` (0: 512),
    shrunk to a divisor of the edge budget. Under int8 the messages are
    requantized per column within each block, so this changes the
    numbers; under fp32/bf16 only the summation order."""
    return pick_block(edge_budget, int(block_edges) or DEFAULT_BLOCK_EDGES)


def resolve_scatter(scatter: str) -> str:
    """The reference's `resolve_scatter`: "fold" and "mxu" pass; "auto"
    is "fold" here, as the reference resolves it off the TPU."""
    if scatter in SCATTERS:
        return scatter
    if scatter != "auto":
        raise ValueError(f"unknown ggnn_kernel scatter {scatter!r}")
    return "fold"


_COUNTERS = (*_STEP_COUNTER.values(), "AGGREGATE_LAUNCHES", *_FUSED_COUNTER.values(),
             "FUSED_CHAIN_LAUNCHES", "GRU_BWD_LAUNCHES", "DMSG_LAUNCHES", "FUSED_FALLBACKS")


def launch_counts() -> dict[str, int]:
    """Every launch counter and FUSED_FALLBACKS, by name."""
    return {name: globals()[name] for name in _COUNTERS}


def reset_launch_counts() -> None:
    with _launch_lock:
        globals().update(dict.fromkeys(_COUNTERS, 0))


def _count(name: str) -> None:
    with _launch_lock:
        globals()[name] += 1


def check_accum(accum: str, scatter: str = "fold") -> None:
    if accum not in POLICIES:
        raise ValueError(f"unknown ggnn_kernel accum {accum!r}")
    if scatter not in SCATTERS:
        raise ValueError(f"unknown ggnn_kernel scatter {scatter!r}")


def kernel_shape_ok(
    node_budget: int, edge_budget: int, d: int, n_etypes: int = 1
) -> bool:
    """Can the CUDA kernels take this problem? d must be a multiple of
    32 (one column per lane) and at most MAX_WIDTH; indices are int32."""
    if min(node_budget, edge_budget, d, n_etypes) <= 0:
        return False
    if d % 32 or d > MAX_WIDTH:
        return False
    return n_etypes * edge_budget < 2**31 and node_budget < 2**31 - 1


@dataclasses.dataclass(frozen=True)
class EdgeIndex:
    """Per-batch edge preprocessing, shared by every step and by the
    backward. The src-sorted fields are set only when the backward
    needs them (`prepare_edges(..., transpose=True)`)."""

    src: torch.Tensor  # [E] int32
    dst: torch.Tensor  # [E] int32 (plain version, weight cotangents)
    w2: torch.Tensor  # [T, E] f32: edge_mask * [edge_type == t]
    rowptr: torch.Tensor  # [N + 1] int32 CSR row pointer over live edges
    srcp: torch.Tensor | None = None  # [E] int32 src in src-sorted order
    dstp: torch.Tensor | None = None  # [E] int32 dst in src-sorted order
    wp: torch.Tensor | None = None  # [T, E] f32 w2 in src-sorted order
    srcptr: torch.Tensor | None = None  # [N + 1] int32 src CSR over live edges

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def _row_pointer(key: torch.Tensor, n: int) -> torch.Tensor:
    nodes = torch.arange(n + 1, device=key.device, dtype=torch.int32)
    return torch.searchsorted(key, nodes, out_int32=True)


def prepare_edges(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_type: torch.Tensor | None,
    n: int,
    n_etypes: int = 1,
    *,
    transpose: bool = False,
) -> EdgeIndex:
    """Per-type edge weights and the CSR row pointer, on the edges'
    device, with no host sync; with `transpose`, also the src-sorted
    layout the backward walks (the reference's `perm`, `src_sorted`,
    `dstp2`, `wp2`).

    Live edges are a dst-sorted prefix (graphs/batch.py), so keying
    every masked edge as node `n` keeps the key sorted; a search for
    0..n then gives each node's run, and rowptr[n] is the live edge
    count. The padded edges, all pointed at node n-1, never enter a row:
    a one-graph batch in a large edge budget would otherwise hand one
    node a run of tens of thousands of dead edges. The src order is a
    stable argsort of src keyed the same way, so the live edges stay a
    prefix there too and srcptr covers them only."""
    w = edge_mask.to(torch.float32)
    if n_etypes == 1:
        w2 = w[None]
    else:
        if edge_type is None:
            raise ValueError(f"n_etypes={n_etypes} needs edge_type")
        w2 = torch.stack(
            [w * (edge_type == t).to(torch.float32) for t in range(n_etypes)]
        )
    w2 = w2.contiguous()
    src = edge_src.to(torch.int32).contiguous()
    dst = edge_dst.to(torch.int32).contiguous()
    dead = torch.full_like(dst, n)
    rowptr = _row_pointer(torch.where(edge_mask, dst, dead), n)
    if not transpose:
        return EdgeIndex(src=src, dst=dst, w2=w2, rowptr=rowptr)
    key = torch.where(edge_mask, src, dead)
    perm = torch.argsort(key, stable=True)
    return EdgeIndex(
        src=src, dst=dst, w2=w2, rowptr=rowptr,
        srcp=src[perm].contiguous(), dstp=dst[perm].contiguous(),
        wp=w2[:, perm].contiguous(), srcptr=_row_pointer(key[perm], n),
    )


# ---------------------------------------------------------------------------
# work formulas: (operations, bytes) of each kernel's call, for the card's
# bounds and the counted cost (obs/cost.py)

_ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1}


def step_work(n: int, e_live: int, d: int, t: int, with_aggregate: bool) -> tuple[int, int]:
    """(operations, bytes) of one fp32 fold step (kernel 1). Operations:
    2*d per live edge (the run sums), 2*N*d^2*T (the per-type transform),
    12*N*d^2 (the two GRU products); the gate arithmetic (~30 per node
    and column, under 2%) is not counted. Bytes: h read and h' (and a)
    written once, the live edges' src and weights, the row pointer, the
    weights."""
    flops = 2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d
    weights = t * d * d + t * d + 2 * (3 * d * d + 3 * d)
    nbytes = 4 * (
        n * d * (3 if with_aggregate else 2) + e_live * (1 + t) + (n + 1) + weights
    )
    return flops, nbytes


def policy_step_work(n: int, e_live: int, d: int, t: int, accum: str) -> tuple[int, int]:
    """`step_work` without the aggregate, with Wm read in the policy's
    type (int8 adds its [T, d] scales); the per-row quantization (~4
    operations an element) is not counted. The message-side table is an
    intermediate and moves no counted bytes."""
    flops = 2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d) + (t * d if accum == "int8" else 0))
    nbytes = (4 * (2 * n * d + e_live * (1 + t) + (n + 1)) + weights
              + _ITEMSIZE[accum] * t * d * d)
    return flops, nbytes


def fused_work(n: int, e_live: int, d: int, t: int, accum: str, n_steps: int,
               chain: bool) -> tuple[int, int]:
    """(operations, bytes) of kernel 2: n_steps steps' operations
    (`step_work`'s count); bytes: feat read and h_out written once, the
    chain written once when asked for, the edges and weights once."""
    flops = n_steps * (2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d)
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d)) + _ITEMSIZE[accum] * t * d * d
    nbytes = (4 * ((2 + (n_steps if chain else 0)) * n * d + e_live * (1 + t) + (n + 1))
              + weights)
    return flops, nbytes


def mxu_work(n: int, e_live: int, d: int, t: int, accum: str, n_steps: int = 1,
             chain: bool = False) -> tuple[int, int, int]:
    """(message operations, fp32 operations, bytes) of n_steps mxu steps
    (kernel 1, or kernel 2 with `n_steps` and `chain`): the per-edge
    messages' 2*E_live*d^2*T products, in the policy's type, and the
    GRU's 12*N*d^2 plus the sums' 2*E_live*d in fp32; bytes as
    `policy_step_work`'s, with the chain written once when asked for."""
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d) + (t * d if accum == "int8" else 0))
    nbytes = (4 * ((2 + (n_steps if chain else 0)) * n * d + e_live * (1 + t) + (n + 1))
              + weights + _ITEMSIZE[accum] * t * d * d)
    return (n_steps * 2 * e_live * d * d * t,
            n_steps * (12 * n * d * d + 2 * e_live * d), nbytes)


def gru_bwd_work(n: int, d: int, weights: bool = True) -> tuple[int, int]:
    """(operations, bytes) of B3: 36*N*d^2 operations (the two recomputed
    gate products, da, dh_gru and the two weight products, 6*N*d^2 each;
    24*N*d^2 without the weight pass), the gate chain not counted; bytes:
    h, a, g read and da, dh written once, the weights read and (with the
    weight pass) their cotangents written once."""
    if weights:
        return 36 * n * d * d, 4 * (5 * n * d + 2 * (2 * 3 * d * d + 2 * 3 * d))
    return 24 * n * d * d, 4 * (5 * n * d + 2 * (3 * d * d + 3 * d))


def dmsg_work(n: int, e_live: int, d: int, t: int, add: bool = False) -> tuple[int, int]:
    """(operations, bytes) of B4: 2*N*d^2*T (each node's sums times
    Wm_t^T) plus 2*d per live edge (each live edge has one type); bytes:
    da read and dh_msg written once (with `add`, the dh it is added to
    read too), the live edges' dst and T weights, the src row pointer,
    Wm."""
    flops = 2 * n * d * d * t + 2 * e_live * d
    nbytes = 4 * ((3 if add else 2) * n * d + e_live * (1 + t) + (n + 1) + t * d * d)
    return flops, nbytes


def _report_step(kernel: str, n: int, d: int, t: int, edges: "EdgeIndex", accum: str,
                 scatter: str, with_aggregate: bool, n_steps: int = 0,
                 chain: bool = False) -> None:
    """Report one launch of kernel 1 (`n_steps` 0) or kernel 2 to the
    open counts; reads the live edge count from the device."""
    e_live = int(edges.rowptr[-1])
    aggregate = 4 * n * d if with_aggregate else 0
    if scatter == "mxu":
        msg, other, nbytes = mxu_work(n, e_live, d, t, accum, max(1, n_steps), chain)
        by = {"fp32": other}
        by[accum] = by.get(accum, 0) + msg
        cost.report(kernel, by, nbytes + aggregate)
        return
    if n_steps:
        flops, nbytes = fused_work(n, e_live, d, t, accum, n_steps, chain)
    elif accum == "fp32":
        flops, nbytes = step_work(n, e_live, d, t, with_aggregate)
        aggregate = 0
    else:
        flops, nbytes = policy_step_work(n, e_live, d, t, accum)
    cost.report(kernel, flops, nbytes + aggregate)


def gru_cell(x, h, wih, whh, bih, bhh):
    """torch.nn.GRUCell's update with [in, 3*out] weights, gates r, z, n
    (the reference's `_gru` / `GRUCell.__call__`)."""
    gx = x @ wih + bih
    gh = h @ whh + bhh
    xr, xz, xn = gx.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


# ---------------------------------------------------------------------------
# the message policies (the reference's _quant_rows, _quant_wm and
# _msg_weight_operands)

_INV_127 = 1.0 / 127.0


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (q int8 [n, d], s f32 [n, 1]) with
    s = max|row| * (1/127) (XLA compiles the reference's `/ 127.0` to
    that product), 1 for an all-zero row, and q = clip(round(x / s),
    -127, 127), rounding half to even; x ~= q * s."""
    s = x.abs().amax(dim=-1, keepdim=True) * _INV_127
    s = torch.where(s > 0.0, s, torch.ones_like(s))
    return torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8), s


def quant_wm(wm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of the [T, in, out] transforms:
    (q int8 [T, d, d], s f32 [T, d]), the max taken over the input axis."""
    s = wm.abs().amax(dim=1, keepdim=True) * _INV_127
    s = torch.where(s > 0.0, s, torch.ones_like(s))
    return torch.clamp(torch.round(wm / s), -127.0, 127.0).to(torch.int8), s[:, 0, :]


def msg_weights(wm: torch.Tensor, accum: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The transform operand the kernels read under `accum`, with its
    per-channel scales: (Wm, None), (bf16(Wm), None) or quant_wm(Wm)."""
    check_accum(accum)
    if accum == "int8":
        return quant_wm(wm)
    if accum == "bf16":
        return wm.to(torch.bfloat16).contiguous(), None
    return wm, None


def _kernel_weights(kernel: str, wm, wih, whh, accum: str, scatter: str):
    """(Wm operand, ws) as the step kernels read them: the policy's
    transform (`msg_weights`), transposed to [T, out, in] under int8 mxu
    (the tensor cores' B operand). The kernels stage Wm, Wih and Whh 16
    bytes at a time, so each must start 16-byte aligned."""
    for name, x in (("wm", wm), ("wih", wih), ("whh", whh)):
        if x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must start 16-byte aligned")
    wm_k, ws = msg_weights(wm, accum)
    if accum == "int8" and scatter == "mxu":
        wm_k = wm_k.transpose(1, 2).contiguous()
    return wm_k, ws


def _fold_aggregate_plain(h, edges: EdgeIndex, wm, bm, accum: str):
    """The fold scatter's aggregate: per type, sum(coef * row) and
    sum(w) per node, then the policy's Wm_t (and ws_t) and c * bm_t."""
    src = edges.src.long()
    dst = edges.dst.long()
    n = h.shape[0]
    row_scale = None
    if accum == "int8":
        q, row_scale = quant_rows(h)
        rows = q.to(h.dtype)
        row_scale = row_scale[:, 0]
    elif accum == "bf16":
        rows = h.to(torch.bfloat16).to(h.dtype)
    else:
        rows = h
    wm_k, ws = msg_weights(wm, accum)
    wm_k = wm_k.to(h.dtype)
    a = torch.zeros_like(h)
    for t in range(wm.shape[0]):
        wt = edges.w2[t].to(h.dtype)
        coef = wt if row_scale is None else wt * row_scale[src]
        s = torch.zeros_like(h).index_add_(0, dst, rows[src] * coef[:, None])
        c = torch.zeros(n, dtype=h.dtype, device=h.device).index_add_(0, dst, wt)
        m = s @ wm_k[t]
        if ws is not None:
            m = m * ws[t]
        a = a + (m + c[:, None] * bm[t])
    return a


def mxu_messages_plain(h, edges: EdgeIndex, wm, bm, accum: str) -> torch.Tensor:
    """Every edge slot's message under `accum`, masked by its weight:
    [T, E, d] f32, in the reference's `_edge_messages` operation order
    (int8: ((q(h_src) @ Wq_t) * s_src * ws_t + bm_t) * w). The int8
    products are integers below 2^24, so the fp32 matmul is exact."""
    src = edges.src.long()
    wm_k, ws = msg_weights(wm, accum)
    wm_k = wm_k.to(h.dtype)
    if accum == "int8":
        q, row_scale = quant_rows(h)
        rows, sg = q.to(h.dtype)[src], row_scale[src]
    else:
        rows = (h.to(torch.bfloat16).to(h.dtype) if accum == "bf16" else h)[src]
    out = []
    for t in range(wm.shape[0]):
        m = rows @ wm_k[t]
        if accum == "int8":
            m = m * sg * ws[t]
        out.append((m + bm[t]) * edges.w2[t].to(h.dtype)[:, None])
    return torch.stack(out)


def mxu_colmax_plain(msg: torch.Tensor, block_e: int) -> torch.Tensor:
    """max |msg| per (type, edge block, column): [T, E / block_e, d]."""
    t, e, d = msg.shape
    return msg.abs().reshape(t, e // block_e, block_e, d).amax(dim=2)


def _mxu_aggregate_plain(h, edges: EdgeIndex, wm, bm, accum: str, block_e: int):
    """The mxu scatter's aggregate (the reference's one-hot product per
    edge block, `_aggregate`/`_block_aggregate`): per type, each node
    sums its edges' messages within each block of `block_e` edges, and
    the block partials are added in ascending block order; under int8
    each block's messages are first requantized per column
    (ms = max|msg| * (1/127), q = clip(rint(msg / ms), -127, 127)), the
    quanta summed exactly and dequantized as float(sum) * ms. A node's
    run covers consecutive blocks, so its k-th block is
    rowptr[v] // block_e + k; the partials are added rank by rank."""
    n, d = h.shape
    e = edges.src.shape[0]
    n_eb = e // block_e
    idx = torch.arange(e, device=h.device)
    live = idx < edges.rowptr[-1]
    dst = edges.dst.long()[live]
    blk = idx // block_e
    first = edges.rowptr[:n].long() // block_e  # each node's first block
    rank = blk[live] - first[dst]
    n_ranks = int(rank.max()) + 1 if dst.numel() else 0
    msg = mxu_messages_plain(h, edges, wm, bm, accum)
    a = torch.zeros_like(h)
    for t in range(wm.shape[0]):
        vals = msg[t]
        if accum == "int8":
            ms = mxu_colmax_plain(msg[t:t + 1], block_e)[0] * _INV_127
            ms = torch.where(ms > 0.0, ms, torch.ones_like(ms))
            vals = torch.clamp(torch.round(vals / ms[blk]), -127.0, 127.0).to(torch.float64)
        vals = vals[live]
        acc_t = torch.zeros_like(h)
        for r in range(n_ranks):
            sel = rank == r
            part = torch.zeros((n, d), dtype=vals.dtype, device=h.device).index_add_(
                0, dst[sel], vals[sel])
            if accum == "int8":
                part = part.to(h.dtype) * ms[(first + r).clamp(max=n_eb - 1)]
            acc_t = acc_t + part
        a = a + acc_t
    return a


def ggnn_step_plain(h, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh, accum: str = "fp32",
                    scatter: str = "fold", block_e: int = 0):
    """The forward kernel's function in plain PyTorch: (h', a). Under
    fold the message-side rows are rounded (bf16) or quantized (int8)
    before the per-node sums, as the kernel does; under mxu the
    aggregate is `_mxu_aggregate_plain` over blocks of `block_e` edges
    (0: `edge_block`'s default)."""
    if scatter == "mxu":
        a = _mxu_aggregate_plain(h, edges, wm, bm, accum,
                                 block_e or edge_block(edges.src.shape[0]))
    else:
        a = _fold_aggregate_plain(h, edges, wm, bm, accum)
    return gru_cell(a, h, wih, whh, bih, bhh), a


def ggnn_fused_plain(feat, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh, *,
                     n_steps: int, accum: str = "fp32", with_chain: bool = False,
                     scatter: str = "fold", block_e: int = 0):
    """Kernel 2's function in plain PyTorch: n_steps of `ggnn_step_plain`;
    (h_out, chain [n_steps, N, d] of the step inputs | None)."""
    h, chain = feat, []
    for _ in range(n_steps):
        chain.append(h)
        h, _ = ggnn_step_plain(h, edges, wm, bm, wih, whh, bih, bhh, accum, scatter, block_e)
    return h, (torch.stack(chain) if with_chain else None)


# ---------------------------------------------------------------------------
# admission of the fused unroll (the reference's fused_residency_bytes,
# resolve_unroll and _note_fused_fallback, re-derived for the card)


def fused_residency_bytes(n: int, d: int, accum: str, n_steps: int = 1, *,
                          scatter: str = "fold", n_eb: int = 0, n_etypes: int = 1) -> int:
    """Bytes kernel 2 keeps live across its steps: the f32 state planes
    (h_out, plus a scratch plane when n_steps > 1) and, under int8, the
    int8 shadow tables with their row scales (one read and one written a
    step, so two when n_steps > 1); under int8 mxu also the pre-pass's
    column maxima, one [n_etypes, n_eb, d] uint32 slice a step. The chain
    is written once and not read back; the edges and weights are the
    per-step kernel's too. At the flagship (N 16384, d 128, 5 steps):
    16.8 MB, 21.1 MB under int8, +0.33 MB under int8 mxu (n_eb 128)."""
    planes = min(int(n_steps), 2)
    total = planes * n * d * 4
    if accum == "int8":
        total += planes * (n * d + n * 4)
        if scatter == "mxu":
            total += int(n_steps) * n_etypes * n_eb * d * 4
    return total


def fused_budget_bytes(device: torch.device) -> int:
    """Kernel 2's residency budget: the CUDA device's L2 (the state
    planes are meant to live there between steps), CPU_BUDGET_BYTES for
    the CPU."""
    if device.type != "cuda":
        return CPU_BUDGET_BYTES
    return torch.cuda.get_device_properties(device).L2_cache_size


def resolve_unroll(unroll: str, *, n: int, d: int, n_steps: int, accum: str,
                   scan_steps: bool, budget_bytes: int, scatter: str = "fold",
                   n_eb: int = 0, n_etypes: int = 1) -> tuple[str, str]:
    """(the unroll that runs, the reason when it is not the one asked
    for). `fused` runs per step when `scan_steps` asks for a bounded
    trace over n_steps > 1 (the reference's rule, kept so one config
    means the same in both packages) or when `fused_residency_bytes`
    exceeds `budget_bytes`."""
    if unroll not in ("per_step", "fused"):
        raise ValueError(f"unknown ggnn_kernel unroll {unroll!r}")
    if unroll != "fused":
        return "per_step", ""
    if scan_steps and n_steps > 1:
        return ("per_step", "scan_steps requested a bounded trace; the fused "
                "unroll's backward re-unrolls every step")
    need = fused_residency_bytes(n, d, accum, n_steps, scatter=scatter, n_eb=n_eb,
                                 n_etypes=n_etypes)
    if need > budget_bytes:
        return ("per_step", f"fused unroll residency {need} B exceeds the L2 "
                f"budget {budget_bytes} B at {n}x{d}")
    return "fused", ""


_warned: set[str] = set()


def _note_fused_fallback(reason: str) -> None:
    """A fused request that runs per step: counted every time, and
    logged as a warning once per reason (a reason names the shape)."""
    _count("FUSED_FALLBACKS")
    if reason not in _warned:
        _warned.add(reason)
        logger.warning("ggnn_kernel: fused unroll unavailable — %s; falling "
                       "back to the per-step kernel", reason)


def gru_bwd_plain(h, a, wih, whh, bih, bhh, g, weights: bool = True):
    """B3's function in plain PyTorch, step by step as the reference's
    `_gru_bwd_kernel`: (da, dh_gru, dwih, dwhh, dbih, dbhh); without
    `weights` the four weight cotangents are None and not computed."""
    gx = a @ wih + bih
    gh = h @ whh + bhh
    xr, xz, xn = gx.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    dz = g * (h - n)
    dn = g * (1.0 - z)
    dt = dn * (1.0 - n * n)
    dhn = dt * r
    dr = dt * hn
    dsr = dr * r * (1.0 - r)
    dsz = dz * z * (1.0 - z)
    dgx = torch.cat([dsr, dsz, dt], dim=-1)
    dgh = torch.cat([dsr, dsz, dhn], dim=-1)
    da = dgx @ wih.T
    dh = dgh @ whh.T + g * z
    if not weights:
        return da, dh, None, None, None, None
    return da, dh, a.T @ dgx, h.T @ dgh, dgx.sum(0), dgh.sum(0)


def dmsg_plain(da, edges: EdgeIndex, wm, dh=None):
    """B4's function in plain PyTorch: dh_msg [N, d], the reference's
    `segment_sum(_dmsg_call(...), src_sorted)` in the kernel's order: per
    type the src runs' sums s_t = sum_e w_te da_dst (edge order), then
    s_t @ Wm_t^T, the types added in order. With `dh`, dh + dh_msg, added
    into dh in place."""
    srcp = edges.srcp.long()
    dstp = edges.dstp.long()
    out = torch.zeros_like(da) if dh is None else dh
    for t in range(wm.shape[0]):
        s = torch.zeros_like(da).index_add_(0, srcp, da[dstp] * edges.wp[t].to(da.dtype)[:, None])
        out.add_(s @ wm[t].T)
    return out


def msg_weight_grads(h, da, edges: EdgeIndex):
    """(dWm [T, d, d], dbm [T, d]): the message transform's cotangents,
    sum_e w * h_src^T da_dst and sum_e w * da_dst, over every edge slot
    (padded ones weigh 0). index_select and matmul only: both give the
    same bits on every run on the card, where index_add_ would not."""
    hg = h.index_select(0, edges.src.long())
    dag = da.index_select(0, edges.dst.long())
    w2 = edges.w2.to(h.dtype)
    dwm = torch.stack([(hg * w2[t][:, None]).T @ dag for t in range(w2.shape[0])])
    return dwm, w2 @ dag


# ---------------------------------------------------------------------------
# the CUDA libraries

_lib_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    """The loaded, typed library of csrc/<name>.cu (built at first use)."""
    with _lib_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        lib = cuda_build.load(name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "ggnn_step":
            lib.ggnn_step.argtypes = [i, i] + [p] * 16 + [i] * 5 + [p]
            lib.ggnn_step.restype = i
            lib.ggnn_fused.argtypes = [i, i] + [p] * 19 + [i] * 7 + [p, p]
            lib.ggnn_fused.restype = i
            lib.ggnn_fused_blocks_per_sm.argtypes = [i, i, i, p]
            lib.ggnn_fused_blocks_per_sm.restype = i
            lib.ggnn_cuda_error_string.argtypes = [i]
            lib.ggnn_cuda_error_string.restype = ctypes.c_char_p
            lib.ggnn_step_tile_nodes.argtypes = []
            lib.ggnn_step_tile_nodes.restype = i
            if lib.ggnn_step_tile_nodes() != NODE_TILE:
                raise RuntimeError(
                    f"csrc/ggnn_step.cu tiles {lib.ggnn_step_tile_nodes()} "
                    f"nodes per block; NODE_TILE says {NODE_TILE}"
                )
        else:
            lib.ggnn_gru_bwd_f32.argtypes = [p] * 11 + [i] * 3 + [p]
            lib.ggnn_gru_bwd_f32.restype = i
            lib.ggnn_gru_bwd_workspace_floats.argtypes = [i, i, i]
            lib.ggnn_gru_bwd_workspace_floats.restype = ll
            lib.ggnn_gru_bwd_splits.argtypes = [i, i]
            lib.ggnn_gru_bwd_splits.restype = i
            lib.ggnn_dmsg_f32.argtypes = [p] * 6 + [i] * 5 + [p]
            lib.ggnn_dmsg_f32.restype = i
            lib.ggnn_bwd_error_string.argtypes = [i]
            lib.ggnn_bwd_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def _check_args(kernel: str, device: torch.device, want: dict) -> None:
    """Every operand on `device`, of its dtype and shape, contiguous."""
    for name, (x, dtype, shape) in want.items():
        if x.device != device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, not {device}")
        if x.dtype != dtype:
            raise TypeError(f"{kernel}: {name} is {x.dtype}, needs {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, needs {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _check_shape(kernel: str, n: int, e: int, d: int, t: int) -> None:
    if not kernel_shape_ok(n, e, d, t):
        raise ValueError(
            f"{kernel}: the CUDA kernels take d a multiple of 32 up to "
            f"{MAX_WIDTH} with int32 indices; got n={n}, e={e}, d={d}, "
            f"n_etypes={t}"
        )


def _raise_on(rc: int, kernel: str, lib: ctypes.CDLL, errstr: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            f"{getattr(lib, errstr)(rc).decode()} (cudaError {rc})"
        )


def _on_cuda(kernel: str, device: torch.device) -> bool:
    """False for the CPU (plain version), True for CUDA, else raise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {device}")
    return True


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def _check_step_operands(kernel: str, h, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh):
    n, d = h.shape
    t = wm.shape[0]
    e = edges.src.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_args(kernel, h.device, {
        "h": (h, f32, (n, d)), "src": (edges.src, i32, (e,)),
        "w2": (edges.w2, f32, (t, e)), "rowptr": (edges.rowptr, i32, (n + 1,)),
        "wm": (wm, f32, (t, d, d)), "bm": (bm, f32, (t, d)),
        "wih": (wih, f32, (d, 3 * d)), "whh": (whh, f32, (d, 3 * d)),
        "bih": (bih, f32, (3 * d,)), "bhh": (bhh, f32, (3 * d,)),
    })
    _check_shape(kernel, n, e, d, t)
    return n, e, d, t


def _mxu_block(scatter: str, e: int, block_e: int) -> int:
    """The mxu scatter's edge block for an edge budget e (0 under fold)."""
    if scatter != "mxu":
        return 0
    block_e = block_e or edge_block(e)
    if block_e <= 0 or e % block_e:
        raise ValueError(f"the mxu edge block {block_e} does not divide the edge budget {e}")
    return block_e


def ggnn_step(h, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh,
              *, accum: str = "fp32", scatter: str = "fold", block_e: int = 0,
              with_aggregate: bool = False):
    """One GGNN step under the message policy `accum` and `scatter`: (h',
    a) with a None unless `with_aggregate`. `block_e` is the mxu
    scatter's edge block (0: `edge_block`'s default).

    CPU tensors run `ggnn_step_plain`; CUDA tensors launch the kernel on
    the current stream (under bf16 and int8 after a launch that writes
    the message-side table, under int8 mxu then the pre-pass's) or
    raise."""
    check_accum(accum, scatter)
    block_e = _mxu_block(scatter, edges.src.shape[0], block_e)
    if not _on_cuda("ggnn_step", h.device):
        with cost.plain():
            h_new, a = ggnn_step_plain(h, edges, wm, bm, wih, whh, bih, bhh, accum, scatter,
                                       block_e)
        if cost.counting():
            _report_step("ggnn_step", *h.shape, wm.shape[0], edges, accum, scatter,
                         with_aggregate)
        return h_new, (a if with_aggregate else None)
    n, e, d, t = _check_step_operands("ggnn_step", h, edges, wm, bm, wih, whh, bih, bhh)
    if sanitize.checks_on():
        sanitize.check_edges("ggnn_step", edges, n)
    lib = _library("ggnn_step")
    wm_k, ws = _kernel_weights("ggnn_step", wm, wih, whh, accum, scatter)
    table = tscale = colmax = None
    if accum == "bf16":
        table = torch.empty((n, d), dtype=torch.bfloat16, device=h.device)
    elif accum == "int8":
        table = torch.empty((n, d), dtype=torch.int8, device=h.device)
        tscale = torch.empty(n, dtype=torch.float32, device=h.device)
        if scatter == "mxu":
            colmax = torch.empty((t, e // block_e, d), dtype=torch.int32, device=h.device)
    h_out = torch.empty_like(h)
    a_out = torch.empty_like(h) if with_aggregate else None
    with torch.cuda.device(h.device):
        rc = lib.ggnn_step(
            POLICIES[accum], SCATTERS[scatter], h.data_ptr(), _ptr(table), _ptr(tscale),
            edges.src.data_ptr(), edges.w2.data_ptr(), edges.rowptr.data_ptr(),
            wm_k.data_ptr(), _ptr(ws), bm.data_ptr(), wih.data_ptr(), whh.data_ptr(),
            bih.data_ptr(), bhh.data_ptr(), h_out.data_ptr(), _ptr(a_out), _ptr(colmax),
            n, e, d, t, block_e, _stream(h.device),
        )
    _raise_on(rc, "ggnn_step", lib, "ggnn_cuda_error_string")
    sanitize.after_launch("ggnn_step", h.device)
    _count(_STEP_COUNTER[scatter, accum])
    if with_aggregate:
        _count("AGGREGATE_LAUNCHES")
    if cost.counting():
        _report_step("ggnn_step", n, d, t, edges, accum, scatter, with_aggregate)
    return h_out, a_out


def ggnn_fused(feat, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh, *, n_steps: int,
               accum: str = "fp32", scatter: str = "fold", block_e: int = 0,
               with_chain: bool = False, grid: int = 0):
    """Kernel 2: `n_steps` >= 1 GGNN steps in one launch; (h_out, chain
    [n_steps, N, d] of each step's input state | None unless
    `with_chain`).

    CPU tensors run `ggnn_fused_plain`; CUDA tensors launch the kernel
    cooperatively on the current stream or raise. `grid` asks for that
    many blocks (0: as many as the card holds at once); the card refuses
    a grid it cannot hold at once, and then this raises."""
    check_accum(accum, scatter)
    if n_steps < 1:
        raise ValueError(f"ggnn_fused runs n_steps >= 1, got {n_steps}")
    block_e = _mxu_block(scatter, edges.src.shape[0], block_e)
    if not _on_cuda("ggnn_fused", feat.device):
        with cost.plain():
            out = ggnn_fused_plain(feat, edges, wm, bm, wih, whh, bih, bhh, n_steps=n_steps,
                                   accum=accum, with_chain=with_chain, scatter=scatter,
                                   block_e=block_e)
        if cost.counting():
            _report_step("ggnn_fused", *feat.shape, wm.shape[0], edges, accum, scatter, False,
                         n_steps, with_chain)
        return out
    n, e, d, t = _check_step_operands("ggnn_fused", feat, edges, wm, bm, wih, whh, bih, bhh)
    if sanitize.checks_on():
        sanitize.check_edges("ggnn_fused", edges, n)
    lib = _library("ggnn_step")
    wm_k, ws = _kernel_weights("ggnn_fused", wm, wih, whh, accum, scatter)
    dev = feat.device
    h_out = torch.empty_like(feat)
    scratch = torch.empty_like(feat) if n_steps > 1 else None
    chain = torch.empty((n_steps, n, d), dtype=torch.float32, device=dev) if with_chain else None
    q = [None, None]
    qs = [None, None]
    colmax = None
    if accum == "int8":
        for k in range(min(n_steps, 2)):
            q[k] = torch.empty((n, d), dtype=torch.int8, device=dev)
            qs[k] = torch.empty(n, dtype=torch.float32, device=dev)
        if scatter == "mxu":
            colmax = torch.empty((n_steps, t, e // block_e, d), dtype=torch.int32, device=dev)
    used = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.ggnn_fused(
            POLICIES[accum], SCATTERS[scatter], feat.data_ptr(), edges.src.data_ptr(),
            edges.w2.data_ptr(), edges.rowptr.data_ptr(), wm_k.data_ptr(), _ptr(ws),
            bm.data_ptr(), wih.data_ptr(), whh.data_ptr(), bih.data_ptr(), bhh.data_ptr(),
            h_out.data_ptr(), _ptr(scratch), _ptr(chain), _ptr(q[0]), _ptr(q[1]),
            _ptr(qs[0]), _ptr(qs[1]), _ptr(colmax), n, e, d, t, block_e, n_steps, int(grid),
            ctypes.addressof(used), _stream(dev),
        )
    _raise_on(rc, "ggnn_fused", lib, "ggnn_cuda_error_string")
    sanitize.after_launch("ggnn_fused", dev)
    _count(_FUSED_COUNTER[scatter])
    if with_chain:
        _count("FUSED_CHAIN_LAUNCHES")
    if cost.counting():
        _report_step("ggnn_fused", n, d, t, edges, accum, scatter, False, n_steps, with_chain)
    return h_out, chain


def fused_blocks_per_sm(accum: str, scatter: str, d: int, device: torch.device) -> int:
    """Blocks of kernel 2 under (accum, scatter) at width d that one SM of
    the CUDA `device` holds at once; its cooperative grid is that times
    the SM count, at most one block a tile."""
    check_accum(accum, scatter)
    _check_shape("ggnn_fused", 1, 1, d, 1)
    lib = _library("ggnn_step")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.ggnn_fused_blocks_per_sm(POLICIES[accum], SCATTERS[scatter], d,
                                          ctypes.addressof(per_sm))
    _raise_on(rc, "ggnn_fused", lib, "ggnn_cuda_error_string")
    return per_sm.value


def gru_bwd(h, a, wih, whh, bih, bhh, g, weights: bool = True):
    """B3: (da, dh_gru, dwih, dwhh, dbih, dbhh) of one step's GRU; without
    `weights` (no parameter takes a cotangent) (da, dh_gru, None, None,
    None, None), da and dh_gru the same bits.

    CPU tensors run `gru_bwd_plain`; CUDA tensors launch the kernel (its
    gate pass, input pass and, with `weights`, its split-K weight pass and
    fixed-order reduce) on the current stream or raise. The kernel stages
    its operands 16 bytes at a time, so every operand must start 16-byte
    aligned."""
    global GRU_BWD_LAUNCHES
    if not _on_cuda("gru_bwd", h.device):
        with cost.plain():
            out = gru_bwd_plain(h, a, wih, whh, bih, bhh, g, weights)
        if cost.counting():
            cost.report("gru_bwd", *gru_bwd_work(*h.shape, weights))
        return out
    n, d = h.shape
    f32 = torch.float32
    _check_args("gru_bwd", h.device, {
        "h": (h, f32, (n, d)), "a": (a, f32, (n, d)), "g": (g, f32, (n, d)),
        "wih": (wih, f32, (d, 3 * d)), "whh": (whh, f32, (d, 3 * d)),
        "bih": (bih, f32, (3 * d,)), "bhh": (bhh, f32, (3 * d,)),
    })
    _check_shape("gru_bwd", n, 1, d, 1)
    for name, x in (("h", h), ("a", a), ("g", g), ("wih", wih), ("whh", whh)):
        if x.data_ptr() % 16:
            raise ValueError(f"gru_bwd: {name} must start 16-byte aligned")
    lib = _library("ggnn_bwd")
    da = torch.empty_like(h)
    dh = torch.empty_like(h)
    grads = (torch.empty(2 * d * 3 * d + 2 * 3 * d, dtype=f32, device=h.device)
             if weights else None)
    work = torch.empty(lib.ggnn_gru_bwd_workspace_floats(n, d, int(weights)), dtype=f32,
                       device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.ggnn_gru_bwd_f32(
            h.data_ptr(), a.data_ptr(), g.data_ptr(), wih.data_ptr(),
            whh.data_ptr(), bih.data_ptr(), bhh.data_ptr(), da.data_ptr(),
            dh.data_ptr(), _ptr(grads), work.data_ptr(), n, d, int(weights),
            _stream(h.device),
        )
    _raise_on(rc, "gru_bwd", lib, "ggnn_bwd_error_string")
    sanitize.after_launch("gru_bwd", h.device)
    with _launch_lock:
        GRU_BWD_LAUNCHES += 1
    if cost.counting():
        cost.report("gru_bwd", *gru_bwd_work(n, d, weights))
    if not weights:
        return da, dh, None, None, None, None
    w = d * 3 * d
    return (da, dh, grads[:w].view(d, 3 * d), grads[w:2 * w].view(d, 3 * d),
            grads[2 * w:2 * w + 3 * d], grads[2 * w + 3 * d:])


def dmsg(da, edges: EdgeIndex, wm, dh=None):
    """B4: dh_msg [N, d], the transposed message summed by src; with `dh`
    ([N, d] f32, contiguous), dh + dh_msg, added into dh in place.

    CPU tensors run `dmsg_plain`; CUDA tensors launch the kernel (one
    launch: per 64-node block the src runs' sums, then their product with
    each Wm_t^T) on the current stream or raise. `edges` needs the
    src-sorted layout. The kernel stages Wm 16 bytes at a time, so wm
    must start 16-byte aligned."""
    global DMSG_LAUNCHES
    if edges.srcptr is None:
        raise ValueError("dmsg needs prepare_edges(..., transpose=True)")
    if not _on_cuda("dmsg", da.device):
        with cost.plain():
            out = dmsg_plain(da, edges, wm, dh)
        if cost.counting():
            cost.report("dmsg", *dmsg_work(da.shape[0], int(edges.srcptr[-1]), da.shape[1],
                                           wm.shape[0], dh is not None))
        return out
    n, d = da.shape
    t = wm.shape[0]
    e = edges.dstp.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_args("dmsg", da.device, {
        "da": (da, f32, (n, d)), "wm": (wm, f32, (t, d, d)),
        "dstp": (edges.dstp, i32, (e,)), "wp": (edges.wp, f32, (t, e)),
        "srcptr": (edges.srcptr, i32, (n + 1,)),
        **({} if dh is None else {"dh": (dh, f32, (n, d))}),
    })
    _check_shape("dmsg", n, e, d, t)
    if wm.data_ptr() % 16:
        raise ValueError("dmsg: wm must start 16-byte aligned")
    if sanitize.checks_on():
        live = sanitize.check_pointer("dmsg", "srcptr", edges.srcptr, e)
        sanitize.check_index("dmsg", "dstp", edges.dstp, n, live)
    lib = _library("ggnn_bwd")
    out = torch.empty_like(da) if dh is None else dh
    with torch.cuda.device(da.device):
        rc = lib.ggnn_dmsg_f32(
            da.data_ptr(), wm.data_ptr(), edges.dstp.data_ptr(), edges.wp.data_ptr(),
            edges.srcptr.data_ptr(), out.data_ptr(), int(dh is not None), n, e, d, t,
            _stream(da.device),
        )
    _raise_on(rc, "dmsg", lib, "ggnn_bwd_error_string")
    sanitize.after_launch("dmsg", da.device)
    with _launch_lock:
        DMSG_LAUNCHES += 1
    if cost.counting():
        cost.report("dmsg", *dmsg_work(n, int(edges.srcptr[-1]), d, t, dh is not None))
    return out


def step_bwd(h, a, g, edges: EdgeIndex, wm, wih, whh, bih, bhh, weights: bool = True):
    """One step's backward from its saved (h, a): B3, then B4 adding into
    B3's dh, then the message weights' cotangents; (dh, dwm, dbm, dwih,
    dwhh, dbih, dbhh). Without `weights` (an attribution: only the input
    takes a cotangent) B3 skips its weight pass and the message weights'
    cotangents are not formed: (dh, None, ..., None), dh the same bits."""
    da, dh, dwih, dwhh, dbih, dbhh = gru_bwd(h, a, wih, whh, bih, bhh, g.contiguous(), weights)
    dh = dmsg(da, edges, wm, dh)
    if not weights:
        return dh, None, None, None, None, None, None
    dwm, dbm = msg_weight_grads(h, da, edges)
    return dh, dwm, dbm, dwih, dwhh, dbih, dbhh


class GgnnStep(torch.autograd.Function):
    """One differentiable GGNN step (the reference's `_step` custom_vjp).

    forward: the step kernel under `accum` and `scatter` (mxu: edge
    blocks of `block_e`) with its aggregate, saving (h, a); backward:
    `step_bwd`, straight-through for the policy and the scatter (fp32 on
    h and Wm, from the saved aggregate), without the weight passes when
    no parameter requires a gradient. The edge tensors
    (`EdgeIndex.tensors()`, src-sorted layout included) are passed one by
    one, take no gradient and must not require one."""

    @staticmethod
    def forward(ctx, accum, scatter, block_e, h, wm, bm, wih, whh, bih, bhh, *edge_tensors):
        edges = EdgeIndex(*edge_tensors)
        if edges.srcptr is None:
            raise ValueError("GgnnStep needs prepare_edges(..., transpose=True)")
        if any(x.requires_grad for x in edge_tensors):
            raise ValueError("GgnnStep: edge tensors take no gradient")
        h_new, a = ggnn_step(h, edges, wm, bm, wih, whh, bih, bhh, accum=accum,
                             scatter=scatter, block_e=block_e, with_aggregate=True)
        ctx.save_for_backward(h, a, wm, wih, whh, bih, bhh, *edge_tensors)
        return h_new

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, a, wm, wih, whh, bih, bhh, *edge_tensors = ctx.saved_tensors
        weights = any(ctx.needs_input_grad[4:10])
        dh, *grads = step_bwd(h, a, g, EdgeIndex(*edge_tensors), wm, wih, whh, bih, bhh,
                              weights)
        return (None, None, None, dh, *grads) + (None,) * len(edge_tensors)


class GgnnUnroll(torch.autograd.Function):
    """The whole differentiable unroll in kernel 2 (the reference's
    `_unroll` custom_vjp).

    forward: `ggnn_fused` with the chain, which it saves (the step
    inputs, the backward's only residual); backward: for each step in
    reverse, kernel 1 under `accum` and `scatter` recomputes that step's
    aggregate from its chain entry, then `step_bwd`; the parameter
    cotangents sum over the steps from the last one down, the order in
    which autograd sums a chain of `GgnnStep`s, so both unrolls give the
    same bits. Without a parameter requiring a gradient the weight
    passes are skipped, as in `GgnnStep`."""

    @staticmethod
    def forward(ctx, accum, scatter, block_e, n_steps, feat, wm, bm, wih, whh, bih, bhh,
                *edge_tensors):
        edges = EdgeIndex(*edge_tensors)
        if edges.srcptr is None:
            raise ValueError("GgnnUnroll needs prepare_edges(..., transpose=True)")
        if any(x.requires_grad for x in edge_tensors):
            raise ValueError("GgnnUnroll: edge tensors take no gradient")
        h_out, chain = ggnn_fused(feat, edges, wm, bm, wih, whh, bih, bhh, n_steps=n_steps,
                                  accum=accum, scatter=scatter, block_e=block_e,
                                  with_chain=True)
        ctx.variant = (accum, scatter, block_e)
        ctx.save_for_backward(chain, wm, bm, wih, whh, bih, bhh, *edge_tensors)
        return h_out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        chain, wm, bm, wih, whh, bih, bhh, *edge_tensors = ctx.saved_tensors
        edges = EdgeIndex(*edge_tensors)
        accum, scatter, block_e = ctx.variant
        weights = any(ctx.needs_input_grad[5:11])
        dh, total = g, None
        for s in reversed(range(chain.shape[0])):
            _, a = ggnn_step(chain[s], edges, wm, bm, wih, whh, bih, bhh, accum=accum,
                             scatter=scatter, block_e=block_e, with_aggregate=True)
            dh, *grads = step_bwd(chain[s], a, dh, edges, wm, wih, whh, bih, bhh, weights)
            if weights:
                total = grads if total is None else [x + y for x, y in zip(total, grads)]
        if not weights:
            total = [None] * 6
        return (None, None, None, None, dh, *total) + (None,) * len(edge_tensors)


def ggnn_propagate(
    wm: torch.Tensor,  # [T, d, d] per-etype message kernels ([in, out])
    bm: torch.Tensor,  # [T, d]
    wih: torch.Tensor,  # [d, 3d] GRU input projection
    whh: torch.Tensor,  # [d, 3d] GRU hidden projection
    bih: torch.Tensor,  # [3d]
    bhh: torch.Tensor,  # [3d]
    feat: torch.Tensor,  # [N, d] f32 initial node state
    edge_src: torch.Tensor,  # [E] int32
    edge_dst: torch.Tensor,  # [E] int32, non-decreasing
    edge_mask: torch.Tensor,  # [E] bool, live edges a prefix
    edge_type: torch.Tensor | None,  # [E] int32 or None
    *,
    n_steps: int,
    n_etypes: int = 1,
    accum: str = "fp32",
    scatter: str = "fold",
    block_edges: int = 0,
    unroll: str = "per_step",
    scan_steps: bool = False,
) -> torch.Tensor:
    """Run `n_steps` GGNN steps under the message policy `accum` and
    `scatter` ("auto" is "fold", as off the TPU in the reference; mxu
    cuts the edges into blocks of `edge_block(E, block_edges)`); the
    edge preprocessing is done once and shared by all of them and by the
    backward. `unroll="fused"` runs them in one launch of kernel 2 when
    `resolve_unroll` admits it (against this device's budget), else per
    step, counted in FUSED_FALLBACKS and logged. With gradients enabled
    and any input requiring one, the steps are `GgnnStep`s or one
    `GgnnUnroll`; otherwise (inference_mode, no_grad) each step is one
    launch without the aggregate, or the unroll one launch without the
    chain. `scan_steps` only enters the admission rule: PyTorch has no
    traced loop to bound."""
    scatter = resolve_scatter(scatter)
    check_accum(accum, scatter)
    if n_steps == 0:
        return feat
    params = [x.to(torch.float32).contiguous() for x in (wm, bm, wih, whh, bih, bhh)]
    h = feat.to(torch.float32).contiguous()
    n, d = h.shape
    e = edge_src.shape[0]
    block_e = _mxu_block(scatter, e, edge_block(e, block_edges))
    mode, why = resolve_unroll(unroll, n=n, d=d, n_steps=n_steps, accum=accum,
                               scan_steps=scan_steps, budget_bytes=fused_budget_bytes(h.device),
                               scatter=scatter, n_eb=e // block_e if block_e else 0,
                               n_etypes=n_etypes)
    if unroll == "fused" and mode != "fused":
        _note_fused_fallback(why)
    train = torch.is_grad_enabled() and any(x.requires_grad for x in (*params, h))
    edges = prepare_edges(edge_src, edge_dst, edge_mask, edge_type, n, n_etypes,
                          transpose=train)
    variant = dict(accum=accum, scatter=scatter, block_e=block_e)
    if mode == "fused":
        if train:
            return GgnnUnroll.apply(accum, scatter, block_e, n_steps, h, *params,
                                    *edges.tensors())
        return ggnn_fused(h, edges, *params, n_steps=n_steps, **variant)[0]
    for _ in range(n_steps):
        if train:
            h = GgnnStep.apply(accum, scatter, block_e, h, *params, *edges.tensors())
        else:
            h, _ = ggnn_step(h, edges, *params, **variant)
    return h
