"""The GGNN step on Hopper, forward and backward: the wrappers of
`csrc/ggnn_step.cu` and `csrc/ggnn_bwd.cu`, their plain PyTorch
versions, the `GgnnStep` autograd Function and `ggnn_propagate`, the
port of the reference's `deepdfa_tpu/nn/ggnn_kernel.py` (fp32, per
step).

One step computes, for every node v of the padded batch,

    a_v  = sum_t sum_{e: dst_e = v} w_{t,e} * (h_{src_e} @ Wm_t + bm_t)
    h'_v = GRU(a_v, h_v)

with w_{t,e} = edge_mask_e * [edge_type_e == t]. Its backward, as the
reference's `_step_bwd` splits it:

    B3 `gru_bwd`: the GRU's backward from the saved (h, a) -> da,
       dh_gru and the GRU's four parameter cotangents;
    B4 `dmsg`: the transposed message, dh_msg_u = sum over the edges
       leaving u of w * (da_dst @ Wm_t^T);
    then dWm_t = sum_e w * h_src^T da_dst and dbm_t = sum_e w * da_dst as
    an index_select and a matmul (the reference's einsums).

Each wrapper (`ggnn_step`, `gru_bwd`, `dmsg`) launches its CUDA kernel
for tensors on a CUDA device and runs its plain PyTorch version for
tensors on the CPU; there is no other route and no fallback from one to
the other. `LAUNCHES`, `GRU_BWD_LAUNCHES` and `DMSG_LAUNCHES` count
kernel launches.

The forward aggregates sum(w * h) and sum(w) per node first and applies
Wm_t, bm_t once per node; B4 applies Wm_t^T once per node before the
edge sums. Both are reassociations of the reference's per-edge
transform, covered by the fp32 tolerances of the tests. Weights keep
the reference's [in, out] layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch
from torch.autograd.function import once_differentiable

from deepdfa_tpu_torch.nn import cuda_build

#: kernel launches since the process started (or since a caller reset
#: them); each is counted where its kernel is launched and nowhere else
LAUNCHES = 0  # ggnn_step (forward)
GRU_BWD_LAUNCHES = 0  # gru_bwd (B3)
DMSG_LAUNCHES = 0  # dmsg (B4)
_launch_lock = threading.Lock()

#: nodes per thread block and the widest d the kernels take
#: (csrc/ggnn_step.cu: kTileNodes, the GGNN_CASE list)
NODE_TILE = 64
MAX_WIDTH = 256


def block_sizes(node_budget: int) -> tuple[int, int]:
    """(nodes per thread block, thread blocks) of one step launch.

    The reference tiled nodes and edges into VMEM blocks; here the node
    tile is fixed by the kernel (one warp per 8 nodes, 8 warps) and
    edges are not blocked at all — each node walks its own CSR run."""
    return NODE_TILE, -(-int(node_budget) // NODE_TILE)


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


def ggnn_step_plain(h, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh):
    """The forward kernel's function in plain PyTorch: (h', a)."""
    src = edges.src.long()
    dst = edges.dst.long()
    n = h.shape[0]
    a = torch.zeros_like(h)
    for t in range(wm.shape[0]):
        wt = edges.w2[t].to(h.dtype)
        s = torch.zeros_like(h).index_add_(0, dst, h[src] * wt[:, None])
        c = torch.zeros(n, dtype=h.dtype, device=h.device).index_add_(0, dst, wt)
        a = a + (s @ wm[t] + c[:, None] * bm[t])
    return gru_cell(a, h, wih, whh, bih, bhh), a


def gru_bwd_plain(h, a, wih, whh, bih, bhh, g):
    """B3's function in plain PyTorch, step by step as the reference's
    `_gru_bwd_kernel`: (da, dh_gru, dwih, dwhh, dbih, dbhh)."""
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
    return da, dh, a.T @ dgx, h.T @ dgh, dgx.sum(0), dgh.sum(0)


def dmsg_plain(da, edges: EdgeIndex, wm):
    """B4's function in plain PyTorch: dh_msg [N, d], the reference's
    `segment_sum(_dmsg_call(...), src_sorted)` with Wm_t^T applied once
    per node (q_t = da @ Wm_t^T) before the edge sums."""
    srcp = edges.srcp.long()
    dstp = edges.dstp.long()
    out = torch.zeros_like(da)
    for t in range(wm.shape[0]):
        q = da @ wm[t].T
        out.index_add_(0, srcp, q[dstp] * edges.wp[t].to(da.dtype)[:, None])
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
            lib.ggnn_step_f32.argtypes = [p] * 12 + [i] * 4 + [p]
            lib.ggnn_step_f32.restype = i
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
            lib.ggnn_gru_bwd_f32.argtypes = [p] * 13 + [i] * 2 + [p]
            lib.ggnn_gru_bwd_f32.restype = i
            lib.ggnn_gru_bwd_workspace_floats.argtypes = [i, i]
            lib.ggnn_gru_bwd_workspace_floats.restype = ll
            lib.ggnn_gru_bwd_splits.argtypes = [i]
            lib.ggnn_gru_bwd_splits.restype = i
            lib.ggnn_dmsg_f32.argtypes = [p] * 7 + [i] * 4 + [p]
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


def ggnn_step(h, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh,
              *, with_aggregate: bool = False):
    """One GGNN step: (h', a) with a None unless `with_aggregate`.

    CPU tensors run `ggnn_step_plain`; CUDA tensors launch the kernel on
    the current stream or raise."""
    global LAUNCHES
    if not _on_cuda("ggnn_step", h.device):
        h_new, a = ggnn_step_plain(h, edges, wm, bm, wih, whh, bih, bhh)
        return h_new, (a if with_aggregate else None)
    n, d = h.shape
    t = wm.shape[0]
    e = edges.src.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_args("ggnn_step", h.device, {
        "h": (h, f32, (n, d)), "src": (edges.src, i32, (e,)),
        "w2": (edges.w2, f32, (t, e)), "rowptr": (edges.rowptr, i32, (n + 1,)),
        "wm": (wm, f32, (t, d, d)), "bm": (bm, f32, (t, d)),
        "wih": (wih, f32, (d, 3 * d)), "whh": (whh, f32, (d, 3 * d)),
        "bih": (bih, f32, (3 * d,)), "bhh": (bhh, f32, (3 * d,)),
    })
    _check_shape("ggnn_step", n, e, d, t)
    lib = _library("ggnn_step")
    h_out = torch.empty_like(h)
    a_out = torch.empty_like(h) if with_aggregate else None
    with torch.cuda.device(h.device):
        rc = lib.ggnn_step_f32(
            h.data_ptr(), edges.src.data_ptr(), edges.w2.data_ptr(),
            edges.rowptr.data_ptr(), wm.data_ptr(), bm.data_ptr(),
            wih.data_ptr(), whh.data_ptr(), bih.data_ptr(), bhh.data_ptr(),
            h_out.data_ptr(), None if a_out is None else a_out.data_ptr(),
            n, e, d, t, _stream(h.device),
        )
    _raise_on(rc, "ggnn_step", lib, "ggnn_cuda_error_string")
    with _launch_lock:
        LAUNCHES += 1
    return h_out, a_out


def gru_bwd(h, a, wih, whh, bih, bhh, g):
    """B3: (da, dh_gru, dwih, dwhh, dbih, dbhh) of one step's GRU.

    CPU tensors run `gru_bwd_plain`; CUDA tensors launch the kernel (its
    node pass, split-K weight pass and fixed-order reduce) on the
    current stream or raise."""
    global GRU_BWD_LAUNCHES
    if not _on_cuda("gru_bwd", h.device):
        return gru_bwd_plain(h, a, wih, whh, bih, bhh, g)
    n, d = h.shape
    f32 = torch.float32
    _check_args("gru_bwd", h.device, {
        "h": (h, f32, (n, d)), "a": (a, f32, (n, d)), "g": (g, f32, (n, d)),
        "wih": (wih, f32, (d, 3 * d)), "whh": (whh, f32, (d, 3 * d)),
        "bih": (bih, f32, (3 * d,)), "bhh": (bhh, f32, (3 * d,)),
    })
    _check_shape("gru_bwd", n, 1, d, 1)
    lib = _library("ggnn_bwd")
    wih_t = wih.T.contiguous()
    whh_t = whh.T.contiguous()
    da = torch.empty_like(h)
    dh = torch.empty_like(h)
    grads = torch.empty(2 * d * 3 * d + 2 * 3 * d, dtype=f32, device=h.device)
    work = torch.empty(lib.ggnn_gru_bwd_workspace_floats(n, d), dtype=f32, device=h.device)
    with torch.cuda.device(h.device):
        rc = lib.ggnn_gru_bwd_f32(
            h.data_ptr(), a.data_ptr(), g.data_ptr(), wih.data_ptr(),
            whh.data_ptr(), bih.data_ptr(), bhh.data_ptr(), wih_t.data_ptr(),
            whh_t.data_ptr(), da.data_ptr(), dh.data_ptr(), grads.data_ptr(),
            work.data_ptr(), n, d, _stream(h.device),
        )
    _raise_on(rc, "gru_bwd", lib, "ggnn_bwd_error_string")
    with _launch_lock:
        GRU_BWD_LAUNCHES += 1
    w = d * 3 * d
    return (da, dh, grads[:w].view(d, 3 * d), grads[w:2 * w].view(d, 3 * d),
            grads[2 * w:2 * w + 3 * d], grads[2 * w + 3 * d:])


def dmsg(da, edges: EdgeIndex, wm):
    """B4: dh_msg [N, d], the transposed message summed by src.

    CPU tensors run `dmsg_plain`; CUDA tensors launch the kernel (the
    per-node transform, then the src-CSR run sums) on the current
    stream or raise. `edges` needs the src-sorted layout."""
    global DMSG_LAUNCHES
    if edges.srcptr is None:
        raise ValueError("dmsg needs prepare_edges(..., transpose=True)")
    if not _on_cuda("dmsg", da.device):
        return dmsg_plain(da, edges, wm)
    n, d = da.shape
    t = wm.shape[0]
    e = edges.dstp.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check_args("dmsg", da.device, {
        "da": (da, f32, (n, d)), "wm": (wm, f32, (t, d, d)),
        "dstp": (edges.dstp, i32, (e,)), "wp": (edges.wp, f32, (t, e)),
        "srcptr": (edges.srcptr, i32, (n + 1,)),
    })
    _check_shape("dmsg", n, e, d, t)
    lib = _library("ggnn_bwd")
    wm_t = wm.transpose(1, 2).contiguous()
    out = torch.empty_like(da)
    q = torch.empty((t, n, d), dtype=f32, device=da.device)
    with torch.cuda.device(da.device):
        rc = lib.ggnn_dmsg_f32(
            da.data_ptr(), wm_t.data_ptr(), edges.dstp.data_ptr(),
            edges.wp.data_ptr(), edges.srcptr.data_ptr(), out.data_ptr(),
            q.data_ptr(), n, e, d, t, _stream(da.device),
        )
    _raise_on(rc, "dmsg", lib, "ggnn_bwd_error_string")
    with _launch_lock:
        DMSG_LAUNCHES += 1
    return out


class GgnnStep(torch.autograd.Function):
    """One differentiable GGNN step (the reference's `_step` custom_vjp).

    forward: the step kernel with its aggregate, saving (h, a);
    backward: B3, then B4, then the message weights' cotangents. The
    edge tensors (`EdgeIndex.tensors()`, src-sorted layout included) are
    passed one by one, take no gradient and must not require one."""

    @staticmethod
    def forward(ctx, h, wm, bm, wih, whh, bih, bhh, *edge_tensors):
        edges = EdgeIndex(*edge_tensors)
        if edges.srcptr is None:
            raise ValueError("GgnnStep needs prepare_edges(..., transpose=True)")
        if any(x.requires_grad for x in edge_tensors):
            raise ValueError("GgnnStep: edge tensors take no gradient")
        h_new, a = ggnn_step(h, edges, wm, bm, wih, whh, bih, bhh, with_aggregate=True)
        ctx.save_for_backward(h, a, wm, wih, whh, bih, bhh, *edge_tensors)
        return h_new

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        h, a, wm, wih, whh, bih, bhh, *edge_tensors = ctx.saved_tensors
        edges = EdgeIndex(*edge_tensors)
        da, dh, dwih, dwhh, dbih, dbhh = gru_bwd(h, a, wih, whh, bih, bhh, g.contiguous())
        dh = dh + dmsg(da, edges, wm)
        dwm, dbm = msg_weight_grads(h, da, edges)
        return (dh, dwm, dbm, dwih, dwhh, dbih, dbhh) + (None,) * len(edge_tensors)


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
) -> torch.Tensor:
    """Run `n_steps` GGNN steps; the edge preprocessing is done once and
    shared by all of them and by the backward. With gradients enabled
    and any input requiring one, each step is a `GgnnStep`; otherwise
    (inference_mode, no_grad) each step is one launch without the
    aggregate."""
    if n_steps == 0:
        return feat
    params = [x.to(torch.float32).contiguous() for x in (wm, bm, wih, whh, bih, bhh)]
    h = feat.to(torch.float32).contiguous()
    train = torch.is_grad_enabled() and any(x.requires_grad for x in (*params, h))
    edges = prepare_edges(edge_src, edge_dst, edge_mask, edge_type, feat.shape[0],
                          n_etypes, transpose=train)
    for _ in range(n_steps):
        if train:
            h = GgnnStep.apply(h, *params, *edges.tensors())
        else:
            h, _ = ggnn_step(h, edges, *params)
    return h
