"""The GGNN step on Hopper: the wrapper of `csrc/ggnn_step.cu`, its plain
PyTorch version, and `ggnn_propagate`, the port of the reference's
`deepdfa_tpu/nn/ggnn_kernel.py:ggnn_propagate` (fp32, per step).

One step computes, for every node v of the padded batch,

    a_v  = sum_t sum_{e: dst_e = v} w_{t,e} * (h_{src_e} @ Wm_t + bm_t)
    h'_v = GRU(a_v, h_v)

with w_{t,e} = edge_mask_e * [edge_type_e == t]. `ggnn_step` launches
the CUDA kernel for tensors on a CUDA device and runs
`ggnn_step_plain` for tensors on the CPU; there is no other route and no
fallback from one to the other. `LAUNCHES` counts kernel launches.

Both versions aggregate sum(w * h_src) and sum(w) per node first and
apply Wm_t, bm_t once per node — a reassociation of the reference's
per-edge transform, covered by the fp32 tolerances of the tests.
Weights keep the reference's [in, out] layout.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from deepdfa_tpu_torch.nn import cuda_build

#: kernel launches since the process started (or since a caller reset
#: it); counted where the kernel is launched and nowhere else
LAUNCHES = 0
_launch_lock = threading.Lock()

#: nodes per thread block and the widest d the kernel takes
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
    """Can the CUDA kernel take this problem? d must be a multiple of 32
    (one column per lane) and at most MAX_WIDTH; indices are int32."""
    if min(node_budget, edge_budget, d, n_etypes) <= 0:
        return False
    if d % 32 or d > MAX_WIDTH:
        return False
    return n_etypes * edge_budget < 2**31 and node_budget < 2**31 - 1


@dataclasses.dataclass(frozen=True)
class EdgeIndex:
    """Per-batch edge preprocessing, shared by every step."""

    src: torch.Tensor  # [E] int32
    dst: torch.Tensor  # [E] int32 (plain version)
    w2: torch.Tensor  # [T, E] f32: edge_mask * [edge_type == t]
    rowptr: torch.Tensor  # [N + 1] int32 CSR row pointer over live edges


def prepare_edges(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_mask: torch.Tensor,
    edge_type: torch.Tensor | None,
    n: int,
    n_etypes: int = 1,
) -> EdgeIndex:
    """Per-type edge weights and the CSR row pointer, on the edges'
    device, with no host sync.

    Live edges are a dst-sorted prefix (graphs/batch.py), so keying
    every masked edge as node `n` keeps the key sorted; a search for
    0..n then gives each node's run, and rowptr[n] is the live edge
    count. The padded edges, all pointed at node n-1, never enter a row:
    a one-graph batch in a large edge budget would otherwise hand one
    node a run of tens of thousands of dead edges."""
    w = edge_mask.to(torch.float32)
    if n_etypes == 1:
        w2 = w[None]
    else:
        if edge_type is None:
            raise ValueError(f"n_etypes={n_etypes} needs edge_type")
        w2 = torch.stack(
            [w * (edge_type == t).to(torch.float32) for t in range(n_etypes)]
        )
    src = edge_src.to(torch.int32).contiguous()
    dst = edge_dst.to(torch.int32).contiguous()
    key = torch.where(edge_mask, dst, torch.full_like(dst, n))
    nodes = torch.arange(n + 1, device=dst.device, dtype=torch.int32)
    rowptr = torch.searchsorted(key, nodes, out_int32=True)
    return EdgeIndex(src=src, dst=dst, w2=w2.contiguous(), rowptr=rowptr)


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
    """The kernel's function in plain PyTorch: (h', a)."""
    src = edges.src.long()
    dst = edges.dst.long()
    n = h.shape[0]
    a = torch.zeros_like(h)
    for t in range(wm.shape[0]):
        wt = edges.w2[t]
        s = torch.zeros_like(h).index_add_(0, dst, h[src] * wt[:, None])
        c = torch.zeros(n, dtype=h.dtype, device=h.device).index_add_(0, dst, wt)
        a = a + (s @ wm[t] + c[:, None] * bm[t])
    return gru_cell(a, h, wih, whh, bih, bhh), a


_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load("ggnn_step")
            p, i = ctypes.c_void_p, ctypes.c_int
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
            _lib = lib
        return _lib


def _check_cuda_args(h, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh) -> None:
    n, d = h.shape
    t = wm.shape[0]
    e = edges.src.shape[0]
    want = {
        "h": (h, torch.float32, (n, d)),
        "src": (edges.src, torch.int32, (e,)),
        "w2": (edges.w2, torch.float32, (t, e)),
        "rowptr": (edges.rowptr, torch.int32, (n + 1,)),
        "wm": (wm, torch.float32, (t, d, d)),
        "bm": (bm, torch.float32, (t, d)),
        "wih": (wih, torch.float32, (d, 3 * d)),
        "whh": (whh, torch.float32, (d, 3 * d)),
        "bih": (bih, torch.float32, (3 * d,)),
        "bhh": (bhh, torch.float32, (3 * d,)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != h.device:
            raise ValueError(f"ggnn_step: {name} is on {x.device}, h on {h.device}")
        if x.dtype != dtype:
            raise TypeError(f"ggnn_step: {name} is {x.dtype}, needs {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"ggnn_step: {name} has shape {tuple(x.shape)}, needs {shape}")
        if not x.is_contiguous():
            raise ValueError(f"ggnn_step: {name} must be contiguous")
    if not kernel_shape_ok(n, e, d, t):
        raise ValueError(
            f"ggnn_step: the CUDA kernel takes d a multiple of 32 up to "
            f"{MAX_WIDTH} with int32 indices; got n={n}, e={e}, d={d}, "
            f"n_etypes={t}"
        )
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (h, wm, bm, wih, whh, bih, bhh)
    ):
        raise RuntimeError(
            "ggnn_step: the CUDA kernel has no backward yet (the training "
            "slice of the port adds it); run under torch.inference_mode()"
        )


def ggnn_step(h, edges: EdgeIndex, wm, bm, wih, whh, bih, bhh,
              *, with_aggregate: bool = False):
    """One GGNN step: (h', a) with a None unless `with_aggregate`.

    CPU tensors run `ggnn_step_plain`; CUDA tensors launch the kernel on
    the current stream or raise."""
    global LAUNCHES
    if h.device.type == "cpu":
        h_new, a = ggnn_step_plain(h, edges, wm, bm, wih, whh, bih, bhh)
        return h_new, (a if with_aggregate else None)
    if h.device.type != "cuda":
        raise ValueError(f"ggnn_step runs on cuda or cpu, not {h.device}")
    _check_cuda_args(h, edges, wm, bm, wih, whh, bih, bhh)
    lib = _library()
    n, d = h.shape
    h_out = torch.empty_like(h)
    a_out = torch.empty_like(h) if with_aggregate else None
    with torch.cuda.device(h.device):
        rc = lib.ggnn_step_f32(
            h.data_ptr(), edges.src.data_ptr(), edges.w2.data_ptr(),
            edges.rowptr.data_ptr(), wm.data_ptr(), bm.data_ptr(),
            wih.data_ptr(), whh.data_ptr(), bih.data_ptr(), bhh.data_ptr(),
            h_out.data_ptr(), None if a_out is None else a_out.data_ptr(),
            n, edges.src.shape[0], d, wm.shape[0],
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ggnn_step kernel launch failed: "
            f"{lib.ggnn_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    with _launch_lock:
        LAUNCHES += 1
    return h_out, a_out


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
    shared by all of them."""
    if n_steps == 0:
        return feat
    n = feat.shape[0]
    edges = prepare_edges(edge_src, edge_dst, edge_mask, edge_type, n, n_etypes)
    params = [x.to(torch.float32).contiguous() for x in (wm, bm, wih, whh, bih, bhh)]
    h = feat.to(torch.float32).contiguous()
    for _ in range(n_steps):
        h, _ = ggnn_step(h, edges, *params)
    return h
