"""The port's GGNN step (deepdfa_tpu_torch/nn/ggnn_kernel.py) against
the reference.

On the CPU the port's `ggnn_propagate` runs the kernel's plain PyTorch
version. It is held against the reference's per-step Pallas kernel
(interpret="legacy", scatter="fold", as tests/test_ggnn_kernel.py runs
it) and against the reference's lax `GatedGraphConv`, across the serve
ladder (1, 2, 4 and the all-padding batch), a single-node graph and
n_etypes 1 and 3. Tolerance: fp32 rtol 1e-5, atol 1e-5 — the two
frameworks sum in different orders (the port aggregates sum(w * h)
before applying the message transform), so only reassociation-level
agreement is expected, never bits.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py
holds it against this plain version there.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.graphs import GraphSpec as JSpec, pack as jpack  # noqa: E402
from deepdfa_tpu.nn import GatedGraphConv as JConv  # noqa: E402
from deepdfa_tpu.nn import ggnn_kernel as jgk  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, pack as tpack  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as tgk  # noqa: E402

RTOL = ATOL = 1e-5  # fp32, cross-framework reassociation
N_STEPS = 5


def _graphs(rng, count, n_etypes, max_nodes=40):
    ref, port = [], []
    for gid in range(count):
        n = int(rng.integers(2, max_nodes))
        e = int(rng.integers(1, 3 * n))
        kw = dict(
            graph_id=gid,
            node_feats=rng.integers(0, 5, (n, 4)).astype(np.int32),
            node_vuln=np.zeros((n,), np.int32),
            edge_src=rng.integers(0, n, (e,)).astype(np.int32),
            edge_dst=rng.integers(0, n, (e,)).astype(np.int32),
            label=float(gid % 2),
            edge_type=(
                rng.integers(0, n_etypes, (e,)).astype(np.int32)
                if n_etypes > 1 else None
            ),
        )
        ref.append(JSpec(**kw))
        port.append(TSpec(**kw))
    return ref, port


def _single_node(n_etypes):
    kw = dict(
        graph_id=0,
        node_feats=np.zeros((1, 4), np.int32),
        node_vuln=np.zeros((1,), np.int32),
        edge_src=np.zeros((0,), np.int32),
        edge_dst=np.zeros((0,), np.int32),
        label=1.0,
        edge_type=np.zeros((0,), np.int32) if n_etypes > 1 else None,
    )
    return [JSpec(**kw)], [TSpec(**kw)]


def _weights(rng, d, n_etypes):
    s = d ** -0.5
    return dict(
        wm=(rng.standard_normal((n_etypes, d, d)) * s).astype(np.float32),
        bm=(rng.standard_normal((n_etypes, d)) * 0.1).astype(np.float32),
        wih=(rng.standard_normal((d, 3 * d)) * s).astype(np.float32),
        whh=(rng.standard_normal((d, 3 * d)) * s).astype(np.float32),
        bih=(rng.standard_normal((3 * d,)) * 0.1).astype(np.float32),
        bhh=(rng.standard_normal((3 * d,)) * 0.1).astype(np.float32),
    )


def _flax_params(w):
    params = {
        f"etype_{t}": {"kernel": w["wm"][t], "bias": w["bm"][t]}
        for t in range(w["wm"].shape[0])
    }
    params["GRUCell_0"] = {
        "input_proj": {"kernel": w["wih"], "bias": w["bih"]},
        "hidden_proj": {"kernel": w["whh"], "bias": w["bhh"]},
    }
    return {"params": params}


@functools.lru_cache(maxsize=None)
def _jax_fns(d, n_etypes):
    """(Pallas per-step kernel in interpret mode, lax GatedGraphConv),
    jitted once per width and type count."""

    def kernel(w, b, feat):
        return jgk.ggnn_propagate(
            w["wm"], w["bm"], w["wih"], w["whh"], w["bih"], w["bhh"], feat,
            b.edge_src, b.edge_dst, b.edge_mask, b.edge_type,
            n_steps=N_STEPS, n_etypes=n_etypes,
            interpret="legacy", scatter="fold",
        )

    conv = JConv(out_features=d, n_steps=N_STEPS, n_etypes=n_etypes)
    return jax.jit(kernel), jax.jit(conv.apply)


def _port(w, batch, feat, n_etypes):
    b = batch.to("cpu")
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    return tgk.ggnn_propagate(
        t["wm"], t["bm"], t["wih"], t["whh"], t["bih"], t["bhh"],
        torch.from_numpy(feat), b.edge_src, b.edge_dst, b.edge_mask,
        b.edge_type, n_steps=N_STEPS, n_etypes=n_etypes,
    ).numpy()


def _check(ref_graphs, port_graphs, size, node_budget, edge_budget, d, n_etypes, seed):
    rng = np.random.default_rng(seed)
    etypes = n_etypes > 1
    jbatch = jpack(ref_graphs, size, node_budget, edge_budget, etypes=etypes)
    tbatch = tpack(port_graphs, size, node_budget, edge_budget, etypes=etypes)
    w = _weights(rng, d, n_etypes)
    feat = rng.standard_normal((node_budget, d)).astype(np.float32)
    got = _port(w, tbatch, feat, n_etypes)
    f_kernel, f_lax = _jax_fns(d, n_etypes)
    want_kernel = np.asarray(f_kernel(w, jbatch, feat))
    want_lax = np.asarray(f_lax(_flax_params(w), jbatch, feat))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL,
                               err_msg="vs the Pallas per-step kernel")
    np.testing.assert_allclose(got, want_lax, rtol=RTOL, atol=ATOL,
                               err_msg="vs the lax GatedGraphConv")


@pytest.mark.parametrize("n_etypes", [1, 3])
@pytest.mark.parametrize("rung", ["1_single_node", "2_graphs", "2_all_padding", "4_graphs"])
def test_propagate_matches_reference_across_ladder(rung, n_etypes):
    rng = np.random.default_rng(11)
    size = int(rung[0])
    if rung == "1_single_node":
        ref, port = _single_node(n_etypes)
    elif rung == "2_all_padding":
        ref, port = [], []
    else:
        ref, port = _graphs(rng, size, n_etypes)
    _check(ref, port, size, 512, 2048, 32, n_etypes, seed=size + 10 * n_etypes)


def test_propagate_matches_reference_at_flagship_width():
    rng = np.random.default_rng(5)
    ref, port = _graphs(rng, 4, 1, max_nodes=60)
    _check(ref, port, 4, 256, 1024, 128, 1, seed=3)


def _exact_step(h, src, dst, w2, wm, bm, wih, whh, bih, bhh):
    """One step in float64 numpy, in the reference's per-edge order."""
    h = h.astype(np.float64)
    a = np.zeros_like(h)
    for t in range(wm.shape[0]):
        msg = (h[src] @ wm[t] + bm[t]) * w2[t][:, None]
        np.add.at(a, dst, msg)
    gx = a @ wih + bih
    gh = h @ whh + bhh
    d = h.shape[1]
    r = 1 / (1 + np.exp(-(gx[:, :d] + gh[:, :d])))
    z = 1 / (1 + np.exp(-(gx[:, d:2 * d] + gh[:, d:2 * d])))
    n = np.tanh(gx[:, 2 * d:] + r * gh[:, 2 * d:])
    return (1 - z) * n + z * h, a


@pytest.mark.parametrize("n_etypes", [1, 3])
def test_step_and_aggregate_match_float64(n_etypes):
    rng = np.random.default_rng(4)
    _, port = _graphs(rng, 3, n_etypes)
    b = tpack(port, 4, 128, 512, etypes=n_etypes > 1).to("cpu")
    w = _weights(rng, 32, n_etypes)
    h = rng.standard_normal((128, 32)).astype(np.float32)
    edges = tgk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, 128, n_etypes)
    t = [torch.from_numpy(w[k]) for k in ("wm", "bm", "wih", "whh", "bih", "bhh")]
    h_new, a = tgk.ggnn_step(torch.from_numpy(h), edges, *t, with_aggregate=True)
    want_h, want_a = _exact_step(
        h, edges.src.numpy(), edges.dst.numpy(), edges.w2.numpy().astype(np.float64),
        *(w[k].astype(np.float64) for k in ("wm", "bm", "wih", "whh", "bih", "bhh")),
    )
    np.testing.assert_allclose(h_new.numpy(), want_h, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a.numpy(), want_a, rtol=RTOL, atol=ATOL)
    _, none = tgk.ggnn_step(torch.from_numpy(h), edges, *t)
    assert none is None


def test_rowptr_covers_the_live_prefix_only():
    rng = np.random.default_rng(9)
    _, port = _graphs(rng, 3, 1)
    b = tpack(port, 4, 256, 1024).to("cpu")
    n = b.node_budget
    edges = tgk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, None, n)
    rowptr = edges.rowptr.numpy()
    live = int(b.edge_mask.sum())
    assert edges.rowptr.dtype == torch.int32 and rowptr.shape == (n + 1,)
    assert rowptr[0] == 0 and rowptr[-1] == live
    assert np.all(np.diff(rowptr) >= 0)
    dst = b.edge_dst.numpy()
    for v in range(n):
        assert np.all(dst[rowptr[v]:rowptr[v + 1]] == v)
    # padded edges all point at node n-1, yet its run holds none of them
    assert rowptr[n] - rowptr[n - 1] == 0
    empty = tpack([], 2, 256, 1024).to("cpu")
    e0 = tgk.prepare_edges(empty.edge_src, empty.edge_dst, empty.edge_mask, None, n)
    assert not e0.rowptr.any()


def test_shape_rules_and_tiling():
    assert tgk.kernel_shape_ok(16384, 65536, 128)
    assert tgk.kernel_shape_ok(16384, 65536, 128, n_etypes=3)
    for d in (32, 64, 96, 160, 224, 256):
        assert tgk.kernel_shape_ok(512, 2048, d)
    for d in (8, 48, 100, 288, 0):
        assert not tgk.kernel_shape_ok(512, 2048, d)
    assert not tgk.kernel_shape_ok(0, 2048, 128)
    assert tgk.block_sizes(16384) == (tgk.NODE_TILE, 16384 // tgk.NODE_TILE)
    assert tgk.block_sizes(100) == (tgk.NODE_TILE, 2)
    assert tgk.block_sizes(64) == (tgk.NODE_TILE, 1)


def test_step_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card gets no
    silent route: the wrapper raises."""
    h = torch.zeros(64, 32, device="meta")
    edges = tgk.EdgeIndex(
        src=torch.zeros(8, dtype=torch.int32, device="meta"),
        dst=torch.zeros(8, dtype=torch.int32, device="meta"),
        w2=torch.zeros(1, 8, device="meta"),
        rowptr=torch.zeros(65, dtype=torch.int32, device="meta"),
    )
    w = [torch.zeros(s, device="meta") for s in ((1, 32, 32), (1, 32), (32, 96), (32, 96), (96,), (96,))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgk.ggnn_step(h, edges, *w)
