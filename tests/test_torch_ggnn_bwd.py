"""The backward of the port's GGNN step (deepdfa_tpu_torch/nn/ggnn_kernel.py)
against the reference.

On the CPU the port's backward runs the plain versions of its two
kernels: `gru_bwd_plain` (B3) and `dmsg_plain` (B4). They are held
against the reference's Pallas kernels `_gru_bwd_call` and
`_dmsg_call` + the sorted `segment_sum` by src, run with
interpret="legacy" as tests/test_ggnn_kernel.py runs them; and the VJP
of the port's `ggnn_propagate` (each step a `GgnnStep`) is held against
`jax.vjp` of the reference's `ggnn_propagate(..., interpret="legacy",
scatter="fold")` and of its lax `GatedGraphConv`, across the serve
ladder (1, 2, 4 and the all-padding batch), a single-node graph and
n_etypes 1 and 3.

Tolerances. B3 alone: fp32 rtol 1e-5, atol 1e-5 (the same products in
another summation order). B4 and the 5-step VJP: each cotangent within
1e-5 of its own largest magnitude (max |port - ref| / max |ref|), since
the port applies Wm_t^T per node before the edge sums and cotangents
grow through 5 steps; measured ~1e-6. float64 `gradcheck` holds the
decomposition itself at a tiny size.

The CUDA kernels run only on a card: tests/test_torch_cuda.py holds them
against these plain versions there.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.graphs import GraphSpec as JSpec, pack as jpack  # noqa: E402
from deepdfa_tpu.nn import GatedGraphConv as JConv  # noqa: E402
from deepdfa_tpu.nn import ggnn_kernel as jgk  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, pack as tpack  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as tgk  # noqa: E402

RTOL = ATOL = 1e-5
REL = 1e-5  # max |port - ref| / max |ref| per cotangent
N_STEPS = 5
NODE_BUDGET, EDGE_BUDGET = 512, 2048
WEIGHTS = ("wm", "bm", "wih", "whh", "bih", "bhh")


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


def _ladder(rung, n_etypes):
    rng = np.random.default_rng(11)
    if rung == "1_single_node":
        kw = dict(
            graph_id=0, node_feats=np.zeros((1, 4), np.int32),
            node_vuln=np.zeros((1,), np.int32), edge_src=np.zeros((0,), np.int32),
            edge_dst=np.zeros((0,), np.int32), label=1.0,
            edge_type=np.zeros((0,), np.int32) if n_etypes > 1 else None,
        )
        return 1, [JSpec(**kw)], [TSpec(**kw)]
    if rung == "2_all_padding":
        return 2, [], []
    size = int(rung[0])
    return (size, *_graphs(rng, size, n_etypes))


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


def _from_flax_grads(gp, n_etypes):
    p = gp["params"]
    gru = p["GRUCell_0"]
    return dict(
        wm=np.stack([np.asarray(p[f"etype_{t}"]["kernel"]) for t in range(n_etypes)]),
        bm=np.stack([np.asarray(p[f"etype_{t}"]["bias"]) for t in range(n_etypes)]),
        wih=np.asarray(gru["input_proj"]["kernel"]),
        whh=np.asarray(gru["hidden_proj"]["kernel"]),
        bih=np.asarray(gru["input_proj"]["bias"]),
        bhh=np.asarray(gru["hidden_proj"]["bias"]),
    )


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-6)


def _kernel_params(d, n_etypes, n, e):
    block_n, block_e = jgk.block_sizes(n, e)
    return jgk._Params(n=n, e=e, d=d, block_n=block_n, block_e=block_e,
                       n_etypes=n_etypes, accum="fp32", scatter="fold",
                       interpret="legacy")


@pytest.mark.parametrize("n, d", [(64, 32), (256, 128)], ids=["n64_d32", "n256_d128"])
def test_gru_bwd_plain_matches_reference_kernel(n, d):
    rng = np.random.default_rng(n + d)
    w = _weights(rng, d, 1)
    h, a, g = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(3))
    p = _kernel_params(d, 1, n, 4 * n)
    want = jgk._gru_bwd_call(p, h, a, w["wih"], w["whh"], w["bih"][None], w["bhh"][None], g)
    t = {k: torch.from_numpy(w[k]) for k in ("wih", "whh", "bih", "bhh")}
    got = tgk.gru_bwd_plain(torch.from_numpy(h), torch.from_numpy(a), t["wih"], t["whh"],
                            t["bih"], t["bhh"], torch.from_numpy(g))
    names = ("da", "dh", "dwih", "dwhh", "dbih", "dbhh")
    for name, x, y in zip(names, got, want):
        y = np.asarray(y).reshape(x.shape)
        np.testing.assert_allclose(x.numpy(), y, rtol=RTOL, atol=ATOL * max(1.0, np.abs(y).max()),
                                   err_msg=name)


@pytest.mark.parametrize("n_etypes", [1, 3])
@pytest.mark.parametrize("rung", ["1_single_node", "2_all_padding", "4_graphs"])
def test_dmsg_plain_matches_reference_kernel(rung, n_etypes):
    size, ref, port = _ladder(rung, n_etypes)
    etypes = n_etypes > 1
    jb = jpack(ref, size, NODE_BUDGET, EDGE_BUDGET, etypes=etypes)
    tb = tpack(port, size, NODE_BUDGET, EDGE_BUDGET, etypes=etypes).to("cpu")
    rng = np.random.default_rng(5 + n_etypes)
    d = 32
    wm = _weights(rng, d, n_etypes)["wm"]
    da = rng.standard_normal((NODE_BUDGET, d)).astype(np.float32)
    # the reference's own layout (_step_bwd's operands, ggnn_propagate)
    p = _kernel_params(d, n_etypes, NODE_BUDGET, EDGE_BUDGET)
    w = jb.edge_mask.astype(np.float32)
    w2 = (np.stack([w * (jb.edge_type == t) for t in range(n_etypes)]) if etypes
          else w[None]).astype(np.float32)
    perm = np.argsort(jb.edge_src, kind="stable")
    dmsg = jgk._dmsg_call(
        p, da, jb.edge_dst[perm].reshape(p.n_eb, p.block_e),
        w2[:, perm].reshape(n_etypes, p.n_eb, p.block_e), wm,
    )
    want = jax.ops.segment_sum(dmsg, jb.edge_src[perm], num_segments=NODE_BUDGET,
                               indices_are_sorted=True)
    edges = tgk.prepare_edges(tb.edge_src, tb.edge_dst, tb.edge_mask, tb.edge_type,
                              NODE_BUDGET, n_etypes, transpose=True)
    got = tgk.dmsg(torch.from_numpy(da), edges, torch.from_numpy(wm)).numpy()
    assert _rel(got, want) <= REL


@functools.lru_cache(maxsize=None)
def _jax_vjps(n_etypes):
    """jitted (kernel vjp, lax vjp) of N_STEPS steps for one type count."""

    def kernel(w, feat, b, g):
        def f(w, feat):
            return jgk.ggnn_propagate(
                w["wm"], w["bm"], w["wih"], w["whh"], w["bih"], w["bhh"], feat,
                b.edge_src, b.edge_dst, b.edge_mask, b.edge_type,
                n_steps=N_STEPS, n_etypes=n_etypes, interpret="legacy", scatter="fold",
            )
        return jax.vjp(f, w, feat)[1](g)

    conv = JConv(out_features=32, n_steps=N_STEPS, n_etypes=n_etypes)

    def lax(params, feat, b, g):
        return jax.vjp(lambda p, x: conv.apply(p, b, x), params, feat)[1](g)

    return jax.jit(kernel), jax.jit(lax)


@pytest.mark.parametrize("n_etypes", [1, 3])
@pytest.mark.parametrize("rung", ["1_single_node", "2_graphs", "2_all_padding", "4_graphs"])
def test_step_vjp_matches_reference(rung, n_etypes):
    size, ref, port = _ladder(rung, n_etypes)
    etypes = n_etypes > 1
    jb = jpack(ref, size, NODE_BUDGET, EDGE_BUDGET, etypes=etypes)
    tb = tpack(port, size, NODE_BUDGET, EDGE_BUDGET, etypes=etypes).to("cpu")
    rng = np.random.default_rng(size + 10 * n_etypes)
    w = _weights(rng, 32, n_etypes)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    g = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)

    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tf = torch.from_numpy(feat).requires_grad_()
    out = tgk.ggnn_propagate(
        *(tw[k] for k in WEIGHTS), tf, tb.edge_src, tb.edge_dst, tb.edge_mask,
        tb.edge_type, n_steps=N_STEPS, n_etypes=n_etypes,
    )
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    got = {k: tw[k].grad.numpy() for k in WEIGHTS} | {"feat": tf.grad.numpy()}

    f_kernel, f_lax = _jax_vjps(n_etypes)
    kw, kfeat = f_kernel(w, feat, jb, jnp.asarray(g))
    lp, lfeat = f_lax(_flax_params(w), feat, jb, jnp.asarray(g))
    for label, want in (("kernel", kw | {"feat": kfeat}),
                        ("lax", _from_flax_grads(lp, n_etypes) | {"feat": lfeat})):
        for k, v in got.items():
            assert np.isfinite(v).all()
            assert _rel(v, want[k]) <= REL, f"{k} vs the {label} path: {_rel(v, want[k])}"


def test_gradcheck_float64():
    """float64 gradcheck of one GgnnStep on the plain path: the
    decomposition B3 + B4 + the message weight cotangents is the step's
    exact derivative."""
    rng = np.random.default_rng(0)
    specs = [TSpec(graph_id=i, node_feats=np.zeros((n, 4), np.int32),
                   node_vuln=np.zeros((n,), np.int32),
                   edge_src=rng.integers(0, n, 2 * n).astype(np.int32),
                   edge_dst=rng.integers(0, n, 2 * n).astype(np.int32),
                   edge_type=rng.integers(0, 2, 2 * n).astype(np.int32), label=0.0)
             for i, n in enumerate((5, 7))]
    b = tpack(specs, 2, 16, 64).to("cpu")
    edges = tgk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, 16, 2,
                              transpose=True)
    edge_tensors = [x.double() if x.is_floating_point() else x for x in edges.tensors()]
    gen = torch.Generator().manual_seed(0)
    d = 4
    shapes = ((16, d), (2, d, d), (2, d), (d, 3 * d), (d, 3 * d), (3 * d,), (3 * d,))
    args = [(torch.randn(s, dtype=torch.float64, generator=gen) * 0.5).requires_grad_()
            for s in shapes]
    assert torch.autograd.gradcheck(
        lambda *a: tgk.GgnnStep.apply("fp32", "fold", 0, *a, *edge_tensors), args
    )


def test_src_sorted_layout_covers_the_live_prefix_only():
    rng = np.random.default_rng(9)
    _, port = _graphs(rng, 3, 1)
    b = tpack(port, 4, 256, 1024).to("cpu")
    n = b.node_budget
    edges = tgk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, None, n, transpose=True)
    live = int(b.edge_mask.sum())
    srcptr = edges.srcptr.numpy()
    assert edges.srcptr.dtype == torch.int32 and srcptr[0] == 0 and srcptr[-1] == live
    srcp, dstp = edges.srcp.numpy(), edges.dstp.numpy()
    for u in range(n):
        assert np.all(srcp[srcptr[u]:srcptr[u + 1]] == u)
    # the live edges keep their (dst-sorted) order inside each src run,
    # and the padded edges, all from node n-1, sit past srcptr[n]
    assert sorted(zip(srcp[:live], dstp[:live])) == list(zip(srcp[:live], dstp[:live]))
    assert srcptr[n] - srcptr[n - 1] == 0 and not edges.wp.numpy()[0, live:].any()
    assert tgk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, None, n).srcptr is None


def test_inference_keeps_the_forward_only_route():
    """Under inference_mode (and no_grad) ggnn_propagate builds no
    backward; with gradients it goes through GgnnStep."""
    rng = np.random.default_rng(2)
    _, port = _graphs(rng, 2, 1)
    b = tpack(port, 2, 128, 512).to("cpu")
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in _weights(rng, 32, 1).items()}
    feat = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    args = (*(w[k] for k in WEIGHTS), feat, b.edge_src, b.edge_dst, b.edge_mask, None)
    with torch.inference_mode():
        h_inf = tgk.ggnn_propagate(*args, n_steps=3)
    with torch.no_grad():
        h_ng = tgk.ggnn_propagate(*args, n_steps=3)
    h = tgk.ggnn_propagate(*args, n_steps=3)
    assert h_inf.grad_fn is None and h_ng.grad_fn is None
    assert type(h.grad_fn).__name__ == "GgnnStepBackward"
    assert torch.equal(h.detach(), h_ng) and torch.equal(h_ng, h_inf)
