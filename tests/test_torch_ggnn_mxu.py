"""The port's mxu scatter (`scatter="mxu"`, deepdfa_tpu_torch/nn/ggnn_kernel.py)
on the CPU against the reference.

The reference multiplies each 512-edge block's messages by a one-hot
block on the MXU (`_aggregate`); under int8 it first requantizes the
block's messages per column. The port's plain version sums each node's
messages within each edge block and adds the blocks in ascending order
(`_mxu_aggregate_plain`), the same function. It is held against the
reference's `ggnn_propagate(..., scatter="mxu", interpret="legacy")`,
as tests/test_ggnn_kernel.py runs it, on the same seeded numpy inputs.

Tolerances, with their reasons:
- one step, fp32 and bf16: rtol = atol = 1e-5 (fp32 reassociation of the
  message products and the block sums);
- one step, int8: 1e-5 of the state's scale. The products are exact
  integers and the messages take the reference's operation order, so
  the quanta agree; only the GRU's fp32 reassociation is left;
- five steps: fp32 at 1e-5; bf16 and int8 by the five-step rule of
  tests/test_torch_ggnn_policy.py (5e-3 of scale, 99% of the elements
  within 1e-4): the rows are rounded or quantized anew each step from
  states that differ by reassociation noise, and a flip near a boundary
  spreads;
- gradients of one step, every leaf: 1e-4 of its scale against jax.vjp
  of the reference (straight-through: fp32 on h and Wm from the mxu
  aggregate).

The model, serving and `cli train` under mxu: test_torch_ggnn_mxu_model.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.graphs import pack as jpack  # noqa: E402
from deepdfa_tpu.nn import ggnn_kernel as jgk  # noqa: E402
from deepdfa_tpu_torch.graphs import pack as tpack  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as tgk  # noqa: E402

from test_torch_ggnn_policy import (  # noqa: E402
    CLOSE_SHARE, CLOSE_TOL, NODE_BUDGET, STEPS_TOL, WEIGHTS, _graphs, _ladder, _scale_err,
    _weights,
)

STEP_TOL = 1e-5
GRAD_REL = 1e-4
ACCUMS = ["fp32", "bf16", "int8"]


@functools.lru_cache(maxsize=None)
def _ref(n_etypes, n_steps, accum, block_edges=0, unroll="per_step", scatter="mxu"):
    """The reference's jitted kernel path (interpret) under `scatter`."""

    def f(w, feat, b):
        return jgk.ggnn_propagate(
            w["wm"], w["bm"], w["wih"], w["whh"], w["bih"], w["bhh"], feat,
            b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n_steps=n_steps,
            n_etypes=n_etypes, accum=accum, unroll=unroll, scatter=scatter,
            block_edges=block_edges, interpret="legacy",
        )

    return jax.jit(f)


def _port(w, feat, tb, n_etypes, n_steps, accum, block_edges=0, unroll="per_step",
          scatter="mxu"):
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    return tgk.ggnn_propagate(
        *(t[k] for k in WEIGHTS), torch.from_numpy(feat), tb.edge_src, tb.edge_dst,
        tb.edge_mask, tb.edge_type, n_steps=n_steps, n_etypes=n_etypes, accum=accum,
        scatter=scatter, block_edges=block_edges, unroll=unroll,
    ).numpy()


def _inputs(seed, n_etypes, d=32, rung="4_graphs"):
    jb, tb = _ladder(rung, n_etypes)
    rng = np.random.default_rng(seed)
    w = _weights(rng, d, n_etypes)
    feat = rng.standard_normal((NODE_BUDGET, d)).astype(np.float32)
    return jb, tb, w, feat


def _check_step(got, want, accum):
    assert np.isfinite(got).all()
    if accum == "int8":
        assert _scale_err(got, want) <= STEP_TOL
    else:
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)


@pytest.mark.parametrize("block_edges", [128, 512])
@pytest.mark.parametrize("n_etypes", [1, 3])
@pytest.mark.parametrize("accum", ACCUMS)
def test_one_step_matches_reference(accum, n_etypes, block_edges):
    jb, tb, w, feat = _inputs(3 + n_etypes, n_etypes)
    got = _port(w, feat, tb, n_etypes, 1, accum, block_edges)
    want = np.asarray(_ref(n_etypes, 1, accum, block_edges)(w, feat, jb))
    _check_step(got, want, accum)


@pytest.mark.parametrize("rung", ["1_single_node", "2_graphs", "2_all_padding"])
@pytest.mark.parametrize("accum", ["fp32", "int8"])
def test_one_step_across_the_serve_ladder(accum, rung):
    jb, tb, w, feat = _inputs(21, 1, rung=rung)
    got = _port(w, feat, tb, 1, 1, accum)
    want = np.asarray(_ref(1, 1, accum)(w, feat, jb))
    _check_step(got, want, accum)


def test_one_step_matches_reference_at_flagship_width():
    rng = np.random.default_rng(5)
    ref, port = _graphs(rng, 4, 1, max_nodes=60)
    jb, tb = jpack(ref, 4, 256, 1024), tpack(port, 4, 256, 1024).to("cpu")
    w = _weights(rng, 128, 1)
    feat = rng.standard_normal((256, 128)).astype(np.float32)
    for accum in ACCUMS:
        got = _port(w, feat, tb, 1, 1, accum)
        want = np.asarray(_ref(1, 1, accum)(w, feat, jb))
        _check_step(got, want, accum)


@pytest.mark.parametrize("total, target", [(65536, 512), (65536, 1000), (2048, 128), (2062, 512),
                                           (300, 512), (7 * 97, 64), (1, 512)])
def test_edge_block_is_the_reference_pick_block(total, target):
    assert tgk.pick_block(total, target) == jgk._pick_block(total, target)
    assert tgk.edge_block(total, target) == jgk.block_sizes(1, total, 0, target)[1]
    assert tgk.edge_block(total) == jgk.block_sizes(1, total)[1]


def test_one_block_fallback_matches_reference():
    """An edge budget with no divisor near 512 is one block in both
    packages (`_pick_block`'s fallback), so int8 requantizes over every
    edge at once."""
    e = 2 * 1031
    assert tgk.edge_block(e) == e
    rng = np.random.default_rng(12)
    ref, port = _graphs(rng, 4, 1)
    jb, tb = jpack(ref, 4, NODE_BUDGET, e), tpack(port, 4, NODE_BUDGET, e).to("cpu")
    w = _weights(rng, 32, 1)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    for accum in ("fp32", "int8"):
        got = _port(w, feat, tb, 1, 1, accum)
        want = np.asarray(_ref(1, 1, accum)(w, feat, jb))
        _check_step(got, want, accum)


def test_resolve_scatter_like_the_reference():
    for scatter in ("fold", "mxu", "auto"):  # "auto" is fold off the TPU in both
        assert tgk.resolve_scatter(scatter) == jgk.resolve_scatter(scatter)
    for mod in (tgk, jgk):
        with pytest.raises(ValueError, match="unknown ggnn_kernel scatter"):
            mod.resolve_scatter("onehot")


@pytest.mark.parametrize("unroll", ["per_step", "fused"])
@pytest.mark.parametrize("accum", ACCUMS)
def test_five_steps_match_reference(accum, unroll):
    jb, tb, w, feat = _inputs(7, 1)
    got = _port(w, feat, tb, 1, 5, accum, 128, unroll)
    want = np.asarray(_ref(1, 5, accum, 128, unroll)(w, feat, jb))
    assert np.isfinite(got).all()
    if accum == "fp32":
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
    else:
        assert _scale_err(got, want) <= STEPS_TOL
        assert np.isclose(got, want, rtol=CLOSE_TOL, atol=CLOSE_TOL).mean() >= CLOSE_SHARE


@pytest.mark.parametrize("n_etypes", [1, 3])
def test_int8_mxu_is_another_function_in_both_packages(n_etypes):
    """The mode is engaged: int8 mxu differs from int8 fold, and from
    int8 mxu at another edge block, in both packages, by about what the
    one package's two functions differ by in the other."""
    jb, tb, w, feat = _inputs(9, n_etypes)
    port = {k: _port(w, feat, tb, n_etypes, 1, "int8", be, scatter=s)
            for k, (s, be) in {"fold": ("fold", 0), "mxu512": ("mxu", 512),
                               "mxu128": ("mxu", 128)}.items()}
    ref = {k: np.asarray(_ref(n_etypes, 1, "int8", be, scatter=s)(w, feat, jb))
           for k, (s, be) in {"fold": ("fold", 0), "mxu512": ("mxu", 512),
                              "mxu128": ("mxu", 128)}.items()}
    for pkg in (port, ref):
        assert _scale_err(pkg["mxu512"], pkg["fold"]) > 1e-4
        assert _scale_err(pkg["mxu128"], pkg["mxu512"]) > 1e-4
    for k in port:
        assert _scale_err(port[k], ref[k]) <= STEP_TOL, k


@pytest.mark.parametrize("n_etypes", [1, 3])
@pytest.mark.parametrize("accum", ACCUMS)
def test_step_vjp_matches_reference(accum, n_etypes):
    """Every gradient leaf of one mxu GgnnStep against jax.vjp of the
    reference's mxu step."""
    jb, tb, w, feat = _inputs(13 + n_etypes, n_etypes)
    g = np.random.default_rng(99).standard_normal(feat.shape).astype(np.float32)
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tf = torch.from_numpy(feat).requires_grad_()
    out = tgk.ggnn_propagate(*(tw[k] for k in WEIGHTS), tf, tb.edge_src, tb.edge_dst,
                             tb.edge_mask, tb.edge_type, n_steps=1, n_etypes=n_etypes,
                             accum=accum, scatter="mxu", block_edges=128)
    assert type(out.grad_fn).__name__ == "GgnnStepBackward"
    out.backward(torch.from_numpy(g))
    got = {k: tw[k].grad.numpy() for k in WEIGHTS} | {"feat": tf.grad.numpy()}
    ref = _ref(n_etypes, 1, accum, 128)
    want_w, want_f = jax.vjp(lambda w_, f_: ref(w_, f_, jb), w, feat)[1](jnp.asarray(g))
    want = {k: np.asarray(v) for k, v in want_w.items()} | {"feat": np.asarray(want_f)}
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for k, v in got.items():
        err = float(np.abs(v - want[k]).max()) / max(float(np.abs(want[k]).max()), floor)
        assert err <= GRAD_REL, (k, err)


@pytest.mark.parametrize("accum", ["fp32", "int8"])
def test_fused_unroll_is_bit_equal_to_per_step(accum):
    """On the CPU both unrolls run the plain mxu step, so GgnnUnroll and
    a chain of GgnnSteps give the same bits, forward and every gradient
    (its backward recomputes each step's mxu aggregate)."""
    _, tb, w, feat = _inputs(17, 3)
    g = np.random.default_rng(5).standard_normal(feat.shape).astype(np.float32)
    res = {}
    for unroll in ("per_step", "fused"):
        tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
        tf = torch.from_numpy(feat).requires_grad_()
        out = tgk.ggnn_propagate(*(tw[k] for k in WEIGHTS), tf, tb.edge_src, tb.edge_dst,
                                 tb.edge_mask, tb.edge_type, n_steps=3, n_etypes=3,
                                 accum=accum, scatter="mxu", block_edges=128, unroll=unroll)
        out.backward(torch.from_numpy(g))
        res[unroll] = (type(out.grad_fn).__name__,
                       [out.detach(), tf.grad, *(tw[k].grad for k in WEIGHTS)])
    assert res["per_step"][0] == "GgnnStepBackward" and res["fused"][0] == "GgnnUnrollBackward"
    assert all(torch.equal(a, b) for a, b in zip(res["fused"][1], res["per_step"][1]))


def test_residency_counts_the_int8_pre_pass_maxima():
    n, d, n_eb = 16384, 128, 65536 // 512
    fold = tgk.fused_residency_bytes(n, d, "int8", 5)
    mxu = tgk.fused_residency_bytes(n, d, "int8", 5, scatter="mxu", n_eb=n_eb)
    assert mxu - fold == 5 * n_eb * d * 4  # one [T, n_eb, d] uint32 slice a step
    for accum in ("fp32", "bf16"):  # no pre-pass: nothing more resident
        assert tgk.fused_residency_bytes(n, d, accum, 5, scatter="mxu", n_eb=n_eb) == \
            tgk.fused_residency_bytes(n, d, accum, 5)
    assert tgk.resolve_unroll("fused", n=n, d=d, n_steps=5, accum="int8", scan_steps=False,
                              budget_bytes=fold, scatter="mxu", n_eb=n_eb)[0] == "per_step"
    assert tgk.resolve_unroll("fused", n=n, d=d, n_steps=5, accum="int8", scan_steps=False,
                              budget_bytes=mxu, scatter="mxu", n_eb=n_eb) == ("fused", "")


def test_mxu_wrappers_refuse_what_they_cannot_take():
    _, tb, w, feat = _inputs(2, 1)
    edges = tgk.prepare_edges(tb.edge_src, tb.edge_dst, tb.edge_mask, None, NODE_BUDGET)
    params = [torch.from_numpy(w[k]) for k in WEIGHTS]
    h = torch.from_numpy(feat)
    with pytest.raises(ValueError, match="does not divide the edge budget"):
        tgk.ggnn_step(h, edges, *params, scatter="mxu", block_e=300)
    with pytest.raises(ValueError, match="unknown ggnn_kernel scatter"):
        tgk.ggnn_fused(h, edges, *params, n_steps=2, scatter="onehot")
    counts = tgk.launch_counts()
    for name in ("MXU_LAUNCHES", "MXU_BF16_LAUNCHES", "MXU_INT8_LAUNCHES", "FUSED_MXU_LAUNCHES"):
        assert name in counts
    tgk.ggnn_step(h, edges, *params, scatter="mxu")  # the CPU runs the plain version
    assert tgk.launch_counts() == counts
