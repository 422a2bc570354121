"""The port's GGNN message policies (`accum="bf16"` and `"int8"`,
deepdfa_tpu_torch/nn/ggnn_kernel.py) against the reference.

On the CPU the port runs the step kernel's plain PyTorch version under
the policy. It is held against the reference's `ggnn_propagate(...,
accum=, scatter="fold", interpret="legacy")`, as tests/test_ggnn_kernel.py
runs it, on the same seeded numpy inputs, across the serve ladder (1, 2,
4, the all-padding batch, a single-node graph) and n_etypes 1 and 3.

Tolerances, with their reasons:
- quantization: `quant_rows` and `quant_wm` give the reference's jitted
  q and s exactly (XLA computes `max / 127` as `max * (1/127)`);
- one step, bf16 and int8: rtol = atol = 1e-5. The quantized rows are
  the same, so only fp32 reassociation separates the two (the port sums
  coef * row per node before applying Wm_t);
- five steps, bf16 and int8: the message-side rows are rounded (bf16)
  or quantized (int8) anew from each step's state, and the two packages'
  fp32 states differ by reassociation noise (~2e-7 of scale after one
  step). An element that lies within that noise of a bf16 rounding
  boundary (or a row near a quantum's edge) rounds the other way in one
  package, and the flip spreads to its neighbours' messages in the
  steps after. On this file's five-step cases the bf16 states differ by
  up to 5.7e-4 of the state's scale (0.24% of the elements beyond 1e-4),
  the int8 states by up to 5.3e-7. So five steps are held at
  STEPS_TOL = 5e-3 of scale with at least 99% of the elements within
  1e-4, and the DeepDFA logits under bf16 at 1e-4. Both packages' bf16
  and int8 states stay within INT8_DRIFT_BOUND (5e-2) of their fp32
  states, relative to scale, and differ from them (the policy is
  engaged);
- gradients of one `GgnnStep` (straight-through: fp32 on h and Wm from
  the policy's aggregate): 1e-4 of each leaf's scale against jax.vjp of
  the reference.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.graphs import GraphSpec as JSpec, pack as jpack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.nn import GatedGraphConv as JConv  # noqa: E402
from deepdfa_tpu.nn import ggnn_kernel as jgk  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, pack as tpack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.nn import GatedGraphConv  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as tgk  # noqa: E402

STEP_TOL = 1e-5  # one step: the same quantized rows, fp32 reassociation
STEPS_TOL = 5e-3  # five steps, of the state's scale: a rounding may flip (docstring)
CLOSE_TOL, CLOSE_SHARE = 1e-4, 0.99  # ... and this share of elements within 1e-4
LOGITS_TOL = 1e-4
GRAD_REL = 1e-4
NODE_BUDGET, EDGE_BUDGET = 512, 2048
WEIGHTS = ("wm", "bm", "wih", "whh", "bih", "bhh")
RUNGS = ["1_single_node", "2_graphs", "2_all_padding", "4_graphs"]


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
            edge_type=(rng.integers(0, n_etypes, (e,)).astype(np.int32)
                       if n_etypes > 1 else None),
        )
        ref.append(JSpec(**kw))
        port.append(TSpec(**kw))
    return ref, port


def _ladder(rung, n_etypes, node_budget=NODE_BUDGET, edge_budget=EDGE_BUDGET):
    """(reference batch, port batch on the CPU) of one serve rung."""
    rng = np.random.default_rng(11)
    if rung == "1_single_node":
        kw = dict(
            graph_id=0, node_feats=np.zeros((1, 4), np.int32),
            node_vuln=np.zeros((1,), np.int32), edge_src=np.zeros((0,), np.int32),
            edge_dst=np.zeros((0,), np.int32), label=1.0,
            edge_type=np.zeros((0,), np.int32) if n_etypes > 1 else None,
        )
        size, ref, port = 1, [JSpec(**kw)], [TSpec(**kw)]
    elif rung == "2_all_padding":
        size, ref, port = 2, [], []
    else:
        size = int(rung[0])
        ref, port = _graphs(rng, size, n_etypes)
    etypes = n_etypes > 1
    return (jpack(ref, size, node_budget, edge_budget, etypes=etypes),
            tpack(port, size, node_budget, edge_budget, etypes=etypes).to("cpu"))


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


@functools.lru_cache(maxsize=None)
def _ref_propagate(n_etypes, n_steps, accum, unroll="per_step"):
    """The reference's jitted kernel path (interpret, fold scatter)."""

    def f(w, feat, b):
        return jgk.ggnn_propagate(
            w["wm"], w["bm"], w["wih"], w["whh"], w["bih"], w["bhh"], feat,
            b.edge_src, b.edge_dst, b.edge_mask, b.edge_type,
            n_steps=n_steps, n_etypes=n_etypes, accum=accum, unroll=unroll,
            scatter="fold", interpret="legacy",
        )

    return jax.jit(f)


def port_propagate(w, feat, tb, n_etypes, n_steps, accum, unroll="per_step"):
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    return tgk.ggnn_propagate(
        *(t[k] for k in WEIGHTS), torch.from_numpy(feat), tb.edge_src, tb.edge_dst,
        tb.edge_mask, tb.edge_type, n_steps=n_steps, n_etypes=n_etypes, accum=accum,
        unroll=unroll,
    ).numpy()


def _scale_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-6)


def test_quantization_matches_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2048, 128)) * rng.uniform(1e-3, 10, (2048, 1))).astype(np.float32)
    x[7] = 0.0  # an all-zero row: scale 1, exact zeros
    wm = (rng.standard_normal((3, 128, 128)) * 0.1).astype(np.float32)
    wm[1, :, 5] = 0.0
    for (q, s), (jq, js) in (
        (tgk.quant_rows(torch.from_numpy(x)), jax.jit(jgk._quant_rows)(x)),
        (tgk.quant_wm(torch.from_numpy(wm)), jax.jit(jgk._quant_wm)(wm)),
    ):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    q, s = tgk.quant_rows(torch.from_numpy(x))
    assert not q[7].any() and s[7].item() == 1.0
    assert q.abs().max().item() == 127


def test_int8_drift_bound_is_the_reference_bound():
    assert tgk.INT8_DRIFT_BOUND == jgk.INT8_DRIFT_BOUND == 5e-2


@pytest.mark.parametrize("n_etypes", [1, 3])
@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("accum", ["bf16", "int8"])
def test_one_step_matches_reference(accum, rung, n_etypes):
    jb, tb = _ladder(rung, n_etypes)
    rng = np.random.default_rng(3 + n_etypes)
    w = _weights(rng, 32, n_etypes)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    got = port_propagate(w, feat, tb, n_etypes, 1, accum)
    want = np.asarray(_ref_propagate(n_etypes, 1, accum)(w, feat, jb))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)


def test_one_step_matches_reference_at_flagship_width():
    rng = np.random.default_rng(5)
    ref, port = _graphs(rng, 4, 1, max_nodes=60)
    jb, tb = jpack(ref, 4, 256, 1024), tpack(port, 4, 256, 1024).to("cpu")
    w = _weights(rng, 128, 1)
    feat = rng.standard_normal((256, 128)).astype(np.float32)
    for accum in ("bf16", "int8"):
        got = port_propagate(w, feat, tb, 1, 1, accum)
        want = np.asarray(_ref_propagate(1, 1, accum)(w, feat, jb))
        np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL, err_msg=accum)


@pytest.mark.parametrize("n_etypes", [1, 3])
def test_five_steps_under_each_policy(n_etypes):
    """bf16 and int8 within STEPS_TOL of scale of the reference's, with
    CLOSE_SHARE of the elements within 1e-4; both policies in both
    packages within the drift bound of their fp32 and engaged."""
    jb, tb = _ladder("4_graphs", n_etypes)
    rng = np.random.default_rng(7 + n_etypes)
    w = _weights(rng, 32, n_etypes)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    port = {a: port_propagate(w, feat, tb, n_etypes, 5, a) for a in ("fp32", "bf16", "int8")}
    ref = {a: np.asarray(_ref_propagate(n_etypes, 5, a)(w, feat, jb))
           for a in ("fp32", "bf16", "int8")}
    np.testing.assert_allclose(port["fp32"], ref["fp32"], rtol=STEP_TOL, atol=STEP_TOL)
    for a in ("bf16", "int8"):
        assert _scale_err(port[a], ref[a]) <= STEPS_TOL, a
        close = np.isclose(port[a], ref[a], rtol=CLOSE_TOL, atol=CLOSE_TOL).mean()
        assert close >= CLOSE_SHARE, (a, close)
    for pkg in (port, ref):
        for a in ("bf16", "int8"):
            drift = _scale_err(pkg[a], pkg["fp32"])
            assert 0.0 < drift <= tgk.INT8_DRIFT_BOUND, (a, drift)


@pytest.mark.parametrize("accum", ["bf16", "int8"])
@pytest.mark.parametrize("n_etypes", [1, 3])
def test_step_vjp_matches_reference(accum, n_etypes):
    """Every gradient leaf of one GgnnStep under the policy against
    jax.vjp of the reference's step."""
    jb, tb = _ladder("4_graphs", n_etypes)
    rng = np.random.default_rng(13 + n_etypes)
    w = _weights(rng, 32, n_etypes)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    g = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tf = torch.from_numpy(feat).requires_grad_()
    out = tgk.ggnn_propagate(*(tw[k] for k in WEIGHTS), tf, tb.edge_src, tb.edge_dst,
                             tb.edge_mask, tb.edge_type, n_steps=1, n_etypes=n_etypes,
                             accum=accum)
    assert type(out.grad_fn).__name__ == "GgnnStepBackward"
    out.backward(torch.from_numpy(g))
    got = {k: tw[k].grad.numpy() for k in WEIGHTS} | {"feat": tf.grad.numpy()}
    ref = _ref_propagate(n_etypes, 1, accum)
    want_w, want_f = jax.vjp(lambda w_, f_: ref(w_, f_, jb), w, feat)[1](jnp.asarray(g))
    want = {k: np.asarray(v) for k, v in want_w.items()} | {"feat": np.asarray(want_f)}
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for k, v in got.items():
        err = float(np.abs(v - want[k]).max()) / max(float(np.abs(want[k]).max()), floor)
        assert err <= GRAD_REL, (k, err)


INPUT_DIM, HIDDEN = 52, 8


@functools.lru_cache(maxsize=None)
def _ref_model(accum, use_kernel=True):
    model = JDeepDFA(input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_steps=5,
                     ggnn_kernel=use_kernel, ggnn_kernel_accum=accum)
    rng = np.random.default_rng(0)
    init = jpack(_graphs(rng, 3, 1)[0], 4, NODE_BUDGET, EDGE_BUDGET)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(4), init))
    return jax.jit(model.apply), params


def _model_specs(count):
    rng = np.random.default_rng(23)
    ref, port = [], []
    for gid in range(count):
        n = int(rng.integers(1, 30))
        e = int(rng.integers(0, 3 * n))
        kw = dict(graph_id=gid, node_feats=rng.integers(0, INPUT_DIM, (n, 4)).astype(np.int32),
                  node_vuln=np.zeros((n,), np.int32),
                  edge_src=rng.integers(0, n, (e,)).astype(np.int32),
                  edge_dst=rng.integers(0, n, (e,)).astype(np.int32), label=float(gid % 2))
        ref.append(JSpec(**kw))
        port.append(TSpec(**kw))
    return ref, port


@pytest.mark.parametrize("rung", [1, 2, 4])
def test_deepdfa_logits_under_bf16_match_reference(rung):
    apply, params = _ref_model("bf16")
    ref, port = _model_specs(rung)
    jb = jpack(ref, rung, NODE_BUDGET, EDGE_BUDGET)
    tb = tpack(port, rung, NODE_BUDGET, EDGE_BUDGET).to("cpu")
    model = DeepDFA(INPUT_DIM, HIDDEN, 5, ggnn_kernel=True, ggnn_kernel_accum="bf16")
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.inference_mode():
        got = model(tb).numpy()
    want = np.asarray(apply(params, jb))
    np.testing.assert_allclose(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)


def test_knobs_act_only_under_ggnn_kernel_in_both_packages():
    """`ggnn_kernel=false ggnn_kernel_accum=bf16` is the fp32 function in
    both packages (the reference runs its lax path there); with the
    kernel, bf16 moves the result."""
    jb, tb = _ladder("4_graphs", 1)
    rng = np.random.default_rng(31)
    w = _weights(rng, 32, 1)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    params = {"params": {"etype_0": {"kernel": w["wm"][0], "bias": w["bm"][0]},
                         "GRUCell_0": {"input_proj": {"kernel": w["wih"], "bias": w["bih"]},
                                       "hidden_proj": {"kernel": w["whh"], "bias": w["bhh"]}}}}
    outs = {}
    for use_kernel, accum in ((False, "fp32"), (False, "bf16"), (True, "bf16")):
        conv = JConv(out_features=32, n_steps=5, use_kernel=use_kernel, kernel_accum=accum,
                     kernel_interpret="legacy", kernel_scatter="fold")
        ref = np.asarray(jax.jit(conv.apply)(params, jb, feat))
        port = GatedGraphConv(32, 5, use_kernel=use_kernel, accum=accum)
        with torch.no_grad():
            for name, key in (("etype_kernel", "wm"), ("etype_bias", "bm"),
                              ("gru.input_kernel", "wih"), ("gru.hidden_kernel", "whh"),
                              ("gru.input_bias", "bih"), ("gru.hidden_bias", "bhh")):
                port.get_parameter(name).copy_(torch.from_numpy(w[key]))
            got = port(tb, torch.from_numpy(feat)).numpy()
        outs[use_kernel, accum] = (got, ref)
    (p0, r0), (p1, r1), (p2, r2) = outs.values()
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_allclose(p1, r1, rtol=1e-5, atol=1e-5)
    assert _scale_err(p2, p0) > 0 and _scale_err(r2, r0) > 0
