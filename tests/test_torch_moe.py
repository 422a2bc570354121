"""The port's mixture-of-experts block (deepdfa_tpu_torch/parallel/moe.py)
and the combined model's MoE adapter against the reference
(deepdfa_tpu/parallel/moe.py, models/combined.py, train/combined_loop.py):
the one-device cases of tests/test_moe.py, the combined forward with its
aux loss and gradients, and one `CombinedTrainer` step.

Weights come from the reference's initializers (numpy arrays carried
over). Tolerances: dispatch exactly (the same experts, slots and
drops); combine weights, outputs and aux fp32 1e-5 (rtol and atol);
the hand-computed dense equivalence as the reference's test holds it
(rtol 2e-4, atol 2e-5); a bf16 token batch 2e-2 (bf16 rows); the
combined model's logits, aux and loss 1e-5, its gradients 1e-4 of each
leaf's scale as the combined training tests hold them."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepdfa_tpu.models import combined as jcmb  # noqa: E402
from deepdfa_tpu.parallel import make_mesh  # noqa: E402
from deepdfa_tpu.parallel import moe as jmoe  # noqa: E402
from deepdfa_tpu.train.combined_loop import CombinedTrainer as JTrainer  # noqa: E402
from deepdfa_tpu_torch.models import CombinedModel, from_jax_combined_params  # noqa: E402
from deepdfa_tpu_torch.parallel import moe  # noqa: E402
from deepdfa_tpu_torch.train import CombinedTrainer  # noqa: E402
from tests.test_torch_combined_train import (  # noqa: E402
    _batches,
    _cfgs,
    _leaf_errors,
    _model_cfgs,
)

TOL = 1e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4
EXPERTS = 4


def _setup(n: int = 24):
    cfg = jmoe.MoEConfig(hidden_size=16, intermediate_size=32, num_experts=4, top_k=2)
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(cfg, jax.random.key(0)))
    x = np.array(jax.random.normal(jax.random.key(1), (n, 16)))
    tcfg = moe.MoEConfig(**dataclasses.asdict(cfg))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return cfg, params, x, tcfg, tparams


@pytest.mark.parametrize("cap", [None, 1, 3], ids=["default", "cap1", "cap3"])
def test_routing_and_output_match_reference(cap):
    cfg, params, x, tcfg, tparams = _setup()
    c = cap or jmoe.capacity(cfg, x.shape[0])
    d_want, c_want, a_want = jmoe._route(cfg, params["router"], x, c)
    d_got, c_got, a_got = moe._route(tcfg, tparams["router"], torch.from_numpy(x), c)
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(a_got.item(), float(a_want), rtol=TOL, atol=TOL)
    want, aux = jmoe.moe_ffn(cfg, params, x, cap=cap)
    got, got_aux = moe.moe_ffn(tcfg, tparams, torch.from_numpy(x), cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_aux.item(), float(aux), rtol=TOL, atol=TOL)
    assert got_aux.item() > 0 and np.isfinite(got.numpy()).all()


def test_capacity_drops_overflow():
    """Capacity 1: most tokens lose their slot and pass through the
    residual; the output shrinks against ample capacity, as in the
    reference, and the dropped rows are all zero."""
    _, _, x, tcfg, tparams = _setup()
    ample, _ = moe.moe_ffn(tcfg, tparams, torch.from_numpy(x))
    tight, _ = moe.moe_ffn(tcfg, tparams, torch.from_numpy(x), cap=1)
    assert np.isfinite(tight.numpy()).all()
    assert torch.linalg.norm(tight) < torch.linalg.norm(ample)
    dispatch, _, _ = moe._route(tcfg, tparams["router"], torch.from_numpy(x), 1)
    dropped = dispatch.sum(dim=(1, 2)) == 0
    assert dropped.any() and (tight[dropped] == 0).all()


def test_dense_equivalence_with_full_capacity():
    cfg, params, x, tcfg, tparams = _setup()
    out, _ = moe.moe_ffn(tcfg, tparams, torch.from_numpy(x), cap=x.shape[0])
    logits = x @ params["router"]
    probs = np.asarray(jax.nn.softmax(logits, -1))
    want = np.zeros_like(x)
    for i in range(x.shape[0]):
        top = np.argsort(-logits[i])[: cfg.top_k]
        g = probs[i][top] / probs[i][top].sum()
        for w, e in zip(g, top):
            h = np.asarray(jax.nn.gelu(x[i] @ params["w1"][e] + params["b1"][e]))
            want[i] += w * (h @ params["w2"][e] + params["b2"][e])
    np.testing.assert_allclose(out.numpy(), want, rtol=2e-4, atol=2e-5)


def test_capacity_formula():
    cfg = moe.MoEConfig(hidden_size=4, intermediate_size=8, num_experts=4, top_k=2,
                        capacity_factor=1.0)
    assert moe.capacity(cfg, 16) == 8 == jmoe.capacity(jmoe.MoEConfig(**dataclasses.asdict(cfg)),
                                                       16)
    for n in (1, 5, 16, 37, 512):
        assert moe.capacity(moe.MoEConfig(768, 3072), n) == jmoe.capacity(
            jmoe.MoEConfig(768, 3072), n)


def test_ties_pick_the_lower_expert_as_lax_top_k():
    """Identical rows (a serving bucket's padded [CLS] rows) tie on every
    logit: the experts and slots are the reference's."""
    cfg, params, x, tcfg, tparams = _setup()
    x = np.repeat(x[:1], 8, axis=0)
    x[5] = 0.0  # an all-zero row: every logit ties at 0
    tied = np.array([[0.5, 1.0, 1.0, 0.2], [3.0, 3.0, 3.0, 3.0]], np.float32)
    assert np.array_equal(moe.top_k_indices(torch.from_numpy(tied), 2).numpy(),
                          np.asarray(jax.lax.top_k(tied, 2)[1]))
    c = jmoe.capacity(cfg, x.shape[0])
    d_want, _, _ = jmoe._route(cfg, params["router"], x, c)
    d_got, _, _ = moe._route(tcfg, tparams["router"], torch.from_numpy(x), c)
    np.testing.assert_array_equal(d_got.numpy(), np.asarray(d_want))


def test_bf16_rows_route_as_the_reference():
    cfg, params, x, tcfg, tparams = _setup()
    xb = jnp.asarray(x, jnp.bfloat16)
    want, aux = jmoe.moe_ffn(cfg, params, xb)
    got, got_aux = moe.moe_ffn(tcfg, tparams, torch.from_numpy(x).to(torch.bfloat16))
    c = jmoe.capacity(cfg, x.shape[0])
    d_want, _, _ = jmoe._route(cfg, params["router"], xb, c)
    d_got, _, _ = moe._route(tcfg, tparams["router"], torch.from_numpy(x).to(torch.bfloat16), c)
    assert d_got.dtype == torch.bfloat16 and got.dtype == torch.float32
    np.testing.assert_array_equal(d_got.float().numpy(), np.asarray(d_want, np.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(got_aux.item(), float(aux), rtol=BF16_TOL, atol=BF16_TOL)


def test_expert_parallel_forms_are_item_9():
    for fn in (moe.moe_stage_forward, moe.moe_ffn_ep, moe.moe_param_specs):
        with pytest.raises(NotImplementedError, match="item 9"):
            fn()


def _moe_cfgs():
    jmcfg, tmcfg = _model_cfgs(0.0)
    return (dataclasses.replace(jmcfg, moe_experts=EXPERTS),
            dataclasses.replace(tmcfg, moe_experts=EXPERTS))


def test_combined_model_with_moe_matches_reference():
    """Forward with the aux loss and the gradients of (loss + weight *
    aux) against `combined.forward(..., with_aux=True)`."""
    jmcfg, tmcfg = _moe_cfgs()
    params = jax.tree.map(np.asarray, jcmb.init_params(jmcfg, jax.random.key(4)))
    assert set(params["moe"]) == set(moe.PARAM_NAMES)
    ref_b, port_b = _batches(False)[2], _batches(True)[2].to("cpu")
    local = jax.tree.map(lambda x: x[0], ref_b)

    def loss(p):
        logits, aux = jcmb.forward(jmcfg, p, local.input_ids, local.graphs, local.has_graph,
                                   with_aux=True)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, local.labels)
        m = local.row_mask.astype(per.dtype)
        total = (per * m).sum() + jmcfg.moe_aux_weight * aux * m.sum()
        return total / jnp.maximum(m.sum(), 1.0), (logits, aux)

    (want_loss, (want_logits, want_aux)), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    model = CombinedModel(tmcfg)
    model.load_state_dict(from_jax_combined_params(params), strict=True)
    logits, aux = model(port_b.input_ids, port_b.graphs, port_b.has_graph, with_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=TOL, atol=TOL)
    _, tcfg = _cfgs()
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=1, device="cpu")
    state = trainer.init_state(params=from_jax_combined_params(params))
    got_loss = trainer.forward_loss(state, port_b, None)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    want = {k: v.numpy() for k, v in from_jax_combined_params(
        jax.tree.map(np.asarray, jgrads)).items()}
    got = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    assert got.keys() == want.keys() and any(k.startswith("moe.") for k in got)
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= GRAD_TOL, errs
    without = model(port_b.input_ids, port_b.graphs, port_b.has_graph)
    assert torch.equal(without, logits)


def test_one_trainer_step_matches_reference_trainer():
    jcfg, tcfg = _cfgs()
    jmcfg, tmcfg = _moe_cfgs()
    jtr = JTrainer(jcfg, jmcfg, mesh=make_mesh(jcfg.train.mesh, devices=jax.devices()[:1]),
                   total_steps=2)
    jstate = jtr.init_state()
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=2, device="cpu")
    state = trainer.init_state(params=from_jax_combined_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))))
    ref_b, port_b = _batches(False)[1], _batches(True)[1]
    jl, tl = [], []
    for i in range(2):
        jstate, loss = jtr.train_step(jstate, jtr.place_batch(ref_b), jax.random.key(i))
        jl.append(float(loss))
        # no dropout seed: the parity configs run every rate at 0
        tl.append(float(trainer.train_step(state, port_b.to("cpu"), None)))
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mesh, moe_experts, err", [
    ({"dp": 1, "ep": 2}, 0, ValueError),  # an ep mesh without an MoE block
    ({"dp": 1, "ep": 3}, 4, ValueError),  # experts not divisible by ep
    ({"dp": 1, "ep": 2}, 4, NotImplementedError),  # the ep mesh itself: item 9
])
def test_trainer_keeps_the_reference_ep_refusals(mesh, moe_experts, err):
    _, tcfg = _cfgs(mesh=mesh)
    _, tmcfg = _model_cfgs(0.0)
    with pytest.raises(err):
        CombinedTrainer(tcfg, dataclasses.replace(tmcfg, moe_experts=moe_experts), device="cpu")
