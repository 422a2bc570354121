"""The port's bit propagation (deepdfa_tpu_torch/nn/setops.py,
nn/bitprop.py) against the reference's (deepdfa_tpu/nn/setops.py,
nn/bitprop.py), on numpy-seeded inputs.

Tolerances: the unions and their gradients 1e-6 (the same terms summed
in the same order); the exact-solver labels 1e-5, as the reference's
own test; the learned gate's gradients 1e-5 against `jax.grad`, the
gate's weights carried over in the Dense layout of `from_jax_params`. The host problem
(`rd_bit_problem`) is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.data import synthetic as jsynthetic  # noqa: E402
from deepdfa_tpu.frontend import parse_function as jparse  # noqa: E402
from deepdfa_tpu.nn import bitprop as jbitprop, setops as jsetops  # noqa: E402
from deepdfa_tpu_torch.data import synthetic  # noqa: E402
from deepdfa_tpu_torch.frontend import parse_function  # noqa: E402
from deepdfa_tpu_torch.nn import bitprop, setops  # noqa: E402
from tests.test_bitprop import PROGRAMS  # noqa: E402

UNION_TOL = 1e-6
SOLVER_TOL = GRAD_TOL = 1e-5


def _messages(seed: int, e: int = 90, n: int = 17, d: int = 6):
    rng = np.random.default_rng(seed)
    msgs = rng.random((e, d)).astype(np.float32)
    msgs[rng.random((e, d)) < 0.2] = 0.0
    msgs[rng.random((e, d)) < 0.1] = 1.0  # saturated bits, the clip's bound
    init = rng.random((n, d)).astype(np.float32)
    seg = rng.integers(0, n, e).astype(np.int32)  # unsorted, as rd_bit_problem's
    mask = rng.random(e) < 0.8
    return msgs, init, seg, mask


@pytest.mark.parametrize("union_type", ["simple", "relu"])
@pytest.mark.parametrize("seed", [0, 5])
def test_segment_union_and_its_gradients_match_reference(union_type, seed):
    msgs, init, seg, mask = _messages(seed)
    cot = np.random.default_rng(seed + 1).standard_normal(init.shape).astype(np.float32)

    def ref(m, i):
        return jsetops.segment_union(m, i, seg, mask, union_type)

    want, vjp = jax.vjp(ref, msgs, init)
    dm_want, di_want = vjp(cot)
    m_t = torch.from_numpy(msgs).requires_grad_(True)
    i_t = torch.from_numpy(init).requires_grad_(True)
    got = setops.segment_union(m_t, i_t, torch.from_numpy(seg), torch.from_numpy(mask),
                               union_type)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=UNION_TOL)
    np.testing.assert_allclose(m_t.grad.numpy(), np.asarray(dm_want), rtol=0, atol=UNION_TOL)
    np.testing.assert_allclose(i_t.grad.numpy(), np.asarray(di_want), rtol=0, atol=UNION_TOL)


@pytest.mark.parametrize("union", ["simple_union", "relu_union"])
def test_pairwise_unions_match_reference(union):
    rng = np.random.default_rng(3)
    a, b = rng.random((2, 64, 8)).astype(np.float32)
    got = getattr(setops, union)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(jsetops, union)(a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=UNION_TOL)
    with pytest.raises(ValueError, match="union_type"):
        setops.segment_union(torch.zeros(2, 1), torch.zeros(2, 1), torch.zeros(2, dtype=torch.int32),
                             torch.ones(2, dtype=torch.bool), "max")


def test_gather_sum_plain_is_the_fixed_order_sum():
    """Each run summed from 0 in run order: the bits of a sequential
    loop; empty runs are 0."""
    rng = np.random.default_rng(9)
    y = torch.from_numpy(rng.standard_normal((11, 5)).astype(np.float32))
    keys = torch.from_numpy(rng.integers(0, 7, 40).astype(np.int32))
    valid = torch.from_numpy(rng.random(40) < 0.7)
    vals = torch.from_numpy(rng.integers(0, 11, 40).astype(np.int32))
    idx, ptr = setops.csr_layout(keys, valid, 7, values=vals)
    got = setops.gather_sum(y, idx, ptr)
    for v in range(7):
        want = torch.zeros(5)
        for j in range(40):
            if valid[j] and keys[j] == v:
                want = want + y[vals[j]]
        assert torch.equal(got[v], want)
    assert int(ptr[-1]) == int(valid.sum())


def _problem_pairs():
    programs = [(f"program_{i}", code) for i, code in enumerate(PROGRAMS)]
    examples = synthetic.to_examples(synthetic.generate(48, seed=11))
    ref_examples = jsynthetic.to_examples(jsynthetic.generate(48, seed=11))
    assert [e.code for e in examples] == [e.code for e in ref_examples]
    return programs + [(f"synthetic_{e.id}", e.code) for e in examples]


@pytest.mark.parametrize("clip", [False, True])
def test_rd_bit_problem_equals_reference(clip):
    checked = 0
    for name, code in _problem_pairs():
        got = bitprop.rd_bit_problem(parse_function(code), 8 if clip else 64, clip=clip)
        want = jbitprop.rd_bit_problem(jparse(code), 8 if clip else 64, clip=clip)
        assert (got is None) == (want is None), name
        if got is None:
            continue
        assert got.keys() == want.keys(), name
        for k in got:
            if isinstance(got[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, (name, k)
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
            else:
                assert got[k] == want[k], (name, k)
        checked += 1
    assert checked >= 40


def test_too_many_defs_returns_none():
    body = "".join(f"x{i} = {i};\n" for i in range(70))
    code = ("int f(void) {\nint " + ",".join(f"x{i}" for i in range(70)) + ";\n" + body
            + "return x0;\n}")
    assert bitprop.rd_bit_problem(parse_function(code), max_defs=64) is None
    assert jbitprop.rd_bit_problem(jparse(code), max_defs=64) is None
    got = bitprop.rd_bit_problem(parse_function(code), max_defs=128)
    assert got is not None and got["gen"].shape[1] == 128
    clipped = bitprop.rd_bit_problem(parse_function(code), max_defs=64, clip=True)
    assert clipped["gen"].shape[1] == 64 and clipped["gen"].sum() == 64


@pytest.mark.parametrize("union_type", ["simple", "relu"])
@pytest.mark.parametrize("code", PROGRAMS, ids=range(len(PROGRAMS)))
def test_matches_exact_solver(code, union_type):
    prob = bitprop.rd_bit_problem(parse_function(code), max_defs=64)
    n = prob["n_nodes"]
    prop = bitprop.BitvectorPropagation(n_steps=n + 1, union_type=union_type)
    args = [torch.from_numpy(prob[k]) for k in ("gen", "kill", "edge_src", "edge_dst")]
    in_, out = prop(*args, torch.ones(len(prob["edge_src"]), dtype=torch.bool))
    np.testing.assert_allclose(in_.numpy(), prob["labels_in"], rtol=0, atol=SOLVER_TOL)
    np.testing.assert_allclose(out.numpy(), prob["labels_out"], rtol=0, atol=SOLVER_TOL)


@pytest.mark.parametrize("union_type", ["simple", "relu"])
def test_learned_gate_gradients_match_jax_grad(union_type):
    prob = bitprop.rd_bit_problem(parse_function(PROGRAMS[0]), max_defs=64)
    n = prob["n_nodes"]
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((n, 12)).astype(np.float32)
    mask = rng.random(len(prob["edge_src"])) < 0.9
    jmodel = jbitprop.BitvectorPropagation(n_steps=6, union_type=union_type, learned_gate=True)
    jargs = (prob["gen"], prob["kill"], prob["edge_src"], prob["edge_dst"], mask)
    params = jmodel.init(jax.random.key(0), *jargs, node_feats=feats)

    def loss(p, f):
        in_, out = jmodel.apply(p, *jargs, node_feats=f)
        return jnp.mean((in_ - prob["labels_in"]) ** 2) + jnp.mean((out - prob["labels_out"]) ** 2)

    want_loss, (g_p, g_f) = jax.value_and_grad(loss, argnums=(0, 1))(params, feats)
    port = bitprop.BitvectorPropagation(n_steps=6, union_type=union_type, learned_gate=True,
                                        width=12)
    gate = params["params"]["kill_gate"]  # the Dense layout from_jax_params maps
    sd = {"kill_gate.weight": torch.from_numpy(np.asarray(gate["kernel"]).T.copy()),
          "kill_gate.bias": torch.from_numpy(np.array(gate["bias"]))}
    port.load_state_dict(sd, strict=True)
    f_t = torch.from_numpy(feats).requires_grad_(True)
    targs = [torch.from_numpy(x) for x in jargs]
    in_, out = port(*targs, node_feats=f_t)
    got_loss = (((in_ - torch.from_numpy(prob["labels_in"])) ** 2).mean()
                + ((out - torch.from_numpy(prob["labels_out"])) ** 2).mean())
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=GRAD_TOL, atol=GRAD_TOL)
    g_gate = g_p["params"]["kill_gate"]
    np.testing.assert_allclose(port.kill_gate.weight.grad.numpy().T, np.asarray(g_gate["kernel"]),
                               rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(port.kill_gate.bias.grad.numpy(), np.asarray(g_gate["bias"]),
                               rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(f_t.grad.numpy(), np.asarray(g_f), rtol=0, atol=GRAD_TOL)
    assert np.abs(port.kill_gate.weight.grad.numpy()).max() > 0


def test_sharded_union_is_item_9():
    with pytest.raises(NotImplementedError, match="item 9"):
        bitprop.BitvectorPropagation(n_steps=2, axis_name="edges")
