"""The port's DeepDFA (deepdfa_tpu_torch/models/deepdfa.py) against the
reference model, weights carried over by `from_jax_params`.

A Flax init of the reference model gives the weights; the port loads
them (strictly: every name and shape must match) and both score the
same packed batches across the serve ladder (1, 2, 4 and the
all-padding batch). The reference runs its per-step GGNN kernel in
interpret mode (`ggnn_kernel=True`), as its own tests do. Tolerance:
fp32 rtol 1e-5, atol 1e-5 — cross-framework reassociation.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.graphs import GraphSpec as JSpec, pack as jpack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu_torch.core.config import ModelConfig  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, pack as tpack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402

RTOL = ATOL = 1e-5  # fp32, cross-framework reassociation
INPUT_DIM, HIDDEN, N_STEPS = 52, 8, 3
NODE_BUDGET, EDGE_BUDGET = 512, 2048


def _graphs(rng, count):
    ref, port = [], []
    for gid in range(count):
        n = int(rng.integers(1, 30))
        e = int(rng.integers(0, 3 * n))
        kw = dict(
            graph_id=gid,
            node_feats=rng.integers(0, INPUT_DIM, (n, 4)).astype(np.int32),
            node_vuln=np.zeros((n,), np.int32),
            edge_src=rng.integers(0, n, (e,)).astype(np.int32),
            edge_dst=rng.integers(0, n, (e,)).astype(np.int32),
            label=float(gid % 2),
        )
        ref.append(JSpec(**kw))
        port.append(TSpec(**kw))
    return ref, port


def _ladder_case(rung):
    rng = np.random.default_rng(21)
    if rung == "2_all_padding":
        return 2, [], []
    if rung == "1_single_node":
        kw = dict(
            graph_id=0, node_feats=np.full((1, 4), 3, np.int32),
            node_vuln=np.zeros((1,), np.int32),
            edge_src=np.zeros((0,), np.int32), edge_dst=np.zeros((0,), np.int32),
            label=1.0,
        )
        return 1, [JSpec(**kw)], [TSpec(**kw)]
    size = int(rung[0])
    ref, port = _graphs(rng, size)
    return size, ref, port


@functools.lru_cache(maxsize=None)
def _reference(encoder_mode, label_style="graph"):
    """(jitted apply, numpy params) of a Flax-initialised reference."""
    model = JDeepDFA(
        input_dim=INPUT_DIM, hidden_dim=HIDDEN, n_steps=N_STEPS,
        encoder_mode=encoder_mode, label_style=label_style, ggnn_kernel=True,
    )
    rng = np.random.default_rng(0)
    init_batch = jpack(_graphs(rng, 3)[0], 4, NODE_BUDGET, EDGE_BUDGET)
    params = model.init(jax.random.key(4), init_batch)
    params = jax.tree.map(np.asarray, params)
    return jax.jit(model.apply), params


def _port(params, encoder_mode, label_style="graph"):
    model = DeepDFA(
        INPUT_DIM, HIDDEN, N_STEPS, encoder_mode=encoder_mode,
        label_style=label_style,
    )
    model.load_state_dict(from_jax_params(params))
    return model.eval()


@pytest.mark.parametrize("encoder_mode", [False, True], ids=["logits", "encoder"])
@pytest.mark.parametrize("rung", ["1_single_node", "2_graphs", "2_all_padding", "4_graphs"])
def test_model_matches_reference_across_ladder(rung, encoder_mode):
    size, ref, port = _ladder_case(rung)
    apply, params = _reference(encoder_mode)
    model = _port(params, encoder_mode)
    want = np.asarray(apply(params, jpack(ref, size, NODE_BUDGET, EDGE_BUDGET)))
    with torch.inference_mode():
        got = model(tpack(port, size, NODE_BUDGET, EDGE_BUDGET).to("cpu")).numpy()
    assert got.shape == want.shape == ((size,) if not encoder_mode else (size, 8 * HIDDEN))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_node_label_style_matches_reference():
    size, ref, port = _ladder_case("2_graphs")
    apply, params = _reference(False, "node")
    model = _port(params, False, "node")
    want = np.asarray(apply(params, jpack(ref, size, NODE_BUDGET, EDGE_BUDGET)))
    with torch.inference_mode():
        got = model(tpack(port, size, NODE_BUDGET, EDGE_BUDGET).to("cpu")).numpy()
    assert got.shape == (NODE_BUDGET,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flagship_param_tree_converts_exactly():
    """The flagship model (input_dim 1002, hidden 32, 5 steps): the
    converted Flax tree fills every port parameter with the right shape,
    375,938 values on both sides, and values arrive unchanged (Dense
    kernels transposed for nn.Linear)."""
    model = JDeepDFA(input_dim=1002)
    rng = np.random.default_rng(0)
    params = model.init(
        jax.random.key(0), jpack(_graphs(rng, 2)[0], 2, 64, 256)
    )
    params = jax.tree.map(np.asarray, params)
    n_ref = sum(x.size for x in jax.tree.leaves(params))
    port = DeepDFA(1002)
    sd = from_jax_params(params)
    port.load_state_dict(sd)  # strict
    assert n_ref == sum(p.numel() for p in port.parameters()) == 375_938
    p = params["params"]
    np.testing.assert_array_equal(
        port.ggnn.gru.input_kernel.detach().numpy(),
        p["ggnn"]["GRUCell_0"]["input_proj"]["kernel"],
    )
    np.testing.assert_array_equal(
        port.head.dense_1.weight.detach().numpy(), p["head"]["dense_1"]["kernel"].T
    )
    np.testing.assert_array_equal(
        port.embedding.embed_literal.weight.detach().numpy(),
        p["embedding"]["embed_literal"]["embedding"],
    )
    with pytest.raises(KeyError, match="bitprop"):
        from_jax_params({"params": {**p, "bitprop": {}}})


def test_seeded_init_is_reproducible():
    a = DeepDFA(INPUT_DIM, HIDDEN, generator=torch.Generator().manual_seed(3))
    b = DeepDFA(INPUT_DIM, HIDDEN, generator=torch.Generator().manual_seed(3))
    c = DeepDFA(INPUT_DIM, HIDDEN, generator=torch.Generator().manual_seed(4))
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.ggnn.etype_kernel, c.ggnn.etype_kernel)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        DeepDFA(INPUT_DIM, HIDDEN, label_style="dataflow_solution_in")
    with pytest.raises(NotImplementedError, match="frontend slice"):
        DeepDFA.from_config(ModelConfig(struct_feats=True), INPUT_DIM)
    with pytest.raises(NotImplementedError, match="fp32"):
        DeepDFA.from_config(ModelConfig(param_dtype="bfloat16"), INPUT_DIM)
