"""The port's RoBERTa encoder (deepdfa_tpu_torch/models/transformer.py)
against the reference `encode` at a tiny config, weights carried over by
`from_jax_encoder_params`.

The reference runs its Pallas flash kernel in interpret mode
(DEEPDFA_TPU_FLASH_INTERPRET=1, as tests/test_flash_attention.py does);
the port on the CPU runs the kernel's plain version. Tolerances: fp32
rtol = atol = 1e-5 (cross-framework reassociation); bf16 5e-2 (bf16
rounds at other points of the matmuls, GELU and the attention in the
two frameworks). Inputs carry ragged padding and one all-pad row."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.models import transformer as jtfm  # noqa: E402
from deepdfa_tpu_torch.models import RobertaEncoder, TransformerConfig, from_jax_encoder_params  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TINY = dict(vocab_size=256, max_position_embeddings=70, num_layers=2, num_heads=4,
            hidden_size=64, intermediate_size=128)


def _ids():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 256, (4, 64)).astype(np.int32)
    ids[:, 0] = 0  # <s>
    ids[1, 30:] = 1  # ragged padding
    ids[2, 5:] = 1
    ids[3, :] = 1  # an all-pad row
    return ids


def _params():
    cfg = jtfm.TransformerConfig.tiny(**TINY)
    return jax.tree.map(np.asarray, jtfm.init_params(cfg, jax.random.key(0)))


def _port(params, dtype, **kw):
    model = RobertaEncoder(TransformerConfig.tiny(**TINY, dtype=dtype, **kw))
    model.load_state_dict(from_jax_encoder_params(params))  # strict
    return model.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference_flash_path(dtype, monkeypatch):
    monkeypatch.setenv("DEEPDFA_TPU_FLASH_INTERPRET", "1")
    params = _params()
    cfg = jtfm.TransformerConfig.tiny(**TINY, dtype=dtype)
    assert jtfm._resolve_attn_impl(cfg, 64, cfg.head_dim) == "flash"
    ids = _ids()
    want = jtfm.encode(cfg, params, jnp.asarray(ids))
    want_pool = np.asarray(jtfm.cls_pool(cfg, params, want).astype(jnp.float32))
    want = np.asarray(want.astype(jnp.float32))
    model = _port(params, dtype)
    with torch.inference_mode():
        hidden = model.encode(torch.from_numpy(ids))
        pooled = model.cls_pool(hidden)
    assert hidden.dtype == getattr(torch, dtype) and hidden.shape == (4, 64, 64)
    tol = TOL[dtype]
    np.testing.assert_allclose(hidden.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(pooled.float().numpy(), want_pool, rtol=tol, atol=tol)


def test_embed_matches_reference_and_guards_the_position_table():
    params = _params()
    cfg = jtfm.TransformerConfig.tiny(**TINY)
    ids = _ids()
    want = np.asarray(jtfm.embed(cfg, params, jnp.asarray(ids)))
    model = _port(params, "float32")
    with torch.inference_mode():
        got = model.embed(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # RoBERTa position ids run to pad + T: T = 68 needs row 69 of 70, 69 does not fit
    with torch.inference_mode():
        model.embed(torch.full((1, 68), 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="position table"):
        model.embed(torch.full((1, 69), 5, dtype=torch.int32))


def test_attention_routes_agree_on_the_cpu():
    """"flash" and "xla" both run the plain version on CPU tensors, so
    the encoder gives the same bits either way."""
    params = _params()
    ids = torch.from_numpy(_ids())
    with torch.inference_mode():
        a = _port(params, "float32", attn_impl="flash").encode(ids)
        b = _port(params, "float32", attn_impl="xla").encode(ids)
    assert torch.equal(a, b)


def test_converted_tree_and_seeded_init():
    params = _params()
    n_ref = sum(x.size for x in jax.tree.leaves(params))
    model = _port(params, "float32")
    assert sum(p.numel() for p in model.parameters()) == n_ref
    lay = params["layers"]
    d = TINY["hidden_size"]
    np.testing.assert_array_equal(model.layers[1].wqkv.detach().numpy()[:, d:2 * d],
                                  lay["wk"][1].reshape(d, d))
    np.testing.assert_array_equal(model.layers[0].wo.detach().numpy(), lay["wo"][0].reshape(d, d))
    cfg = TransformerConfig.tiny(**TINY)
    a = RobertaEncoder(cfg, generator=torch.Generator().manual_seed(1))
    b = RobertaEncoder(cfg, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert abs(a.layers[0].w1.std().item() - 0.02) < 2e-3
    with pytest.raises(KeyError, match="no module"):
        from_jax_encoder_params({**params, "adapter": {}})


def test_unported_knobs_raise():
    cfg = TransformerConfig.tiny(**TINY)
    with pytest.raises(NotImplementedError, match="multi-device"):
        TransformerConfig.tiny(**TINY, sp_variant="ulysses")
    with pytest.raises(ValueError, match="attn_impl"):
        TransformerConfig.tiny(**TINY, attn_impl="sdpa")
    model = RobertaEncoder(cfg)
    ids = torch.from_numpy(_ids())
    # attn_saved (remat with grads on) runs, and gives "full"'s bits
    outs = []
    for policy in ("full", "attn_saved"):
        enc = RobertaEncoder(dataclasses.replace(cfg, remat_policy=policy),
                             generator=torch.Generator().manual_seed(1))
        h = enc.encode(ids, dropout_key=5)
        h.float().square().mean().backward()
        outs.append((h.detach(), [p.grad for p in enc.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(outs[0][1], outs[1][1]))
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerConfig.tiny(**TINY, remat_policy="dots")
    model.eval()
    for kw in ({"sp_axis": "sp"}, {"tp_axis": "tp"}):
        with pytest.raises(NotImplementedError, match="multi-device"):
            model.encode(ids, **kw)
    model = RobertaEncoder(dataclasses.replace(cfg, dropout_rate=0.0))
    with torch.inference_mode():
        model.encode(ids)  # training mode without dropout runs
    with pytest.raises(ValueError, match="pooler"):
        RobertaEncoder(cfg, with_pooler=False).cls_pool(torch.zeros(1, 2, 64))
