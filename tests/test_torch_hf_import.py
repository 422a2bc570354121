"""Hugging Face weight import (`params_from_hf_torch` of
deepdfa_tpu_torch/models/transformer.py and t5.py, `gen_params_from_hf_torch`
of t5_gen.py) and the `attn_saved` layer checkpoint, against the
reference on the CPU.

The state dict of a randomly initialised `RobertaModel`,
`T5EncoderModel` and `T5ForConditionalGeneration` of a small config (the
reference's own tests' configs) goes through both packages' importers:

- the port's forward (hidden states; the seq2seq's teacher-forced
  logits) is within 1e-5 of the reference's forward over the reference's
  import (fp32);
- under remat_policy="attn_saved" the port's loss and gradients equal
  its "full" ones to the bit, while the flash forward runs once a layer
  instead of twice, and they are within 1e-5 of each leaf's scale
  (floored at 1e-3 of the largest gradient) of the reference's
  `jax.grad` under its `attn_saved` checkpoint policy (its XLA attention
  on the CPU). Reference gradients are carried to the port's layout by
  the same `from_jax_*` maps as parameters (they are linear).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.models import t5_gen as jgen  # noqa: E402
from deepdfa_tpu.models import transformer as jtfm  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    GenConfig,
    RobertaEncoder,
    T5Config,
    T5Encoder,
    T5Seq2Seq,
    TransformerConfig,
    from_jax_encoder_params,
    from_jax_gen_params,
    from_jax_t5_params,
)
from deepdfa_tpu_torch.models import t5 as tt5, t5_gen as tgen, transformer as ttfm  # noqa: E402
from deepdfa_tpu_torch.nn import flash_attention as fa  # noqa: E402

TOL = 1e-5
FAMILIES = ["roberta", "t5", "seq2seq"]
T5_KW = dict(vocab_size=256, d_model=64, num_layers=2, num_heads=4, d_kv=16, d_ff=128,
             relative_attention_num_buckets=32, relative_attention_max_distance=128,
             dropout_rate=0.0, feed_forward_proj="relu")


def _hf(family):
    torch.manual_seed(0)
    if family == "roberta":
        return transformers.RobertaModel(transformers.RobertaConfig(
            vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=40, type_vocab_size=1,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, pad_token_id=1),
            add_pooling_layer=True).eval()
    if family == "t5":
        return transformers.T5EncoderModel(transformers.T5Config(**T5_KW)).eval()
    return transformers.T5ForConditionalGeneration(transformers.T5Config(
        **T5_KW, num_decoder_layers=2, decoder_start_token_id=0, eos_token_id=2,
        pad_token_id=0)).eval()


def _ids(family, shape, seed=0):
    rng = np.random.default_rng(seed)
    if family == "roberta":
        ids = rng.integers(5, 128, shape)
        ids[:, 0] = 0
        ids[1, -5:] = 1  # ragged padding
        return ids.astype(np.int32)
    ids = rng.integers(3, 256, shape)
    ids[:, -3:] = 0
    ids[:, -4] = 2  # eos
    ids[0, -6:] = 0
    return ids.astype(np.int32)


def _setup(family, policy="full"):
    """(reference cfg, reference params, port module) over one HF model."""
    sd = _hf(family).state_dict()
    remat = dict(remat=True, remat_policy=policy)
    if family == "roberta":
        kw = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                  intermediate_size=64, max_position_embeddings=40, dropout_rate=0.0)
        jcfg = jtfm.TransformerConfig(**kw, **remat)
        port = RobertaEncoder(TransformerConfig(**kw, **remat))
        port.load_state_dict(ttfm.params_from_hf_torch(port.cfg, sd))
        return jcfg, jtfm.params_from_hf_torch(jcfg, sd), port
    jenc = jt5.T5Config.tiny(dropout_rate=0.0, **remat)
    tenc = T5Config.tiny(dropout_rate=0.0, **remat)
    if family == "t5":
        port = T5Encoder(tenc)
        port.load_state_dict(tt5.params_from_hf_torch(tenc, sd))
        return jenc, jt5.params_from_hf_torch(jenc, sd), port
    jcfg = jgen.GenConfig(encoder=jenc, max_target_length=8)
    port = T5Seq2Seq(GenConfig(encoder=tenc, max_target_length=8))
    port.load_state_dict(tgen.gen_params_from_hf_torch(port.cfg, sd))
    return jcfg, jgen.gen_params_from_hf_torch(jcfg, sd), port


def _inputs(family):
    if family == "roberta":
        return (_ids(family, (2, 24)),)
    if family == "t5":
        return (_ids(family, (2, 20)),)
    return _ids(family, (2, 12), 1), _ids(family, (2, 8), 2)


def _ref_out(family, jcfg, params, inputs):
    if family == "roberta":
        return jtfm.encode(jcfg, params, jnp.asarray(inputs[0]))
    if family == "t5":
        return jt5.encode(jcfg, params, jnp.asarray(inputs[0]))
    return jgen.seq2seq_logits(jcfg, params, *map(jnp.asarray, inputs))


def _port_out(family, port, inputs):
    ts = [torch.from_numpy(x).long() for x in inputs]
    if family == "seq2seq":
        return tgen.seq2seq_logits(port, *ts)
    return port.encode(ts[0])


@pytest.mark.parametrize("family", FAMILIES)
def test_hf_import_forward_matches_the_reference(family):
    jcfg, params, port = _setup(family)
    inputs = _inputs(family)
    want = np.asarray(_ref_out(family, jcfg, params, inputs))
    with torch.inference_mode():
        got = _port_out(family, port.eval(), inputs).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _weights(shape):
    return np.random.default_rng(7).normal(size=shape).astype(np.float32)


def _port_grads(family, port, inputs):
    out = _port_out(family, port.train(), inputs)
    loss = (out.float() * torch.from_numpy(_weights(tuple(out.shape)))).sum()
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in port.named_parameters()
                           if p.grad is not None}


def _to_port(family, tree):
    tree = jax.tree.map(np.asarray, tree)
    return {"roberta": from_jax_encoder_params, "t5": from_jax_t5_params,
            "seq2seq": from_jax_gen_params}[family](tree)


@pytest.mark.parametrize("family", FAMILIES)
def test_attn_saved_gradients_equal_full_and_the_reference(family, monkeypatch):
    inputs = _inputs(family)
    calls = {"n": 0}
    flash_fwd = fa.flash_fwd

    def counting(*a, **k):
        calls["n"] += 1
        return flash_fwd(*a, **k)

    monkeypatch.setattr(fa, "flash_fwd", counting)
    got = {}
    for policy in ("full", "attn_saved"):
        _, _, port = _setup(family, policy)
        calls["n"] = 0
        got[policy] = (*_port_grads(family, port, inputs), calls["n"])
    (l_full, g_full, n_full), (l_saved, g_saved, n_saved) = got["full"], got["attn_saved"]
    assert torch.equal(l_full, l_saved) and g_full.keys() == g_saved.keys()
    assert all(torch.equal(g_full[k], g_saved[k]) for k in g_full)
    flash_calls = {"roberta": 2, "t5": 2, "seq2seq": 6}[family]  # a forward's flash calls
    assert (n_full, n_saved) == (2 * flash_calls, flash_calls)

    jcfg, params, _ = _setup(family, "attn_saved")
    out_shape = np.asarray(_ref_out(family, jcfg, params, inputs)).shape
    w = jnp.asarray(_weights(out_shape))
    ref_grads = jax.grad(lambda p: (_ref_out(family, jcfg, p, inputs).astype(jnp.float32)
                                    * w).sum())(params)
    want = _to_port(family, ref_grads)
    floor = 1e-3 * max(float(v.abs().max()) for v in g_saved.values())
    for k, g in g_saved.items():
        scale = max(float(want[k].abs().max()), floor)
        err = float((g - want[k]).abs().max())
        assert err <= TOL * scale, (k, err, scale)
