"""The causal option of kernels 5-8, plain versions (`nn/flash_attention.py`:
`attention_plain`, `attention_bwd_plain`, `flash_fwd`/`flash_bwd` and
`FlashAttention` on CPU tensors) against the reference's
`flash_attention(..., causal=True)` in interpret mode and its custom VJP
(`_block_ok`, `_block_dead`): T = 256 in 128-blocks (the reference skips
its dead block; T spans four of the port's 64-row tiles) and a ragged T =
200 in one block, with and without the bias, keys padded at the end and
at the start (a query whose keys up to itself are all padding has no live
key: o = 0, a finite lse and zero gradients, as on the reference's flash
path). The forward's plain version is also held against the reference
at the generation path's three calls (decoder self-attention T 128,
causal and biased; cross-attention 128 x 256; the encoder's T 256,
biased), cut to B 2, H 2.

Tolerances: every output within 1e-5 of its own largest magnitude in fp32
(o, lse, dq, dk, dv and dbias); dbias above the diagonal exactly 0; at
the generation calls o and lse within rtol = atol = 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.nn import flash_attention as jfa  # noqa: E402
from deepdfa_tpu_torch.nn import flash_attention as tfa  # noqa: E402

REL = 1e-5  # fp32, of each tensor's largest magnitude


def _inputs(seed, B, H, T, D, lens, lead_pad=0):
    """q, k, v, do [B, H, T, D], bias [H, T, T], mask [B, T]: row b's keys
    are real below lens[b]; the last row also pads its first `lead_pad`."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    bias = (rng.standard_normal((H, T, T)) * 0.5).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    mask[-1, :lead_pad] = False
    return q, k, v, do, bias, mask


def _reference(q, k, v, do, bias, mask, scale, block):
    """(o, lse, grads) of the reference kernel's causal custom VJP in
    interpret mode; grads are (dq, dk, dv[, dbias])."""
    has_bias = bias is not None

    def fl(q, k, v, *b):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), scale=scale,
                                   bias=b[0] if b else None, causal=True, block_q=block,
                                   block_k=block, interpret=True)

    args = [jnp.asarray(x) for x in ((q, k, v, bias) if has_bias else (q, k, v))]
    o, vjp = jax.vjp(fl, *args)
    grads = vjp(jnp.asarray(do))
    T = q.shape[2]
    p = jfa._Params(scale=scale, dropout_rate=0.0, block_q=block, block_k=block,
                    n_q=T // block, n_k=T // block, use_prng=True, has_bias=has_bias,
                    causal=True, interpret=True)
    _, lse = jfa._fwd_call(p, *args[:3], jnp.asarray(mask, jnp.int32)[:, None, :],
                           jnp.zeros((1,), jnp.int32), jfa._dummy_bits(),
                           args[3] if has_bias else jfa._dummy_bias())
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= REL * scale, (what, err, scale)


@pytest.mark.parametrize(
    "T, block, biased, scale, lens, lead_pad",
    [(256, 128, True, 1.0, [256, 200, 77], 30),
     (256, 128, False, None, [256, 130, 255], 0),
     (200, 200, True, 1.0, [200, 64, 199], 5)],
    ids=["t5_decoder_lead_padding", "unbiased_default_scale", "ragged_T200_one_block"],
)
def test_plain_causal_fwd_and_bwd_match_reference(T, block, biased, scale, lens, lead_pad):
    q, k, v, do, bias, mask = _inputs(T + len(lens), 3, 2, T, 32, lens, lead_pad)
    bias = bias if biased else None
    s = 1.0 / np.sqrt(32) if scale is None else scale
    want_o, want_lse, want_g = _reference(q, k, v, do, bias, mask, s, block)
    qt, kt, vt, dot, mt = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    bt = None if bias is None else torch.from_numpy(bias)
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, scale=scale, bias=bt, causal=True)
    _close(o.numpy(), want_o, "o")
    _close(lse.numpy(), want_lse, "lse")
    assert np.isfinite(lse.numpy()).all()
    got = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot, scale=scale, bias=bt, causal=True)
    names = ("dq", "dk", "dv", "dbias")[:len(want_g)]
    for name, g, w in zip(names, got, want_g):
        _close(g.numpy(), w, name)
    if bt is None:
        assert got[3] is None
    else:  # above the diagonal ds is 0 in every batch row: dbias is exactly 0
        upper = np.triu(np.ones((T, T), bool), 1)
        assert (got[3].numpy()[:, upper] == 0).all()
        assert np.abs(got[3].numpy()[:, ~upper]).max() > 0
    # the same through autograd
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    if bt is not None:
        leaves.append(bt.clone().requires_grad_())
    out = tfa.flash_attention(*leaves[:3], mt, scale=scale, bias=leaves[3] if bt is not None
                              else None, causal=True)
    out.backward(dot)
    assert torch.equal(out.detach(), o)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)
    if lead_pad:  # the last row's first queries see only padding
        dead = slice(0, lead_pad)
        assert (o[-1, :, dead] == 0).all()
        assert (got[0][-1, :, dead] == 0).all()  # dq of a query without live keys


def test_causal_is_the_plain_mask_and_differs_from_noncausal():
    """The causal plain version equals a hand-built lower-triangular mask
    on the non-causal scores (no bias, every key live), and differs from
    the non-causal result everywhere but the last row."""
    q, k, v, _, _, mask = _inputs(1, 2, 2, 64, 16, [64, 64])
    qt, kt, vt, mt = (torch.from_numpy(x) for x in (q, k, v, mask))
    o = tfa.attention_plain(qt, kt, vt, mt, causal=True)[0]
    s = torch.matmul(qt, kt.transpose(-1, -2)) / 4.0
    s = s.masked_fill(~torch.tril(torch.ones(64, 64, dtype=torch.bool)), float("-inf"))
    torch.testing.assert_close(o, torch.softmax(s, -1) @ vt, rtol=1e-5, atol=1e-6)
    full = tfa.attention_plain(qt, kt, vt, mt)[0]
    # the last row sees every key
    torch.testing.assert_close(o[:, :, -1], full[:, :, -1], rtol=1e-5, atol=1e-6)
    assert not torch.allclose(o[:, :, 0], full[:, :, 0])


def test_causal_with_unequal_lengths_raises_in_both_packages():
    q, k, v, _, _, mask = _inputs(2, 1, 2, 64, 16, [64])
    with pytest.raises(ValueError, match="causal needs Tq == Tk"):
        jfa.flash_attention(jnp.asarray(q[:, :, :32]), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), causal=True, interpret=True)
    qt, kt, vt, mt = (torch.from_numpy(x) for x in (q, k, v, mask))
    with pytest.raises(ValueError, match="causal needs Tq == Tk"):
        tfa.flash_attention(qt[:, :, :32], kt, vt, mt, causal=True)
    with pytest.raises(ValueError, match="causal needs Tq == Tk"):
        tfa.flash_fwd(qt[:, :, :32], kt, vt, mt, causal=True)
    before = (tfa.LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES, tfa.DBIAS_LAUNCHES)
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, causal=True)
    tfa.flash_bwd(qt, kt, vt, mt, o, lse, qt, causal=True, bias=torch.zeros(2, 64, 64))
    # on the CPU the plain versions run: no launch is counted
    assert (tfa.LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES, tfa.DBIAS_LAUNCHES) == before


@pytest.mark.parametrize(
    "Tq, Tk, biased, causal, block, lens",
    [(128, 128, True, True, 64, [128, 93]),
     (128, 256, False, False, 128, [256, 141]),
     (256, 256, True, False, 128, [256, 200])],
    ids=["decoder_t128_causal_biased", "cross_t128x256", "encoder_t256_biased"],
)
def test_plain_fwd_matches_reference_at_the_generation_calls(Tq, Tk, biased, causal, block,
                                                             lens):
    """The forward's plain version (o and lse) against the reference's
    kernel in interpret mode at the generation path's three attention
    calls (T5's scale 1.0, D 64), cut to B 2, H 2, the second row's keys
    padded at the end: o and lse within rtol = atol = 1e-5 in fp32."""
    B, H, D = 2, 2, 64
    rng = np.random.default_rng(Tq + Tk + int(causal))
    q = (rng.standard_normal((B, H, Tq, D)) * D ** -0.5).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Tk, D)).astype(np.float32) for _ in range(2))
    bias = (rng.standard_normal((H, Tq, Tk)) * 0.5).astype(np.float32) if biased else None
    mask = np.arange(Tk)[None, :] < np.asarray(lens)[:, None]
    args = [jnp.asarray(x) for x in (q, k, v)]
    jb = None if bias is None else jnp.asarray(bias)
    want_o = jfa.flash_attention(*args, jnp.asarray(mask), scale=1.0, bias=jb, causal=causal,
                                 block_q=block, block_k=block, interpret=True)
    p = jfa._Params(scale=1.0, dropout_rate=0.0, block_q=block, block_k=block, n_q=Tq // block,
                    n_k=Tk // block, use_prng=True, has_bias=biased, causal=causal,
                    interpret=True)
    _, want_lse = jfa._fwd_call(p, *args, jnp.asarray(mask, jnp.int32)[:, None, :],
                                jnp.zeros((1,), jnp.int32), jfa._dummy_bits(),
                                jfa._dummy_bias() if jb is None else jb)
    o, lse = tfa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
                           scale=1.0, bias=None if bias is None else torch.from_numpy(bias),
                           causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)
    assert np.isfinite(lse.numpy()).all()
