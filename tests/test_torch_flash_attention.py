"""Kernel 5's plain version (`nn/flash_attention.py:attention_plain`,
what `flash_fwd` runs on CPU tensors) against the reference Pallas
kernel `flash_attention` in interpret mode, multi-block (T = 256 in
128-blocks), with ragged kv masks and an all-padding row.

Tolerances: fp32 rtol = atol = 1e-5 (the reference streams two k-blocks
with the online softmax, the plain version takes one); bf16 2e-2 (p is
rounded to bf16 against a different running max in each). lse is held
against the log-sum-exp of the masked scores in float64 (atol 1e-5) and
against the reference kernel's own lse output."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.nn import flash_attention as jfa  # noqa: E402
from deepdfa_tpu_torch.nn import flash_attention as tfa  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LENS = [256, 200, 77, 0]  # full, ragged, ragged, all padding


def _inputs(rng, B, H, Tq, Tk, D, lens):
    q = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, D)).astype(np.float32)
    mask = np.arange(Tk)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, mask


def _reference(q, k, v, mask, dtype, block):
    """(o, lse) of the reference kernel (interpret mode) in `dtype`."""
    jd = jnp.dtype(dtype)
    qj, kj, vj = (jnp.asarray(x, jd) for x in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    bq, bk = min(block, Tq), min(block, Tk)
    p = jfa._Params(scale=float(D) ** -0.5, dropout_rate=0.0, block_q=bq, block_k=bk,
                    n_q=Tq // bq, n_k=Tk // bk, use_prng=True, has_bias=False, causal=False,
                    interpret=True)
    out = jfa.flash_attention(qj, kj, vj, jnp.asarray(mask), block_q=block, block_k=block,
                              interpret=True)
    _, lse = jfa._fwd_call(p, qj, kj, vj, jnp.asarray(mask, jnp.int32)[:, None, :],
                           jnp.zeros((1,), jnp.int32), jfa._dummy_bits(), jfa._dummy_bias())
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _port(q, k, v, mask, dtype):
    td = getattr(torch, dtype)
    o, lse = tfa.flash_fwd(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                           torch.from_numpy(mask))
    assert o.dtype == td and lse.dtype == torch.float32
    return o.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(dtype):
    rng = np.random.default_rng(0)
    q, k, v, mask = _inputs(rng, 4, 2, 256, 256, 64, LENS)
    want_o, want_lse = _reference(q, k, v, mask, dtype, block=128)
    got_o, got_lse = _port(q, k, v, mask, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got_o, want_o, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-5, atol=1e-5)
    # the all-padding row: o == 0 exactly and a finite lse, never NaN
    assert (got_o[3] == 0).all() and (want_o[3] == 0).all()
    assert np.isfinite(got_lse).all()


def test_lse_is_the_log_sum_exp_of_the_masked_scores():
    rng = np.random.default_rng(1)
    q, k, v, mask = _inputs(rng, 4, 2, 256, 256, 32, LENS)
    _, lse = _port(q, k, v, mask, "float32")
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * 32 ** -0.5
    for b, n in enumerate(LENS):
        if n == 0:
            np.testing.assert_array_equal(lse[b], np.float32(-1e30))
            continue
        sv = s[b][..., :n]
        m = sv.max(-1, keepdims=True)
        want = (m + np.log(np.exp(sv - m).sum(-1, keepdims=True)))
        np.testing.assert_allclose(lse[b], want, rtol=1e-5, atol=1e-5)


def test_cross_attention_and_strided_views():
    """Tq != Tk (the decoder's cross-attention shape) against the
    reference, and q/k/v given as strided [B, T, H, D] -> [B, H, T, D]
    views (the encoder's layout) give the same result as contiguous."""
    rng = np.random.default_rng(2)
    q, k, v, mask = _inputs(rng, 2, 3, 96, 256, 16, [256, 31])
    want_o, want_lse = _reference(q, k, v, mask, "float32", block=128)
    got_o, got_lse = _port(q, k, v, mask, "float32")
    np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lse, want_lse, rtol=1e-5, atol=1e-5)
    qt, kt, vt = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)
                  for x in (q, k, v))
    assert not qt.is_contiguous()
    o, lse = tfa.flash_fwd(qt, kt, vt, torch.from_numpy(mask))
    np.testing.assert_array_equal(o.numpy(), got_o)
    np.testing.assert_array_equal(lse.numpy(), got_lse)


def test_flash_attention_returns_o_and_refuses_unported_options():
    rng = np.random.default_rng(3)
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(rng, 2, 2, 16, 16, 8, [16, 3]))
    o = tfa.flash_attention(q, k, v, mask)
    torch.testing.assert_close(o, tfa.attention_plain(q, k, v, mask)[0], rtol=0, atol=0)
    torch.testing.assert_close(tfa.flash_attention(q, k, v, mask, scale=0.5),
                               tfa.attention_plain(q, k, v, mask, 0.5)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a seed"):  # dropout runs, with a seed
        tfa.flash_attention(q, k, v, mask, dropout_rate=0.1)
    # the additive bias is ported: it is the plain version with the bias
    bias = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(np.float32))
    torch.testing.assert_close(tfa.flash_attention(q, k, v, mask, bias=bias),
                               tfa.attention_plain(q, k, v, mask, bias=bias)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention(q, k, v, mask, bias=bias[:, :8])
    # the causal option is ported: the plain version with the causal mask;
    # Tq != Tk refuses it, as the reference does
    torch.testing.assert_close(tfa.flash_attention(q, k, v, mask, causal=True),
                               tfa.attention_plain(q, k, v, mask, causal=True)[0],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="causal needs Tq == Tk"):
        tfa.flash_attention(q, k[:, :, :8], v[:, :, :8], mask[:, :8], causal=True)
    with pytest.raises(ValueError, match="kv_mask"):
        tfa.flash_fwd(q, k, v, mask[:, :8])
    with pytest.raises(ValueError, match="must be"):
        tfa.flash_fwd(q, k[:, :1], v, mask)


def test_shape_rule_and_impl_resolution():
    assert tfa.flash_shape_ok(512, 64) and tfa.flash_shape_ok(77, 128, Tk=300)
    assert not tfa.flash_shape_ok(512, 192)
    # one rule with and without a bias: the kernels read the bias from
    # device memory, so the reference's VMEM cap on biased T does not apply
    assert tfa.flash_shape_ok(8192, 64) and not jfa.flash_shape_ok(8192, 64, biased=True)
    assert tfa.resolve_impl("auto", 513, 64) == "flash"  # ragged tails are masked in-kernel
    assert tfa.resolve_impl("xla", 512, 64) == "xla"
    assert tfa.resolve_impl("flash", 130, 64) == "flash"
    # on the card an untileable shape raises under "auto" too: no silent plain route
    for impl in ("auto", "flash"):
        with pytest.raises(ValueError, match="cannot tile"):
            tfa.resolve_impl(impl, 512, 192)
    assert tfa.resolve_impl("auto", 512, 192, cuda=False) == "xla"
    with pytest.raises(ValueError, match="cannot tile"):
        tfa.resolve_impl("flash", 512, 192, cuda=False)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tfa.resolve_impl("sdpa", 512, 64)
    # what the reference's flash kernel tiles, the port's takes too
    for T in (128, 256, 512, 1024):
        assert jfa.flash_shape_ok(T, 64) and tfa.flash_shape_ok(T, 64)


def test_cpu_tensors_run_the_plain_version():
    before = tfa.LAUNCHES
    rng = np.random.default_rng(4)
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(rng, 1, 1, 8, 8, 8, [5]))
    tfa.flash_fwd(q, k, v, mask)
    assert tfa.LAUNCHES == before  # counted only where the kernel launches
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tfa.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), mask.to("meta"))
    assert jax.devices()[0].platform == "cpu"
