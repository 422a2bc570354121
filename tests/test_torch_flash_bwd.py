"""Kernels 6 and 7 and kernel 5's dropout, plain versions
(`nn/flash_attention.py`: `attention_plain`, `attention_bwd_plain`, the
Philox bits, `FlashAttention` on CPU tensors) against the reference's
`flash_attention` in interpret mode.

The port's dropout bits are Philox4x32-10 per element, the reference's
the TPU PRNG per block: the two cannot agree, so parity runs through
`debug_bits` (explicit uint32 bits given to both), as the reference's own
`tests/test_flash_attention.py` does. Tolerances are that test's: 2e-6
on o, atol 5e-6 / rtol 1e-4 on the gradients (fp32; the reference
streams two 128-key blocks, the plain version takes one)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.nn import flash_attention as jfa  # noqa: E402
from deepdfa_tpu_torch.nn import flash_attention as tfa  # noqa: E402

RATE = 0.1
# Random123's known-answer vectors for Philox4x32-10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
]


@pytest.mark.parametrize("counter, key, want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answer_vectors(counter, key, want):
    got = " ".join(f"{int(w):08x}" for w in tfa.philox4x32_10(counter, key))
    assert got == want


def test_keep_fraction_is_one_minus_rate_within_4_sigma():
    B, H, T = 2, 4, 128
    bits = tfa.dropout_bits(2024, B, H, T, T)
    n = bits.numel()
    frac = float((bits < tfa.keep_threshold(RATE)).double().mean())
    sigma = (RATE * (1 - RATE) / n) ** 0.5
    assert abs(frac - (1 - RATE)) < 4 * sigma
    assert 0 <= int(bits.min()) and int(bits.max()) < 2**32
    assert tfa.keep_threshold(0.0) == 2**32 - 1 and tfa.keep_threshold(0.5) == 2**31


def test_bits_do_not_depend_on_how_a_call_is_tiled():
    """The bits of an element are a function of (seed, b, h, row, col)
    alone: a smaller call is a corner of a larger one, every 64 x 64 tile
    equals its own Philox calls, and another seed gives other bits."""
    seed = (7 << 40) + 12345
    B, H = 2, 3
    big = tfa.dropout_bits(seed, B, H, 130, 131)
    assert torch.equal(tfa.dropout_bits(seed, B, H, 64, 70), big[:, :, :64, :70])
    key = tfa.seed_words(seed)
    rng = np.random.default_rng(0)
    for b, h, row, col in zip(rng.integers(0, B, 20), rng.integers(0, H, 20),
                              rng.integers(0, 130, 20), rng.integers(0, 131, 20)):
        words = tfa.philox4x32_10((int(col) // 4, int(row), int(b) * H + int(h), 0), key)
        assert int(big[b, h, row, col]) == int(words[int(col) % 4])
    for r0, c0 in ((0, 64), (64, 0), (64, 64)):  # tiles of the kernels' 64 x 64 grid
        rows = torch.arange(r0, r0 + 64).view(1, 1, 64, 1)
        cols = torch.arange(c0, c0 + 64).view(1, 1, 1, 64)
        bh = torch.arange(B * H).view(B, H, 1, 1)
        words = tfa.philox4x32_10((cols // 4, rows, bh, 0), key)
        tile = torch.stack([w.expand(B, H, 64, 64) for w in words], -1)
        tile = tile.gather(-1, (cols % 4).expand(B, H, 64, 64)[..., None])[..., 0]
        assert torch.equal(tile, big[:, :, r0:r0 + 64, c0:c0 + 64])
    assert not torch.equal(tfa.dropout_bits(seed + 1, B, H, 64, 64), big[:, :, :64, :64])


def _inputs(seed, B, H, T, D, lens):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    bits = rng.integers(0, 2**32, (B, H, T, T), dtype=np.uint32)
    return q, k, v, do, mask, bits


def _reference(q, k, v, do, mask, rate, bits, dtype=jnp.float32):
    """(o, (dq, dk, dv)) of the reference kernel's custom VJP in
    interpret mode, 128-blocks."""
    def fl(q, k, v):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), dropout_rate=rate,
                                   debug_bits=None if bits is None else jnp.asarray(bits),
                                   block_q=128, block_k=128, interpret=True)

    o, vjp = jax.vjp(fl, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return np.asarray(o.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def test_plain_fwd_and_bwd_match_reference_with_debug_bits():
    q, k, v, do, mask, bits = _inputs(0, 2, 2, 256, 32, [230, 120])
    want_o, want_g = _reference(q, k, v, do, mask, RATE, bits)
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    mt, bt = torch.from_numpy(mask), torch.from_numpy(bits)
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, dropout_rate=RATE, debug_bits=bt)
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-6, rtol=0)
    got = tfa.attention_bwd_plain(qt, kt, vt, mt, o, lse, dot, dropout_rate=RATE, bits=bt)[:3]
    for name, g, w in zip("qkv", got, want_g):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-6, rtol=1e-4, err_msg=f"d{name}")
    # the same through autograd: FlashAttention on CPU tensors
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    out = tfa.flash_attention(*leaves, mt, dropout_rate=RATE, debug_bits=bt)
    out.backward(dot)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_dropout_grads_match_reference_vjp(dtype):
    q, k, v, do, mask, _ = _inputs(1, 2, 2, 256, 64, [256, 77])
    want_o, want_g = _reference(q, k, v, do, mask, 0.0, None, jnp.dtype(dtype))
    td = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, torch.from_numpy(mask))
    o.backward(torch.from_numpy(do).to(td))
    if dtype == "float32":
        np.testing.assert_allclose(o.detach().numpy(), want_o, atol=2e-6, rtol=0)
        for leaf, w in zip(leaves, want_g):
            np.testing.assert_allclose(leaf.grad.numpy(), w, atol=5e-6, rtol=1e-4)
    else:  # bf16: p rounds against another running max; 2e-2 of each scale
        for leaf, w in zip(leaves, want_g):
            err = np.abs(leaf.grad.float().numpy() - w).max()
            assert err <= 2e-2 * np.abs(w).max(), err
            assert leaf.grad.dtype == torch.bfloat16


def test_seeded_dropout_draws_the_philox_bits():
    """The seed route and debug_bits carrying dropout_bits(seed) give the
    same bits forward and backward; another seed another mask."""
    q, k, v, do, mask, _ = _inputs(2, 2, 3, 80, 16, [80, 33])
    qt, kt, vt, dot, mt = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    seed = 2**63 + 17
    bits = tfa.dropout_bits(seed, 2, 3, 80, 80)

    def run(**kw):
        leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
        out = tfa.flash_attention(*leaves, mt, dropout_rate=RATE, **kw)
        out.backward(dot)
        return [out.detach()] + [x.grad for x in leaves]

    seeded, explicit = run(seed=seed), run(debug_bits=bits)
    assert all(torch.equal(a, b) for a, b in zip(seeded, explicit))
    assert not torch.equal(run(seed=seed + 1)[0], seeded[0])
    with pytest.raises(ValueError, match="needs a seed"):
        tfa.flash_attention(qt, kt, vt, mt, dropout_rate=RATE)
    with pytest.raises(ValueError, match="64-bit"):
        tfa.flash_fwd(qt, kt, vt, mt, dropout_rate=RATE, seed=-1)


def test_cpu_tensors_run_the_plain_backward():
    q, k, v, do, mask, _ = _inputs(3, 1, 2, 40, 8, [31])
    qt, kt, vt, dot, mt = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    before = (tfa.LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    o, lse = tfa.flash_fwd(qt, kt, vt, mt)
    got = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot)
    want = tfa.attention_bwd_plain(qt, kt, vt, mt, o, lse, dot)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert got[3] is None and want[3] is None  # no bias, no dbias
    assert (tfa.LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == before
    lse4 = lse.view(1, 2, 40, 1)
    for fn in (tfa.flash_dq, tfa.flash_dkv):
        with pytest.raises(ValueError, match="attention_bwd_plain"):
            fn(qt, kt, vt, mt, lse4, lse4, dot)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tfa.flash_bwd(*(x.to("meta") for x in (qt, kt, vt, mt, o, lse, dot)))


def test_all_padding_row_gives_zero_gradients():
    """A batch row with no real key (a training batch's filler row) has
    lse = -1e30; p is masked before exp(s - lse), so its gradients, and
    those of every padded key, are exactly 0, with dropout too."""
    q, k, v, do, mask, bits = _inputs(4, 2, 2, 96, 16, [0, 50])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, torch.from_numpy(mask), dropout_rate=RATE,
                              debug_bits=torch.from_numpy(bits))
    out.backward(torch.from_numpy(do))
    assert (out[0] == 0).all()
    for leaf in leaves:
        assert torch.isfinite(leaf.grad).all() and (leaf.grad[0] == 0).all()
    for leaf in leaves[1:]:  # the padded keys of the live row
        assert (leaf.grad[1, :, 50:] == 0).all()
    assert leaves[0].grad[1].abs().sum() > 0


#: the kernels' tiling edges: one row or key, a 64-row tile's last and one
#: past, two tiles' either side, and Tq != Tk both ways
EDGE_T = [(1, 1), (1, 200), (200, 1), (63, 65), (65, 63), (127, 129), (129, 127), (200, 64),
          (64, 200)]


def _edge_inputs(seed, Tq, Tk, D=16):
    """q, k, v, do, a mask with a full, a half and an all-padding row, and
    explicit bits: B 3, H 2."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((3, 2, Tq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((3, 2, Tk, D)).astype(np.float32) for _ in range(2))
    mask = np.arange(Tk)[None, :] < np.asarray([Tk, (Tk + 1) // 2, 0])[:, None]
    bits = rng.integers(0, 2**32, (3, 2, Tq, Tk), dtype=np.uint32)
    return q, k, v, do, mask, bits


@pytest.mark.parametrize("Tq, Tk", EDGE_T, ids=[f"q{a}_k{b}" for a, b in EDGE_T])
def test_plain_bwd_matches_reference_at_the_tile_edges(Tq, Tk):
    """attention_bwd_plain against the reference's custom VJP (interpret
    mode, one block a side) at the shapes where the kernels' tiles end,
    dropout 0.1 through explicit bits. With one key (Tk = 1) every live
    row's p is 1 and ds = p (dp - delta) is 0 up to fp32 rounding, so dq
    and dk are rounding noise on both sides: they are held to the
    tolerance in absolute terms, as every gradient is."""
    q, k, v, do, mask, bits = _edge_inputs(10 + Tq + Tk, Tq, Tk)

    def fl(q, k, v):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), dropout_rate=RATE,
                                   debug_bits=jnp.asarray(bits), block_q=Tq, block_k=Tk,
                                   interpret=True)

    want_o, vjp = jax.vjp(fl, *(jnp.asarray(x) for x in (q, k, v)))
    want_g = vjp(jnp.asarray(do))
    qt, kt, vt, dot, mt, bt = (torch.from_numpy(x) for x in (q, k, v, do, mask, bits))
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, dropout_rate=RATE, debug_bits=bt)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=2e-6, rtol=0)
    got = tfa.attention_bwd_plain(qt, kt, vt, mt, o, lse, dot, dropout_rate=RATE, bits=bt)[:3]
    for name, g, w in zip("qkv", got, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-6, rtol=1e-4,
                                   err_msg=f"d{name}")
        assert (g[2] == 0).all()  # the all-padding row
