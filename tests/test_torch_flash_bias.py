"""The additive score bias of kernels 5-7 and kernel 8 (dbias), plain
versions (`nn/flash_attention.py`: `attention_plain`,
`attention_bwd_plain`, `flash_fwd`/`flash_bwd` and `FlashAttention` on
CPU tensors) against the reference's `flash_attention(..., bias=)` in
interpret mode and its custom VJP, as the reference's own
`tests/test_flash_attention.py` runs it (128-blocks over T = 256, so the
reference streams two key blocks where the plain version takes one).

Tolerances: every output within 1e-5 of its own largest magnitude in
fp32 (o, lse, dq, dk, dv and dbias); the dropout case holds the math
through `debug_bits`, explicit uint32 bits given to both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.nn import flash_attention as jfa  # noqa: E402
from deepdfa_tpu_torch.nn import flash_attention as tfa  # noqa: E402

REL = 1e-5  # fp32, of each tensor's largest magnitude


def _inputs(seed, B, H, T, D, lens, bias_scale=0.5):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    bias = (rng.standard_normal((H, T, T)) * bias_scale).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    bits = rng.integers(0, 2**32, (B, H, T, T), dtype=np.uint32)
    return q, k, v, do, bias, mask, bits


def _reference(q, k, v, do, bias, mask, scale, rate=0.0, bits=None):
    """(o, lse, (dq, dk, dv, dbias)) of the reference kernel's custom VJP
    in interpret mode, 128-blocks."""
    jbits = None if bits is None else jnp.asarray(bits)

    def fl(q, k, v, bias):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), scale=scale, dropout_rate=rate,
                                   bias=bias, debug_bits=jbits, block_q=128, block_k=128,
                                   interpret=True)

    args = [jnp.asarray(x) for x in (q, k, v, bias)]
    o, vjp = jax.vjp(fl, *args)
    grads = vjp(jnp.asarray(do))
    B, H, T, D = q.shape
    p = jfa._Params(scale=scale, dropout_rate=rate, block_q=128, block_k=128, n_q=T // 128,
                    n_k=T // 128, use_prng=bits is None, has_bias=True, causal=False,
                    interpret=True)
    _, lse = jfa._fwd_call(p, *args[:3], jnp.asarray(mask, jnp.int32)[:, None, :],
                           jnp.zeros((1,), jnp.int32),
                           jfa._dummy_bits() if bits is None else jbits, args[3])
    return np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads]


def _close(got, want, what, scale=None):
    """Within REL of `scale`, by default want's largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30) if scale is None else scale
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= REL * scale, (what, err, scale)


@pytest.mark.parametrize(
    "scale, lens",
    [(1.0, [256, 200, 77, 0]), (None, [256, 1, 130, 255])],
    ids=["t5_scale1_all_padding_row", "default_scale_ragged"],
)
def test_plain_biased_fwd_and_bwd_match_reference(scale, lens):
    q, k, v, do, bias, mask, _ = _inputs(0, 4, 2, 256, 32, lens)
    want_o, want_lse, want_g = _reference(q, k, v, do, bias, mask,
                                          1.0 / np.sqrt(32) if scale is None else scale)
    qt, kt, vt, dot, bt, mt = (torch.from_numpy(x) for x in (q, k, v, do, bias, mask))
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, scale=scale, bias=bt)
    _close(o.numpy(), want_o, "o")
    _close(lse.numpy(), want_lse, "lse")
    got = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot, scale=scale, bias=bt)
    assert got[3].dtype == torch.float32 and got[3].shape == (2, 256, 256)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want_g):
        _close(g.numpy(), w, name)
    # the same through autograd, the bias a leaf
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt, bt)]
    out = tfa.flash_attention(*leaves[:3], mt, scale=scale, bias=leaves[3])
    out.backward(dot)
    assert torch.equal(out.detach(), o)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)
    if lens[-1] == 0:  # the all-padding row: o == 0, its gradients 0
        assert (o[3] == 0).all() and all((g[3] == 0).all() for g in got[:3])


def test_bias_composes_with_debug_bits_dropout():
    """Bias and probs dropout together (no model path uses both; the
    kernels allow it), held through explicit bits."""
    rate = 0.2
    q, k, v, do, bias, mask, bits = _inputs(1, 2, 2, 128, 16, [100, 128], bias_scale=0.3)
    want_o, want_lse, want_g = _reference(q, k, v, do, bias, mask, 1.0 / 4.0, rate, bits)
    qt, kt, vt, dot, bt, mt, bits_t = (torch.from_numpy(x)
                                       for x in (q, k, v, do, bias, mask, bits))
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, dropout_rate=rate, debug_bits=bits_t, bias=bt)
    _close(o.numpy(), want_o, "o")
    _close(lse.numpy(), want_lse, "lse")
    got = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot, dropout_rate=rate, debug_bits=bits_t,
                        bias=bt)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want_g):
        _close(g.numpy(), w, name)
    # the seed route draws the Philox bits, dbias included
    seed = 31337
    philox = tfa.dropout_bits(seed, 2, 2, 128, 128)
    seeded = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot, dropout_rate=rate, seed=seed, bias=bt)
    explicit = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot, dropout_rate=rate,
                             debug_bits=philox, bias=bt)
    assert all(torch.equal(a, b) for a, b in zip(seeded, explicit))


def test_padding_adds_nothing_to_dbias():
    """Keys that are padding in every row have dbias 0, and an
    all-padding batch row leaves dbias unchanged to the bit."""
    q, k, v, do, bias, mask, _ = _inputs(2, 3, 2, 64, 16, [40, 0, 33])
    qt, kt, vt, dot, bt, mt = (torch.from_numpy(x) for x in (q, k, v, do, bias, mask))
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, scale=1.0, bias=bt)
    dbias = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot, scale=1.0, bias=bt)[3]
    assert (dbias[:, :, 40:] == 0).all() and dbias[:, :, :40].abs().sum() > 0
    live = [0, 2]
    o2, lse2 = tfa.flash_fwd(qt[live], kt[live], vt[live], mt[live], scale=1.0, bias=bt)
    dbias2 = tfa.flash_bwd(qt[live], kt[live], vt[live], mt[live], o2, lse2, dot[live],
                           scale=1.0, bias=bt)[3]
    assert torch.equal(dbias, dbias2)


@pytest.mark.parametrize("q_dtype, bias_dtype",
                         [("float32", "float32"), ("bfloat16", "bfloat16"),
                          ("bfloat16", "float32")])
def test_bias_cotangent_takes_the_bias_dtype(q_dtype, bias_dtype):
    """FlashAttention returns dbias cast to the bias's dtype (the
    reference's `_flash_bwd`), and computes none for a bias that needs no
    gradient."""
    q, k, v, do, bias, mask, _ = _inputs(3, 2, 2, 32, 16, [32, 20])
    td, bd = getattr(torch, q_dtype), getattr(torch, bias_dtype)
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    b = torch.from_numpy(bias).to(bd).requires_grad_()
    out = tfa.flash_attention(*leaves, torch.from_numpy(mask), scale=1.0, bias=b)
    out.backward(torch.from_numpy(do).to(td))
    assert b.grad.dtype == bd and out.dtype == td
    o, lse = tfa.flash_fwd(*(x.detach() for x in leaves), torch.from_numpy(mask), scale=1.0,
                           bias=b.detach())
    want = tfa.flash_bwd(*(x.detach() for x in leaves), torch.from_numpy(mask), o, lse,
                         torch.from_numpy(do).to(td), scale=1.0, bias=b.detach())[3]
    assert torch.equal(b.grad, want.to(bd))
    frozen = torch.from_numpy(bias).to(bd)
    leaves = [x.detach().requires_grad_() for x in leaves]
    tfa.flash_attention(*leaves, torch.from_numpy(mask), scale=1.0, bias=frozen).sum().backward()
    assert frozen.grad is None and all(x.grad is not None for x in leaves)


def test_dbias_wrapper_refuses_the_cpu_and_a_missing_bias():
    q, k, v, do, bias, mask, _ = _inputs(4, 1, 2, 16, 8, [16])
    qt, kt, vt, dot, bt, mt = (torch.from_numpy(x) for x in (q, k, v, do, bias, mask))
    lse = torch.zeros(1, 2, 16, 1)
    with pytest.raises(ValueError, match="attention_bwd_plain"):
        tfa.flash_dbias(qt, kt, vt, mt, lse, lse, dot, bt)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_fwd(qt, kt, vt, mt, bias=bt[:1])
    before = tfa.DBIAS_LAUNCHES
    tfa.flash_bwd(qt, kt, vt, mt, *tfa.flash_fwd(qt, kt, vt, mt, bias=bt), dot, bias=bt)
    assert tfa.DBIAS_LAUNCHES == before  # counted only where the kernel launches


#: the kernels' tiling edges: one row or key, a 64-row tile's last and one
#: past, two tiles' either side, and Tq != Tk both ways
EDGE_T = [(1, 1), (1, 200), (200, 1), (63, 65), (65, 63), (127, 129), (129, 127), (200, 64),
          (64, 200)]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("Tq, Tk", EDGE_T, ids=[f"q{a}_k{b}" for a, b in EDGE_T])
def test_plain_biased_bwd_matches_reference_at_the_tile_edges(Tq, Tk, rate):
    """The biased plain versions against the reference's custom VJP
    (interpret mode, one block a side) at the shapes where the kernels'
    tiles end, T5's scale 1.0, with and without dropout through explicit
    bits; a full, a half and an all-padding batch row. With one key (Tk =
    1) every live row's p is 1 and ds = p (dp - delta) is 0 up to fp32
    rounding, so dq, dk and dbias are rounding noise on both sides: they
    are held to REL of dv's scale, the call's other gradient."""
    rng = np.random.default_rng(20 + Tq + Tk)
    B, H, D = 3, 2, 16
    q, do = (rng.standard_normal((B, H, Tq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, H, Tk, D)).astype(np.float32) for _ in range(2))
    bias = (rng.standard_normal((H, Tq, Tk)) * 0.5).astype(np.float32)
    mask = np.arange(Tk)[None, :] < np.asarray([Tk, (Tk + 1) // 2, 0])[:, None]
    bits = rng.integers(0, 2**32, (B, H, Tq, Tk), dtype=np.uint32)
    jbits = jnp.asarray(bits) if rate else None

    def fl(q, k, v, bias):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), scale=1.0, dropout_rate=rate,
                                   bias=bias, debug_bits=jbits, block_q=Tq, block_k=Tk,
                                   interpret=True)

    want_o, vjp = jax.vjp(fl, *(jnp.asarray(x) for x in (q, k, v, bias)))
    want_g = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt, dot, bt, mt = (torch.from_numpy(x) for x in (q, k, v, do, bias, mask))
    bits_t = torch.from_numpy(bits) if rate else None
    o, lse = tfa.flash_fwd(qt, kt, vt, mt, scale=1.0, dropout_rate=rate, debug_bits=bits_t,
                           bias=bt)
    _close(o.numpy(), np.asarray(want_o), "o")
    got = tfa.flash_bwd(qt, kt, vt, mt, o, lse, dot, scale=1.0, dropout_rate=rate,
                        debug_bits=bits_t, bias=bt)
    noise = float(np.abs(want_g[2]).max()) if Tk == 1 else None
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want_g):
        _close(g.numpy(), w, name, None if name == "dv" else noise)
    assert all((g[2] == 0).all() for g in got[:3])  # the all-padding row



#: (B, slices): cuts of the batch as the FMA dbias makes them, contiguous
#: runs of ceil(B / slices) rows with the last one shorter: no cut, an
#: odd batch in 2, 3 and 5 runs, the gen path's 16 in 4 and in 16
BATCH_CUTS = [(1, 1), (5, 2), (5, 3), (5, 5), (16, 4), (16, 16)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("B, slices", BATCH_CUTS, ids=[f"b{b}_s{s}" for b, s in BATCH_CUTS])
def test_dbias_is_the_in_order_sum_of_its_batch_runs(B, slices, causal):
    """dbias is the batch sum of ds, so a cut batch gives the whole one:
    the reference's dbias of the whole batch (interpret mode, causal or
    not) equals, within REL, the plain version's dbias of each contiguous
    run of the batch summed in run order, as the FMA kernel sums its
    slices' partials; ragged rows and an all-padding one included."""
    _check_run_sums(B, slices, causal, 64)


#: (T, B, slices): the tensor-core dbias's cuts at the T5 path's short
#: buckets, runs of 4 rows at T 128 (B 64 in 16) and of 8 at T 256 (B 32
#: in 4), here at fewer rows with the same run lengths, and an odd batch
#: whose last run is shorter
BUCKET_CUTS = [(128, 8, 2), (128, 7, 2), (256, 16, 2), (256, 5, 3)]


@pytest.mark.parametrize("T, B, slices", BUCKET_CUTS,
                         ids=[f"t{t}_b{b}_s{s}" for t, b, s in BUCKET_CUTS])
def test_dbias_run_sums_at_the_t5_buckets(T, B, slices):
    """test_dbias_is_the_in_order_sum_of_its_batch_runs at the T5 path's
    bucket lengths T 128 and 256, where the tensor-core dbias cuts the
    batch (the reference's blocks min(512, T) wide)."""
    _check_run_sums(B, slices, False, T)


def _check_run_sums(B, slices, causal, T):
    rng = np.random.default_rng(40 + B + slices + (T if T != 64 else 0))
    H, D = 2, 16
    q, k, v, do = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    bias = (rng.standard_normal((H, T, T)) * 0.5).astype(np.float32)
    lens = np.resize([T, 1, 0, 40, T - 1], B)
    mask = np.arange(T)[None, :] < lens[:, None]
    if causal:  # the causal build takes every row at full length
        mask[:] = True

    def fl(q, k, v, bias):
        return jfa.flash_attention(q, k, v, jnp.asarray(mask), scale=1.0, bias=bias,
                                   causal=causal, block_q=T, block_k=T, interpret=True)

    _, vjp = jax.vjp(fl, *(jnp.asarray(x) for x in (q, k, v, bias)))
    want = np.asarray(vjp(jnp.asarray(do))[3])
    qt, kt, vt, dot, bt, mt = (torch.from_numpy(x) for x in (q, k, v, do, bias, mask))
    per = -(-B // slices)
    total = torch.zeros(H, T, T)
    for b0 in range(0, B, per):
        run = slice(b0, b0 + per)
        o, lse = tfa.flash_fwd(qt[run], kt[run], vt[run], mt[run], scale=1.0, bias=bt,
                               causal=causal)
        total += tfa.flash_bwd(qt[run], kt[run], vt[run], mt[run], o, lse, dot[run], scale=1.0,
                               bias=bt, causal=causal)[3]
    _close(total.numpy(), want, "dbias")
    if causal:
        assert (total.triu(1) == 0).all()
