"""The port's T5 generation model (`models/t5_gen.py`) against the
reference's `deepdfa_tpu/models/t5_gen.py` on the CPU: the decoder's
unidirectional bucket table, the encoder's and decoder's cached one-hots,
`decode_train` (logits and `return_hidden`), `seq2seq_loss` and every
gradient leaf (the decoder's `rel_bias` through the causal dbias and the
one-hot product) with the tied and an untied LM head, `_decode_step`'s
logits at every step, `beam_search` and `greedy_decode` ids, `trim_at_eos`,
and the clone head's logits and gradients.

The reference runs its causal flash kernel in interpret mode
(DEEPDFA_TPU_FLASH_INTERPRET=1), without remat (that mode cannot sit under
`jax.checkpoint`); the port keeps remat on. Dropout 0: the two packages'
dropout streams differ by design. Tolerances (fp32): logits and hidden
states within 1e-5 of their largest magnitude; gradients within 1e-4 of
each leaf's scale (floored at 1e-3 of the largest gradient, as
tests/test_torch_t5_train.py holds them); decode-step logits within 1e-5
of their scale; beam ids exactly equal, after the test has asserted that
every step's K-th and (K+1)-th candidates and the final ranking are more
than 1e-4 apart (no float tie decides them)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.models import t5_gen as jgen  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    T5Config,
    from_jax_clone_params,
    from_jax_gen_params,
)
from deepdfa_tpu_torch.models import t5 as tt5  # noqa: E402
from deepdfa_tpu_torch.models import t5_gen as tgen  # noqa: E402

VOCAB = 48
REL, GRAD_REL, MARGIN = 1e-5, 1e-4, 1e-4


@pytest.fixture
def flash_interpret(monkeypatch):
    monkeypatch.setenv("DEEPDFA_TPU_FLASH_INTERPRET", "1")


def _cfgs(**kw):
    """(reference, port) GenConfigs: 2 + 2 layers, tiny widths."""
    base = dict(vocab_size=VOCAB, dropout_rate=0.0)
    gen = dict(max_target_length=8, beam_size=3)
    gen.update(kw)
    return (jgen.GenConfig(encoder=jt5.T5Config.tiny(**base, remat=False), **gen),
            tgen.GenConfig(encoder=T5Config.tiny(**base), **gen))


def _params(jcfg, seed=0, untied=False):
    params = jax.tree.map(np.asarray, jgen.init_gen_params(jcfg, jax.random.key(seed)))
    if untied:
        rng = np.random.default_rng(seed)
        params["decoder"]["lm_head"] = rng.standard_normal(
            (VOCAB, jcfg.encoder.hidden_size)).astype(np.float32) * 0.2
    return params


def _model(tcfg, params, untied=False):
    model = tgen.T5Seq2Seq(tcfg, untied_head=untied)
    model.load_state_dict(from_jax_gen_params(params), strict=True)
    return model


def _data(seed=0, B=3, S=24, T=16):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, VOCAB, (B, S)).astype(np.int32)
    tgt = rng.integers(3, VOCAB, (B, T)).astype(np.int32)
    src[1, 2 * S // 3:] = 0
    src[-1, 5:] = 0
    tgt[1, T // 2:] = 0
    tgt[0, T - 4] = 2  # an eos inside a target
    return src, tgt


def _close(got, want, what, rel=REL):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


def _leaf_errors(got: dict, want: dict) -> dict:
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


# -- the relative-position tables ---------------------------------------------


def test_unidirectional_bucket_table_matches_reference_to_4096():
    """Every distance 0..4096 (both directions) in the decoder's scheme,
    and a square table in both schemes."""
    q = np.array([4096, 0])
    k = np.arange(4097)
    for bidirectional in (False, True):
        want = np.asarray(jt5.relative_position_buckets(jnp.asarray(q), jnp.asarray(k), 32, 128,
                                                        bidirectional=bidirectional))
        got = tt5.relative_position_buckets(q, k, 32, 128, bidirectional=bidirectional)
        np.testing.assert_array_equal(got, want)
        pos = np.arange(300)
        np.testing.assert_array_equal(
            tt5.relative_position_buckets(pos, pos, 32, 128, bidirectional),
            np.asarray(jt5.relative_position_buckets(jnp.asarray(pos), jnp.asarray(pos), 32, 128,
                                                     bidirectional=bidirectional)))
    # the past fills all 32 buckets; the future is bucket 0 in the decoder's scheme
    row = tt5.relative_position_buckets(q[:1], k, 32, 128, bidirectional=False)[0]
    assert set(row.tolist()) == set(range(32))


def test_encoder_and_decoder_one_hots_do_not_collide():
    """The one-hot cache keys the scheme: the decoder's table is not the
    encoder's, each matches its own buckets, and the decoder bias is the
    reference's gather rel_bias[buckets] as a product."""
    T = 40
    enc = tt5.bucket_one_hot(T, 32, 128, torch.device("cpu"))
    dec = tt5.bucket_one_hot(T, 32, 128, torch.device("cpu"), bidirectional=False)
    assert not torch.equal(enc, dec)
    assert tt5.bucket_one_hot(T, 32, 128, torch.device("cpu")) is enc  # cached
    pos = np.arange(T)
    for oh, bidir in ((enc, True), (dec, False)):
        want = tt5.relative_position_buckets(pos, pos, 32, 128, bidir).reshape(-1)
        assert torch.equal(oh.argmax(0), torch.from_numpy(want).long())
    cfg = T5Config.tiny()
    rel = torch.randn(32, cfg.num_heads, generator=torch.Generator().manual_seed(0))
    buckets = jt5.relative_position_buckets(jnp.arange(T), jnp.arange(T), 32, 128,
                                            bidirectional=False)
    want = np.asarray(rel.numpy()[np.asarray(buckets)]).transpose(2, 0, 1)
    np.testing.assert_array_equal(tt5.decoder_rel_bias(cfg, rel, T, torch.float32).numpy(),
                                  want)


# -- teacher forcing ------------------------------------------------------------------


@pytest.mark.parametrize("untied", [False, True], ids=["tied_head", "untied_head"])
def test_decode_train_loss_and_every_gradient_match_reference(flash_interpret, untied):
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=1, untied=untied)
    model = _model(tcfg, params, untied)
    src, tgt = _data()
    jsrc, jtgt = jnp.asarray(src), jnp.asarray(tgt)

    # decode_train on a decoder mask with padding (flash semantics: a query
    # without a live key gets 0), logits and the hidden states
    ecfg = jcfg.encoder
    enc_mask = src != 0
    enc_h = jt5.encode(ecfg, params["encoder"], jsrc)
    dec_in = np.array(jgen.shift_right(ecfg, jtgt))
    dec_mask = tgt != 0
    dec_mask[:, 0] = True
    want_logits = jgen.decode_train(jcfg, params, jnp.asarray(dec_in), jnp.asarray(dec_mask),
                                    enc_h, jnp.asarray(enc_mask))
    want_hidden = jgen.decode_train(jcfg, params, jnp.asarray(dec_in), jnp.asarray(dec_mask),
                                    enc_h, jnp.asarray(enc_mask), return_hidden=True)
    t_enc_h = torch.from_numpy(np.array(enc_h))
    args = (model, torch.from_numpy(dec_in).long(), torch.from_numpy(dec_mask), t_enc_h,
            torch.from_numpy(enc_mask))
    with torch.no_grad():
        _close(tgen.decode_train(*args).numpy(), want_logits, "logits")
        _close(tgen.decode_train(*args, return_hidden=True).numpy(), want_hidden, "hidden")

    # seq2seq_loss and the gradient of every leaf
    def loss(p):
        return jgen.seq2seq_loss(jcfg, p, jsrc, jtgt)

    (want_loss, want_n), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    want = {k: v.numpy() for k, v in from_jax_gen_params(jax.tree.map(np.asarray,
                                                                       jgrads)).items()}
    got_loss, got_n = tgen.seq2seq_loss(model, torch.from_numpy(src).long(),
                                        torch.from_numpy(tgt).long())
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert got_n.item() == float(want_n)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want) and ("decoder.lm_head" in got) == untied
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= GRAD_REL, errs
    assert np.abs(got["decoder.rel_bias"]).max() > 0 and np.abs(got["encoder.rel_bias"]).max() > 0


def test_remat_on_and_off_give_bit_equal_gradients():
    """The decoder layers under torch.utils.checkpoint with dropout on:
    the same loss and gradients to the bit as without remat."""
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(tcfg.encoder, dropout_rate=0.1))
    off = dataclasses.replace(tcfg, encoder=dataclasses.replace(tcfg.encoder, remat=False))
    a = tgen.T5Seq2Seq(tcfg, generator=torch.Generator().manual_seed(3))
    b = tgen.T5Seq2Seq(off)
    b.load_state_dict(a.state_dict())
    src, tgt = (torch.from_numpy(x).long() for x in _data(2))
    grads = []
    for m in (a, b):
        loss, _ = tgen.seq2seq_loss(m, src, tgt, dropout_key=77)
        loss.backward()
        grads.append((loss.detach(), {k: p.grad.clone() for k, p in m.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(grads[0][1][k], grads[1][1][k]) for k in grads[0][1])
    with torch.no_grad():
        clean = tgen.seq2seq_loss(a, src, tgt)[0]
    assert not torch.equal(clean, grads[0][0])  # dropout ran


# -- incremental decoding ----------------------------------------------------------------


def test_decode_step_logits_match_reference_at_every_step():
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=4)
    model = _model(tcfg, params)
    src, tgt = _data(4, B=2, S=20, T=8)
    ecfg, L = jcfg.encoder, jcfg.n_dec_layers
    enc_mask = src != 0
    enc_h = jt5.encode(ecfg, params["encoder"], jnp.asarray(src))
    jck, jcv = jgen._precompute_cross_kv(jcfg, params, enc_h)
    with torch.no_grad():
        tck, tcv = tgen._precompute_cross_kv(model, torch.from_numpy(np.array(enc_h)))
    _close(tck.numpy(), jck, "cross k")
    _close(tcv.numpy(), jcv, "cross v")
    N, Tmax, H, Dh = 2, 8, ecfg.num_heads, ecfg.head_dim
    jk = jnp.zeros((L, N, H, Tmax, Dh))
    jv = jnp.zeros_like(jk)
    tk = torch.zeros(L, N, H, Tmax, Dh)
    tv = torch.zeros_like(tk)
    tokens = np.array(jgen.shift_right(ecfg, jnp.asarray(tgt)))
    with torch.no_grad():
        for t in range(Tmax):
            want, jk, jv = jgen._decode_step(jcfg, params, jnp.asarray(tokens[:, t]),
                                             jnp.int32(t), jk, jv, jck, jcv,
                                             jnp.asarray(enc_mask))
            got, tk, tv = tgen._decode_step(model, torch.from_numpy(tokens[:, t]).long(), t, tk,
                                            tv, tck, tcv, torch.from_numpy(enc_mask))
            assert got.dtype == torch.float32
            _close(got.numpy(), want, f"logits at step {t}")
    _close(tk.numpy(), jk, "self-attention cache")


def _margins(model, src, K, Tmax):
    """The smallest gap, over every decoding step, between the K-th and
    (K+1)-th candidates of each row, and between the final ranking's best
    and second beam: what a float tie could flip."""
    gaps = []
    real = tgen.top_k_stable

    def spy(x, k):
        vals = torch.sort(x, dim=-1, descending=True, stable=True)[0]
        gaps.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return real(x, k)

    argmax = torch.argmax

    def spy_argmax(x, dim):
        if x.shape[-1] > 1:
            top2 = torch.sort(x, dim=dim, descending=True)[0]
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        return argmax(x, dim=dim)

    tgen.top_k_stable, torch.argmax = spy, spy_argmax
    try:
        ids = tgen.beam_search(model, src, beam_size=K, max_length=Tmax)
    finally:
        tgen.top_k_stable, torch.argmax = real, argmax
    return ids, min(gaps)


@pytest.mark.parametrize("K, untied", [(3, True), (1, True), (3, False)],
                         ids=["beam3", "greedy", "beam3_tied_head"])
def test_beam_search_ids_match_reference(K, untied):
    """(The untied head's random rows give varied sequences; the tied
    head's random model repeats a few tokens.)"""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=6, untied=untied)
    model = _model(tcfg, params, untied)
    src, _ = _data(6, B=3, S=16)
    tsrc = torch.from_numpy(src).long()
    ids, gap = _margins(model, tsrc, K, 8)
    assert gap > MARGIN, gap
    if K == 1:
        want = jgen.greedy_decode(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(src),
                                  max_length=8)
        got = tgen.greedy_decode(model, tsrc, max_length=8)
        assert torch.equal(got, ids)
    else:
        want = jgen.beam_search(jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(src),
                                beam_size=K, max_length=8)
        got = ids
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (3, 8)


def test_beam_search_stops_when_every_beam_is_done():
    """A model whose LM head favours EOS finishes every beam within two
    steps: the loop ends there, finished beams carry pad and the best
    beam is EOS then pad, as in the reference."""
    jcfg, tcfg = _cfgs()
    params = _params(jcfg, seed=7, untied=True)
    params["decoder"]["lm_head"][2] *= 0.0
    params["decoder"]["lm_head"][2] += 50.0 * np.sign(np.ones(jcfg.encoder.hidden_size))
    model = _model(tcfg, params, untied=True)
    src, _ = _data(7, B=2, S=16)
    want = np.asarray(jgen.beam_search(jcfg, jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(src), beam_size=3, max_length=8))
    got = tgen.beam_search(model, torch.from_numpy(src).long(), beam_size=3, max_length=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == 2).all() and (got[:, 1:] == 0).all()


def test_trim_at_eos_matches_reference():
    ids = np.array([[5, 6, 0, 7, 2, 9, 2], [2, 5, 5, 5, 5, 5, 5], [4, 4, 4, 4, 4, 4, 0],
                    [0, 0, 0, 0, 0, 0, 0]])
    assert tgen.trim_at_eos(ids, 2, 0) == jgen.trim_at_eos(ids, 2, 0) == [
        [5, 6, 7], [], [4, 4, 4, 4, 4, 4], []]


# -- the clone head -----------------------------------------------------------------------


def test_clone_forward_and_gradients_match_reference(flash_interpret):
    base = dict(vocab_size=VOCAB, dropout_rate=0.0)
    jcfg = jgen.CloneConfig(encoder=jt5.T5Config.tiny(**base, remat=False))
    tcfg = tgen.CloneConfig(encoder=T5Config.tiny(**base))
    params = jax.tree.map(np.asarray, jgen.init_clone_params(jcfg, jax.random.key(8)))
    model = tgen.CloneModel(tcfg)
    model.load_state_dict(from_jax_clone_params(params), strict=True)
    rng = np.random.default_rng(8)
    pairs = rng.integers(3, VOCAB, (3, 2, 20)).astype(np.int32)
    pairs[0, 1, 12:] = 0
    pairs[1, 0, 6] = 2
    pairs[2, :, 15:] = 0
    labels = np.array([0, 1, 1])

    def loss(p):
        logits = jgen.clone_forward(jcfg, p, jnp.asarray(pairs))
        lp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(lp, jnp.asarray(labels)[:, None], 1).mean(), logits

    (want_loss, want_logits), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    logits = tgen.clone_forward(model, torch.from_numpy(pairs).long())
    _close(logits.detach().numpy(), want_logits, "clone logits")
    got_loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    want = {k: v.numpy() for k, v in from_jax_clone_params(
        jax.tree.map(np.asarray, jgrads)).items()}
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= GRAD_REL, errs
