"""The port's CodeT5+DeepDFA defect model (deepdfa_tpu_torch/models/t5.py)
against the reference `deepdfa_tpu.models.t5` at a tiny config (2
layers, width 64, 4 heads x 16, T <= 64), weights carried over by
`from_jax_defect_params`: the relative-position bucket table, encoder
hidden states, `eos_pool`, `defect_forward` logits with and without
graphs, and `score_combined` serving a `DefectModel` on the CPU.

The reference runs its Pallas flash kernel with the bias in interpret
mode (DEEPDFA_TPU_FLASH_INTERPRET=1, as its own T5 tests do); the port on
the CPU runs the kernel's plain version. Tolerances: the bucket table
and eos_pool exactly; fp32 hidden states and logits within 1e-5 of each
tensor's largest magnitude (cross-framework reassociation); bf16 hidden
states within 5e-2 (bf16 rounds at other points of the matmuls in the
two frameworks). Inputs carry ragged padding and one all-pad row."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.data import text as jtext  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as JSpec  # noqa: E402
from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.serve.batcher import CombinedExecutor as JExecutor  # noqa: E402
from deepdfa_tpu.serve.batcher import DynamicBatcher as JBatcher  # noqa: E402
from deepdfa_tpu_torch.core.config import Config, DataConfig, ServeConfig  # noqa: E402
from deepdfa_tpu_torch.data import text as ttext  # noqa: E402
from deepdfa_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    DefectConfig,
    DefectModel,
    T5Config,
    T5Encoder,
    from_jax_defect_params,
    from_jax_t5_params,
)
from deepdfa_tpu_torch.models import t5 as tt5  # noqa: E402
from deepdfa_tpu_torch.serve import CombinedExecutor, DynamicBatcher, score_combined  # noqa: E402

VOCAB = 256
BUCKETS = (16, 32, 64)
TOKEN_BUDGET = 256
NODE_BUDGET, EDGE_BUDGET = 512, 2048
INPUT_DIM = 52
TOL = {"float32": 1e-5, "bfloat16": 5e-2}  # of each tensor's largest magnitude
WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
         "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n")


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.fixture
def flash_interpret(monkeypatch):
    """The reference's encoder takes its flash kernel (with the bias) in
    interpret mode."""
    monkeypatch.setenv("DEEPDFA_TPU_FLASH_INTERPRET", "1")


def _ids():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, VOCAB, (4, 64)).astype(np.int32)
    ids[0, 63] = 2  # </s> at the end
    ids[1, 29], ids[1, 30:] = 2, 0  # ragged padding
    ids[2, 4], ids[2, 5:] = 2, 0
    ids[3, :] = 0  # an all-pad row
    return ids


def _enc_cfgs(**kw):
    base = dict(vocab_size=VOCAB, dropout_rate=0.0, remat=False)
    base.update(kw)
    return jt5.T5Config.tiny(**base), T5Config.tiny(**base)


# -- the bucket table ------------------------------------------------------------


@pytest.mark.parametrize("bidirectional", [True, False], ids=["encoder", "decoder"])
def test_bucket_table_equals_reference_over_every_distance(bidirectional):
    """Every relative distance up to 4096 either way lands in the
    reference's bucket exactly (the fp32 log and int cast of both), and a
    whole 512 x 512 table is equal."""
    far = np.arange(4096)
    zero = np.zeros(1, np.int64)
    for q, k in ((zero, far), (far, zero)):
        want = np.asarray(jt5.relative_position_buckets(jnp.asarray(q), jnp.asarray(k), 32, 128,
                                                        bidirectional))
        got = tt5.relative_position_buckets(q, k, 32, 128, bidirectional)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    pos = np.arange(512)
    np.testing.assert_array_equal(
        tt5.relative_position_buckets(pos, pos, 32, 128, bidirectional),
        np.asarray(jt5.relative_position_buckets(jnp.asarray(pos), jnp.asarray(pos), 32, 128,
                                                 bidirectional)))


def test_rel_bias_is_the_gathered_table():
    """The one-hot product gives rel_bias[buckets] exactly, [H, T, T] and
    contiguous (the kernels read its rows), in the activation dtype."""
    cfg = T5Config.tiny()
    table = torch.randn(32, 4, generator=torch.Generator().manual_seed(1))
    bias = tt5.encoder_rel_bias(cfg, table, 40, torch.float32)
    pos = np.arange(40)
    buckets = torch.from_numpy(tt5.relative_position_buckets(pos, pos, 32, 128)).long()
    assert bias.shape == (4, 40, 40) and bias.is_contiguous()
    assert torch.equal(bias, table[buckets].permute(2, 0, 1))
    assert tt5.encoder_rel_bias(cfg, table, 40, torch.bfloat16).dtype == torch.bfloat16
    # cached per length: the same one-hot object on a second call
    assert tt5.bucket_one_hot(40, 32, 128, "cpu") is tt5.bucket_one_hot(40, 32, 128, "cpu")


# -- the encoder and eos pooling ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference_flash_path(dtype, flash_interpret):
    jcfg, tcfg = _enc_cfgs(dtype=dtype)
    params = jax.tree.map(np.asarray, jt5.init_params(jcfg, jax.random.key(0)))
    ids = _ids()
    want = np.asarray(jt5.encode(jcfg, params, jnp.asarray(ids)).astype(jnp.float32))
    model = T5Encoder(tcfg)
    model.load_state_dict(from_jax_t5_params(params))  # strict
    with torch.inference_mode():
        got = model.eval().encode(torch.from_numpy(ids))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), want, TOL[dtype], "hidden")


def test_encoder_guards_and_refusals():
    _, tcfg = _enc_cfgs(max_sequence_length=32)
    model = T5Encoder(tcfg)
    with pytest.raises(ValueError, match="max_sequence_length"):
        model.encode(torch.zeros(1, 64, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="multi-device"):
        model.encode(torch.zeros(1, 8, dtype=torch.int64), sp_axis="sp")
    with pytest.raises(NotImplementedError, match="multi-device"):
        T5Config.tiny(sp_variant="ulysses")
    # attn_saved (remat with grads on) runs, and gives "full"'s bits
    ids = torch.from_numpy(np.random.default_rng(2).integers(3, 256, (2, 16)))
    outs = []
    for policy in ("full", "attn_saved"):
        enc = T5Encoder(dataclasses.replace(tcfg, remat=True, remat_policy=policy),
                        generator=torch.Generator().manual_seed(1))
        h = enc.encode(ids, dropout_key=3)
        h.float().square().mean().backward()
        outs.append((h.detach(), [p.grad for p in enc.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_eos_pool_takes_the_last_eos_or_the_last_position():
    cfg = T5Config.tiny()
    hidden = np.arange(3 * 6 * 4, dtype=np.float32).reshape(3, 6, 4)
    ids = np.zeros((3, 6), np.int32)
    ids[0, 2] = ids[0, 4] = 2  # several eos: the last one, at 4
    ids[1, 0] = 2  # one eos at the start
    # row 2 has none: the last position
    got = tt5.eos_pool(cfg, torch.from_numpy(hidden), torch.from_numpy(ids))
    want = np.asarray(jt5.eos_pool(jt5.T5Config.tiny(), jnp.asarray(hidden), jnp.asarray(ids)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), hidden[[0, 1, 2], [4, 0, 5]])
    bf = tt5.eos_pool(cfg, torch.from_numpy(hidden).bfloat16(), torch.from_numpy(ids))
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, torch.from_numpy(hidden).bfloat16()[
        [0, 1, 2], [4, 0, 5]])


# -- the defect classifier ------------------------------------------------------


def _graph_kw(rng, gid):
    n = int(rng.integers(2, 30))
    e = int(rng.integers(1, 2 * n))
    return dict(graph_id=gid, node_feats=rng.integers(0, INPUT_DIM, (n, 4)).astype(np.int32),
                node_vuln=np.zeros((n,), np.int32),
                edge_src=rng.integers(0, n, (e,)).astype(np.int32),
                edge_dst=rng.integers(0, n, (e,)).astype(np.int32), label=float(gid % 2))


def _snippet(rng, n_tokens):
    return " ".join(str(w) for w in rng.choice(WORDS, n_tokens))


def _corpus(n=24, seed=0):
    """(texts, T5-framed ids [n, 64], labels, graph kwargs; every 5th row
    has no graph)."""
    rng = np.random.default_rng(seed)
    texts = [_snippet(rng, int(rng.integers(1, 62))) for _ in range(n)]
    ids = HashTokenizer(vocab_size=VOCAB, t5_frame=True).batch_encode(texts, 64)
    labels = [int(i % 3 == 0) for i in range(n)]
    graphs = {i: _graph_kw(rng, i) for i in range(n) if i % 5}
    return texts, ids, labels, graphs


def _batches(port: bool):
    _, ids, labels, graphs = _corpus()
    sel = list(range(len(labels)))
    text, spec = (ttext, TSpec) if port else (jtext, JSpec)
    return list(text.bucketed_collate_batches(
        {i: ids[i] for i in sel}, {i: labels[i] for i in sel}, sel,
        {i: spec(**kw) for i, kw in graphs.items()}, BUCKETS, TOKEN_BUDGET, 1,
        NODE_BUDGET, EDGE_BUDGET, pad_id=0))


def _defect_cfgs(use_graph=True, **enc):
    jenc, tenc = _enc_cfgs(**enc)
    kw = dict(graph_hidden_dim=8, graph_input_dim=INPUT_DIM, use_graph=use_graph)
    return jt5.DefectConfig(encoder=jenc, **kw), DefectConfig(encoder=tenc, **kw)


def _port_model(tmcfg, params):
    model = DefectModel(tmcfg)
    model.load_state_dict(from_jax_defect_params(params))  # strict
    return model.eval()


@pytest.mark.parametrize("use_graph", [True, False], ids=["with_graphs", "text_only"])
def test_defect_logits_match_reference(use_graph, flash_interpret):
    jmcfg, tmcfg = _defect_cfgs(use_graph)
    params = jax.tree.map(np.asarray, jt5.init_defect_params(jmcfg, jax.random.key(3)))
    model = _port_model(tmcfg, params)
    checked = 0
    for ref, port in zip(_batches(False), _batches(True)):
        port = port.to("cpu")
        local = jax.tree.map(lambda x: x[0], ref)
        kw = dict(graph_batch=local.graphs, has_graph=local.has_graph) if use_graph else {}
        want = np.asarray(jt5.defect_forward(jmcfg, params, local.input_ids, **kw))
        with torch.inference_mode():
            got = model(port.input_ids, port.graphs if use_graph else None,
                        port.has_graph if use_graph else None)
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got.numpy(), want, TOL["float32"], "logits")
        checked += int(np.asarray(port.has_graph).sum())
    assert checked > 0 or not use_graph
    if use_graph:  # zeroing the graph rows changes the logits; no graph batch refuses
        b = _batches(True)[0].to("cpu")
        with torch.inference_mode():
            a = model(b.input_ids, b.graphs, b.has_graph)
            z = model(b.input_ids, b.graphs, torch.zeros_like(b.has_graph))
        assert not torch.equal(a, z)
        with pytest.raises(ValueError, match="graph_batch"):
            model(b.input_ids)


def test_defect_model_width_at_codet5_base():
    """The slice's model at codet5-base width: its parameter count and the
    combined model's call signature (pp_axis refused)."""
    model = DefectModel(DefectConfig(encoder=T5Config(dtype="bfloat16")),
                        generator=torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    # word 32100 x 768, rel_bias 32 x 12, 12 layers of 4 x 768^2 + 2 x 768 x 3072
    # + 2 x 768, final norm, the flagship graph encoder and the 1024 -> 2 head
    enc = 32100 * 768 + 32 * 12 + 12 * (4 * 768 * 768 + 2 * 768 * 3072 + 2 * 768) + 768
    graph = sum(p.numel() for p in model.graph.parameters())
    assert n == enc + graph + (768 + 256) * 2 + 2
    with pytest.raises(NotImplementedError, match="pipeline"):
        model(torch.zeros(1, 8, dtype=torch.int64), pp_axis="pp")


# -- serving --------------------------------------------------------------------


def _serve_cfg():
    return Config(data=DataConfig(seq_buckets=BUCKETS, token_budget=TOKEN_BUDGET),
                  serve=ServeConfig(node_budget=NODE_BUDGET, edge_budget=EDGE_BUDGET,
                                    max_batch_delay_ms=2.0))


def test_score_combined_serves_the_defect_model_like_the_reference(flash_interpret):
    """score_combined with a DefectModel on the CPU (T5-framed tokenizer:
    pad 0, eos 2) against the reference's CombinedExecutor(is_t5=True),
    request by request; a request scores the same alone and co-batched."""
    jmcfg, tmcfg = _defect_cfgs()
    params = jax.tree.map(np.asarray, jt5.init_defect_params(jmcfg, jax.random.key(5)))
    texts, _, _, graphs = _corpus(12, seed=1)
    tok = HashTokenizer(vocab_size=VOCAB, t5_frame=True)
    payloads = [(t, TSpec(**graphs[i]) if i in graphs else None) for i, t in enumerate(texts)]
    summary = score_combined(_port_model(tmcfg, params), payloads, _serve_cfg(), tok,
                             device="cpu")
    assert summary["serve_scored"] == 12 and summary["flash_fwd_launches"] == 0
    from deepdfa_tpu.data.tokenizer import HashTokenizer as JTokenizer

    jtok = JTokenizer(vocab_size=VOCAB, t5_frame=True)
    ref = JExecutor(jmcfg, lambda: params, jtok, BUCKETS, TOKEN_BUDGET, NODE_BUDGET,
                    EDGE_BUDGET, is_t5=True)
    want = [r.wait(60) for r in JBatcher(ref).score_all(
        [(jtok.encode(t, 64), JSpec(**graphs[i]) if i in graphs else None)
         for i, t in enumerate(texts)])]
    np.testing.assert_allclose(summary["probs"], want, rtol=1e-5, atol=1e-6)
    ex = CombinedExecutor(_port_model(tmcfg, params), tok, BUCKETS, TOKEN_BUDGET, NODE_BUDGET,
                          EDGE_BUDGET, device="cpu")
    enc = [(tok.encode(t, 64), None) for t in texts[:3]]
    together = [r.wait(0) for r in DynamicBatcher(ex).score_all(enc)]
    alone = [DynamicBatcher(ex).score_all([p])[0].wait(0) for p in enc]
    assert together == alone
    with pytest.raises(ValueError, match="pads with"):  # the RoBERTa frame pads with 1
        CombinedExecutor(_port_model(tmcfg, params), HashTokenizer(VOCAB), BUCKETS,
                         TOKEN_BUDGET, NODE_BUDGET, EDGE_BUDGET, device="cpu")
