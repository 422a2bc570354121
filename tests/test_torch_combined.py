"""The port's combined (DeepDFA+LineVul) serving path on the CPU against
the reference: the hash tokenizer and the text collater exactly, the
CombinedModel against `combined.forward` through
`from_jax_combined_params`, and `score_combined` against the reference
`CombinedExecutor` behind its `DynamicBatcher`.

Tolerances: ids, collated arrays and bucket sizes exactly; logits and
probabilities fp32 rtol = atol = 1e-5 (cross-framework reassociation).
A request scored alone and co-batched runs on the same padded shape:
text-only rows give the same bits; with graphs the node offsets move
inside the pooling's one-hot products, so those are held within 1e-5."""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.data import text as jtext  # noqa: E402
from deepdfa_tpu.data.tokenizer import HashTokenizer as JHashTokenizer  # noqa: E402
from deepdfa_tpu.graphs.batch import GraphSpec as JSpec  # noqa: E402
from deepdfa_tpu.models import combined as jcmb  # noqa: E402
from deepdfa_tpu.models import transformer as jtfm  # noqa: E402
from deepdfa_tpu.serve import batcher as jbatcher  # noqa: E402
from deepdfa_tpu_torch.core.config import Config, DataConfig, ServeConfig  # noqa: E402
from deepdfa_tpu_torch.data import text as ttext  # noqa: E402
from deepdfa_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    CombinedConfig,
    CombinedModel,
    TransformerConfig,
    from_jax_combined_params,
)
from deepdfa_tpu_torch.serve import CombinedExecutor, DynamicBatcher, score_combined  # noqa: E402

RTOL = ATOL = 1e-5
VOCAB = 256
BUCKETS = (16, 32, 64)
TOKEN_BUDGET = 256  # rows per bucket: 16, 8, 4
NODE_BUDGET, EDGE_BUDGET = 256, 1024
WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
         "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n")


def _snippet(rng, n_tokens):
    words = rng.choice(WORDS, n_tokens)
    lines, line = [], []
    for w in words:
        line.append(str(w))
        if w in (";", "{", "}"):
            lines.append(" ".join(line))
            line = []
    lines.append(" ".join(line))
    return "\n".join(lines) + "\n"


def _graph_kw(rng, gid, n=None, input_dim=1002):
    n = int(rng.integers(1, 40)) if n is None else n
    e = int(rng.integers(0, 2 * n))
    return dict(
        graph_id=gid,
        node_feats=rng.integers(0, input_dim, (n, 4)).astype(np.int32),
        node_vuln=np.zeros((n,), np.int32),
        edge_src=rng.integers(0, n, (e,)).astype(np.int32),
        edge_dst=rng.integers(0, n, (e,)).astype(np.int32),
        label=float(gid % 2),
    )


# -- tokenizer and collater ---------------------------------------------------


@pytest.mark.parametrize("t5_frame", [False, True], ids=["roberta", "t5"])
def test_hash_tokenizer_ids_equal_reference(t5_frame):
    rng = np.random.default_rng(0)
    texts = [
        "int main(void) {\n  char buf[16];\n  strcpy(buf, argv[1]);\n  return 0;\n}\n",
        "static int f(int *p, size_t n)\f{ if (n > 0x10) return -1; }\n\n",
        "x y = 3;\r\n// comment\n",
        "",
    ] + [_snippet(rng, int(rng.integers(1, 120))) for _ in range(4)]
    port = HashTokenizer(vocab_size=4096, t5_frame=t5_frame)
    ref = JHashTokenizer(vocab_size=4096, t5_frame=t5_frame)
    assert (port.pad_id, port.cls_id, port.sep_id) == (ref.pad_id, ref.cls_id, ref.sep_id)
    for text in texts:
        for max_length in (8, 64, 512):
            got_ids, got_lines = port.encode_with_lines(text, max_length)
            want_ids, want_lines = ref.encode_with_lines(text, max_length)
            np.testing.assert_array_equal(got_ids, want_ids)
            np.testing.assert_array_equal(got_lines, want_lines)
    np.testing.assert_array_equal(port.batch_encode(texts, 32), ref.batch_encode(texts, 32))


def test_collate_and_bucket_helpers_equal_reference():
    """collate (including the has_graph degrade when budgets run out),
    token_lengths, rows_for_bucket and _fit_width, array for array."""
    rng = np.random.default_rng(1)
    tok = HashTokenizer(vocab_size=VOCAB)
    ids = tok.batch_encode([_snippet(rng, int(rng.integers(0, 60))) for _ in range(7)], 64)
    ids[3] = tok.pad_id  # an all-pad row: length 0
    np.testing.assert_array_equal(ttext.token_lengths(ids, tok.pad_id),
                                  jtext.token_lengths(ids, tok.pad_id))
    for T in (1, 16, 100, 512):
        for budget in (8, 8192):
            for shards in (1, 2):
                assert ttext.rows_for_bucket(T, budget, shards) == jtext.rows_for_bucket(T, budget, shards)
    for row in (ids[0], ids[0][:5], np.arange(70)):
        np.testing.assert_array_equal(ttext._fit_width(row, 32, 1), jtext._fit_width(row, 32, 1))

    kws = [_graph_kw(rng, i, n=int(rng.integers(1, 60))) for i in range(7)]
    with_graph = [0, 1, 2, 4, 5, 6]  # row 3 has none
    # tight budgets: later graphs no longer fit and degrade to has_graph=False
    for node_budget, edge_budget in ((64, 200), (512, 2048)):
        got = ttext.collate(ids[:, :32], list(range(7)), list(range(7)),
                            {i: TSpec(**kws[i]) for i in with_graph}, 12, node_budget, edge_budget)
        want = jtext.collate(ids[:, :32], list(range(7)), list(range(7)),
                             {i: JSpec(**kws[i]) for i in with_graph}, 12, node_budget, edge_budget)
        for f in ("input_ids", "labels", "row_mask", "has_graph"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        for f in ("node_feats", "node_graph", "node_mask", "edge_src", "edge_dst", "edge_mask",
                  "graph_mask", "graph_ids"):
            np.testing.assert_array_equal(getattr(got.graphs, f), getattr(want.graphs, f), err_msg=f)
        if node_budget == 64:
            assert 0 < got.has_graph.sum() < len(with_graph)  # the degrade happened
    moved = got.to("cpu")
    assert moved.input_ids.dtype == torch.int32 and moved.has_graph.dtype == torch.bool
    assert moved.graphs.edge_src.dtype == torch.int32


# -- the model ----------------------------------------------------------------


def _enc_cfgs(**kw):
    base = dict(vocab_size=VOCAB, max_position_embeddings=68, num_layers=2, num_heads=4,
                hidden_size=64, intermediate_size=128)
    base.update(kw)
    return jtfm.TransformerConfig.tiny(**base), TransformerConfig.tiny(**base)


@functools.lru_cache(maxsize=None)
def _reference(use_graph):
    """(reference cfg, numpy params, port model) for a tiny fp32 encoder
    and the flagship-width graph encoder (hidden 32, input_dim 1002)."""
    jenc, tenc = _enc_cfgs()
    jcfg = jcmb.CombinedConfig(encoder=jenc, graph_hidden_dim=32, graph_input_dim=1002,
                               use_graph=use_graph)
    params = jax.tree.map(np.asarray, jcmb.init_params(jcfg, jax.random.key(3)))
    model = CombinedModel(CombinedConfig(encoder=tenc, graph_hidden_dim=32, graph_input_dim=1002,
                                         use_graph=use_graph))
    model.load_state_dict(from_jax_combined_params(params))  # strict
    return jcfg, params, model.eval()


@pytest.mark.parametrize("use_graph", [True, False], ids=["graphs", "text_only"])
def test_combined_model_matches_reference(use_graph):
    rng = np.random.default_rng(2)
    tok = HashTokenizer(vocab_size=VOCAB)
    ids = tok.batch_encode([_snippet(rng, int(rng.integers(1, 50))) for _ in range(5)], 32)
    kws = {i: _graph_kw(rng, i) for i in (0, 1, 3)}  # rows 2 and 4 have no graph
    port_b = ttext.collate(ids, [0] * 5, list(range(5)), {i: TSpec(**k) for i, k in kws.items()},
                           6, NODE_BUDGET, EDGE_BUDGET)
    ref_b = jtext.collate(ids, [0] * 5, list(range(5)), {i: JSpec(**k) for i, k in kws.items()},
                          6, NODE_BUDGET, EDGE_BUDGET)
    assert port_b.has_graph.tolist() == [True, True, False, True, False, False]
    jcfg, params, model = _reference(use_graph)
    want = np.asarray(jax.jit(functools.partial(jcmb.forward, jcfg))(
        params, ref_b.input_ids, ref_b.graphs, ref_b.has_graph))
    b = port_b.to("cpu")
    with torch.inference_mode():
        got = model(b.input_ids, b.graphs, b.has_graph).numpy()
    assert got.shape == want.shape == (6, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    n_ref = sum(x.size for x in jax.tree.leaves(params))
    assert n_ref == sum(p.numel() for p in model.parameters())


def test_codebert_width_model_is_the_reference_size():
    """At codebert-base width with the flagship graph encoder the port
    has the reference's parameter count (no weights drawn for it)."""
    jcfg = jcmb.CombinedConfig(encoder=jtfm.TransformerConfig(dtype="bfloat16"))
    shapes = jax.eval_shape(lambda: jcmb.init_params(jcfg, jax.random.key(0)))
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = CombinedModel(CombinedConfig(encoder=TransformerConfig(dtype="bfloat16")))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert n_ref > 124_000_000


def test_unported_options_raise():
    _, tenc = _enc_cfgs()
    # the MoE adapter is ported (tests/test_torch_moe.py): its block sits
    # under `moe`, and the expert-parallel axis is still item 9
    ids = torch.full((2, 8), 5, dtype=torch.int32)
    with_moe = CombinedModel(CombinedConfig(encoder=tenc, moe_experts=4, use_graph=False)).eval()
    assert {k for k in with_moe.state_dict() if k.startswith("moe.")} == {
        "moe.router", "moe.w1", "moe.b1", "moe.w2", "moe.b2"}
    logits, aux = with_moe(ids, with_aux=True)
    assert logits.shape == (2, 2) and aux.item() > 0
    with pytest.raises(NotImplementedError, match="multi-device"):
        with_moe(ids, ep_axis="ep")
    model = CombinedModel(CombinedConfig(encoder=tenc, use_graph=False))
    model.eval()
    with pytest.raises(NotImplementedError, match="multi-device"):
        model(ids, pp_axis="pp")
    with pytest.raises(NotImplementedError, match="multi-device"):
        model(ids, sp_axis="sp")
    with pytest.raises(ValueError, match="graph_batch"):
        CombinedModel(CombinedConfig(encoder=tenc)).eval()(ids)


# -- serving ------------------------------------------------------------------


def _payloads(rng, count, tok, graph_every=1, input_dim=1002):
    """(ids, port spec, reference spec) triples with lengths over all
    three buckets."""
    out = []
    for i in range(count):
        n_tok = int(rng.choice([8, 25, 55])) + int(rng.integers(0, 6))
        ids = tok.encode(_snippet(rng, n_tok), BUCKETS[-1])
        if i % graph_every == 0:
            kw = _graph_kw(rng, i, input_dim=input_dim)
            out.append((ids, TSpec(**kw), JSpec(**kw)))
        else:
            out.append((ids, None, None))
    return out


def _serve_cfg():
    return Config(
        data=DataConfig(seq_buckets=BUCKETS, token_budget=TOKEN_BUDGET),
        serve=ServeConfig(node_budget=NODE_BUDGET, edge_budget=EDGE_BUDGET,
                          max_batch_delay_ms=5.0),
    )


def test_score_combined_matches_reference_executor():
    """score_combined (a started batcher on the CPU) against the
    reference CombinedExecutor + DynamicBatcher.score_all on the same
    payloads; then batched == singleton on the port's executor."""
    rng = np.random.default_rng(4)
    tok = HashTokenizer(vocab_size=VOCAB)
    jtok = JHashTokenizer(vocab_size=VOCAB)
    triples = _payloads(rng, 14, tok, graph_every=2)
    jcfg, params, model = _reference(True)
    ref_ex = jbatcher.CombinedExecutor(
        jcfg, lambda: params, jtok, seq_buckets=BUCKETS, token_budget=TOKEN_BUDGET,
        node_budget=NODE_BUDGET, edge_budget=EDGE_BUDGET,
    )
    want = [r.wait(0) for r in jbatcher.DynamicBatcher(ref_ex, queue_limit=64).score_all(
        [(ids, js) for ids, _, js in triples])]

    summary = score_combined(model, [(ids, ts) for ids, ts, _ in triples], _serve_cfg(), tok,
                             device="cpu")
    assert summary["device"] == "cpu" and summary["serve_scored"] == len(triples)
    np.testing.assert_allclose(summary["probs"], want, rtol=RTOL, atol=ATOL)
    assert summary["flash_fwd_launches"] == summary["ggnn_step_launches"] == 0  # CPU: plain
    assert summary["buckets"] == [[16, 16, 16], [32, 8, 8], [64, 4, 4]]
    assert summary["serve_batches"] >= 3
    for key in ("serve_requests_per_sec", "serve_latency_p50_ms", "serve_latency_p99_ms",
                "serve_batch_occupancy_mean"):
        assert summary[key] > 0, key
    assert summary["serve_tokenize_seconds"] >= 0

    ex = CombinedExecutor(model, tok, BUCKETS, TOKEN_BUDGET, NODE_BUDGET, EDGE_BUDGET,
                          device="cpu")
    assert ex.signatures() == ref_ex.signatures()
    batched = [r.wait(0) for r in DynamicBatcher(ex, queue_limit=64).score_all(
        [(ids, ts) for ids, ts, _ in triples])]
    for (ids, ts, _), got in zip(triples, batched):
        [alone] = DynamicBatcher(ex).score_all([(ids, ts)])
        if ts is None:
            assert alone.wait(0) == got  # text-only: the same bits
        else:
            assert abs(alone.wait(0) - got) <= 1e-5


def test_combined_budget_accounting_matches_reference():
    """admit / fits / bucket_key agree with the reference executor, so
    an admitted chunk never degrades a row (tight budgets)."""
    rng = np.random.default_rng(5)
    tok = HashTokenizer(vocab_size=VOCAB)
    jcfg, _, model = _reference(True)
    port = CombinedExecutor(model, tok, BUCKETS, TOKEN_BUDGET, 64, 200, device="cpu")
    ref = jbatcher.CombinedExecutor(jcfg, lambda: None, None, seq_buckets=BUCKETS,
                                    token_budget=TOKEN_BUDGET, node_budget=64, edge_budget=200)
    triples = _payloads(rng, 30, tok, graph_every=1)
    for ids, ts, js in triples:
        assert port.bucket_key((ids, ts)) == ref.bucket_key((ids, js))
        outcome = []
        for ex, spec in ((port, ts), (ref, js)):
            try:
                ex.admit((ids, spec))
                outcome.append(True)
            except (jbatcher.RequestTooLarge, ValueError):
                outcome.append(False)
        assert outcome[0] == outcome[1]
    for _ in range(20):
        pick = rng.choice(len(triples), 4, replace=False)
        chunk_t = [(triples[i][0], triples[i][1]) for i in pick[:3]]
        chunk_j = [(triples[i][0], triples[i][2]) for i in pick[:3]]
        i = pick[3]
        assert port.fits(16, chunk_t, triples[i][:2]) == ref.fits(16, chunk_j, (triples[i][0], triples[i][2]))
    long_ids = np.full((200,), 7, np.int32)
    with pytest.raises(ValueError, match="largest bucket"):
        port.bucket_key((long_ids, None))


def test_score_combined_encodes_text_and_refuses_oversized():
    rng = np.random.default_rng(6)
    tok = HashTokenizer(vocab_size=VOCAB)
    _, _, model = _reference(False)
    kw = _graph_kw(rng, 0, n=NODE_BUDGET + 1)
    payloads = [(_snippet(rng, 10), None), (_snippet(rng, 40), None),
                (tok.encode(_snippet(rng, 10), 64), TSpec(**kw))]
    summary = score_combined(model, payloads, _serve_cfg(), tok, device="cpu")
    assert summary["serve_scored"] == 2 and summary["probs"][2] is None
    ex = CombinedExecutor(model, tok, BUCKETS, TOKEN_BUDGET, NODE_BUDGET, EDGE_BUDGET,
                          device="cpu")
    direct = [r.wait(0) for r in DynamicBatcher(ex).score_all(
        [(tok.encode(t, 64), None) for t, _ in payloads[:2]])]
    assert summary["probs"][:2] == direct
    with pytest.raises(ValueError, match="pads with"):
        CombinedExecutor(model, HashTokenizer(VOCAB, t5_frame=True), BUCKETS, 256, 64, 64,
                         device="cpu")
    with pytest.raises(ValueError, match="seq_buckets"):
        CombinedExecutor(model, tok, (), 256, 64, 64, device="cpu")
    cfg = _serve_cfg()
    piped = score_combined(model, payloads, dataclasses.replace(
        cfg, serve=dataclasses.replace(cfg.serve, pipeline_depth=2)), tok, device="cpu")
    assert piped["serve_scored"] == 2 and piped["probs"][2] is None
    assert piped["probs"][:2] == direct


def test_combined_config_loads_and_defaults_to_cuda():
    from deepdfa_tpu_torch.core import load

    cfg = load(Path(__file__).resolve().parents[1] / "configs" / "bigvul_combined.json")
    assert cfg.data.token_budget == 8192 and cfg.data.seq_buckets == ()
    assert (cfg.data.batch.node_budget, cfg.data.batch.edge_budget) == (8192, 32768)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, _, model = _reference(False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CombinedExecutor(model, HashTokenizer(VOCAB), BUCKETS, 256, 64, 64)
