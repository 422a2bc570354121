"""The port's line-level localization (deepdfa_tpu_torch/eval/localize.py,
eval/statements.py, serve/localize.py, `serve.lines` and `cli localize`)
against the reference on the CPU.

The same seeded numpy inputs go to both packages, and the weights are the
reference's Flax inits carried over by `models/convert.py`. Tolerances:

- the statement metrics and the two line aggregators: equal to the bit
  (numpy on the same floats, ties included);
- GGNN probabilities: rtol 1e-5 (cross-framework reassociation); node
  scores, a backward through the GGNN steps and a per-graph
  normalisation: within 1e-5 of each graph's largest |score|, with the
  line ranking equal wherever two neighbouring scores differ by more;
- token scores (each row normalised to unit L2 norm): within 1e-5 of
  each row's largest |score|, fp32 encoders, the sampled methods fed the
  reference's `jax.random` draws;
- the served localizer against the offline program: a function alone
  the same bits; co-batched the same ranking and rtol 1e-5.

The reference's GGNN runs its lax path (jitted), its encoders their
plain attention; the port on the CPU runs every kernel's plain version.
"""

import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.eval import localize as JL  # noqa: E402
from deepdfa_tpu.eval import statements as JS  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as JSpec, pack as jpack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.models import combined as jcmb  # noqa: E402
from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.models import transformer as jtfm  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic  # noqa: E402
from deepdfa_tpu_torch.data import text as ttext  # noqa: E402
from deepdfa_tpu_torch.data.examples import Example  # noqa: E402
from deepdfa_tpu_torch.data.tokenizer import HashTokenizer, split_lines  # noqa: E402
from deepdfa_tpu_torch.eval import localize as L  # noqa: E402
from deepdfa_tpu_torch.eval import statements as S  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, GraphStore, pack  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    CombinedConfig,
    CombinedModel,
    DeepDFA,
    DefectConfig,
    DefectModel,
    T5Config,
    TransformerConfig,
    from_jax_combined_params,
    from_jax_defect_params,
    from_jax_params,
)
from deepdfa_tpu_torch.nn import ggnn_kernel as gk  # noqa: E402
from deepdfa_tpu_torch.serve.frontend import RequestPreprocessor  # noqa: E402
from deepdfa_tpu_torch.serve.localize import GgnnLocalizer  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

NODE_BUDGET, EDGE_BUDGET = 2048, 8192
OVERRIDES = ['data.feat={"limit_all": 50, "limit_subkeys": 50}', "model.hidden_dim=8",
             "model.n_steps=2", "serve.max_batch_graphs=4",
             f"serve.node_budget={NODE_BUDGET}", f"serve.edge_budget={EDGE_BUDGET}"]
PROB_RTOL = 1e-5
SCORE_TOL = 1e-5  # of each graph's (or token row's) largest |score|
SPEC_FIELDS = ("graph_id", "node_feats", "node_vuln", "edge_src", "edge_dst", "label")


# -- statements and the line aggregators ----------------------------------------


def _ranked(rng, n_examples=24):
    """Examples with tied integer scores, some without any flagged line."""
    out = []
    for i in range(n_examples):
        n = int(rng.integers(1, 40))
        scores = rng.integers(0, 5, n).astype(np.float64)  # ties
        flagged = rng.random(n) < (0.0 if i % 5 == 0 else 0.15)
        out.append((scores, flagged))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statement_metrics_equal_the_reference(seed):
    rows = _ranked(np.random.default_rng(seed))
    port = [S.RankedExample(s, f) for s, f in rows]
    ref = [JS.RankedExample(s, f) for s, f in rows]
    assert S.statement_report(port) == JS.statement_report(ref)
    assert S.per_example_ifa(port) == JS.per_example_ifa(ref)
    for frac in (0.01, 0.2, 0.5, 1.0):
        assert S.effort_at_recall(port, frac) == JS.effort_at_recall(ref, frac)
        assert S.recall_at_effort(port, frac) == JS.recall_at_effort(ref, frac)
    for k in (1, 2, 7):
        assert S.top_k_accuracy(port, k) == JS.top_k_accuracy(ref, k)
    assert all(np.array_equal(a.ranking(), b.ranking()) for a, b in zip(port, ref))
    assert S.statement_report([]) == JS.statement_report([])


@pytest.mark.parametrize("reduce", ["max", "sum"])
def test_line_aggregators_equal_the_reference(reduce):
    rng = np.random.default_rng(4)
    for _ in range(20):
        t = int(rng.integers(1, 60))
        scores = np.round(rng.normal(size=t), 2).astype(np.float32)  # signed, with ties
        lines = rng.integers(0, 12, t)  # 0 = no line; some past n_lines
        n_lines = int(rng.integers(1, 10))
        got = L.aggregate_line_scores(scores, lines, n_lines, reduce)
        want = JL.aggregate_line_scores(scores, lines, n_lines, reduce)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for top_k in (0, 3):
            assert L.node_line_attributions(scores, lines, top_k) == \
                JL.node_line_attributions(scores, lines, top_k)
    # signed: no clamp, and a line without tokens ranks below every other
    out = L.aggregate_line_scores(np.array([-0.5, -0.1, 0.3, -0.9]), np.array([1, 1, 2, 3]), 4)
    assert list(out[:3]) == [-0.1, 0.3, -0.9] and out[3] < out[2]


# -- GGNN node attributions ------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """(port examples, port specs, vocabs): `generate(12, seed=5)`, the
    reference's tests/test_scan.py corpus, through the port's pipeline."""
    examples = synthetic.to_examples(synthetic.generate(12, seed=5))
    specs, vocabs = pipeline.build_dataset(examples, train_ids=range(12), limit_all=50,
                                           limit_subkeys=50)
    return examples, specs, vocabs


def _cfg(extra=()):
    return config_mod.apply_overrides(config_mod.Config(), OVERRIDES + list(extra))


@pytest.fixture(scope="module")
def ggnn():
    """(port cfg, reference model, reference params): a Flax init."""
    jcfg = jconfig.apply_overrides(jconfig.Config(), OVERRIDES)
    jmodel = JDeepDFA.from_config(jcfg.model, input_dim=jcfg.data.feat.input_dim)
    params = jmodel.init(jax.random.key(0), jpack([], 1, NODE_BUDGET, EDGE_BUDGET))
    return _cfg(), jmodel, jax.tree.map(np.asarray, params)


def _port_model(cfg, params, **kw):
    model = DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim, **kw)
    model.load_state_dict(from_jax_params(params))
    return model.eval()


def _batches(specs, n, size):
    """(port batch on the CPU, reference batch) of specs[:n] at rung size."""
    port = pack(specs[:n], size, NODE_BUDGET, EDGE_BUDGET).to("cpu")
    ref = jpack([JSpec(**{f: getattr(s, f) for f in SPEC_FIELDS}) for s in specs[:n]], size,
                NODE_BUDGET, EDGE_BUDGET)
    return port, ref


def test_ggnn_forward_is_the_models_forward(corpus, ggnn):
    """The recomposed forward gives the bits of `DeepDFA.forward`, and the
    pooling attention sums to 1 over each graph's nodes."""
    _, specs, _ = corpus
    cfg, _, params = ggnn
    model = _port_model(cfg, params)
    batch, _ = _batches(specs, 4, 4)
    with torch.inference_mode():
        want = model(batch)
        fn, rows = L.ggnn_forward(model, batch)
        logits, attn = fn(rows)
    assert torch.equal(logits, want)
    onehot = (batch.node_graph[None, :] == torch.arange(5)[:, None]).double()
    np.testing.assert_allclose((onehot @ attn.double())[:4].numpy(), 1.0, atol=1e-5)
    assert not any(p.requires_grad for p in model.parameters())


def _node_bound(ref_scores, node_graph, num_graphs):
    """Per node: SCORE_TOL times its graph's largest |reference score|."""
    scale = np.zeros(num_graphs + 1)
    np.maximum.at(scale, node_graph, np.abs(ref_scores))
    return SCORE_TOL * scale[node_graph]


@pytest.mark.parametrize("method", L.GGNN_METHODS)
def test_ggnn_methods_match_the_reference(corpus, ggnn, method):
    """Probabilities (rtol 1e-5) and node scores (1e-5 of each graph's
    scale) of every method against the reference's jitted
    `ggnn_score_fn` on 3 graphs in the 4-graph rung; padding is zero, and
    each graph's line ranking is the reference's wherever neighbouring
    scores differ by more than the bound."""
    examples, specs, vocabs = corpus
    cfg, jmodel, params = ggnn
    batch, jbatch = _batches(specs, 3, 4)
    want_p, want_s = (np.asarray(x) for x in jax.jit(
        JL.ggnn_score_fn(method, jmodel, n_steps=4))(params, jbatch))
    got_p, got_s = (x.numpy() for x in L.ggnn_score_fn(method, _port_model(cfg, params),
                                                       n_steps=4)(batch))
    np.testing.assert_allclose(got_p, want_p, rtol=PROB_RTOL, atol=1e-7)
    graph = batch.node_graph.numpy()
    bound = _node_bound(want_s, graph, 4)
    assert np.all(np.abs(got_s - want_s) <= bound), float(np.abs(got_s - want_s).max())
    mask = batch.node_mask.numpy()
    assert np.all(got_s[~mask] == 0) and np.abs(got_s[mask]).max() > 0
    pre = RequestPreprocessor(cfg, vocabs)
    off = 0
    for e, spec in zip(examples, specs[:3]):
        lines = pre.features_full(e.code, e.id).node_lines
        n = spec.num_nodes
        got = L.node_line_attributions(got_s[off:off + n], lines)
        want = JL.node_line_attributions(want_s[off:off + n], lines)
        tol = 2 * bound[off]
        for i in range(len(want) - 1):  # ranking settled where the gap exceeds the bound
            if want[i]["score"] - want[i + 1]["score"] > tol:
                assert [d["line"] for d in got[:i + 1]] == [d["line"] for d in want[:i + 1]]
        off += n


def test_ggnn_refusals(ggnn):
    cfg, _, params = ggnn
    with pytest.raises(ValueError, match="unknown GGNN method"):
        L.ggnn_score_fn("nope", None)
    node_model = DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim, label_style="node")
    with pytest.raises(ValueError, match="label_style"):
        L.ggnn_forward(node_model, None)


@pytest.mark.parametrize("unroll", ["per_step", "fused"])
def test_input_only_backward_keeps_the_bits(corpus, ggnn, unroll):
    """With no parameter requiring a gradient the GGNN backward skips the
    weight passes: the node embedding rows' cotangent is the same bits as
    with every parameter requiring one, per step and through the fused
    unroll."""
    _, specs, _ = corpus
    cfg, _, params = ggnn
    batch, _ = _batches(specs, 4, 4)
    kw = dict(ggnn_kernel=True, ggnn_kernel_unroll=unroll)
    grads = []
    for frozen in (False, True):
        model = _port_model(cfg, params, **kw)
        model.requires_grad_(not frozen)
        with torch.no_grad():
            rows = model.embedding(batch.node_feats)
        rows.requires_grad_(True)
        out = torch.cat([model.ggnn(batch, rows), rows], dim=-1)
        (g,) = torch.autograd.grad(model.head(model.pooling(batch, out)).sum(), rows)
        grads.append(g)
    assert torch.equal(grads[0], grads[1])
    # step_bwd's dh without the weights is the bits of the full backward's
    h, g, a = (torch.randn(64, 32, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    w = [torch.randn(s, generator=torch.Generator().manual_seed(9)) * 0.1
         for s in ((1, 32, 32), (32, 96), (32, 96), (96,), (96,))]
    edges = gk.prepare_edges(torch.arange(64, dtype=torch.int32) % 7,
                             torch.arange(64, dtype=torch.int32), torch.ones(64, dtype=torch.bool),
                             None, 64, 1, transpose=True)
    full = gk.step_bwd(h, a, g, edges, *w)
    only = gk.step_bwd(h, a, g, edges, *w, weights=False)
    assert torch.equal(full[0], only[0]) and all(x is None for x in only[1:])


def test_ggnn_fused_saliency_is_the_per_step_bits(corpus, ggnn):
    _, specs, _ = corpus
    cfg, _, params = ggnn
    batch, _ = _batches(specs, 4, 4)
    runs = [L.ggnn_score_fn("saliency", _port_model(
        cfg, params, ggnn_kernel=True, ggnn_kernel_unroll=u))(batch) for u in ("per_step", "fused")]
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][0], runs[1][0])


# -- the served localizer ------------------------------------------------------------


def test_served_lines_equal_the_offline_program(corpus, ggnn):
    """A function attributed alone through the localizer is the offline
    `ggnn_score_fn` at rung 1 to the bit; co-batched, the same ranking
    and rtol 1e-5; `attribute_all` chunks greedily under the budgets and
    keeps the input's order."""
    examples, _, vocabs = corpus
    cfg, _, params = ggnn
    model = _port_model(cfg, params)
    pre = RequestPreprocessor(cfg, vocabs)
    feats = [pre.features_full(e.code, e.id) for e in examples[:4]]
    loc = GgnnLocalizer(model, NODE_BUDGET, EDGE_BUDGET, sizes=(1, 2, 4), method="saliency",
                        n_steps=2, top_k=0, device="cpu")
    assert set(loc.warmup()) == {"L1", "L2", "L4"} and loc.warmup() == {}
    offline = L.ggnn_score_fn("saliency", model, n_steps=2)
    alone = {}
    for f in feats:
        probs, scores = offline(pack([f.spec], 1, NODE_BUDGET, EDGE_BUDGET).to("cpu"))
        ref = L.node_line_attributions(scores.numpy()[:f.spec.num_nodes], f.node_lines)
        [(prob, lines)] = loc.attribute([f])
        assert lines == ref and prob == float(probs[0])
        alone[f.spec.graph_id] = lines
    for f, (_, lines) in zip(feats, loc.attribute(feats)):
        ref = alone[f.spec.graph_id]
        assert [d["line"] for d in lines] == [d["line"] for d in ref]
        np.testing.assert_allclose([d["score"] for d in lines], [d["score"] for d in ref],
                                   rtol=1e-5, atol=1e-7)
    # small budgets: several chunks, each a greedy run of what fits
    nodes = sum(f.spec.num_nodes for f in feats[:2])
    small = GgnnLocalizer(model, nodes, EDGE_BUDGET, sizes=(1, 2, 4), method="saliency",
                          n_steps=2, top_k=3, device="cpu")
    want, chunk = [], []
    for f in feats:
        if chunk and not small.fits(chunk, f):
            want.extend(small.attribute(chunk))
            chunk = []
        chunk.append(f)
    want.extend(small.attribute(chunk))
    batches = small.batches
    assert batches >= 2 and small.attribute_all(feats) == want
    assert small.batches == 2 * batches and all(len(lines) <= 3 for _, lines in want)
    with pytest.raises(ValueError, match="unknown GGNN method"):
        GgnnLocalizer(model, NODE_BUDGET, EDGE_BUDGET, (1,), method="lime", device="cpu")


# -- token attributions ---------------------------------------------------------


WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
         "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n")
VOCAB, T, INPUT_DIM = 256, 24, 52


def _codes(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(6, 30)))).replace("; ", ";\n")
            for _ in range(n)]


def _graph_specs(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for gid in range(n):
        nn_ = int(rng.integers(2, 12))
        e = int(rng.integers(1, 2 * nn_))
        out.append(dict(graph_id=gid, node_feats=rng.integers(0, INPUT_DIM, (nn_, 4)).astype(
            np.int32), node_vuln=np.zeros((nn_,), np.int32),
            edge_src=rng.integers(0, nn_, (e,)).astype(np.int32),
            edge_dst=rng.integers(0, nn_, (e,)).astype(np.int32), label=0.0))
    return out


@pytest.fixture(scope="module")
def token_models():
    """{arch: (reference cfg, reference params, port model, ids, graph
    batches (port, reference) or None)}: fp32 tiny encoders with a graph
    branch (roberta) and without (t5)."""
    out = {}
    codes = _codes()
    ids = HashTokenizer(vocab_size=VOCAB).batch_encode(codes, T)
    ids[1, -6:] = 1  # ragged padding
    specs = _graph_specs(2)
    gb = pack([TSpec(**kw) for kw in specs], 2, 64, 256).to("cpu")
    jgb = jpack([JSpec(**kw) for kw in specs], 2, 64, 256)
    enc = dict(vocab_size=VOCAB, dropout_rate=0.0, max_position_embeddings=T + 4)
    kw = dict(graph_hidden_dim=8, graph_n_steps=2, graph_input_dim=INPUT_DIM, head_dropout=0.0)
    jcfg = jcmb.CombinedConfig(encoder=jtfm.TransformerConfig.tiny(**enc), **kw)
    params = jax.tree.map(np.asarray, jcmb.init_params(jcfg, jax.random.key(0)))
    model = CombinedModel(CombinedConfig(encoder=TransformerConfig.tiny(**enc), **kw))
    model.load_state_dict(from_jax_combined_params(params))
    out["roberta"] = (jcfg, params, model.eval(), ids, (gb, jgb))

    ids5 = HashTokenizer(vocab_size=VOCAB, t5_frame=True).batch_encode(codes, T)
    ids5[1, -6:] = 0
    enc5 = dict(vocab_size=VOCAB, dropout_rate=0.0)
    jcfg5 = jt5.DefectConfig(encoder=jt5.T5Config.tiny(remat=False, **enc5), use_graph=False)
    params5 = jax.tree.map(np.asarray, jt5.init_defect_params(jcfg5, jax.random.key(1)))
    model5 = DefectModel(DefectConfig(encoder=T5Config.tiny(**enc5), use_graph=False))
    model5.load_state_dict(from_jax_defect_params(params5))
    out["t5"] = (jcfg5, params5, model5.eval(), ids5, None)
    return out


def _reference_draws(method, shape, n_samples, seed=0):
    """The reference's noise for the sampled methods (eval/localize.py:
    token_scores), as (alpha, eps) pairs."""
    out = []
    for k in jax.random.split(jax.random.key(seed), n_samples):
        if method == "deeplift_shap":
            out.append((0.0, jax.random.normal(k, shape, jnp.float32)))
        else:
            k1, k2 = jax.random.split(k)
            out.append((float(jax.random.uniform(k1)), jax.random.normal(k2, shape, jnp.float32)))
    return [(a, torch.from_numpy(np.array(e))) for a, e in out]


def _close_rows(got, want):
    """Within SCORE_TOL of each row's largest |reference score|."""
    scale = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert got.shape == want.shape and np.all(err <= SCORE_TOL * scale), float(err.max())


@pytest.mark.parametrize("arch, method", [("roberta", m) for m in L.METHODS]
                         + [("t5", m) for m in L.GRADIENT_METHODS])
def test_token_scores_match_the_reference(token_models, arch, method):
    jcfg, params, model, ids, graphs = token_models[arch]
    kw, jkw = {}, {}
    if graphs is not None:
        gb, jgb = graphs
        has = np.array([True, True])
        kw = dict(graph_batch=gb, has_graph=torch.from_numpy(has))
        jkw = dict(graph_batch=jgb, has_graph=jnp.asarray(has))
    want = JL.token_scores(method, arch, jcfg, params, jnp.asarray(ids), n_steps=4, n_samples=2,
                           **jkw)
    draws = None
    if method in ("deeplift_shap", "gradient_shap"):
        draws = _reference_draws(method, (*ids.shape, jcfg.encoder.hidden_size), 2)
    got = L.token_scores(method, arch, model, torch.from_numpy(ids), n_steps=4, n_samples=2,
                         draws=draws, **kw)
    _close_rows(got, np.asarray(want))
    if method != "attention":  # differentiated with respect to the rows alone
        assert not any(p.requires_grad for p in model.parameters())


def test_token_refusals_and_own_draws(token_models):
    jcfg, params, model, ids, _ = token_models["t5"]
    with pytest.raises(ValueError, match="use a gradient method"):
        L.token_scores("attention", "t5", model, torch.from_numpy(ids))
    with pytest.raises(ValueError, match="unknown method"):
        L.token_scores("lime", "t5", model, torch.from_numpy(ids))
    # without draws: a CPU generator's, the same on every call
    a = L.token_scores("gradient_shap", "t5", model, torch.from_numpy(ids), n_samples=2, seed=3)
    b = L.token_scores("gradient_shap", "t5", model, torch.from_numpy(ids), n_samples=2, seed=3)
    assert np.array_equal(a, b) and np.isfinite(a).all()
    d1, d2 = L.shap_draws((2, 3), 2, seed=3), L.shap_draws((2, 3), 2, seed=3)
    assert all(x[0] == y[0] and torch.equal(x[1], y[1]) for x, y in zip(d1, d2))


def test_combined_saliency_scores_match_the_reference(token_models):
    jcfg, params, model, ids, (gb, jgb) = token_models["roberta"]
    has = np.array([True, False])
    want = JL.combined_saliency_scores(jcfg, params, jnp.asarray(ids), jgb, jnp.asarray(has))
    got = L.combined_saliency_scores(model, torch.from_numpy(ids), gb, torch.from_numpy(has))
    _close_rows(got, np.asarray(want))


def test_path_attribution_exact_on_linear_and_complete():
    """The n-step rescale: exact at every step count on a linear target
    (delta x weight), and sum(attr) -> f(input) - f(baseline) on a
    nonlinear one, tighter with more steps."""
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.normal(size=(2, 5, 4)).astype(np.float32))
    base = torch.zeros_like(rows)
    w = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    grad = L._grad_of(lambda r: (r * w).sum())
    a1 = L._path_attribution(grad, rows, base, 1)
    a32 = L._path_attribution(grad, rows, base, 32)
    torch.testing.assert_close(a1, a32, atol=1e-6, rtol=0)
    torch.testing.assert_close(a32, (rows - base) * w, atol=1e-6, rtol=0)

    def mlp(r):
        h = torch.tanh(r.reshape(2, -1) @ torch.ones(20, 3))
        return (h * torch.tensor([0.5, -1.0, 2.0])).sum()

    grad2 = L._grad_of(mlp)
    exact = float(mlp(rows) - mlp(base))
    err64 = abs(float(L._path_attribution(grad2, rows, base, 64).sum()) - exact)
    err1 = abs(float(L._path_attribution(grad2, rows, base, 1).sum()) - exact)
    assert err64 <= 1e-3 * abs(exact) and err64 <= err1 + 1e-6


# -- serving {"lines": true} and `cli localize` ------------------------------------------


@pytest.fixture()
def run(tmp_path, monkeypatch, corpus, ggnn):
    """A GGNN run of the port's (config.json, vocabulary, a checkpoint of
    the reference's init) under a temporary storage root."""
    from deepdfa_tpu_torch.core import paths

    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    _, _, vocabs = corpus
    cfg, _, params = ggnn
    cfg = config_mod.apply_overrides(cfg, ['run_name="lines"', 'data.dataset="lines"'])
    run_dir = paths.runs_dir(cfg.run_name)
    config_mod.to_json(cfg, run_dir / "config.json")
    (paths.processed_dir(cfg.data.dataset) / f"vocab{cfg.data.feat.name}.json").write_text(
        json.dumps({k: v.to_json() for k, v in vocabs.items()}))
    CheckpointManager(run_dir / "checkpoints-torch").save(
        "epoch-0001", {"model": from_jax_params(params)}, {"val_loss": 1.0}, step=1)
    return cfg, run_dir, params


@pytest.mark.parametrize("cascade", [False, True], ids=["ggnn", "cascade"])
def test_lines_over_http(run, corpus, cascade, tmp_path):
    """`serve.lines=true`: POST /score {"lines": true} answers the ranked
    lines of the function attributed alone (the offline program at rung
    1, top 10), also on a cascade server (stage 1's lines), `/healthz`
    names the method; without `serve.lines` the request is a 400 before
    any device work and /healthz says lines false."""
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import BackgroundServer, ScoringService

    cfg, run_dir, params = run
    examples, _, vocabs = corpus
    extra = ["serve.lines=true", 'serve.lines_method="lig"', "serve.lines_steps=3"]
    if cascade:
        from deepdfa_tpu_torch.serve.cascade import build_stage2_smoke

        stage2 = tmp_path / "stage2"
        stage2.mkdir()
        config_mod.to_json(cfg, stage2 / "config.json")
        build_stage2_smoke(stage2, cfg, family="combined")
        extra += ["serve.cascade=true", "serve.cascade_band=[0.0, 1.0]",
                  f'serve.cascade_run_dir="{stage2}"']
    lcfg = config_mod.apply_overrides(cfg, extra)
    model = _port_model(cfg, params)
    offline = L.ggnn_score_fn("lig", model, n_steps=3)
    pre = RequestPreprocessor(cfg, vocabs)
    server = BackgroundServer(ScoringService(ModelRegistry(run_dir, cfg=lcfg, device="cpu"), lcfg))
    try:
        health = server.request("GET", "/healthz")[1]
        assert health["lines"] is True and health["lines_method"] == "lig"
        for e in examples[:3]:
            status, body = server.request("POST", "/score", {"code": e.code, "lines": True})
            f = pre.features_full(e.code)
            _, scores = offline(pack([f.spec], 1, NODE_BUDGET, EDGE_BUDGET).to("cpu"))
            want = L.node_line_attributions(scores.numpy()[:f.spec.num_nodes], f.node_lines,
                                            top_k=10)
            assert status == 200 and body["lines"] == want and 0 < len(want) <= 10
            assert body.get("stage") == (2 if cascade else None)
            status, body = server.request("POST", "/score", {"code": e.code})
            assert status == 200 and "lines" not in body
        assert server.request("POST", "/score", {"code": "@@@", "lines": True})[0] == 422
        assert server.request("GET", "/stats")[1]["localize"]["functions"] == 3
    finally:
        server.close()
    plain = BackgroundServer(ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), cfg))
    try:
        assert plain.request("GET", "/healthz")[1]["lines"] is False
        status, body = plain.request("POST", "/score", {"code": examples[0].code, "lines": True})
        assert status == 400 and "serve.lines=true" in body["error"]
        assert plain.service.batcher.batches_run == 0
    finally:
        plain.close()


def _localize_run(tmp_path, n=24):
    """A processed dir (port Examples with labelled lines, a graph store,
    splits) and a tiny combined run's checkpoint, under `tmp_path`; the
    config path."""
    rng = np.random.default_rng(7)
    codes = _codes(n, seed=7)
    examples = [Example(id=i, code=c, label=float(i % 2),
                        vuln_lines=frozenset({int(rng.integers(1, len(split_lines(c)) + 1))})
                        if i % 3 else frozenset())
                for i, c in enumerate(codes)]
    out = tmp_path / "processed" / "loc"
    out.mkdir(parents=True)
    with (out / "examples.pkl").open("wb") as f:
        pickle.dump(examples, f)
    cfg_d = {"run_name": "loc", "data": {"dataset": "loc",
                                          "feat": {"limit_all": 50, "limit_subkeys": 50},
                                          "batch": {"node_budget": 256, "edge_budget": 1024}},
             "model": {"hidden_dim": 8}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg_d))
    cfg = config_mod.load(cfg_path)
    GraphStore(out / cli.graphs_dirname(cfg)).write(
        [TSpec(**kw) for kw in _graph_specs(n, seed=8) if kw["graph_id"] % 4])
    (out / "splits.json").write_text(json.dumps({str(i): "test" if i % 2 else "train"
                                                 for i in range(n)}))
    args = cli.build_parser().parse_args(["localize", "--max-length", "48"])
    _, mcfg = cli.combined_setup(args, cfg)
    model = CombinedModel(mcfg, generator=torch.Generator().manual_seed(2))
    CheckpointManager(tmp_path / "runs" / "loc" / cli.COMBINED_CHECKPOINTS_DIR).save(
        "epoch-0000", {"model": model.state_dict()}, {"val_loss": 1.0}, step=1)
    return cfg_path, examples


@pytest.mark.parametrize("method", ["saliency", "attention", "lig"])
def test_cli_localize_end_to_end(tmp_path, monkeypatch, capsys, method):
    """`cli localize --device cpu`: the report is `statement_report` over
    the port's in-process scores of the split's functions with labelled
    lines (limited), plus n_examples and method, in
    localize_<split>_<method>.json and on stdout; one IFA line per
    example with a flagged line."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cfg_path, examples = _localize_run(tmp_path)
    argv = ["localize", "--config", str(cfg_path), "--device", "cpu", "--method", method,
            "--max-length", "48", "--limit", "5"]
    cli.main(argv)
    printed = json.loads(capsys.readouterr().out)
    run = tmp_path / "runs" / "loc"
    report = json.loads((run / f"localize_test_{method}.json").read_text())
    assert report == printed and report["method"] == method and report["n_examples"] == 5

    args = cli.build_parser().parse_args(argv)
    cfg = config_mod.load(cfg_path)
    tok, mcfg = cli.combined_setup(args, cfg)
    model = CombinedModel(mcfg)
    model.load_state_dict(CheckpointManager(run / cli.COMBINED_CHECKPOINTS_DIR).restore(
        "best")["model"])
    graphs = GraphStore(tmp_path / "processed" / "loc" / cli.graphs_dirname(cfg)).load_all()
    targets = [e for e in examples if e.id % 2 and e.vuln_lines][:5]
    ranked = []
    for e in targets:
        ids, tok_lines = tok.encode_with_lines(e.code, max_length=48)
        b = ttext.collate(ids[None], [int(e.label)], [e.id], graphs, 1, 256, 1024,
                          pad_id=tok.pad_id).to("cpu")
        scores = L.token_scores(method, "roberta", model, b.input_ids, b.graphs, b.has_graph)
        n_lines = len(split_lines(e.code))
        flagged = np.zeros(n_lines, bool)
        flagged[[ln - 1 for ln in e.vuln_lines]] = True
        ranked.append(S.RankedExample(L.aggregate_line_scores(scores[0], tok_lines, n_lines),
                                      flagged))
    assert {k: v for k, v in report.items() if k not in ("n_examples", "method")} == \
        S.statement_report(ranked)
    ifa = (run / "ifa_records" / f"ifa_{method}.txt").read_text().split()
    assert [int(x) for x in ifa] == S.per_example_ifa(ranked) and len(ifa) == 5
