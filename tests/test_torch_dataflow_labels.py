"""The dataflow_solution_{in,out} label styles of the port against the
reference: the bit-labelled extraction (`build_dataset(max_defs=...)`),
the graph store and `pack` with bits, the DeepDFA dataflow branch
(forward and gradients, weights carried over by `from_jax_params`) and
a short `GraphTrainer.fit` on the CPU.

Tolerances: the extraction, the store and `pack` exact; the model's
logits and the loss rtol=atol 1e-5 (fp32, cross-framework
reassociation; the reference runs its GGNN step kernel in interpret
mode); the gradients 1e-5 of each leaf's scale (`_leaf_errors`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.data import pipeline as jpipeline, synthetic as jsynthetic  # noqa: E402
from deepdfa_tpu.graphs import GraphStore as JStore, pack as jpack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.train import losses as jlosses  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphStore, pack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.train import GraphTrainer, losses  # noqa: E402
from tests.test_torch_pipeline import assert_specs_equal  # noqa: E402

TOL = 1e-5
MAX_DEFS = 16
HIDDEN, N_STEPS = 8, 3
NODE_BUDGET, EDGE_BUDGET, GRAPHS = 512, 2048, 8
STYLES = ("dataflow_solution_in", "dataflow_solution_out")


def _datasets(gtype: str = "cfg", n: int = 24):
    examples = synthetic.to_examples(synthetic.generate(n, seed=3, vuln_rate=0.3))
    ref_examples = jsynthetic.to_examples(jsynthetic.generate(n, seed=3, vuln_rate=0.3))
    train = [e.id for e in examples if e.id % 4]
    got = pipeline.build_dataset(examples, train, max_defs=MAX_DEFS, gtype=gtype)
    want = jpipeline.build_dataset(ref_examples, train, max_defs=MAX_DEFS, gtype=gtype)
    return got, want


@pytest.mark.parametrize("gtype", ["cfg", "cfg+dep"])
def test_build_dataset_with_bits_equals_reference(gtype):
    (specs, vocabs), (want, _) = _datasets(gtype)
    assert_specs_equal(specs, want)
    assert all(s.node_gen.shape == (len(s.node_feats), MAX_DEFS) for s in specs)
    # the corpus has definitions: real bits, and a label set
    assert sum(float(s.node_bits_out.sum()) for s in specs) > 0


def test_store_round_trip_and_pack_with_bits(tmp_path):
    (specs, _), (want, _) = _datasets()
    GraphStore(tmp_path / "port").write(specs)
    back = list(GraphStore(tmp_path / "port").iter_graphs())
    assert_specs_equal(back, want)
    assert_specs_equal(list(JStore(tmp_path / "port").iter_graphs()), want)
    JStore(tmp_path / "ref").write(want)
    assert_specs_equal(list(GraphStore(tmp_path / "ref").iter_graphs()), want)
    got = pack(specs[:GRAPHS], GRAPHS, NODE_BUDGET, EDGE_BUDGET)
    ref = jpack(want[:GRAPHS], GRAPHS, NODE_BUDGET, EDGE_BUDGET)
    for f in ("node_gen", "node_kill", "node_bits_in", "node_bits_out", "node_mask", "edge_src",
              "edge_dst", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)), err_msg=f)
    # a batch mixing specs with and without bits is refused, as the reference refuses it
    bare = [type(s)(**{**s.__dict__, "node_gen": None, "node_kill": None,
                       "node_bits_in": None, "node_bits_out": None}) for s in specs[:2]]
    jbare = [type(s)(**{**s.__dict__, "node_gen": None, "node_kill": None,
                        "node_bits_in": None, "node_bits_out": None}) for s in want[:2]]
    with pytest.raises(ValueError, match="bit"):
        pack([specs[2], *bare], 4, NODE_BUDGET, EDGE_BUDGET)
    with pytest.raises(ValueError, match="bit"):
        jpack([want[2], *jbare], 4, NODE_BUDGET, EDGE_BUDGET)


def _reference(style: str, n_etypes: int, batch):
    model = JDeepDFA(input_dim=1002, hidden_dim=HIDDEN, n_steps=N_STEPS, n_etypes=n_etypes,
                     label_style=style, ggnn_kernel=True)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(2), batch))
    return model, params


def _leaf_errors(got, want):
    """max |got - want| / max |want| per leaf, the scale floored at 1e-3
    of the largest magnitude over all leaves."""
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    return {k: float(np.abs(np.asarray(got[k]) - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("gtype", ["cfg", "cfg+dep"])
def test_dataflow_model_and_grads_match_reference(style, gtype):
    (specs, _), (want, _) = _datasets(gtype)
    n_etypes = 3 if gtype == "cfg+dep" else 1
    jb = jpack(want[:GRAPHS], GRAPHS, NODE_BUDGET, EDGE_BUDGET)
    tb = pack(specs[:GRAPHS], GRAPHS, NODE_BUDGET, EDGE_BUDGET).to("cpu")
    model, params = _reference(style, n_etypes, jb)
    assert set(params["params"]) == {"embedding", "ggnn", "bitprop", "head"}

    def loss(p):
        logits = model.apply(p, jb)
        labels, mask = jlosses.dataflow_labels(jb, style)
        per = jlosses.bce_elements(logits, labels, 1.0)
        m = mask.astype(per.dtype)
        return (per * m).sum() / jnp.maximum(m.sum(), 1.0), logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = DeepDFA(1002, HIDDEN, N_STEPS, n_etypes, label_style=style, max_defs=MAX_DEFS)
    port.load_state_dict(from_jax_params(params))
    logits = port(tb)
    assert logits.shape == (NODE_BUDGET, MAX_DEFS)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=TOL,
                               atol=TOL)
    got_loss, labels, mask = losses.classifier_loss(logits, tb, style)
    assert mask.shape == labels.shape == (NODE_BUDGET, MAX_DEFS)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=TOL, atol=TOL)
    got_loss.backward()
    want_sd = from_jax_params(jax.tree.map(np.asarray, want_grads))
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(grads) == set(want_sd)
    errs = _leaf_errors(grads, want_sd)
    assert max(errs.values()) <= TOL, errs
    # encoder mode returns the head's input features
    enc = DeepDFA(1002, HIDDEN, N_STEPS, n_etypes, label_style=style, max_defs=MAX_DEFS,
                  encoder_mode=True)
    enc.load_state_dict({k: v for k, v in port.state_dict().items() if not k.startswith("head.")})
    with torch.inference_mode():
        feats = enc(tb)
    assert feats.shape == (NODE_BUDGET, 8 * HIDDEN + 4 * MAX_DEFS)


def test_short_fit_on_the_cpu_lowers_the_loss():
    """Four epochs of dataflow_solution_out on the CPU: the loss falls,
    and `evaluate` scores every valid node's bits."""
    (specs, _), _ = _datasets(n=16)
    cfg = tconfig.apply_overrides(tconfig.Config(), [
        "model.label_style=dataflow_solution_out", f"model.hidden_dim={HIDDEN}",
        f"model.n_steps={N_STEPS}", f"data.feat.max_defs={MAX_DEFS}",
        "train.optim.learning_rate=0.01", "train.prefetch_batches=0"])
    batches = [pack(specs[i:i + GRAPHS], GRAPHS, NODE_BUDGET, EDGE_BUDGET)
               for i in range(0, len(specs), GRAPHS)]
    model = DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim, max_defs=MAX_DEFS)
    trainer = GraphTrainer(model, cfg, device="cpu")
    state = trainer.init_state()
    records = []
    trainer.fit(state, lambda epoch: batches, max_epochs=4, log_fn=records.append)
    losses_ = [r["train_loss"] for r in records if "train_loss" in r]
    assert len(losses_) == 4 and np.isfinite(losses_).all()
    assert losses_[-1] < losses_[0]
    metrics, m = trainer.evaluate(batches)
    valid = sum(int(b.node_mask.sum()) for b in batches) * MAX_DEFS
    assert m.count == valid and np.isfinite(metrics["loss"])


def test_request_frontend_extracts_the_bits_as_the_reference():
    """`serve.frontend.RequestPreprocessor` with `data.feat.max_defs`:
    the served spec carries the reference's bits and content key."""
    from deepdfa_tpu.core import config as jconfig
    from deepdfa_tpu.serve import frontend as jfrontend
    from deepdfa_tpu_torch.serve import frontend

    (specs, vocabs), (_, ref_vocabs) = _datasets(n=12)
    over = [f"data.feat.max_defs={MAX_DEFS}"]
    port = frontend.RequestPreprocessor(tconfig.apply_overrides(tconfig.Config(), over), vocabs)
    ref = jfrontend.RequestPreprocessor(jconfig.apply_overrides(jconfig.Config(), over),
                                        ref_vocabs)
    examples = synthetic.to_examples(synthetic.generate(12, seed=3, vuln_rate=0.3))
    for e, s in zip(examples, specs):
        got = port.features(e.code, request_id=e.id)
        want = ref.features(e.code, request_id=e.id)
        for f in ("node_feats", "edge_src", "edge_dst", "node_gen", "node_kill", "node_bits_in",
                  "node_bits_out"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
            np.testing.assert_array_equal(getattr(got, f), getattr(s, f), err_msg=f)
        assert port.content_key(e.code) == ref.content_key(e.code)
