"""The port's training path (deepdfa_tpu_torch/train/, graphs/ planner and
store, cli.py) against the reference, on the CPU.

Same seeded numpy inputs into both packages:
- labels, losses, the sampler, the bucket planner and the metrics:
  bit for bit (or to fp32 ulps where a float is computed);
- whole-model gradients of the masked-mean loss, per parameter leaf,
  against `jax.grad` of the reference model (lax path and the Pallas
  step kernel in interpret mode): max |port - ref| / max |ref| <= 1e-4
  (the reference's own kernel-vs-lax bound is 1e-3,
  tests/test_ggnn_kernel.py); measured ~1e-6;
- one AdamW (and Adam, SGD, warmup-schedule) update against optax on
  identical gradients: 1e-6;
- a K = 5 step SGD trajectory against the reference `GraphTrainer`
  (dp = 1 mesh, lax path): losses rtol 1e-5, parameters 1e-4 relative
  per leaf (measured 8e-8 and 3e-7);
- an AdamW trajectory is held on its losses only (rtol 1e-4; measured
  2e-6 over 5 steps): Adam's first updates are close to lr * sign(g),
  so a gradient element at fp32 noise level flips sign between the
  frameworks and moves its weight by 2 * lr. The gate's bias, whose
  gradient is noise (the softmax is shift invariant), does just that;
  the loss does not feel it;
- checkpoints, and `cli train` / `cli test` on a store written by the
  reference's `GraphStore.write`.
"""

import csv
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as JSpec, GraphStore as JStore  # noqa: E402
from deepdfa_tpu.graphs import pack as jpack  # noqa: E402
from deepdfa_tpu.graphs import batch as jbatch  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.parallel import make_mesh  # noqa: E402
from deepdfa_tpu.train import losses as jlosses  # noqa: E402
from deepdfa_tpu.train import metrics as jmetrics  # noqa: E402
from deepdfa_tpu.train import sampler as jsampler  # noqa: E402
from deepdfa_tpu.train import state as jstate  # noqa: E402
from deepdfa_tpu.train.loop import GraphTrainer as JTrainer  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, GraphStore as TStore  # noqa: E402
from deepdfa_tpu_torch.graphs import batch as tbatch, pack as tpack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.train import (  # noqa: E402
    BinaryClassificationMetrics,
    CheckpointManager,
    GraphTrainer,
    TrainState,
    classification_report,
    drop_known_feats,
    losses as tlosses,
    lr_factor,
    sampler as tsampler,
)

VOCAB = 20
CFG = {
    "run_name": "port-train",
    "data": {
        "feat": {"limit_all": VOCAB - 2, "limit_subkeys": VOCAB - 2},
        "batch": {"graphs_per_batch": 8, "node_budget": 256, "edge_budget": 1024},
    },
    "model": {"hidden_dim": 8, "n_steps": 3},
    "train": {"optim": {"name": "sgd", "learning_rate": 0.5}, "mesh": {"dp": 1},
              "seed": 3, "max_epochs": 2, "checkpoint_every_epochs": 1},
}


def _cfgs(**train):
    d = json.loads(json.dumps(CFG))
    d["train"].update(train)
    return jconfig.from_dict(d), tconfig.from_dict(d)


def synthetic(rng, n_graphs=48, vuln_per_node=False):
    """Graphs whose label is the presence of feature token 7 on a node
    (the reference's tests/test_train.py signal), as both packages'
    specs."""
    ref, port = [], []
    for gid in range(n_graphs):
        n = int(rng.integers(4, 16))
        feats = rng.integers(2, VOCAB, (n, 4)).astype(np.int32)
        vuln = np.zeros((n,), np.int32)
        if gid % 2 == 0:
            k = int(rng.integers(0, n))
            feats[k, 0] = 7
            vuln[k] = 1
        src = np.arange(n - 1, dtype=np.int32)
        extra = rng.integers(0, n, (2, n // 2)).astype(np.int32)
        kw = dict(graph_id=gid, node_feats=feats, node_vuln=vuln,
                  edge_src=np.concatenate([src, extra[0]]),
                  edge_dst=np.concatenate([src + 1, extra[1]]),
                  label=float(vuln.max()) if not vuln_per_node else 0.0)
        ref.append(JSpec(**kw))
        port.append(TSpec(**kw))
    return ref, port


def _batch_pair(rng, count=6, size=8):
    ref, port = synthetic(rng, count)
    return jpack(ref, size, 256, 1024), tpack(port, size, 256, 1024)


# -- labels and losses ------------------------------------------------------


@pytest.mark.parametrize("pos_weight", [1.0, 2.5])
@pytest.mark.parametrize("style", ["graph", "node"])
def test_labels_and_losses_match_reference(style, pos_weight):
    rng = np.random.default_rng(1)
    jb, tb = _batch_pair(rng)
    tb = tb.to("cpu")
    if style == "graph":
        np.testing.assert_array_equal(tlosses.graph_labels(tb).numpy(),
                                      np.asarray(jlosses.graph_labels(jb)))
    n = jb.node_budget if style == "node" else jb.num_graphs
    logits = (rng.standard_normal(n) * 3).astype(np.float32)
    want, wl, wm = jlosses.classifier_loss(jnp.asarray(logits), jb, style, pos_weight)
    got, gl, gm = tlosses.classifier_loss(torch.from_numpy(logits), tb, style, pos_weight)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    per = tlosses.bce_elements(torch.from_numpy(logits), gl, pos_weight).numpy()
    np.testing.assert_allclose(
        per, np.asarray(jlosses.bce_elements(jnp.asarray(logits), wl, pos_weight)),
        rtol=1e-6, atol=1e-7)


def test_graph_labels_take_the_stored_label_and_skip_padding():
    """A graph-only label survives (OR with the stored label), padded
    slots are 0, and the all-padding batch gives all zeros."""
    rng = np.random.default_rng(2)
    ref, port = synthetic(rng, 4, vuln_per_node=True)
    port[1] = TSpec(**{**port[1].__dict__, "label": 1.0})
    ref[1] = JSpec(**{**ref[1].__dict__, "label": 1.0})
    jb, tb = jpack(ref, 6, 128, 512), tpack(port, 6, 128, 512).to("cpu")
    got = tlosses.graph_labels(tb).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlosses.graph_labels(jb)))
    assert got[1] == 1.0 and not got[4:].any()
    empty = tpack([], 3, 64, 256).to("cpu")
    assert not tlosses.graph_labels(empty).any()
    # the dataflow styles are ported: a batch without bits is refused as
    # the reference refuses it
    with pytest.raises(ValueError, match="bit labels"):
        tlosses.classifier_loss(torch.zeros(3), empty, "dataflow_solution_in")
    with pytest.raises(ValueError, match="bit labels"):
        jlosses.dataflow_labels(jpack([], 3, 64, 256), "dataflow_solution_in")


# -- host-side copies: bit for bit ------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_matches_reference_bit_for_bit(seed):
    labels = (np.random.default_rng(seed).random(97) < 0.2).astype(np.float32)
    for epoch in range(3):
        np.testing.assert_array_equal(tsampler.undersample_epoch(labels, epoch, seed),
                                      jsampler.undersample_epoch(labels, epoch, seed))
        np.testing.assert_array_equal(tsampler.undersample_epoch(labels, epoch, seed, 2.0),
                                      jsampler.undersample_epoch(labels, epoch, seed, 2.0))
        np.testing.assert_array_equal(tsampler.oversample_epoch(labels, epoch, seed),
                                      jsampler.oversample_epoch(labels, epoch, seed))
    assert tsampler.positive_weight(labels) == jsampler.positive_weight(labels)
    zeros = np.zeros(5)
    np.testing.assert_array_equal(tsampler.oversample_epoch(zeros, 0, seed),
                                  jsampler.oversample_epoch(zeros, 0, seed))


def _heavy_tail(rng, count=60):
    ref, port = [], []
    for gid in range(count):
        n = int(rng.choice([3, 20, 90, 300]))  # some exceed the node budget
        e = int(rng.integers(0, 2 * n))
        kw = dict(graph_id=gid, node_feats=rng.integers(0, 9, (n, 4)).astype(np.int32),
                  node_vuln=np.zeros((n,), np.int32),
                  edge_src=rng.integers(0, n, e).astype(np.int32),
                  edge_dst=rng.integers(0, n, e).astype(np.int32), label=float(gid % 3 == 0))
        ref.append(JSpec(**kw))
        port.append(TSpec(**kw))
    return ref, port


@pytest.mark.parametrize("oversized", ["drop", "singleton"])
def test_bucket_planner_matches_reference_bit_for_bit(oversized):
    ref, port = _heavy_tail(np.random.default_rng(3))
    jstats, tstats = {}, {}
    jplans = list(jbatch.plan_shard_bucket_batches(ref, 1, 8, 256, 640, oversized=oversized,
                                                   stats=jstats))
    tplans = list(tbatch.plan_shard_bucket_batches(port, 8, 256, 640, oversized=oversized,
                                                   stats=tstats))
    assert [(p.shard_indices[0], p.num_graphs, p.node_budget, p.edge_budget) for p in jplans] \
        == [(p.indices, p.num_graphs, p.node_budget, p.edge_budget) for p in tplans]
    assert jstats == tstats and tstats["oversized"] > 0
    jbs = list(jbatch.shard_bucket_batches(ref, 1, 8, 256, 640, oversized=oversized))
    tbs = list(tbatch.shard_bucket_batches(port, 8, 256, 640, oversized=oversized))
    assert len(jbs) == len(tbs) == len(tplans)
    for j, t in zip(jbs, tbs):
        assert j.num_graphs == t.num_graphs
        for f in tbatch.ARRAY_FIELDS:
            a, b = getattr(j, f), getattr(t, f)
            assert (a is None) == (b is None), f
            if b is not None:
                np.testing.assert_array_equal(np.asarray(a)[0], b, err_msg=f)
    with pytest.raises(tbatch.BudgetExceeded):
        list(tbatch.plan_shard_bucket_batches(port, 8, 256, 640, oversized="raise"))


def test_bucket_batches_match_reference_bit_for_bit():
    ref, port = _heavy_tail(np.random.default_rng(4), 40)
    js, ts = {}, {}
    jbs = list(jbatch.bucket_batches(ref, 8, 256, 640, stats=js))
    tbs = list(tbatch.bucket_batches(port, 8, 256, 640, stats=ts))
    assert js == ts and len(jbs) == len(tbs)
    for j, t in zip(jbs, tbs):
        for f in tbatch.ARRAY_FIELDS:
            if getattr(t, f) is not None:
                np.testing.assert_array_equal(getattr(j, f), getattr(t, f), err_msg=f)


def test_metrics_match_reference_bit_for_bit():
    rng = np.random.default_rng(5)
    jm, tm = jmetrics.BinaryClassificationMetrics(), BinaryClassificationMetrics()
    for _ in range(4):
        probs = rng.random(33).astype(np.float32)
        labels = (rng.random(33) < 0.4).astype(np.float32)
        mask = rng.random(33) < 0.8
        jm.update(probs, labels, mask)
        tm.update(probs, labels, mask)
    assert jm.compute() == tm.compute()
    np.testing.assert_array_equal(jm.confusion_matrix(), tm.confusion_matrix())
    for k, v in jm.pr_curve(50).items():
        np.testing.assert_array_equal(v, tm.pr_curve(50)[k])
    assert jmetrics.classification_report(jm) == classification_report(tm)


def test_store_reads_what_the_reference_writes(tmp_path):
    rng = np.random.default_rng(6)
    ref, port = synthetic(rng, 9)
    typed = [JSpec(**{**g.__dict__, "edge_type": np.zeros(g.num_edges, np.int32)})
             for g in ref[:3]]
    JStore(tmp_path / "plain").write(ref, shard_size=4)
    JStore(tmp_path / "typed").write(typed)
    got = TStore(tmp_path / "plain").load_all()
    assert sorted(got) == [g.graph_id for g in port]
    for g in port:
        h = got[g.graph_id]
        assert h.label == g.label and h.edge_type is None
        for f in ("node_feats", "node_vuln", "edge_src", "edge_dst"):
            np.testing.assert_array_equal(getattr(h, f), getattr(g, f))
    assert all(g.edge_type is not None for g in TStore(tmp_path / "typed").iter_graphs())


# -- gradients, optimiser, trajectory ----------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_model(ggnn_kernel):
    jcfg, _ = _cfgs()
    model = JDeepDFA.from_config(jcfg.model, input_dim=VOCAB, ggnn_kernel=ggnn_kernel)
    jb, _ = _batch_pair(np.random.default_rng(0))
    params = jax.tree.map(np.asarray, model.init(jax.random.key(4), jb))
    return model, params


def _leaf_errors(got, want):
    """max |got - want| / max |want| per leaf. The gate's bias gradient
    vanishes (the softmax is shift invariant) and is fp32 noise on both
    sides, so each leaf's scale is floored at 1e-3 of the largest
    magnitude over all leaves."""
    want = {k: np.asarray(v) for k, v in want.items()}
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    return {k: float(np.abs(np.asarray(got[k]) - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


@pytest.mark.parametrize("ggnn_kernel", [False, True], ids=["lax", "pallas_interpret"])
def test_whole_model_grads_match_jax(ggnn_kernel):
    model, params = _reference_model(ggnn_kernel)
    jb, tb = _batch_pair(np.random.default_rng(8))

    def loss(p):
        logits = model.apply(p, jb)
        per = jlosses.bce_elements(logits, jlosses.graph_labels(jb), 1.0)
        m = jnp.asarray(jb.graph_mask, jnp.float32)
        return (per * m).sum() / jnp.maximum(m.sum(), 1.0)

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    want = from_jax_params(jax.tree.map(np.asarray, want))

    _, tcfg = _cfgs()
    port = DeepDFA.from_config(tcfg.model, VOCAB)
    trainer = GraphTrainer(port, tcfg, device="cpu")
    state = trainer.init_state(params=from_jax_params(params))
    got_loss = trainer.forward_loss(state, tb.to("cpu"))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(grads) == set(want)
    errs = _leaf_errors(grads, want)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.parametrize("name, kw", [
    ("adamw", {}), ("adam", {}), ("sgd", {}),
    ("adamw", {"warmup_frac": 0.5}), ("adamw", {"grad_clip_norm": 0.05}),
])
def test_optimizer_update_matches_optax(name, kw):
    """Identical gradients, three updates: parameters within 1e-6."""
    rng = np.random.default_rng(9)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1 for k, v in params.items()}
             for _ in range(3)]
    ocfg = dict(name=name, learning_rate=1e-2, weight_decay=1e-2, **kw)
    tx = jstate.make_optimizer(jconfig.OptimConfig(**ocfg), total_steps=4)
    jp, opt_state = dict(params), None
    opt_state = tx.init(jp)
    model = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                    for k, v in params.items()})
    state = TrainState.create(model, tconfig.OptimConfig(**ocfg), total_steps=4)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in model.items():
            p.grad = torch.from_numpy(g[k].copy())
        state.apply_gradients()
    for k, p in model.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)


def test_lr_schedule_matches_optax():
    cfg = tconfig.OptimConfig(learning_rate=0.1, warmup_frac=0.3)
    factor = lr_factor(cfg, 10)
    warmup = 3
    sched = optax.join_schedules([optax.linear_schedule(0.0, 0.1, warmup),
                                  optax.linear_schedule(0.1, 0.0, 7)], [warmup])
    for count in range(12):
        np.testing.assert_allclose(0.1 * factor(count), float(sched(count)), rtol=1e-6, atol=1e-9)
    assert lr_factor(tconfig.OptimConfig(), None) is None
    with pytest.raises(ValueError, match="total_steps"):
        lr_factor(cfg, None)


def _trajectories(optim, steps=5):
    """(reference losses, port losses, reference params, port params)
    after `steps` updates over the same fixed batches."""
    jcfg, tcfg = _cfgs(optim=optim)
    ref, port = synthetic(np.random.default_rng(10), 40)
    jbs = list(jbatch.shard_bucket_batches(ref, 1, 8, 256, 1024))
    tbs = list(tbatch.shard_bucket_batches(port, 8, 256, 1024))
    jmodel = JDeepDFA.from_config(jcfg.model, input_dim=VOCAB)
    jtrainer = JTrainer(jmodel, jcfg, mesh=make_mesh(jcfg.train.mesh, devices=jax.devices()[:1]))
    jstate_ = jtrainer.init_state(jbs[0])
    trainer = GraphTrainer(DeepDFA.from_config(tcfg.model, VOCAB), tcfg, device="cpu")
    state = trainer.init_state(params=from_jax_params(jax.device_get(jstate_.params)))
    jl, tl = [], []
    for i in range(steps):
        jstate_, loss = jtrainer.train_step(jstate_, jbs[i % len(jbs)])
        jl.append(float(loss))
        tl.append(float(trainer.train_step(state, tbs[i % len(tbs)].to(trainer.device))))
    want = from_jax_params(jax.tree.map(np.asarray, jax.device_get(jstate_.params)))
    got = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    return np.array(jl), np.array(tl), want, got


def test_sgd_trajectory_matches_reference_trainer():
    jl, tl, want, got = _trajectories({"name": "sgd", "learning_rate": 0.5})
    assert len(set(np.round(tl, 4))) > 1  # the model moved
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= 1e-4, errs


def test_adamw_trajectory_stays_close_to_reference_trainer():
    jl, tl, _, _ = _trajectories({"name": "adamw", "learning_rate": 1e-2})
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_trainer_refuses_what_the_port_does_not_run():
    """A mesh beyond one card is refused. The resilient runtime runs in
    GraphTrainer since the runtime-hooks slice
    (tests/test_torch_resilience.py); the multi-task generation and clone
    loops' rule (`refuse_unported_training` without the hooks) still
    refuses it, as their reference loops do not run it."""
    _, tcfg = _cfgs()
    model = DeepDFA.from_config(tcfg.model, VOCAB)
    for train in ({"mesh": {"dp": 2}}, {"mesh": {"dp": 1, "tp": 2}},
                  {"mesh": {"dp": 1, "num_shards": 4}}):
        _, cfg = _cfgs(**train)
        with pytest.raises(NotImplementedError):
            GraphTrainer(model, cfg, device="cpu")
    _, cfg = _cfgs(resilience={"enabled": True})
    GraphTrainer(model, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="reference's `train-multi-gen`"):
        tconfig.refuse_unported_training(cfg)
    flagship = tconfig.load(cli.Path(__file__).resolve().parents[1] / "configs" / "bigvul_deepdfa.json")
    assert tconfig.one_card(flagship.train.mesh) == 1
    ref = jconfig.load(cli.Path(__file__).resolve().parents[1] / "configs" / "bigvul_deepdfa.json")
    assert tconfig.to_dict(flagship.train.optim) == jconfig._to_dict(ref.train.optim)
    assert (flagship.data.undersample, flagship.data.split, flagship.data.seed) == \
        (ref.data.undersample, ref.data.split, ref.data.seed)
    assert flagship.data.feat.name == ref.data.feat.name


def test_drop_known_feats():
    feats = torch.tensor([[0, 1, 5, 9], [3, 0, 2, 7]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(drop_known_feats(feats, gen, 0.0), feats)
    assert torch.equal(drop_known_feats(feats, gen, 1.0),
                       torch.tensor([[0, 1, 1, 1], [1, 0, 1, 1]], dtype=torch.int32))
    wide = torch.cat([feats, torch.full((2, 2), 5, dtype=torch.int32)], dim=1)
    assert torch.equal(drop_known_feats(wide, gen, 1.0)[:, 4:], wide[:, 4:])


# -- checkpoints and the command line ----------------------------------------


def test_checkpoint_best_selection_and_round_trip(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", monitor="val_loss", mode="min", keep_last=2)
    states = [{"model": {"w": torch.full((3,), float(i))}} for i in range(4)]
    flags = [mgr.save(f"epoch-{i:04d}", s, {"val_loss": v}, step=i)
             for i, (s, v) in enumerate(zip(states, (0.5, 0.3, 0.4, 0.35)))]
    assert flags == [True, True, False, False]
    assert mgr.best_metrics() == {"val_loss": 0.3}
    assert torch.equal(mgr.restore("best")["model"]["w"], states[1]["model"]["w"])
    assert mgr.available_tags() == ["best", "epoch-0002", "epoch-0003"]
    again = CheckpointManager(tmp_path / "ck")
    assert again.best_metrics() == {"val_loss": 0.3}
    (tmp_path / "ck" / "manifest.json").write_text("{not json")
    rebuilt = CheckpointManager(tmp_path / "ck", mode="max")
    assert rebuilt.save("epoch-0004", states[0], {"val_loss": 0.1}, step=4)  # no metric to beat
    with pytest.raises(FileNotFoundError, match="available"):
        rebuilt.restore("epoch-0000")
    up = CheckpointManager(tmp_path / "up", monitor="val_f1", mode="max")
    assert [up.save(t, states[0], {"val_f1": v}, 0) for t, v in
            (("a", 0.2), ("b", 0.1), ("c", 0.3))] == [True, False, True]


def test_cli_train_and_test_on_a_reference_store(tmp_path, monkeypatch, capsys):
    """`cli train` then `cli test` on the CPU, on a store and splits
    written with the reference's GraphStore and layout."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    ref, _ = synthetic(np.random.default_rng(11), 40)
    jcfg, tcfg = _cfgs(optim={"name": "adamw", "learning_rate": 1e-2})
    out = tmp_path / "processed" / "bigvul"
    JStore(out / cli.graphs_dirname(tcfg)).write(ref)
    splits = {str(g.graph_id): ("train", "train", "val", "test")[g.graph_id % 4] for g in ref}
    (out / "splits.json").write_text(json.dumps(splits))
    cfg_path = tmp_path / "cfg.json"
    d = json.loads(json.dumps(CFG))
    d["train"]["optim"] = {"name": "adamw", "learning_rate": 1e-2}
    cfg_path.write_text(json.dumps(d))

    cli.main(["train", "--config", str(cfg_path), "--device", "cpu", "train.log_every_steps=1"])
    assert "best:" in capsys.readouterr().out
    run = tmp_path / "runs" / "port-train"
    records = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and "val_loss" in r for r in epochs)
    assert any("step" in r for r in records)
    manifest = json.loads((run / cli.CHECKPOINTS_DIR / "manifest.json").read_text())
    assert manifest["best"] is not None and len(manifest["history"]) == 2
    saved = tconfig.load(run / "config.json")
    assert saved.train.log_every_steps == 1 and saved.model.hidden_dim == 8

    cli.main(["test", "--device", "cpu", "--export", "run_name=port-train"])
    text = capsys.readouterr().out
    assert "confusion matrix" in text and "exported 10 predictions" in text
    metrics = json.loads((run / "test_metrics_test.json").read_text())
    assert 0.0 <= metrics["acc"] <= 1.0 and np.isfinite(metrics["loss"])
    rows = list(csv.reader((run / "predictions_test.csv").open()))
    assert rows[0] == ["id", "prob", "label"] and len(rows) == 11
    assert sorted(int(r[0]) for r in rows[1:]) == [g.graph_id for g in ref if g.graph_id % 4 == 3]
