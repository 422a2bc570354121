"""The port's whole-unroll GGNN (`unroll="fused"`,
deepdfa_tpu_torch/nn/ggnn_kernel.py: `ggnn_fused`, `GgnnUnroll`,
`resolve_unroll`) on the CPU, against its per-step path and the
reference.

- On the CPU `ggnn_fused` runs its plain version, the per-step plain
  loop, so the fused unroll is bit-equal to the per-step one, forward
  and every gradient leaf, under each policy, across the serve ladder
  (1, 2, 4, the all-padding batch, a single-node graph) and n_etypes 1
  and 3 (the reference's own contract, tests/test_ggnn_kernel.py);
- against the reference's fused kernel (`_fused_kernel_interp`, fold
  scatter), five steps: fp32 forward at rtol = atol = 1e-5 and each
  gradient leaf within 1e-5 of its scale (reassociation only); bf16 and
  int8 forward within tests/test_torch_ggnn_policy.py's five-step rule
  (5e-3 of scale, 99% of the elements within 1e-4: a rounding can flip
  between the packages);
- the admission rule re-derived for the card: the flagship fits the
  H100's 50 MB L2 (16.8 MB, 21.1 MB under int8) where the reference's
  16 MiB VMEM budget refused it; `scan_steps` falls back as in the
  reference; a fallback warns and is counted;
- serving and `cli train` under the knobs.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py
holds it against kernel 1 there, bit for bit.
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as JSpec, GraphStore as JStore  # noqa: E402
from deepdfa_tpu.nn import ggnn_kernel as jgk  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as tgk  # noqa: E402
from deepdfa_tpu_torch.serve import score_graphs  # noqa: E402

from test_torch_ggnn_policy import (  # noqa: E402
    CLOSE_SHARE, CLOSE_TOL, NODE_BUDGET, STEPS_TOL, WEIGHTS, _ladder, _ref_propagate,
    _scale_err, _weights, port_propagate,
)

REL = 1e-5  # fp32 gradients, of each leaf's scale
N_STEPS = 5
RUNGS = ["1_single_node", "2_graphs", "2_all_padding", "4_graphs"]


def _port_grads(w, feat, g, tb, n_etypes, accum, unroll, n_steps=N_STEPS):
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tf = torch.from_numpy(feat).requires_grad_()
    out = tgk.ggnn_propagate(*(tw[k] for k in WEIGHTS), tf, tb.edge_src, tb.edge_dst,
                             tb.edge_mask, tb.edge_type, n_steps=n_steps, n_etypes=n_etypes,
                             accum=accum, unroll=unroll)
    out.backward(torch.from_numpy(g))
    return out.detach(), {k: tw[k].grad for k in WEIGHTS} | {"feat": tf.grad}, out.grad_fn


@pytest.mark.parametrize("n_etypes", [1, 3])
@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("accum", ["fp32", "bf16", "int8"])
def test_fused_is_bit_equal_to_per_step(accum, rung, n_etypes):
    _, tb = _ladder(rung, n_etypes)
    rng = np.random.default_rng(41 + n_etypes)
    w = _weights(rng, 32, n_etypes)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    g = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    fallbacks = tgk.FUSED_FALLBACKS
    h_s, g_s, fn_s = _port_grads(w, feat, g, tb, n_etypes, accum, "per_step")
    h_f, g_f, fn_f = _port_grads(w, feat, g, tb, n_etypes, accum, "fused")
    assert type(fn_s).__name__ == "GgnnStepBackward"
    assert type(fn_f).__name__ == "GgnnUnrollBackward"
    assert tgk.FUSED_FALLBACKS == fallbacks
    assert torch.equal(h_f, h_s)
    for k in g_s:
        assert torch.equal(g_f[k], g_s[k]), k
    with torch.inference_mode():
        h_inf = port_propagate(w, feat, tb, n_etypes, N_STEPS, accum, "fused")
    np.testing.assert_array_equal(h_inf, h_s.numpy())


def test_fused_plain_returns_the_chain_of_step_inputs():
    _, tb = _ladder("4_graphs", 3)
    rng = np.random.default_rng(2)
    w = {k: torch.from_numpy(v) for k, v in _weights(rng, 32, 3).items()}
    feat = torch.from_numpy(rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32))
    edges = tgk.prepare_edges(tb.edge_src, tb.edge_dst, tb.edge_mask, tb.edge_type,
                              NODE_BUDGET, 3)
    params = [w[k] for k in WEIGHTS]
    for accum in ("fp32", "int8"):
        h, chain = tgk.ggnn_fused(feat, edges, *params, n_steps=3, accum=accum, with_chain=True)
        assert chain.shape == (3, NODE_BUDGET, 32)
        x = feat
        for s in range(3):
            assert torch.equal(chain[s], x)
            x, _ = tgk.ggnn_step(x, edges, *params, accum=accum)
        assert torch.equal(h, x)
        h2, none = tgk.ggnn_fused(feat, edges, *params, n_steps=3, accum=accum)
        assert none is None and torch.equal(h2, h)
    with pytest.raises(ValueError, match="n_steps >= 1"):
        tgk.ggnn_fused(feat, edges, *params, n_steps=0)
    with pytest.raises(ValueError, match="unknown ggnn_kernel accum"):
        tgk.ggnn_fused(feat, edges, *params, n_steps=2, accum="fp16")
    meta = [x.to("meta") for x in params]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgk.ggnn_fused(feat.to("meta"), edges, *meta, n_steps=2)


@pytest.mark.parametrize("n_etypes", [1, 3])
def test_fused_matches_reference_fused(n_etypes):
    """Five steps through the reference's fused kernel (interpret) and
    the port's: fp32 forward and gradients at fp32 tolerance; bf16 and
    int8 forward by the five-step rule."""
    jb, tb = _ladder("4_graphs", n_etypes)
    rng = np.random.default_rng(5 + n_etypes)
    w = _weights(rng, 32, n_etypes)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    g = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    h, got, _ = _port_grads(w, feat, g, tb, n_etypes, "fp32", "fused")
    ref = _ref_propagate(n_etypes, N_STEPS, "fp32", "fused")
    want_h, vjp = jax.vjp(lambda w_, f_: ref(w_, f_, jb), w, feat)
    want_w, want_f = vjp(jnp.asarray(g))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    want = {k: np.asarray(v) for k, v in want_w.items()} | {"feat": np.asarray(want_f)}
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    for k, v in got.items():
        err = float(np.abs(v.numpy() - want[k]).max()) / max(float(np.abs(want[k]).max()), floor)
        assert err <= REL, (k, err)
    for accum in ("bf16", "int8"):
        port = port_propagate(w, feat, tb, n_etypes, N_STEPS, accum, "fused")
        ref_h = np.asarray(_ref_propagate(n_etypes, N_STEPS, accum, "fused")(w, feat, jb))
        assert _scale_err(port, ref_h) <= STEPS_TOL, accum
        assert np.isclose(port, ref_h, rtol=CLOSE_TOL, atol=CLOSE_TOL).mean() >= CLOSE_SHARE


def test_residency_and_admission_rules():
    n, d = 16384, 128  # the flagship batch
    assert tgk.fused_residency_bytes(n, d, "fp32", 5) == 2 * n * d * 4  # 16.8 MB
    assert tgk.fused_residency_bytes(n, d, "bf16", 5) == 2 * n * d * 4
    assert tgk.fused_residency_bytes(n, d, "int8", 5) == 2 * n * d * 4 + 2 * (n * d + 4 * n)
    assert tgk.fused_residency_bytes(n, d, "fp32", 1) == n * d * 4  # no scratch plane
    budget = 50 * 2**20  # the H100's L2
    assert tgk.CPU_BUDGET_BYTES == budget
    assert tgk.fused_budget_bytes(torch.device("cpu")) == budget
    for accum in ("fp32", "bf16", "int8"):
        kw = dict(n=n, d=d, n_steps=5, accum=accum)
        assert tgk.resolve_unroll("fused", scan_steps=False, budget_bytes=budget, **kw) == ("fused", "")
        # the reference's 16 MiB VMEM budget refused the flagship
        mode, why = jgk.resolve_unroll("fused", scan_steps=False, **kw)
        assert mode == "per_step" and "VMEM" in why
        # scan_steps over several steps falls back in both
        for mod, extra in ((tgk, {"budget_bytes": budget}), (jgk, {})):
            mode, why = mod.resolve_unroll("fused", scan_steps=True, **kw, **extra)
            assert mode == "per_step" and "scan_steps" in why
        mode, why = tgk.resolve_unroll("fused", scan_steps=False, budget_bytes=2**20, **kw)
        assert mode == "per_step" and "L2 budget" in why
        assert tgk.resolve_unroll("per_step", scan_steps=True, budget_bytes=0, **kw) == \
            ("per_step", "")
    # one step under scan_steps stays fused in both (nothing to bound)
    small = dict(n=512, d=32, n_steps=1, accum="fp32", scan_steps=True)
    assert tgk.resolve_unroll("fused", budget_bytes=budget, **small)[0] == "fused"
    assert jgk.resolve_unroll("fused", **small)[0] == "fused"
    with pytest.raises(ValueError):
        tgk.resolve_unroll("whole", scan_steps=False, budget_bytes=budget, n=1, d=32,
                           n_steps=1, accum="fp32")


def test_fallback_is_loud_and_counted(monkeypatch, caplog):
    _, tb = _ladder("2_graphs", 1)
    rng = np.random.default_rng(8)
    w = _weights(rng, 32, 1)
    feat = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    g = rng.standard_normal((NODE_BUDGET, 32)).astype(np.float32)
    h_ref, g_ref, _ = _port_grads(w, feat, g, tb, 1, "int8", "per_step")
    monkeypatch.setattr(tgk, "CPU_BUDGET_BYTES", 1024)
    before = tgk.FUSED_FALLBACKS
    with caplog.at_level(logging.WARNING, logger=tgk.__name__):
        h, grads, fn = _port_grads(w, feat, g, tb, 1, "int8", "fused")
    assert tgk.FUSED_FALLBACKS == before + 1
    assert type(fn).__name__ == "GgnnStepBackward"
    assert any("exceeds the L2 budget 1024 B" in r.getMessage() for r in caplog.records)
    assert torch.equal(h, h_ref) and all(torch.equal(grads[k], g_ref[k]) for k in grads)
    monkeypatch.undo()
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    with torch.inference_mode():
        tgk.ggnn_propagate(*(t[k] for k in WEIGHTS), torch.from_numpy(feat), tb.edge_src,
                           tb.edge_dst, tb.edge_mask, None, n_steps=5, unroll="fused",
                           scan_steps=True)
    assert tgk.FUSED_FALLBACKS == before + 2


def test_serving_under_each_variant():
    """score_graphs on the CPU with ggnn_kernel=true under each policy
    and unroll: fused scores are the per-step scores' bits, no fused
    request falls back, and the policies move the scores a little."""
    rng = np.random.default_rng(3)
    specs = []
    for gid in range(12):
        n = int(rng.integers(2, 40))
        e = int(rng.integers(1, 3 * n))
        specs.append(TSpec(graph_id=gid, node_feats=rng.integers(0, 52, (n, 4)).astype(np.int32),
                           node_vuln=np.zeros((n,), np.int32),
                           edge_src=rng.integers(0, n, (e,)).astype(np.int32),
                           edge_dst=rng.integers(0, n, (e,)).astype(np.int32), label=0.0))
    probs = {}
    for accum in ("fp32", "bf16", "int8"):
        for unroll in ("per_step", "fused"):
            cfg = tconfig.apply_overrides(tconfig.Config(), [
                "model.ggnn_kernel=true", f'model.ggnn_kernel_accum="{accum}"',
                f'model.ggnn_kernel_unroll="{unroll}"', "serve.max_batch_graphs=4",
                "serve.node_budget=512", "serve.edge_budget=2048"])
            model = DeepDFA.from_config(cfg.model, 52, hidden_dim=8, n_steps=3,
                                        generator=torch.Generator().manual_seed(0))
            assert (model.ggnn.use_kernel, model.ggnn.accum, model.ggnn.unroll) == \
                (True, accum, unroll)
            summary = score_graphs(model, specs, cfg, device="cpu")
            assert summary["serve_scored"] == len(specs)
            assert summary["ggnn_fused_fallbacks"] == 0
            assert summary["ggnn_fused_launches"] == summary["ggnn_step_launches"] == 0  # CPU
            probs[accum, unroll] = np.asarray(summary["probs"])
    for accum in ("fp32", "bf16", "int8"):
        np.testing.assert_array_equal(probs[accum, "fused"], probs[accum, "per_step"])
    for accum in ("bf16", "int8"):
        drift = np.abs(probs[accum, "per_step"] - probs["fp32", "per_step"]).max()
        assert 0.0 < drift <= 5e-2, (accum, drift)


def test_combined_encoders_keep_fp32_per_step():
    """The combined families build their graph encoder without the
    knobs, as the reference's make_graph_encoder_for does."""
    from deepdfa_tpu_torch.models.combined import CombinedConfig, CombinedModel
    from deepdfa_tpu_torch.models.transformer import TransformerConfig

    model = CombinedModel(CombinedConfig(encoder=TransformerConfig.tiny(vocab_size=64)))
    conv = model.graph.ggnn
    assert (conv.use_kernel, conv.accum, conv.unroll) == (False, "fp32", "per_step")


def _store(tmp_path, n_graphs=32):
    rng = np.random.default_rng(11)
    ref = []
    for gid in range(n_graphs):
        n = int(rng.integers(4, 16))
        feats = rng.integers(2, 20, (n, 4)).astype(np.int32)
        vuln = np.zeros((n,), np.int32)
        if gid % 2 == 0:
            feats[0, 0], vuln[0] = 7, 1
        src = np.arange(n - 1, dtype=np.int32)
        ref.append(JSpec(graph_id=gid, node_feats=feats, node_vuln=vuln, edge_src=src,
                         edge_dst=src + 1, label=float(vuln.max())))
    cfg = {"run_name": "fused-train",
           "data": {"feat": {"limit_all": 18, "limit_subkeys": 18},
                    "batch": {"graphs_per_batch": 8, "node_budget": 256, "edge_budget": 1024}},
           "model": {"hidden_dim": 8, "n_steps": 3},
           "train": {"optim": {"name": "adamw", "learning_rate": 1e-2}, "mesh": {"dp": 1},
                     "seed": 3, "max_epochs": 2, "checkpoint_every_epochs": 1}}
    out = tmp_path / "processed" / "bigvul"
    JStore(out / cli.graphs_dirname(tconfig.from_dict(cfg))).write(ref)
    splits = {str(g.graph_id): ("train", "train", "val", "test")[g.graph_id % 4] for g in ref}
    (out / "splits.json").write_text(json.dumps(splits))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    jconfig.from_dict(cfg)  # the reference reads the same file
    return path


def test_cli_train_under_the_knobs_matches_per_step(tmp_path, monkeypatch, capsys):
    """`cli train` with the reference's kernel knobs trains; the fused
    int8 run logs the per-step int8 run's losses bit for bit."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    path = _store(tmp_path)
    losses = {}
    for unroll in ("per_step", "fused"):
        run = f"train-{unroll}"
        cli.main(["train", "--config", str(path), "--device", "cpu", "model.ggnn_kernel=true",
                  'model.ggnn_kernel_accum="int8"', f'model.ggnn_kernel_unroll="{unroll}"',
                  f'run_name="{run}"'])
        assert "best:" in capsys.readouterr().out
        saved = tconfig.load(tmp_path / "runs" / run / "config.json")
        assert (saved.model.ggnn_kernel, saved.model.ggnn_kernel_accum,
                saved.model.ggnn_kernel_unroll) == (True, "int8", unroll)
        log = (tmp_path / "runs" / run / "train_log.jsonl").read_text().splitlines()
        losses[unroll] = [json.loads(x)["train_loss"] for x in log if "epoch" in json.loads(x)]
    assert len(losses["fused"]) == 2 and all(np.isfinite(losses["fused"]))
    assert losses["fused"] == losses["per_step"]
