"""The port's int8 serving (deepdfa_tpu_torch/serve/quant.py) against the
reference's `deepdfa_tpu/serve/quant.py` on the CPU.

- `quantize_params` over a port state dict equals the reference's
  `quantize_params` over the same weights moved into the port's layout
  by `models/convert.py`, exactly: int8 values, scales (broadcast to the
  tensor) and bf16 tensors, for the GGNN (one and three edge types) and
  both combined families (RoBERTa and T5 encoders with a graph branch);
- `dequantize_params`, `quant_report`, the calibration batches and
  `max_prob_drift` equal the reference's (the drift within fp32
  tolerance: the two models reassociate);
- `QuantizedModel` runs the module on the dequantized weights, bit for
  bit, through `forward` and `run`;
- the registry serves `tag@int8` for the combined and t5 families and as
  a cascade's stage 2, and refuses an entry past a tiny drift bound.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.models import combined as jcmb  # noqa: E402
from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.models import transformer as jtfm  # noqa: E402
from deepdfa_tpu.serve import quant as ref_quant  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    CombinedConfig,
    CombinedModel,
    DeepDFA,
    DefectConfig,
    DefectModel,
    T5Config,
    TransformerConfig,
    convert,
)
from deepdfa_tpu_torch.serve import quant  # noqa: E402

INPUT_DIM = 1002


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _family(name):
    """(reference params, converter, port model, num_heads) of a tiny
    model of each family."""
    if name.startswith("ggnn"):
        n_etypes = int(name[-1])
        jm = JDeepDFA(input_dim=INPUT_DIM, hidden_dim=16, n_steps=2, n_etypes=n_etypes)
        batch = ref_quant.calibration_graph_batch(3, 256, 1024, 4, INPUT_DIM,
                                                  etypes=n_etypes > 1, n_etypes=n_etypes)
        params = _np(jm.init(jax.random.key(0), batch))
        model = DeepDFA(INPUT_DIM, 16, 2, n_etypes=n_etypes)
        model.load_state_dict(convert.from_jax_params(params))
        return params, convert.from_jax_params, model.eval(), None
    if name == "combined":
        enc = dict(vocab_size=256, max_position_embeddings=68, num_layers=2, num_heads=4,
                   hidden_size=64, intermediate_size=128)
        kw = dict(graph_hidden_dim=16, graph_input_dim=INPUT_DIM)
        params = _np(jcmb.init_params(jcmb.CombinedConfig(
            encoder=jtfm.TransformerConfig.tiny(**enc), **kw), jax.random.key(3)))
        model = CombinedModel(CombinedConfig(encoder=TransformerConfig.tiny(**enc), **kw))
        model.load_state_dict(convert.from_jax_combined_params(params))
        return params, convert.from_jax_combined_params, model.eval(), 4
    kw = dict(graph_hidden_dim=16, graph_input_dim=INPUT_DIM)
    params = _np(jt5.init_defect_params(jt5.DefectConfig(
        encoder=jt5.T5Config.tiny(vocab_size=256), **kw), jax.random.key(1)))
    model = DefectModel(DefectConfig(encoder=T5Config.tiny(vocab_size=256), **kw))
    model.load_state_dict(convert.from_jax_defect_params(params))
    return params, convert.from_jax_defect_params, model.eval(), None


FAMILIES = ["ggnn1", "ggnn3", "combined", "t5"]


def _map(tree, fn):
    """fn(leaf, quantized?) over the reference's quantized tree."""
    if ref_quant.is_quantized_leaf(tree):
        return fn(tree, True)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree, False)


def _converted_reference(name):
    """The reference's quantized tree moved into the port's layout: its
    int8 values, its scales broadcast over each leaf, its bf16 leaves and
    a 1/0 mask of which port elements come from a quantized leaf."""
    params, conv, _, _ = _family(name)
    qtree = ref_quant.quantize_params(params)
    zeros = lambda leaf: np.zeros(np.shape(leaf["int8"] if isinstance(leaf, dict) else leaf),  # noqa: E731
                                  np.float32)
    views = {
        "int8": lambda leaf, q: np.asarray(leaf["int8"], np.float32) if q else zeros(leaf),
        "scale": lambda leaf, q: (np.broadcast_to(np.asarray(leaf["scale"]), leaf["int8"].shape)
                                  .astype(np.float32) if q else zeros(leaf)),
        "bf16": lambda leaf, q: zeros(leaf) if q else np.asarray(leaf, np.float32),
        "mask": lambda leaf, q: zeros(leaf) + 1 if q else zeros(leaf),
    }
    return qtree, {k: conv(_map(qtree, fn)) for k, fn in views.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_quantize_params_is_the_reference_through_convert(name):
    params, conv, model, heads = _family(name)
    _, want = _converted_reference(name)
    got = quant.quantize_params(model.state_dict(), num_heads=heads)
    assert set(got) == set(model.state_dict())
    n_int8 = 0
    for k, v in got.items():
        if quant.is_quantized_leaf(v):
            n_int8 += 1
            assert want["mask"][k].min() == 1, k
            assert v["int8"].dtype == torch.int8 and v["scale"].dtype == torch.float32
            assert torch.equal(v["int8"].float(), want["int8"][k]), k
            assert torch.equal(torch.broadcast_to(v["scale"], v["int8"].shape),
                               want["scale"][k]), k
        else:
            assert want["mask"][k].max() == 0, k
            assert v.dtype == torch.bfloat16 and torch.equal(v.float(), want["bf16"][k]), k
    assert n_int8 >= 6


@pytest.mark.parametrize("name", FAMILIES)
def test_dequantize_and_report_are_the_reference(name):
    params, conv, model, heads = _family(name)
    ref_q, _ = _converted_reference(name)
    sd = model.state_dict()
    got = quant.quantize_params(sd, num_heads=heads)
    deq = quant.dequantize_params(got)
    want = conv(_np(ref_quant.dequantize_params(ref_q)))
    assert set(deq) == set(want)
    for k in deq:
        assert deq[k].dtype == torch.float32 and torch.equal(deq[k], want[k]), k
    report, ref_report = quant.quant_report(sd, got), ref_quant.quant_report(params, ref_q)
    assert report.bytes_fp32 == ref_report.bytes_fp32
    # the port's scales are broadcast over fused and per-layer tensors
    # (a few more fp32 words than the reference's stacked leaves hold)
    assert abs(report.bytes_fraction - ref_report.bytes_fraction) < 0.02
    assert max(report.path_errors.values()) == max(ref_report.path_errors.values())
    assert report.worst_paths()[0] in report.path_errors


def test_quantize_leaf_and_tags_are_the_reference():
    rng = np.random.default_rng(0)
    for shape in [(7, 5), (3, 4, 6), (1, 9)]:
        w = rng.normal(size=shape).astype(np.float32)
        w[..., 0] = 0.0  # an all-zero channel takes scale 1
        got, want = quant.quantize_leaf(w), ref_quant.quantize_leaf(w)
        assert np.array_equal(got["int8"], want["int8"]) and got["int8"].dtype == np.int8
        assert np.array_equal(got["scale"], want["scale"]) and got["scale"][0] == 1.0
    for tag in ("best", "best@int8", "epoch-0003@int8", "last"):
        assert quant.split_checkpoint_tag(tag) == ref_quant.split_checkpoint_tag(tag)
    with pytest.raises(ValueError, match="num_heads"):
        quant.quantize_params(_family("combined")[2].state_dict())
    with pytest.raises(KeyError, match="no quantization rule"):
        quant.quantize_params({"mystery.weight": torch.zeros(2, 2)})


def test_calibration_batches_are_the_reference():
    for etypes in (False, True):
        got = quant.calibration_graph_batch(5, 512, 2048, 4, INPUT_DIM, etypes=etypes, n_etypes=3)
        want = ref_quant.calibration_graph_batch(5, 512, 2048, 4, INPUT_DIM, etypes=etypes,
                                                 n_etypes=3)
        for f in ("node_feats", "node_graph", "node_mask", "edge_src", "edge_dst", "edge_mask",
                  "graph_label", "graph_mask", "edge_type"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, np.asarray(b)))
    got = quant.calibration_text_batch(4, 16, 256, 1, 512, 2048)
    want = ref_quant.calibration_text_batch(4, 16, 256, 1, 512, 2048)
    assert np.array_equal(got.input_ids, np.asarray(want.input_ids))
    assert np.array_equal(got.has_graph, np.asarray(want.has_graph))


def _ggnn_scores(name):
    params, _, model, _ = _family(name)
    batch = quant.calibration_graph_batch(8, 1024, 4096, 4, INPUT_DIM,
                                          etypes=name == "ggnn3", n_etypes=3)
    jm = JDeepDFA(input_dim=INPUT_DIM, hidden_dim=16, n_steps=2,
                  n_etypes=3 if name == "ggnn3" else 1)
    ref_batch = ref_quant.calibration_graph_batch(8, 1024, 4096, 4, INPUT_DIM,
                                                  etypes=name == "ggnn3", n_etypes=3)
    ref_fn = lambda p, b: jax.nn.sigmoid(jm.apply(p, b))  # noqa: E731

    def port_fn(sd, b):
        return torch.sigmoid(torch.func.functional_call(model, sd, (b.to("cpu"),)))

    return params, model, batch, ref_batch, ref_fn, port_fn


@pytest.mark.parametrize("name", ["ggnn1", "ggnn3"])
def test_max_prob_drift_is_the_reference(name):
    params, model, batch, ref_batch, ref_fn, port_fn = _ggnn_scores(name)
    sd = model.state_dict()
    qtree = quant.quantize_params(sd)
    ref_q = ref_quant.quantize_params(params)
    want = ref_quant.max_prob_drift(ref_fn, params, ref_q, [ref_batch])
    got = quant.max_prob_drift(port_fn, sd, qtree, [batch])
    assert want > 0 and abs(got - want) <= 1e-5
    assert quant.check_drift(port_fn, sd, qtree, [batch], 5e-2) == got
    with pytest.raises(quant.QuantizationError, match="quant_drift_bound") as err:
        quant.check_drift(port_fn, sd, qtree, [batch], 1e-12)
    assert err.value.worst_paths and err.value.drift == got


def test_quantized_model_runs_the_dequantized_weights():
    from deepdfa_tpu_torch.eval.localize import ggnn_score_fn

    _, model, batch, _, _, _ = _ggnn_scores("ggnn3")
    qtree = quant.quantize_params(model.state_dict())
    deq = quant.dequantize_params(qtree)
    reference = DeepDFA(INPUT_DIM, 16, 2, n_etypes=3).eval()
    reference.load_state_dict(deq)
    b = batch.to("cpu")
    served = quant.QuantizedModel(DeepDFA(INPUT_DIM, 16, 2, n_etypes=3), qtree)
    assert all(p.is_meta for p in served.skeleton.parameters())
    with torch.inference_mode():
        assert torch.equal(served(b), reference(b))
    got = quant.run_served(served, lambda m, x: ggnn_score_fn("saliency", m, 2)(x), b)
    want = ggnn_score_fn("saliency", reference, 2)(b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def stage2_run(tmp_path_factory):
    """A smoke GGNN run with combined and t5 stage-2 checkpoints beside it
    (two run dirs) under a storage root of this module's."""
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.core import paths
    from deepdfa_tpu_torch.serve.cascade import build_stage2_smoke
    from deepdfa_tpu_torch.serve.driver import build_smoke_run

    saved = os.environ.get("DEEPDFA_TPU_STORAGE")
    os.environ["DEEPDFA_TPU_STORAGE"] = str(tmp_path_factory.mktemp("storage"))
    try:
        cfg, run_dir, src = build_smoke_run(n_examples=12, max_epochs=1, device="cpu")
        runs = {}
        for family in ("combined", "t5"):
            fam_cfg = config_mod.apply_overrides(cfg, [f'run_name="{family}-stage2"'])
            fam_dir = paths.runs_dir(f"{family}-stage2")
            config_mod.to_json(fam_cfg, fam_dir / "config.json")
            build_stage2_smoke(fam_dir, fam_cfg, family=family, use_graph=True)
            runs[family] = (fam_cfg, fam_dir)
        yield cfg, run_dir, src, runs
    finally:
        if saved is None:
            os.environ.pop("DEEPDFA_TPU_STORAGE", None)
        else:
            os.environ["DEEPDFA_TPU_STORAGE"] = saved


@pytest.mark.parametrize("family", ["combined", "t5"])
def test_registry_serves_int8_for_the_combined_families(stage2_run, family):
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.serve.registry import ModelRegistry, RegistryError
    from deepdfa_tpu_torch.serve.server import ScoringService, score_texts

    _, _, src, runs = stage2_run
    cfg, run_dir = runs[family]
    codes = [(p.name, p.read_text()) for p in sorted(src.glob("*.c"))[:6]]
    plain = ScoringService(ModelRegistry(run_dir, family=family, cfg=cfg, device="cpu"), cfg)
    q = ScoringService(ModelRegistry(run_dir, family=family, checkpoint="best@int8", cfg=cfg,
                                     device="cpu"), cfg)
    try:
        info = q.registry.info()
        assert info["quantized"] == "int8" and 0 < info["quant_drift"] <= 5e-2
        assert 0.25 < info["quant_param_bytes_fraction"] < 0.5
        got = [r["prob"] for r in score_texts(q, codes)]
        want = [r["prob"] for r in score_texts(plain, codes)]
        np.testing.assert_allclose(got, want, atol=5e-2)
    finally:
        plain.close()
        q.close()
    tight = config_mod.apply_overrides(cfg, ["serve.quant_drift_bound=1e-12"])
    with pytest.raises(RegistryError, match="refused"):
        ModelRegistry(run_dir, family=family, checkpoint="best@int8", cfg=tight, device="cpu")


def test_cascade_stage2_serves_int8(stage2_run):
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.serve.cascade import CascadeStage2

    cfg, run_dir, src, runs = stage2_run
    _, s2_dir = runs["combined"]
    casc_cfg = config_mod.apply_overrides(cfg, [
        "serve.cascade=true", f'serve.cascade_run_dir="{s2_dir}"',
        'serve.cascade_family="combined"', 'serve.cascade_checkpoint="best@int8"',
        "serve.cascade_band=[0.0, 1.0]"])
    stage2 = CascadeStage2.from_config(casc_cfg, run_dir, device="cpu")
    stage2.start()
    try:
        assert stage2.service.registry.info()["quantized"] == "int8"
        code = sorted(src.glob("*.c"))[0].read_text()
        prob, info, _ = stage2.decide(code, 0.5, request_id="r0")
        assert info["stage"] == 2 and 0.0 <= prob <= 1.0
    finally:
        stage2.close()


def test_score_summary_reports_the_quantized_entries(stage2_run):
    """`run_score` (the `cli score` drive) of an `@int8` GGNN entry, with
    a quantized cascade stage 2: the summary's `quant` and the cascade's
    `stage2_quant` carry the registries' drift, bound and bytes fraction."""
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.serve.driver import QUANT_KEYS, run_score

    cfg, run_dir, src, runs = stage2_run
    _, s2_dir = runs["combined"]
    casc_cfg = config_mod.apply_overrides(cfg, [
        'serve.checkpoint="best@int8"', "serve.cascade=true",
        f'serve.cascade_run_dir="{s2_dir}"', 'serve.cascade_family="combined"',
        'serve.cascade_checkpoint="best@int8"', "serve.cascade_band=[0.0, 1.0]"])
    sources = [(p.name, p.read_text()) for p in sorted(src.glob("*.c"))[:4]]
    summary = run_score(casc_cfg, run_dir, sources, out_path=run_dir / "int8.jsonl",
                        device="cpu")
    assert summary["serve_scored"] == 4
    for q in (summary["quant"], summary["cascade"]["stage2_quant"]):
        assert set(q) == set(QUANT_KEYS) and q["quantized"] == "int8"
        assert 0 <= q["quant_drift"] <= q["quant_drift_bound"] == 5e-2
    assert summary["cascade"]["stage2_rows"] == 4
