"""Scoring C sources through the port (deepdfa_tpu_torch/serve/frontend.py,
registry.py, cascade.py, server.py:score_texts) against the reference, on
the CPU.

- the request frontend gives exactly the reference's
  `RequestPreprocessor.features` (same arrays, same dtypes) on seeded
  synthetic functions and the same vocabularies, and the model-facing
  arrays of the GraphSpec the port's `extract` wrote for each function
  (a request carries no line labels, so its label and node_vuln are 0);
  cache keys are the reference's, a hit skips extraction, a failure is
  cached;
- `score_texts` over a registry restored from a port checkpoint holds
  the reference's `DeepDFA.apply` + sigmoid on the same features, with
  the reference's Flax init carried across by `from_jax_params`, at
  fp32 rtol 1e-5 / atol 1e-6, whatever order the functions arrive in;
- the registry names drifted config keys on a shape mismatch, refuses a
  run that holds only the reference's orbax checkpoints, hot-swaps a
  new `best` between batches, discards a reload that another swap
  overtook, and the `model_cfg.json` manifest round-trips through both
  packages' `load_model_setup`.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.core import config as ref_config  # noqa: E402
from deepdfa_tpu.data import pipeline as ref_pipeline  # noqa: E402
from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.graphs import pack as ref_pack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as RefDeepDFA  # noqa: E402
from deepdfa_tpu.serve import cascade as ref_cascade  # noqa: E402
from deepdfa_tpu.serve import frontend as ref_frontend  # noqa: E402

from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.data import pipeline, synthetic  # noqa: E402
from deepdfa_tpu_torch.models import from_jax_params  # noqa: E402
from deepdfa_tpu_torch.serve import cascade, frontend  # noqa: E402
from deepdfa_tpu_torch.serve.batcher import DynamicBatcher, GgnnExecutor  # noqa: E402
from deepdfa_tpu_torch.serve.registry import ModelRegistry, RegistryError  # noqa: E402
from deepdfa_tpu_torch.serve.server import ScoringService, score_texts  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

N_FUNCTIONS = 64
RTOL, ATOL = 1e-5, 1e-6  # fp32, cross-framework reassociation
OVERRIDES = ['data.feat={"limit_all": 50, "limit_subkeys": 50}', "model.hidden_dim=8",
             "model.n_steps=3", 'data.dataset="src"', 'run_name="src"',
             "serve.max_batch_graphs=4", "serve.node_budget=2048", "serve.edge_budget=8192"]
UNPARSEABLE = ["not a function @@@", "", "}}}} ;;", "int x;", "#include <x.h>"]
SPEC_ARRAYS = ("node_feats", "edge_src", "edge_dst")


def _functions(mod):
    sizes = mod.bigvul_stmt_sizes(N_FUNCTIONS, seed=5)
    return mod.to_examples(mod.generate(N_FUNCTIONS, seed=5, stmt_sizes=sizes, vuln_rate=0.3))


@pytest.fixture(scope="module")
def corpus():
    """(port examples, port specs, port vocabs, reference vocabs): the
    same functions through each package's `build_dataset`."""
    examples = _functions(synthetic)
    specs, vocabs = pipeline.build_dataset(examples, train_ids=range(N_FUNCTIONS),
                                           limit_all=50, limit_subkeys=50)
    _, ref_vocabs = ref_pipeline.build_dataset(_functions(ref_synthetic),
                                               train_ids=range(N_FUNCTIONS),
                                               limit_all=50, limit_subkeys=50)
    return examples, specs, vocabs, ref_vocabs


def _cfgs(extra=()):
    return (config_mod.apply_overrides(config_mod.Config(), OVERRIDES + list(extra)),
            ref_config.apply_overrides(ref_config.Config(), OVERRIDES + list(extra)))


def _assert_same_arrays(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (f, a, b)
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("gtype", ["cfg", "cfg+dep"])
def test_frontend_features_equal_the_reference(corpus, gtype):
    examples, _, vocabs, ref_vocabs = corpus
    extra = [f'data.gtype="{gtype}"', f"model.n_etypes={3 if gtype == 'cfg+dep' else 1}"]
    cfg, ref_cfg = _cfgs(extra)
    port = frontend.RequestPreprocessor(cfg, vocabs)
    ref = ref_frontend.RequestPreprocessor(ref_cfg, ref_vocabs)
    for e in examples:
        got = port.features_full(e.code, request_id=e.id)
        want = ref.features_full(e.code, request_id=e.id)
        _assert_same_arrays(got.spec, want.spec, SPEC_ARRAYS + ("node_vuln", "edge_type"))
        assert got.spec.graph_id == want.spec.graph_id and got.spec.label == want.spec.label
        assert got.node_lines.dtype == want.node_lines.dtype
        assert np.array_equal(got.node_lines, want.node_lines)
        assert port.content_key(e.code) == ref.content_key(e.code)
    for text in UNPARSEABLE:
        with pytest.raises(ref_frontend.FrontendError):
            ref.features(text)
        with pytest.raises(frontend.FrontendError):
            port.features(text)
    assert port.failures == len(UNPARSEABLE)
    assert port.extractions == N_FUNCTIONS + len(UNPARSEABLE)


def test_frontend_features_equal_what_extract_wrote(corpus):
    examples, specs, vocabs, _ = corpus
    port = frontend.RequestPreprocessor(_cfgs()[0], vocabs)
    by_id = {s.graph_id: s for s in specs}
    assert len(by_id) == N_FUNCTIONS
    for e in examples:
        got = port.features(e.code, request_id=e.id)
        _assert_same_arrays(got, by_id[e.id], SPEC_ARRAYS + ("edge_type",))
        assert got.graph_id == e.id and got.label == 0.0 and not got.node_vuln.any()


def test_cache_keys_hits_and_cached_failures(corpus, monkeypatch):
    examples, _, vocabs, ref_vocabs = corpus
    cfg, ref_cfg = _cfgs()
    cache = frontend.FeatureCache(8)
    port = frontend.RequestPreprocessor(cfg, vocabs, cache=cache)
    ref = ref_frontend.RequestPreprocessor(ref_cfg, ref_vocabs)
    code = examples[0].code
    assert port.content_key(code) == ref.content_key(code)
    calls = []
    extract = port._extract
    monkeypatch.setattr(port, "_extract", lambda c, r: calls.append(c) or extract(c, r))
    first = port.features_full(code)
    assert port.features_full(code) is first  # a hit: no second extraction
    assert calls == [code] and (cache.hits, cache.misses) == (1, 1)
    for _ in range(2):
        with pytest.raises(frontend.FrontendError):
            port.features(UNPARSEABLE[0])
    assert calls == [code, UNPARSEABLE[0]] and port.failures == 2  # the failure was cached
    # another vocabulary is another key
    other = {k: dataclasses.replace(v, hash_index={**v.hash_index, "not-a-hash": 0})
             for k, v in vocabs.items()}
    assert frontend.RequestPreprocessor(cfg, other).content_key(code) != port.content_key(code)
    # the LRU keeps its bound; the shared store only grows
    for e in examples[:12]:
        port.features(e.code)
    assert len(cache) == 8
    shared = frontend.shared_cache(4)
    assert frontend.shared_cache(2) is shared and shared.max_entries >= 4
    frontend.shared_cache(shared.max_entries + 1)
    assert shared.max_entries >= 5


# -- a run of the port's, from the reference's init ----------------------------


def _reference_model(ref_cfg, seed=2):
    model = RefDeepDFA.from_config(ref_cfg.model, input_dim=ref_cfg.data.feat.input_dim)
    params = model.init(jax.random.key(seed), ref_pack([], 1, 64, 256))
    return model, jax.tree.map(np.asarray, params)


def _write_run(root, cfg, vocabs, state, step=1, val_loss=1.0, tag=None):
    """config.json, the vocabulary and a checkpoints-torch/ save, as the
    port's `extract` and `train` leave them under storage root `root`."""
    from deepdfa_tpu_torch.core import paths

    run_dir = paths.runs_dir(cfg.run_name)
    config_mod.to_json(cfg, run_dir / "config.json")
    (paths.processed_dir(cfg.data.dataset) / f"vocab{cfg.data.feat.name}.json").write_text(
        json.dumps({k: v.to_json() for k, v in vocabs.items()}))
    CheckpointManager(run_dir / "checkpoints-torch").save(
        tag or f"epoch-{step:04d}", {"model": state}, {"val_loss": val_loss}, step=step)
    return run_dir


@pytest.fixture()
def run(tmp_path, monkeypatch, corpus):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    _, _, vocabs, _ = corpus
    cfg, ref_cfg = _cfgs()
    ref_model, params = _reference_model(ref_cfg)
    run_dir = _write_run(tmp_path, cfg, vocabs, from_jax_params(params))
    return cfg, run_dir, ref_model, params


def test_scores_from_source_equal_the_reference_model(run, corpus):
    cfg, run_dir, ref_model, params = run
    examples, _, _, ref_vocabs = corpus
    ref = ref_frontend.RequestPreprocessor(_cfgs()[1], ref_vocabs)
    apply = jax.jit(ref_model.apply)
    want = {}
    for e in examples:
        logits = apply(params, ref_pack([ref.features(e.code, e.id)], 1, 2048, 8192))
        want[e.code] = float(jax.nn.sigmoid(logits)[0])
    registry = ModelRegistry(run_dir, cfg=cfg, device="cpu")
    assert registry.info()["checkpoint_step"] == 1
    service = ScoringService(registry, cfg)
    try:
        texts = [(f"fn{e.id}.c", e.code) for e in examples]
        texts += [(f"bad{i}.c", t) for i, t in enumerate(UNPARSEABLE)]
        rng = np.random.default_rng(0)
        for order in [np.arange(len(texts))] + [rng.permutation(len(texts)) for _ in range(2)]:
            sel = [texts[i] for i in order]
            rows = score_texts(service, sel)
            assert [r["name"] for r in rows] == [n for n, _ in sel]
            for (name, code), row in zip(sel, rows):
                if name.startswith("bad"):
                    assert row["ok"] is False and "error" in row
                else:
                    assert row["ok"] is True
                    np.testing.assert_allclose(row["prob"], want[code], rtol=RTOL, atol=ATOL)
        assert service.batcher.batches_run >= 3 * N_FUNCTIONS // 4
    finally:
        service.close()


# -- the registry ------------------------------------------------------------------


def test_registry_names_the_drifted_config_keys(run):
    cfg, run_dir, _, _ = run
    wide = config_mod.apply_overrides(cfg, ["model.hidden_dim=16"])
    with pytest.raises(RegistryError, match=r"model\.hidden_dim"):
        ModelRegistry(run_dir, cfg=wide, device="cpu")


def test_registry_refuses_a_run_with_only_orbax_checkpoints(run, tmp_path):
    cfg, run_dir, _, _ = run
    (run_dir / "checkpoints-torch").rename(run_dir / "checkpoints")
    with pytest.raises(RegistryError, match="orbax"):
        ModelRegistry(run_dir, cfg=cfg, device="cpu")
    with pytest.raises(RegistryError, match="checkpoints-combined-torch"):
        ModelRegistry(run_dir, family="combined", cfg=cfg, model_cfg=object(), device="cpu")


def _bumped(params, by=0.05):
    return {k: v + by if v.is_floating_point() else v for k, v in from_jax_params(params).items()}


def test_registry_hot_swaps_a_new_best_between_batches(run, corpus):
    cfg, run_dir, _, params = run
    _, specs, _, _ = corpus
    registry = ModelRegistry(run_dir, cfg=cfg, device="cpu")
    served = registry.model()
    executor = GgnnExecutor(registry.model, 2048, 8192, 4, device="cpu")
    batcher = DynamicBatcher(executor, on_batch=registry.maybe_reload)
    [r1] = batcher.score_all([specs[0]])
    assert registry.maybe_reload() is False  # nothing moved
    CheckpointManager(run_dir / "checkpoints-torch").save(
        "epoch-0002", {"model": _bumped(params)}, {"val_loss": 0.5}, step=2)
    [r2] = batcher.score_all([specs[0]])
    assert registry.reloads == 1 and registry.info()["checkpoint_step"] == 2
    assert registry.model() is not served and r2.result != r1.result
    # a worse epoch rewrites the manifest but not `best`: the reload
    # restores the same weights
    CheckpointManager(run_dir / "checkpoints-torch").save(
        "epoch-0003", {"model": _bumped(params, 1.0)}, {"val_loss": 0.9}, step=3)
    [r3] = batcher.score_all([specs[0]])
    assert registry.info()["checkpoint_step"] == 2 and r3.result == r2.result


def test_hot_reload_discarded_when_a_swap_lands_mid_restore(run, monkeypatch):
    cfg, run_dir, _, params = run
    registry = ModelRegistry(run_dir, cfg=cfg, device="cpu")
    CheckpointManager(run_dir / "checkpoints-torch").save(
        "epoch-0002", {"model": _bumped(params)}, {"val_loss": 0.5}, step=2)
    restore = registry._restore

    def racing_restore():
        out = restore()
        with registry._lock:
            registry._swap_generation += 1
        return out

    served = registry.model()
    monkeypatch.setattr(registry, "_restore", racing_restore)
    assert registry.maybe_reload() is False  # discarded, not committed
    assert registry.model() is served and registry.reloads == 0
    monkeypatch.setattr(registry, "_restore", restore)
    assert registry.maybe_reload() is True
    assert registry.info()["checkpoint_step"] == 2


def test_hot_swap_refuses_a_changed_config(run, caplog):
    cfg, run_dir, _, params = run
    registry = ModelRegistry(run_dir, cfg=cfg, device="cpu")
    config_mod.to_json(config_mod.apply_overrides(cfg, ["model.n_steps=4"]),
                       run_dir / "config.json")
    CheckpointManager(run_dir / "checkpoints-torch").save(
        "epoch-0002", {"model": _bumped(params)}, {"val_loss": 0.5}, step=2)
    assert registry.maybe_reload() is False
    assert "model.n_steps" in caplog.text and registry.info()["checkpoint_step"] == 1


@pytest.mark.parametrize("family", ["combined", "t5"])
def test_model_cfg_manifest_round_trips_through_both_packages(tmp_path, family):
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import CombinedConfig, DefectConfig, T5Config, TransformerConfig

    t5 = family == "t5"
    if t5:
        mcfg = DefectConfig(encoder=T5Config.tiny(vocab_size=512), graph_hidden_dim=8)
    else:
        mcfg = CombinedConfig(encoder=TransformerConfig.tiny(vocab_size=512),
                              graph_hidden_dim=8, use_graph=False)
    tok = HashTokenizer(512, t5_frame=t5)
    desc = {"kind": "hash", "vocab_size": 512, "t5_frame": t5}
    cascade.save_model_setup(tmp_path, family, mcfg, desc, 48)
    got_tok, got_cfg, got_len = cascade.load_model_setup(tmp_path, family)
    ref_tok, ref_cfg, ref_len = ref_cascade.load_model_setup(tmp_path, family)
    assert got_cfg == mcfg and got_len == ref_len == 48
    want = dataclasses.asdict(mcfg)
    if t5:
        assert want.pop("graph_n_steps") == 5
    assert dataclasses.asdict(ref_cfg) == want
    for t in (got_tok, ref_tok):
        assert (t.vocab_size, t.pad_id, t.sep_id) == (tok.vocab_size, tok.pad_id, tok.sep_id)
    # the reference's own file reads back in the port
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    ref_cascade.save_model_setup(ref_dir, family, ref_cfg, desc, 48)
    assert cascade.load_model_setup(ref_dir, family)[1] == mcfg
    with pytest.raises(ValueError, match="family"):
        cascade.load_model_setup(tmp_path, "t5" if not t5 else "combined")
    # a "bpe" manifest rebuilds the byte-level BPE in both packages
    from deepdfa_tpu_torch.data.tokenizer import BPE_C_DIR, BpeTokenizer, bpe_files

    vocab, merges = bpe_files(BPE_C_DIR)
    doc = json.loads((tmp_path / cascade.MODEL_CFG_MANIFEST).read_text())
    doc["tokenizer"] = {"kind": "bpe", "vocab": str(vocab), "merges": str(merges)}
    (tmp_path / cascade.MODEL_CFG_MANIFEST).write_text(json.dumps(doc))
    bpe = cascade.load_model_setup(tmp_path, family)[0]
    ref_bpe = ref_cascade.load_model_setup(tmp_path, family)[0]
    assert isinstance(bpe, BpeTokenizer)
    assert (bpe.vocab_size, bpe.pad_id, bpe.sep_id) == (ref_bpe.vocab_size, ref_bpe.pad_id,
                                                        ref_bpe.sep_id)
    code = "int f(char *s) {\n  return s[0] + 'a';\n}\n"
    assert np.array_equal(bpe.encode(code, 32), ref_bpe.encode(code, 32))
