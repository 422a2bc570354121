"""The port's structural node features (`frontend/structfeat.py`) and the
struct-feature GGNN against the reference's, on the CPU:

- `struct_features` exactly equal on the reference's own test programs,
  every function of tests/fidelity_corpus/ and seeded token soups, on
  both packages' default (native) frontend;
- `prepare` + `extract` with `data.feat.struct_feats=true` through both
  packages' `main`: the stores equal member for member;
- a struct model's logits at `hidden_dim` 8 (d 72) with the reference's
  weights carried through `convert.from_jax_params`, within 1e-5
  relative, and a 5-step SGD trajectory of the port's `GraphTrainer`
  against the reference's (losses rtol 1e-5, parameters 1e-4 relative
  per leaf, as tests/test_torch_train.py holds the planar model);
- feature dropout sparing the struct columns, the refusal of a batch
  without them, the registry's and executors' pack width, and the
  quantizer's calibration batch staying inside the struct vocabularies.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.cli.main import main as ref_main  # noqa: E402
from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.frontend import parser as ref_parser  # noqa: E402
from deepdfa_tpu.frontend import structfeat as ref_structfeat  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as JSpec, batch as jbatch  # noqa: E402
from deepdfa_tpu.graphs import pack as jpack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.parallel import make_mesh  # noqa: E402
from deepdfa_tpu.train.loop import GraphTrainer as JTrainer  # noqa: E402

from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.frontend import parser, structfeat  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec, batch as tbatch  # noqa: E402
from deepdfa_tpu_torch.graphs import pack as tpack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.serve import quant  # noqa: E402
from deepdfa_tpu_torch.serve.batcher import GgnnExecutor  # noqa: E402
from deepdfa_tpu_torch.train import GraphTrainer, drop_known_feats  # noqa: E402

ROOT = Path(__file__).resolve().parent
CORPUS = {p.name: p.read_text() for p in sorted((ROOT / "fidelity_corpus").glob("*.c*"))}

#: the reference's tests/test_structfeat.py programs, and the guarded-use
#: order family in both forms (channel 4 tells them apart)
PROGRAMS = {
    "branch": "int f(int a) {\n  int b = a + 1;\n  if (b > 0) {\n    b = b - 1;\n  }\n"
              "  return b;\n}",
    "op_classes": "int f(int a) {\n  a = a + 1;\n  if (a > 0) {\n    g(a);\n  }\n  return a;\n}",
    **{f"clamp_order_{'buggy' if v else 'fixed'}": (
        "int f(int len, int total) {\n  char buf[64];\n  int i;\n"
        + "\n".join(ref_synthetic.V2_FAMILIES["index_clamp_order"](v)) + "\n  return total;\n}")
       for v in (True, False)},
}

#: token soups: C-like words inside a function head, seeded
SOUP_WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
              "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n",
              "size_t", "->", "next", "while", "<", "for", "i", "++", "NULL", "&", "ptr",
              "else", ",", "x", "switch", "case", ":", "break", "(int)", "?", "!", "&&")
N_SOUPS = 96


def soup(seed: int) -> str:
    rng = np.random.default_rng(seed)
    lines, line = ["int f(int n, char *buf) {"], []
    for w in rng.choice(SOUP_WORDS, int(rng.integers(6, 60))):
        line.append(str(w))
        if w in (";", "{", "}"):
            lines.append(" ".join(line))
            line = []
    lines.extend([" ".join(line), "}"])
    return "\n".join(lines) + "\n"


def both(code: str):
    """(reference channels, port channels), or None where the reference's
    parser refuses the function (the frontend tests hold both packages'
    refusals equal)."""
    try:
        rcpg = ref_parser.parse_function(code)
    except Exception:
        return None
    cpg = parser.parse_function(code)
    rkeep = [n for n in rcpg.cfg_nodes() if rcpg.nodes[n].line is not None]
    keep = [n for n in cpg.cfg_nodes() if cpg.nodes[n].line is not None]
    assert keep == rkeep
    return ref_structfeat.struct_features(rcpg, rkeep), structfeat.struct_features(cpg, keep)


def test_vocabulary_is_the_references():
    assert structfeat.STRUCT_VOCAB == ref_structfeat.STRUCT_VOCAB
    assert structfeat.NUM_STRUCT_FEATS == ref_structfeat.NUM_STRUCT_FEATS == 5
    assert structfeat.feat_width(True) == 9 and structfeat.feat_width(False) == 4


@pytest.mark.parametrize("name", sorted(PROGRAMS) + sorted(CORPUS))
def test_struct_features_equal_on_programs(name):
    got = both(PROGRAMS.get(name) or CORPUS[name])
    assert got is not None, name
    want, port = got
    assert port.dtype == want.dtype == np.int32
    assert np.array_equal(port, want), name
    for col, vocab in enumerate(structfeat.STRUCT_VOCAB):
        assert port.shape[0] == 0 or (0 <= port[:, col].min() and port[:, col].max() < vocab)


def test_reach_count_separates_the_order_family():
    """Channel 4 at the use statement: 1 reaching definition in the buggy
    order, 2 in the fixed one; the port computes the reference's values."""
    rows = {}
    for v in ("buggy", "fixed"):
        code = PROGRAMS[f"clamp_order_{v}"]
        cpg = parser.parse_function(code)
        keep = [n for n in cpg.cfg_nodes() if cpg.nodes[n].line is not None]
        sf = structfeat.struct_features(cpg, keep)
        rows[v] = next(sf[r] for r, nid in enumerate(keep)
                       if cpg.nodes[nid].code.startswith("total +="))
    assert rows["buggy"][4] == 1 and rows["fixed"][4] == 2


@pytest.mark.parametrize("block", range(4))
def test_struct_features_equal_on_soups(block):
    seen = 0
    for seed in range(block, N_SOUPS, 4):
        got = both(soup(seed))
        if got is None:
            continue
        seen += 1
        assert np.array_equal(got[1], got[0]), seed
    assert seen >= 4  # most soups parse


def test_extract_with_struct_feats_writes_the_references_store(tmp_path, monkeypatch):
    roots = {k: tmp_path / k for k in ("ref", "port")}
    for argv in (["prepare", "--source", "synthetic", "--synthetic-v2", "--n-examples", "40"],
                 ["extract", "data.feat.struct_feats=true"]):
        for name, main in (("ref", ref_main), ("port", cli.main)):
            monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(roots[name]))
            main(argv)
    ref_dir, port_dir = (roots[k] / "processed" / "bigvul" for k in ("ref", "port"))
    dirs = sorted(p.name for p in ref_dir.iterdir() if p.is_dir())
    assert dirs and all(d.endswith("_struct") for d in dirs if d.startswith("graphs"))
    assert sorted(p.name for p in port_dir.iterdir() if p.is_dir()) == dirs
    for d in dirs:
        names = sorted(p.name for p in (ref_dir / d).iterdir())
        assert sorted(p.name for p in (port_dir / d).iterdir()) == names
        for name in names:
            if not name.endswith(".npz"):
                assert (port_dir / d / name).read_text() == (ref_dir / d / name).read_text()
                continue
            with np.load(ref_dir / d / name) as want, np.load(port_dir / d / name) as got:
                assert list(got.files) == list(want.files)
                for k in want.files:
                    assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
                assert want["node_feats"].shape[1] == 9
    for name in sorted(p.name for p in ref_dir.glob("vocab*.json")):
        assert (port_dir / name).read_text() == (ref_dir / name).read_text()


# -- the struct model ----------------------------------------------------------

VOCAB = 20
CFG = {
    "run_name": "port-struct",
    "data": {
        "feat": {"limit_all": VOCAB - 2, "limit_subkeys": VOCAB - 2, "struct_feats": True},
        "batch": {"graphs_per_batch": 8, "node_budget": 256, "edge_budget": 1024},
    },
    "model": {"hidden_dim": 8, "n_steps": 3, "struct_feats": True},
    "train": {"optim": {"name": "sgd", "learning_rate": 0.5}, "mesh": {"dp": 1}, "seed": 3},
}


def _cfgs():
    return jconfig.from_dict(json.loads(json.dumps(CFG))), tconfig.from_dict(CFG)


def struct_graphs(rng, n_graphs=40):
    """Graphs of 4 subkey and 5 struct columns (each in its vocabulary)
    whose label is a struct value, as both packages' specs."""
    ref, port = [], []
    for gid in range(n_graphs):
        n = int(rng.integers(4, 16))
        feats = np.concatenate(
            [rng.integers(2, VOCAB, (n, 4))]
            + [rng.integers(0, v, (n, 1)) for v in structfeat.STRUCT_VOCAB], axis=1
        ).astype(np.int32)
        label = float(gid % 2)
        if label:
            feats[int(rng.integers(0, n)), 8] = 3
        src = np.arange(n - 1, dtype=np.int32)
        extra = rng.integers(0, n, (2, n // 2)).astype(np.int32)
        kw = dict(graph_id=gid, node_feats=feats, node_vuln=np.zeros(n, np.int32),
                  edge_src=np.concatenate([src, extra[0]]),
                  edge_dst=np.concatenate([src + 1, extra[1]]), label=label)
        ref.append(JSpec(**kw))
        port.append(TSpec(**kw))
    return ref, port


def test_struct_model_forward_matches_reference():
    jcfg, tcfg = _cfgs()
    ref, port = struct_graphs(np.random.default_rng(1), 8)
    jb, tb = jpack(ref, 8, 256, 1024), tpack(port, 8, 256, 1024).to("cpu")
    jmodel = JDeepDFA.from_config(jcfg.model, input_dim=VOCAB)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(2), jb))
    assert {f"embed_struct_{j}" for j in range(5)} <= set(params["params"]["embedding"])
    model = DeepDFA.from_config(tcfg.model, VOCAB)
    assert model.embedding.out_dim == 72 and model.out_dim == jmodel.out_dim == 144
    model.load_state_dict(from_jax_params(params))
    want = np.asarray(jmodel.apply(params, jb))
    with torch.no_grad():
        got = model(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _leaf_errors(got, want):
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    return {k: float(np.abs(np.asarray(got[k]) - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


def test_struct_model_trajectory_matches_reference_trainer():
    jcfg, tcfg = _cfgs()
    ref, port = struct_graphs(np.random.default_rng(10))
    jbs = list(jbatch.shard_bucket_batches(ref, 1, 8, 256, 1024))
    tbs = list(tbatch.shard_bucket_batches(port, 8, 256, 1024))
    jtrainer = JTrainer(JDeepDFA.from_config(jcfg.model, input_dim=VOCAB), jcfg,
                        mesh=make_mesh(jcfg.train.mesh, devices=jax.devices()[:1]))
    jstate = jtrainer.init_state(jbs[0])
    trainer = GraphTrainer(DeepDFA.from_config(tcfg.model, VOCAB), tcfg, device="cpu")
    state = trainer.init_state(params=from_jax_params(jax.device_get(jstate.params)))
    jl, tl = [], []
    for i in range(5):
        jstate, loss = jtrainer.train_step(jstate, jbs[i % len(jbs)])
        jl.append(float(loss))
        tl.append(float(trainer.train_step(state, tbs[i % len(tbs)].to(trainer.device))))
    assert len(set(np.round(tl, 4))) > 1  # the model moved
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, jax.device_get(jstate.params)))
    got = {k: v.detach().numpy() for k, v in trainer.model.state_dict().items()}
    errs = _leaf_errors(got, {k: v.numpy() for k, v in want.items()})
    assert max(errs.values()) <= 1e-4, errs
    # the struct tables took gradients
    assert not np.array_equal(got["embedding.embed_struct_4.weight"],
                              from_jax_params(jax.device_get(jtrainer.init_state(jbs[0]).params))
                              ["embedding.embed_struct_4.weight"].numpy())


def test_feat_dropout_spares_struct_columns():
    feats = torch.tensor([[5, 7, 2, 9, 3, 15, 7, 6, 2]] * 32, dtype=torch.int32)
    out = drop_known_feats(feats, torch.Generator().manual_seed(0), 1.0)
    assert (out[:, :4] == 1).all()
    assert torch.equal(out[:, 4:], feats[:, 4:])


def test_struct_model_refuses_a_planar_batch():
    _, tcfg = _cfgs()
    _, port = struct_graphs(np.random.default_rng(5), 4)
    planar = [TSpec(**{**s.__dict__, "node_feats": s.node_feats[:, :4]}) for s in port]
    model = DeepDFA.from_config(tcfg.model, VOCAB)
    with pytest.raises(ValueError, match="struct_feats=True"):
        model(tpack(planar, 4, 256, 1024).to("cpu"))


def test_serving_packs_the_struct_columns():
    """The executor packs at the struct width and scores a struct model
    (on the CPU, its plain path); the quantizer's calibration batch stays
    inside every struct vocabulary and keeps the reference's subkey
    columns."""
    _, tcfg = _cfgs()
    _, port = struct_graphs(np.random.default_rng(6), 6)
    model = DeepDFA.from_config(tcfg.model, VOCAB, generator=torch.Generator().manual_seed(0))
    ex = GgnnExecutor(model, 256, 1024, 4, device="cpu", feat_width=9)
    size, packed = ex.pack_chunk("graph", port[:3])[1]
    assert packed.node_feats.shape[1] == 9
    probs = ex.fetch(ex.dispatch("graph", (size, packed)), 3)
    assert len(probs) == 3
    cal = quant.calibration_graph_batch(8, 1024, 4096, feat_width=9, input_dim=VOCAB)
    planar = quant.calibration_graph_batch(8, 1024, 4096, feat_width=4, input_dim=VOCAB)
    for j, v in enumerate(structfeat.STRUCT_VOCAB):
        assert cal.node_feats[:, 4 + j].max() < v
    with torch.no_grad():
        assert torch.isfinite(model(cal.to("cpu"))).all()
    assert planar.node_feats.shape[1] == 4


def _batches_equal(got, want, squeeze_want=False):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.num_graphs == w.num_graphs
        for f in tbatch.ARRAY_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                a, b = np.asarray(a), np.asarray(b)
                b = b[0] if squeeze_want else b
                assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_width_nine_crosses_the_packers_and_the_cache(tmp_path):
    """The struct columns ride every packing route: the spawn pool and
    the packed-batch cache give the inline batches (9 columns) bit for
    bit, and the reference's packer and cache the same arrays."""
    from deepdfa_tpu.data import packed_cache as ref_cache

    from deepdfa_tpu_torch.data import mp_pack, packed_cache

    ref, port = struct_graphs(np.random.default_rng(7), 40)
    budgets = dict(num_graphs=8, node_budget=256, edge_budget=1024)
    inline = list(tbatch.shard_bucket_batches(port, **budgets))
    assert inline[0].node_feats.shape[1] == 9
    _batches_equal(inline, jbatch.shard_bucket_batches(ref, 1, **budgets), squeeze_want=True)
    with mp_pack.MpPacker(port, workers=2) as packer:
        _batches_equal(packer.shard_bucket_batches(**budgets), inline)
    cache = packed_cache.PackedBatchCache(tmp_path / "cache")
    _batches_equal(cache.get_or_pack("k", lambda: iter(inline)), inline)
    _batches_equal(cache.get_or_pack("k", lambda: iter(())), inline)
    _batches_equal(inline, ref_cache.PackedBatchCache(tmp_path / "cache").replay("k"),
                   squeeze_want=True)
