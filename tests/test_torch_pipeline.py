"""The port's data preparation against the reference's, exactly: the
synthetic generators, the dataset readers (the port's without pandas),
`build_dataset` GraphSpec for GraphSpec, graph-store shards member for
member (and each package reading the other's), and the `prepare`,
`extract-vocab` and `extract` commands through both packages' `main`
under two storage roots; then the port's `train` and `test` on the CPU
on the store the port wrote."""

import dataclasses
import json
import pickle

import numpy as np
import pytest

pytest.importorskip("torch")

from deepdfa_tpu.cli.main import main as ref_main  # noqa: E402
from deepdfa_tpu.data import pipeline as ref_pipeline  # noqa: E402
from deepdfa_tpu.data import readers as ref_readers  # noqa: E402
from deepdfa_tpu.data import synthetic as ref_synthetic  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as RefSpec  # noqa: E402
from deepdfa_tpu.graphs import store as ref_store  # noqa: E402

from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.data import load_examples, pipeline, readers, synthetic  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec, store  # noqa: E402

from pathlib import Path  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "fixtures"
GOLDEN_CSV = FIXTURES / "msr_golden.csv"
GOLDEN_SPLITS = FIXTURES / "linevul_splits_golden.csv"
SPEC_FIELDS = ("graph_id", "node_feats", "node_vuln", "edge_src", "edge_dst", "label",
               "edge_type", "node_gen", "node_kill", "node_bits_in", "node_bits_out")
N_FUNCTIONS = 64


def rows(examples) -> list[tuple]:
    return [(e.id, e.code, e.label, e.vuln_lines) for e in examples]


def assert_specs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in SPEC_FIELDS:
            a, b = getattr(g, f, None), getattr(w, f, None)
            if isinstance(b, np.ndarray):
                assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (f, a, b)
                assert np.array_equal(a, b), (g.graph_id, f)
            else:
                assert type(a) is type(b) and a == b, (g.graph_id, f, a, b)


def vocab_json(vocabs) -> str:
    return json.dumps({k: v.to_json() for k, v in vocabs.items()})


def corpus(mod, version: str, n: int = N_FUNCTIONS, seed: int = 3):
    """Seeded synthetic functions at Big-Vul tail statement counts."""
    sizes = mod.bigvul_stmt_sizes(n, seed=seed)
    if version == "v2":
        synth = mod.generate_v2(n, seed=seed, stmt_sizes=sizes, label_noise=0.05)
    else:
        synth = mod.generate(n, seed=seed, stmt_sizes=sizes, vuln_rate=0.3)
    return mod.to_examples(synth)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_synthetic_generators_equal(version):
    assert np.array_equal(synthetic.bigvul_stmt_sizes(300, seed=5),
                          ref_synthetic.bigvul_stmt_sizes(300, seed=5))
    assert rows(corpus(synthetic, version)) == rows(corpus(ref_synthetic, version))
    gen = "generate_v2" if version == "v2" else "generate"
    assert [dataclasses.astuple(s) for s in getattr(synthetic, gen)(40, seed=1)] == [
        dataclasses.astuple(s) for s in getattr(ref_synthetic, gen)(40, seed=1)]
    assert synthetic.split_ids(97, seed=2) == ref_synthetic.split_ids(97, seed=2)


@pytest.mark.parametrize("gtype", ["cfg", "pdg", "cfg+dep"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_build_dataset_equal(version, gtype):
    examples = corpus(synthetic, version)
    ref_examples = corpus(ref_synthetic, version)
    train = [e.id for e in examples if e.id % 5 != 0]
    specs, vocabs = pipeline.build_dataset(examples, train, limit_all=200, limit_subkeys=50,
                                           gtype=gtype)
    want, ref_vocabs = ref_pipeline.build_dataset(ref_examples, train, limit_all=200,
                                                  limit_subkeys=50, gtype=gtype)
    assert len(specs) == len(examples)
    assert_specs_equal(specs, want)
    assert vocab_json(vocabs) == vocab_json(ref_vocabs)
    assert (specs[0].edge_type is not None) == (gtype == "cfg+dep")


def test_build_dataset_workers_equal_and_encode_corpus():
    """A forked pool of 2 gives what one process gives; the two-stage
    path (train-split vocabularies, then encoding against them) equals the
    reference's too."""
    examples = corpus(synthetic, "v2", seed=4)
    train = range(0, N_FUNCTIONS, 2)
    one, v_one = pipeline.build_dataset(examples, train, gtype="cfg+dep")
    two, v_two = pipeline.build_dataset(examples, train, gtype="cfg+dep", workers=2)
    assert_specs_equal(two, one)
    assert vocab_json(v_two) == vocab_json(v_one)
    ref_examples = corpus(ref_synthetic, "v2", seed=4)
    vocabs = pipeline.build_corpus_vocabs(examples, train, workers=2)
    ref_vocabs = ref_pipeline.build_corpus_vocabs(ref_examples, train)
    assert vocab_json(vocabs) == vocab_json(ref_vocabs)
    assert_specs_equal(pipeline.encode_corpus(examples[::3], vocabs, gtype="pdg"),
                       ref_pipeline.encode_corpus(ref_examples[::3], ref_vocabs, gtype="pdg"))
    assert_specs_equal(synthetic.flagship_corpus(24, seed=2),
                       ref_synthetic.flagship_corpus(24, seed=2))


def test_unported_features_raise():
    examples = corpus(synthetic, "v1", n=4)
    # max_defs is ported: the bit labels ride on every spec, equal to the
    # reference's, in the pool as in one process
    specs, _ = pipeline.build_dataset(examples, [0], max_defs=8)
    want, _ = ref_pipeline.build_dataset(corpus(ref_synthetic, "v1", n=4), [0], max_defs=8)
    assert_specs_equal(specs, want)
    assert all(s.node_gen.shape == (len(s.node_feats), 8) for s in specs)
    bits = pipeline.extract_corpus(examples, max_defs=8, workers=2)
    assert [np.array_equal(g.bits["labels_out"], s.node_bits_out) for g, s in zip(bits, specs)] \
        == [True] * len(specs)
    # the structural channels are ported: extraction takes them, in the
    # pool as in one process
    pooled = pipeline.extract_corpus(examples, struct_feats=True, workers=2)
    assert [g.struct.shape[1] for g in pooled] == [5] * len(pooled)
    one = pipeline.extract_graph(examples[0].code, 0, struct_feats=True)
    assert np.array_equal(one.struct, pooled[0].struct)
    with pytest.raises(ValueError, match="gtype"):
        pipeline.extract_graph(examples[0].code, 0, gtype="ast")


# -- readers ------------------------------------------------------------------

MSR_HEADER = ",func_before,func_after,vul,project\n"
SMALL_CSVS = {
    # an empty func_after cell (NaN -> "nan") and a multi-line quoted cell
    "empty_cell_and_multiline": MSR_HEADER + (
        '0,"int f(int a) {\n  int b = a;\n  b = b + 1;\n  b = b * 2;\n  b = b - 3;\n'
        '  return b;\n}",,1,alpha\n'
        '1,"int g(void) {\n  return 0;\n}","int g(void) {\n  return 1;\n}",0,\n'
        '5,"int h(int x) {\n  int y = x;\n  y += 2;\n  y -= 1;\n  y *= 3;\n  y /= 2;\n'
        '  return y;\n}","int h(int x) {\n  int y = x;\n  y += 2;\n  y -= 4;\n  y *= 3;\n'
        '  y /= 2;\n  return y;\n}",1,beta\n\n'
        '7,NULL,None,0,alpha\n'
    ),
    # no unnamed first column: the row number is the id
    "no_unnamed_column": "func_before,func_after,vul,project\n" + "".join(
        f'"int f{i}(int a) {{\n  return a + {i};\n}}","int f{i}(int a) {{\n  return a;\n}}",'
        f"{int(i % 3 == 0)},p{i % 4}\n" for i in range(12)),
}


@pytest.fixture(scope="module")
def small_csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("csv")
    out = {}
    for name, text in SMALL_CSVS.items():
        (root / f"{name}.csv").write_text(text)
        out[name] = root / f"{name}.csv"
    out["golden"] = GOLDEN_CSV
    return out


@pytest.mark.parametrize("sample", [None, 1, 4, 6, 50])
@pytest.mark.parametrize("name", ["golden", "empty_cell_and_multiline", "no_unnamed_column"])
def test_read_bigvul_equal(small_csvs, name, sample):
    want = rows(ref_readers.read_bigvul(small_csvs[name], sample=sample))
    assert rows(readers.read_bigvul(small_csvs[name], sample=sample)) == want
    if sample is None:
        assert want


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", ["golden", "empty_cell_and_multiline", "no_unnamed_column"])
def test_cross_project_and_random_splits_equal(small_csvs, name, seed):
    assert readers.cross_project_splits(small_csvs[name], seed=seed) == \
        ref_readers.cross_project_splits(small_csvs[name], seed=seed)
    ids = [3, 1, 4, 15, 9, 2, 6, 5, 35, 8, 97, 93]
    splits = readers.random_splits(ids, seed=seed)
    assert splits == ref_readers.random_splits(ids, seed=seed)
    examples = corpus(synthetic, "v1", n=12)
    got = readers.partition(examples, splits)
    want = ref_readers.partition(corpus(ref_synthetic, "v1", n=12), splits)
    assert {k: rows(v) for k, v in got.items()} == {k: rows(v) for k, v in want.items()}


@pytest.mark.parametrize("kw", [{"holdout_frac": 0.4}, {"holdout_frac": 0.4, "seed": 3},
                                {"test_projects": ["9"]}])
def test_cross_project_splits_type_numeric_projects_as_pandas(tmp_path, kw):
    """An all-numeric `project` column sorts and compares as numbers, as
    pandas types it: the seeded holdout picks the reference's projects,
    and the text "9" matches no project (the reference holds out 0 rows)."""
    projects = (9, 10, 100, 2, 33)
    path = tmp_path / "numeric_projects.csv"
    path.write_text(MSR_HEADER + "".join(
        f'{i},"int f{i}(int a) {{ return a; }}","int f{i}(int a) {{ return a; }}",0,'
        f"{projects[i % 5]}\n" for i in range(40)))
    want = ref_readers.cross_project_splits(path, **kw)
    assert readers.cross_project_splits(path, **kw) == want
    assert sum(v == "test" for v in want.values()) == (0 if "test_projects" in kw else 16)


def test_read_splits_devign_dbgbench_and_mutated_equal(tmp_path):
    assert readers.read_splits_csv(GOLDEN_SPLITS) == ref_readers.read_splits_csv(GOLDEN_SPLITS)
    (tmp_path / "splits.csv").write_text("idx,partition\n4,valid\n2,holdout\n9,train\n")
    assert readers.read_splits_csv(tmp_path / "splits.csv") == ref_readers.read_splits_csv(
        tmp_path / "splits.csv") == {4: "val", 2: "test", 9: "train"}
    devign = tmp_path / "function.json"
    devign.write_text(json.dumps([
        {"func": "int f(int a) { /* c */ return a; }", "target": 1},
        {"func": "%%% not C", "target": 0}, {"func": "void g(void) {}"}]))
    for sample in (None, 2):
        assert rows(readers.read_devign(devign, sample=sample)) == rows(
            ref_readers.read_devign(devign, sample=sample))
    dbg = tmp_path / "dbgbench.csv"
    dbg.write_text('c,code\nfind.c,"int f(int a) {\n  return a;\n}"\n'
                   'find_patched.c,"int f(int a) {\n  return a + 1;\n}"\n,int g;\n')
    for sample in (None, 2):
        assert rows(readers.read_dbgbench(dbg, sample=sample)) == rows(
            ref_readers.read_dbgbench(dbg, sample=sample))
    base = readers.read_bigvul(GOLDEN_CSV)
    mutated = tmp_path / "mutated.jsonl"
    mutated.write_text("".join(json.dumps({
        "idx": e.id, "source": f"int s{e.id}(void) {{ return 0; }}",
        "target": f"int t{e.id}(void) {{ /* m */ return 1; }}"}) + "\n"
        for e in base[::2]) + json.dumps({"idx": 10 ** 6, "source": "", "target": ""}) + "\n")
    for flip in (False, True):
        assert rows(readers.read_mutated(mutated, base, flip=flip)) == rows(
            ref_readers.read_mutated(mutated, ref_readers.read_bigvul(GOLDEN_CSV), flip=flip))


# -- graph stores -------------------------------------------------------------


def npz_members(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_stores_equal(got_dir: Path, want_dir: Path):
    names = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in got_dir.iterdir()) == names
    for name in names:
        if name.endswith(".npz"):
            got, want = npz_members(got_dir / name), npz_members(want_dir / name)
            assert list(got) == list(want), name
            for k, w in want.items():
                assert got[k].dtype == w.dtype and got[k].shape == w.shape, (name, k)
                assert np.array_equal(got[k], w), (name, k)
        else:
            assert (got_dir / name).read_text() == (want_dir / name).read_text(), name


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("gtype", ["cfg", "cfg+dep"])
def test_store_shards_equal_and_read_across(tmp_path, gtype, compressed):
    examples = corpus(synthetic, "v1", n=40)
    specs, _ = pipeline.build_dataset(examples, range(40), gtype=gtype)
    ref_specs = [RefSpec(**{f: getattr(s, f) for f in SPEC_FIELDS}) for s in specs]
    port_store, ref_st = store.GraphStore(tmp_path / "port"), ref_store.GraphStore(tmp_path / "ref")
    assert port_store.write(specs, shard_size=16, tag="t", compressed=compressed) == 3
    assert ref_st.write(ref_specs, shard_size=16, tag="t", compressed=compressed) == 3
    assert port_store.write(specs[:5], compressed=compressed) == 1
    ref_st.write(ref_specs[:5], compressed=compressed)
    assert_stores_equal(tmp_path / "port", tmp_path / "ref")
    for path in port_store.shard_paths():
        assert store.file_digest(path) == ref_store.file_digest(path)
        assert_specs_equal(ref_store.load_shard(path), store.load_shard(path))
        assert_specs_equal(store.load_shard(tmp_path / "ref" / path.name),
                           ref_store.load_shard(tmp_path / "ref" / path.name))
    assert port_store.digest() == ref_store.GraphStore(tmp_path / "port").digest()
    assert sorted(port_store.load_all()) == list(range(40))
    empty = tmp_path / "empty" / "graphs-00000.npz"
    empty.parent.mkdir()
    store.save_shard(empty, [])
    assert ref_store.load_shard(empty) == []


# -- the commands ---------------------------------------------------------------

#: (prepare arguments, extract settings, sharded?) per scenario
SCENARIOS = {
    "synthetic_cfg": (["--source", "synthetic", "--n-examples", "48"], [], False),
    "synthetic_cfg_sharded": (["--source", "synthetic", "--n-examples", "48"], [], True),
    "v2_pdg_sharded": (["--source", "synthetic", "--synthetic-v2", "--n-examples", "40",
                        "--export-codet5", "data.gtype=pdg"], ["data.gtype=pdg"], True),
    "v2_cfg_dep": (["--source", "synthetic", "--synthetic-v2", "--n-examples", "40",
                    "--lookalike-rate", "0.3", "--label-noise", "0.1",
                    "data.gtype=cfg+dep", "model.n_etypes=3"],
                   ["data.gtype=cfg+dep", "model.n_etypes=3"], False),
    "golden_csv": (["--source", str(GOLDEN_CSV), "--dep-closure", "--export-codet5",
                    "--splits", str(GOLDEN_SPLITS)], [], False),
    "golden_csv_sharded": (["--source", str(GOLDEN_CSV), "--cross-project", "--sample", "4",
                            "data.seed=3"], ["data.feat.limit_all=8"], True),
    "devign_missing_ids": (["--source", "DEVIGN", "--dep-closure"], [], True),
}


def run_both(monkeypatch, roots: dict, argv: list[str]) -> None:
    for name, main in (("ref", ref_main), ("port", cli.main)):
        monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(roots[name]))
        main(argv)


def devign_source(path: Path) -> Path:
    funcs = [f"int f{i}(int a) {{\n  int b = a + {i};\n  return b;\n}}\n" for i in range(10)]
    funcs[3] = "%%% not C at all"
    funcs[7] = "}}}"
    path.write_text(json.dumps([{"func": f, "target": i % 2} for i, f in enumerate(funcs)]))
    return path


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_prepare_and_extract_commands_equal(tmp_path, monkeypatch, scenario):
    prepare, settings, sharded = SCENARIOS[scenario]
    prepare = [str(devign_source(tmp_path / "function.json")) if a == "DEVIGN" else a
               for a in prepare]
    roots = {k: tmp_path / k for k in ("ref", "port")}
    run_both(monkeypatch, roots, ["prepare", *prepare])
    if sharded:
        run_both(monkeypatch, roots, ["extract-vocab", "--workers", "2", *settings])
        for shard in (0, 1):
            run_both(monkeypatch, roots, ["extract", "--num-shards", "2", "--shard", str(shard),
                                          *(["--workers", "2"] if shard else []), *settings])
    else:
        run_both(monkeypatch, roots, ["extract", *settings])
    ref_dir, port_dir = (roots[k] / "processed" / "bigvul" for k in ("ref", "port"))
    with (ref_dir / "examples.pkl").open("rb") as f:
        ref_rows = rows(pickle.load(f))
    with (port_dir / "examples.pkl").open("rb") as f:
        assert rows(pickle.load(f)) == ref_rows
    assert rows(load_examples(port_dir / "examples.pkl")) == ref_rows
    assert rows(load_examples(ref_dir / "examples.pkl")) == ref_rows
    files = sorted(p.name for p in ref_dir.iterdir() if p.is_file())
    assert sorted(p.name for p in port_dir.iterdir() if p.is_file()) == files
    for name in files:
        if name != "examples.pkl":
            assert (port_dir / name).read_text() == (ref_dir / name).read_text(), name
    dirs = sorted(p.name for p in ref_dir.iterdir() if p.is_dir())
    assert sorted(p.name for p in port_dir.iterdir() if p.is_dir()) == dirs
    for name in dirs:
        assert_stores_equal(port_dir / name, ref_dir / name)
    store_dir = next(port_dir / d for d in dirs if d.startswith("graphs"))
    missing = "".join((store_dir / n).read_text() for n in sorted(
        p.name for p in store_dir.glob("missing_ids*.txt")))
    assert missing.split() == (["3", "7"] if scenario == "devign_missing_ids" else [])
    if "--export-codet5" in prepare:
        assert (port_dir / "codet5" / "train.jsonl").read_text()


def test_extract_refuses_unported_features(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cli.main(["prepare", "--source", "synthetic", "--n-examples", "8"])
    # data.feat.max_defs is ported: the store takes _maxdefs_N and the bits
    processed = tmp_path / "processed" / "bigvul"
    cli.main(["extract", "data.feat.max_defs=16"])
    (store_dir,) = processed.glob("graphs*_maxdefs_16")
    one = list(store.GraphStore(store_dir).iter_graphs())
    assert one and all(s.node_bits_in.shape[1] == 16 for s in one)
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path / "two"))
    cli.main(["prepare", "--source", "synthetic", "--n-examples", "8"])
    cli.main(["extract", "--num-shards", "1", "data.feat.max_defs=16"])
    two = tmp_path / "two" / store_dir.relative_to(tmp_path)
    assert_specs_equal(list(store.GraphStore(two).iter_graphs()), one)
    assert len(list(processed.glob("vocab*_maxdefs_16.json"))) == 1
    with pytest.raises(SystemExit, match="extract-vocab"):
        cli.main(["extract", "--num-shards", "2"])
    with pytest.raises(SystemExit):
        cli.main(["prepare", "--source", "synthetic", "--label-noise", "0.1"])


def test_train_and_test_on_the_store_the_port_wrote(tmp_path, monkeypatch, capsys):
    """prepare -> extract -> train -> test on the port alone (CPU)."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cli.main(["prepare", "--source", "synthetic", "--n-examples", "64"])
    cli.main(["extract", "--workers", "2", "data.feat.limit_all=62",
              "data.feat.limit_subkeys=62"])
    settings = ["run_name=port-pipeline", "data.feat.limit_all=62", "data.feat.limit_subkeys=62",
                "model.hidden_dim=8", "model.n_steps=2", "train.max_epochs=1",
                "data.undersample=false", "data.batch.node_budget=2048",
                "data.batch.edge_budget=4096", "data.batch.graphs_per_batch=32"]
    cli.main(["train", "--device", "cpu", *settings])
    assert "best:" in capsys.readouterr().out
    run = tmp_path / "runs" / "port-pipeline"
    epochs = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()
              if '"epoch"' in x]
    assert len(epochs) == 1 and np.isfinite(epochs[0]["train_loss"])
    cli.main(["test", "--device", "cpu", "--export", "run_name=port-pipeline"])
    metrics = json.loads((run / "test_metrics_test.json").read_text())
    assert np.isfinite(metrics["loss"]) and 0.0 <= metrics["acc"] <= 1.0
    splits = json.loads((tmp_path / "processed" / "bigvul" / "splits.json").read_text())
    predicted = (run / "predictions_test.csv").read_text().splitlines()[1:]
    assert sorted(int(r.split(",")[0]) for r in predicted) == sorted(
        int(k) for k, v in splits.items() if v == "test")


def test_port_spec_type_is_the_ports():
    examples = corpus(synthetic, "v1", n=3)
    specs, _ = pipeline.build_dataset(examples, range(3))
    assert all(type(s) is GraphSpec for s in specs)
    assert all(type(e).__module__ == "deepdfa_tpu_torch.data.examples" for e in examples)
