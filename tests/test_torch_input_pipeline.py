"""The port's training input pipeline on the CPU: `data/prefetch.py`,
`data/mp_pack.py` and `data/packed_cache.py` against the reference's and
against packing inline.

- prefetch yields the source's elements in the source's order under 1-4
  producers, as the reference's prefetch does, re-raises failures in
  source order, and an early close joins its threads;
- the spawn-pool packers give the inline batches bit for bit (graph and
  bucketed text streams, an undersample selection);
- the packed-batch cache replays what it wrote bit for bit; `cache_key`,
  `corpus_digest` and `text_corpus_digest` are the reference's, and an
  entry either package wrote replays in the other bit for bit (the same
  files: the reference's leading logical-shard axis of 1);
- `GraphTrainer` and `CombinedTrainer` losses with prefetch 0 and 2 (two
  producers) are bit-identical, and `cli train` gives the same losses
  inline, prefetched with a pool packer, and replaying the cache.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.data import packed_cache as ref_cache  # noqa: E402
from deepdfa_tpu.data.prefetch import prefetch as ref_prefetch  # noqa: E402
from deepdfa_tpu.data import text as ref_text  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as RefSpec  # noqa: E402
from deepdfa_tpu.graphs import batch as ref_batch  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.data import mp_pack, packed_cache, prefetch  # noqa: E402
from deepdfa_tpu_torch.data import text as port_text  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec  # noqa: E402
from deepdfa_tpu_torch.graphs import batch as port_batch  # noqa: E402

SPEC_FIELDS = ("graph_id", "node_feats", "node_vuln", "edge_src", "edge_dst", "label",
               "edge_type")


def _specs(n=40, seed=0, etypes=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nn = int(rng.integers(1, 30))
        e = int(rng.integers(0, 2 * nn))
        out.append(GraphSpec(
            graph_id=i, node_feats=rng.integers(0, 50, (nn, 4)).astype(np.int32),
            node_vuln=rng.integers(0, 2, nn).astype(np.int32),
            edge_src=rng.integers(0, nn, e).astype(np.int32),
            edge_dst=rng.integers(0, nn, e).astype(np.int32), label=float(i % 3 == 0),
            edge_type=rng.integers(0, 3, e).astype(np.int32) if etypes else None))
    return out


def _ref(specs):
    return [RefSpec(**{f: getattr(s, f) for f in SPEC_FIELDS}) for s in specs]


def _assert_batches_equal(got, want, squeeze_want=False):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(w, (port_text.TextBatch, ref_text.TextBatch)):
            for f in port_text.TEXT_ARRAY_FIELDS:
                a, b = np.asarray(getattr(g, f)), np.asarray(getattr(w, f))
                b = b[0] if squeeze_want else b
                assert a.dtype == b.dtype and np.array_equal(a, b), f
            g, w = g.graphs, w.graphs
        assert g.num_graphs == w.num_graphs
        for f in port_batch.ARRAY_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None), f
            if a is not None:
                a, b = np.asarray(a), np.asarray(b)
                b = b[0] if squeeze_want else b
                assert a.dtype == b.dtype and np.array_equal(a, b), f


# -- prefetch -----------------------------------------------------------------


@pytest.mark.parametrize("producers", [1, 2, 3, 4])
def test_prefetch_same_elements_same_order(producers):
    src = list(range(57))
    place = lambda x: (time.sleep(0.0005 * (x % 3)), x * 2)[1]  # noqa: E731
    stats = prefetch.PipelineStats()
    got = list(prefetch.prefetch(iter(src), size=3, place=place, producers=producers,
                                 stats=stats))
    assert got == [2 * x for x in src]
    assert got == list(ref_prefetch(iter(src), size=3, place=place,
                                             producers=producers))
    rec = stats.record()
    assert rec["produced"] == rec["consumed"] == len(src) and rec["place_seconds"] > 0
    assert list(prefetch.prefetch(iter(src), size=0, place=place)) == got


def test_prefetch_errors_in_source_order_and_early_close_joins():
    def boom(x):
        if x in (5, 9):
            raise ValueError(f"bad {x}")
        return x

    got = []
    with pytest.raises(ValueError, match="bad 5"):
        for x in prefetch.prefetch(iter(range(20)), size=4, place=boom, producers=3):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]

    def source():
        yield from range(1000)
        raise AssertionError("never reached")

    before = {t.name for t in threading.enumerate()}
    stream = prefetch.prefetch(source(), size=2, producers=4)
    assert [next(stream) for _ in range(3)] == [0, 1, 2]
    stream.close()
    left = {t.name for t in threading.enumerate()} - before
    assert not any(n.startswith("batch-prefetch") for n in left)
    with pytest.raises(ValueError, match="source_stage"):
        list(prefetch.prefetch([], source_stage="load-ish"))


def test_device_placer_on_the_cpu_is_a_copy_to_the_device():
    placer = prefetch.DevicePlacer(torch.device("cpu"))
    b = port_batch.pack(_specs(3), 4, 256, 1024)
    placed = placer.receive(placer(b))
    assert isinstance(placed.node_feats, torch.Tensor)
    assert torch.equal(placed.edge_dst, torch.from_numpy(b.edge_dst))
    again = placer.receive(placer(placed))
    assert again.node_feats is placed.node_feats


# -- the spawn-pool packers -----------------------------------------------------


def test_mp_packers_match_inline():
    """One pool of two spawned workers a packer: the graph stream (whole
    corpus and an undersample-like selection) and a bucketed text
    stream are the inline batches, bit for bit."""
    specs = _specs(48, seed=1, etypes=True)
    budgets = dict(num_graphs=8, node_budget=128, edge_budget=512)
    inline = list(port_batch.shard_bucket_batches(specs, **budgets))
    select = list(range(0, 48, 3))[::-1]
    with mp_pack.MpPacker(specs, workers=2) as packer:
        _assert_batches_equal(packer.shard_bucket_batches(**budgets), inline)
        _assert_batches_equal(
            packer.shard_bucket_batches(**budgets, select=select),
            port_batch.shard_bucket_batches([specs[i] for i in select], **budgets))
        stream = packer.shard_bucket_batches(**budgets)
        next(stream)
        stream.close()  # an abandoned stream drains its shared memory
    assert not list(mp_pack._SHM_DIR.glob(packer._shm_prefix + "*"))
    _assert_batches_equal(port_batch.shard_bucket_batches(specs, **budgets),
                          ref_batch.shard_bucket_batches(_ref(specs), 1, **budgets),
                          squeeze_want=True)

    rng = np.random.default_rng(2)
    ids = list(range(30))
    tok = {i: np.concatenate([rng.integers(4, 200, int(rng.integers(3, 60))),
                              np.ones(64, np.int64)])[:64].astype(np.int32) for i in ids}
    labels = {i: i % 2 for i in ids}
    graphs = {i: s for i, s in zip(ids[::2], _specs(15, seed=3))}
    args = (ids, (16, 32, 64), 256, 1, 512, 2048)
    want = list(port_text.bucketed_collate_batches(tok, labels, ids, graphs, *args[1:],
                                                   pad_id=1))
    with mp_pack.TextMpPacker(tok, labels, graphs, pad_id=1, workers=2) as tpacker:
        _assert_batches_equal(tpacker.bucketed_batches(*args), want)
    with mp_pack.TextMpPacker(tok, labels, graphs, pad_id=1, workers=1) as inline_packer:
        _assert_batches_equal(inline_packer.bucketed_batches(*args), want)


# -- the packed-batch cache -----------------------------------------------------


def test_cache_keys_and_digests_are_the_reference():
    specs = _specs(20, seed=4)
    batcher = dict(num_shards=1, num_graphs=8, node_budget=128, edge_budget=512,
                   oversized="drop", add_self_loops=True, phase="train", epoch=None)
    assert packed_cache.cache_key(batcher, "abc") == ref_cache.cache_key(batcher, "abc")
    assert packed_cache.cache_key(batcher, "abc", "v") == ref_cache.cache_key(batcher, "abc", "v")
    assert packed_cache.cache_key(dict(batcher, epoch=1), "abc") != \
        packed_cache.cache_key(batcher, "abc")
    assert packed_cache.corpus_digest(specs) == ref_cache.corpus_digest(_ref(specs))
    assert packed_cache.corpus_digest(specs[:-1]) != packed_cache.corpus_digest(specs)
    tok = {i: np.arange(i, i + 8, dtype=np.int32) for i in range(6)}
    labels = {i: i % 2 for i in tok}
    assert packed_cache.text_corpus_digest(tok, labels) == ref_cache.text_corpus_digest(
        tok, labels)
    assert packed_cache.SCHEMA_VERSION == ref_cache.SCHEMA_VERSION


def test_cache_replays_bit_identical_and_across_packages(tmp_path):
    specs = _specs(40, seed=5, etypes=True)
    budgets = dict(num_graphs=8, node_budget=128, edge_budget=512)
    inline = list(port_batch.shard_bucket_batches(specs, **budgets))
    port = packed_cache.PackedBatchCache(tmp_path / "port", max_entries=3)
    built = []

    def builder():
        built.append(1)
        return port_batch.shard_bucket_batches(specs, **budgets)

    _assert_batches_equal(port.get_or_pack("k1", builder), inline)
    _assert_batches_equal(port.get_or_pack("k1", builder), inline)
    assert len(built) == 1 and port.keys() == ["k1"]
    # the reference replays the port's entry, and the port the reference's
    _assert_batches_equal(inline, ref_cache.PackedBatchCache(tmp_path / "port").replay("k1"),
                          squeeze_want=True)
    ref = ref_cache.PackedBatchCache(tmp_path / "ref")
    list(ref.write_through("k1", ref_batch.shard_bucket_batches(_ref(specs), 1, **budgets)))
    _assert_batches_equal(packed_cache.PackedBatchCache(tmp_path / "ref").replay("k1"), inline)
    for p in (tmp_path / "ref" / "k1").glob("*.npy"):
        assert p.read_bytes() == (tmp_path / "port" / "k1" / p.name).read_bytes(), p.name
    assert json.loads((tmp_path / "ref" / "k1" / "manifest.json").read_text()) == json.loads(
        (tmp_path / "port" / "k1" / "manifest.json").read_text())

    # text entries cross the same way
    rng = np.random.default_rng(6)
    ids = list(range(20))
    tok = {i: np.concatenate([rng.integers(4, 200, int(rng.integers(3, 30))),
                              np.ones(32, np.int64)])[:32].astype(np.int32) for i in ids}
    labels = {i: i % 2 for i in ids}
    graphs = {i: s for i, s in zip(ids[::2], _specs(10, seed=7))}
    args = ((16, 32), 128, 1, 256, 1024)
    want = list(port_text.bucketed_collate_batches(tok, labels, ids, graphs, *args, pad_id=1))
    list(port.write_through("t1", iter(want)))
    _assert_batches_equal(port.replay("t1"), want)
    ref_graphs = dict(zip(graphs, _ref(list(graphs.values()))))
    list(ref.write_through("t1", ref_text.bucketed_collate_batches(
        tok, labels, ids, ref_graphs, *args, pad_id=1)))
    _assert_batches_equal(packed_cache.PackedBatchCache(tmp_path / "ref").replay("t1"), want)
    _assert_batches_equal(want, ref_cache.PackedBatchCache(tmp_path / "port").replay("t1"),
                          squeeze_want=True)

    # eviction keeps max_entries, a damaged entry is quarantined and rebuilt
    for k in ("k2", "k3"):
        list(port.write_through(k, iter(inline)))
    assert len(port.keys()) == 3 and "k1" not in port.keys()
    victim = next((tmp_path / "port" / "k3").glob("*.npy"))
    victim.write_bytes(victim.read_bytes()[:-8])
    _assert_batches_equal(port.get_or_pack("k3", lambda: iter(inline)), inline)
    assert len(list((tmp_path / "port" / "quarantine").iterdir())) == 1
    assert port.prune(keep=["k3"]) >= 2 and port.keys() == ["k3"]


# -- the trainers ---------------------------------------------------------------


def _graph_losses(prefetch_batches, producers, batches):
    from deepdfa_tpu_torch.models import DeepDFA
    from deepdfa_tpu_torch.train import GraphTrainer

    cfg = config_mod.apply_overrides(config_mod.Config(), [
        "model.hidden_dim=8", "model.n_steps=2", "train.log_every_steps=1",
        f"train.prefetch_batches={prefetch_batches}",
        f"train.prefetch_producers={producers}", "train.feat_unknown_dropout=0.1"])
    trainer = GraphTrainer(DeepDFA(52, 8, 2), cfg, total_steps=3 * len(batches), device="cpu")
    state = trainer.init_state(seed=3)
    steps, records = [], []
    trainer.fit(state, lambda epoch: iter(batches),
                log_fn=lambda r: (steps if "step" in r else records).append(r), max_epochs=3)
    return [r["loss"] for r in steps], records, trainer.model.state_dict()


def test_graph_trainer_losses_equal_with_and_without_prefetch():
    specs = _specs(60, seed=8)
    batches = list(port_batch.shard_bucket_batches(specs, 8, 128, 512))
    want, records0, weights0 = _graph_losses(0, 1, batches)
    got, records2, weights2 = _graph_losses(2, 2, batches)
    assert got == want and len(want) == 3 * len(batches)
    assert all(torch.equal(weights2[k], weights0[k]) for k in weights0)
    assert [r["train_loss"] for r in records2] == [r["train_loss"] for r in records0]
    assert all(k in records2[0] for k in ("host_load_seconds", "host_pack_seconds",
                                          "host_place_seconds", "input_wait_seconds",
                                          "input_wait_fraction"))


def test_combined_trainer_losses_equal_with_and_without_prefetch():
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import CombinedConfig, TransformerConfig
    from deepdfa_tpu_torch.train import CombinedTrainer

    tok = HashTokenizer(vocab_size=256)
    rng = np.random.default_rng(9)
    words = ("int", "x", "=", "0", ";", "if", "(", ")", "{", "}", "return", "buf")
    ids = list(range(24))
    token_ids = {i: tok.encode(" ".join(rng.choice(words, int(rng.integers(3, 40)))), 64)
                 for i in ids}
    labels = {i: i % 2 for i in ids}
    graphs = {i: s for i, s in zip(ids, _specs(24, seed=10))}
    batches = list(port_text.bucketed_collate_batches(
        token_ids, labels, ids, graphs, (16, 32, 64), 256, 1, 512, 2048, pad_id=tok.pad_id))
    mcfg = CombinedConfig(encoder=TransformerConfig.tiny(
        vocab_size=256, max_position_embeddings=68, num_layers=1, num_heads=2,
        hidden_size=32, intermediate_size=64), graph_hidden_dim=8, graph_input_dim=52)
    out = []
    for depth, producers in ((0, 1), (2, 2)):
        cfg = config_mod.apply_overrides(config_mod.Config(), [
            "data.seq_buckets=[16,32,64]", "data.token_budget=256",
            f"train.prefetch_batches={depth}", f"train.prefetch_producers={producers}",
            "train.log_every_steps=1"])
        trainer = CombinedTrainer(cfg, mcfg, total_steps=2 * len(batches), device="cpu")
        state = trainer.init_state()
        logged = []
        trainer.fit(state, lambda epoch: iter(batches), log_fn=logged.append, max_epochs=2,
                    seed=5)
        out.append(([r["loss"] for r in logged if "step" in r],
                    [r for r in logged if "epoch" in r]))
    (want, rec0), (got, rec2) = out
    assert got == want and len(want) == 2 * len(batches)
    assert [r["real_tokens"] for r in rec2] == [r["real_tokens"] for r in rec0] and \
        rec0[0]["real_tokens"] > 0


def test_cli_train_losses_equal_across_the_input_pipeline(tmp_path, monkeypatch):
    """`cli train` inline (prefetch 0); prefetched with two pool workers
    and the packed-batch cache (the step-count estimate writes epoch 0's
    undersampled selection, epoch 0 replays it, epoch 1 packs on the pool
    through the cache); and again on the warm cache: the same step
    losses bit for bit."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cli.main(["prepare", "--source", "synthetic", "--n-examples", "48"])
    cli.main(["extract", "data.feat.limit_all=62", "data.feat.limit_subkeys=62"])
    base = ["data.feat.limit_all=62", "data.feat.limit_subkeys=62", "model.hidden_dim=8",
            "model.n_steps=2", "train.max_epochs=2",
            "data.batch.node_budget=1024", "data.batch.edge_budget=4096",
            "data.batch.graphs_per_batch=2", "train.log_every_steps=1"]
    runs = {
        "inline": ["train.prefetch_batches=0"],
        "piped": ["train.prefetch_batches=2", "data.pack_workers=2", "data.packed_cache=true"],
        "warm": ["train.prefetch_batches=2", "data.packed_cache=true"],
    }
    losses, epochs = {}, {}
    for name, extra in runs.items():
        cli.main(["train", "--device", "cpu", f"run_name=ip-{name}", *base, *extra])
        log = [json.loads(x) for x in
               (tmp_path / "runs" / f"ip-{name}" / "train_log.jsonl").read_text().splitlines()]
        losses[name] = [r["loss"] for r in log if "step" in r]
        epochs[name] = [r for r in log if "epoch" in r]
    assert len(losses["inline"]) >= 4
    assert losses["piped"] == losses["inline"] == losses["warm"]
    piped, warm = epochs["piped"], epochs["warm"]
    assert piped[0]["host_load_seconds"] > 0 and piped[0]["host_pack_seconds"] == 0
    assert piped[1]["host_load_seconds"] == 0 and piped[1]["host_pack_seconds"] > 0
    assert all(e["host_pack_seconds"] == 0 and e["host_load_seconds"] > 0 for e in warm)
    # train epochs 0 and 1 (undersampled selections key apart) and val
    assert len(list((tmp_path / "cache" / "bigvul" / "packed").iterdir())) == 3
