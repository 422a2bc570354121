"""The port's combined (DeepDFA+LineVul) training path on the CPU against
the reference: the bucket planner and the bucketed collater exactly,
training-mode forwards, dropout determinism under remat, whole-model
gradients against `jax.grad` of the reference's loss, a 5-step AdamW
trajectory of the reference `CombinedTrainer`, freezing, the examples
reader and `cli train-combined` on a reference-written processed dir.

Parity runs set every dropout rate to 0: the reference's masks come from
`jax.random`, the port's from its own seeds (the dropout math is held
through explicit bits in tests/test_torch_flash_bwd.py). Tolerances:
arrays and plans exactly; gradients fp32 within 1e-4 of each leaf's
scale (floored at 1e-3 of the largest gradient: some leaves, like the
GGNN gate's bias, have gradients that vanish analytically); the AdamW
losses rtol 1e-4, as the GGNN trajectory test holds them."""

import dataclasses
import functools
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.data import pipeline as jpipeline  # noqa: E402
from deepdfa_tpu.data import text as jtext  # noqa: E402
from deepdfa_tpu.graphs import GraphSpec as JSpec, GraphStore as JStore  # noqa: E402
from deepdfa_tpu.models import combined as jcmb  # noqa: E402
from deepdfa_tpu.models import transformer as jtfm  # noqa: E402
from deepdfa_tpu.parallel import make_mesh  # noqa: E402
from deepdfa_tpu.train.combined_loop import CombinedTrainer as JTrainer  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.data import text as ttext  # noqa: E402
from deepdfa_tpu_torch.data.examples import Example, load_examples  # noqa: E402
from deepdfa_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    CombinedConfig,
    CombinedModel,
    DeepDFA,
    RobertaEncoder,
    TransformerConfig,
    from_jax_combined_params,
)
from deepdfa_tpu_torch.nn.dropout import fold_seed  # noqa: E402
from deepdfa_tpu_torch.train import (  # noqa: E402
    CombinedTrainer,
    graph_encoder_subset,
    load_graph_encoder,
)

VOCAB = 256
BUCKETS = (16, 32, 64)
TOKEN_BUDGET = 256  # rows per bucket: 16, 8, 4
NODE_BUDGET, EDGE_BUDGET = 512, 2048
INPUT_DIM = 52  # feat.limit_all + 2
WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
         "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n")
CFG = {
    "run_name": "port-combined",
    "data": {
        "feat": {"limit_all": INPUT_DIM - 2, "limit_subkeys": INPUT_DIM - 2},
        "undersample": False,
        "batch": {"graphs_per_batch": 16, "node_budget": NODE_BUDGET,
                  "edge_budget": EDGE_BUDGET},
    },
    "model": {"hidden_dim": 8, "n_steps": 3},
    "train": {"max_epochs": 1, "monitor": "val_f1", "monitor_mode": "max", "seed": 5,
              "optim": {"name": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01,
                        "warmup_frac": 0.2, "grad_clip_norm": 1.0},
              "mesh": {"dp": 1}},
}


def _cfgs(**train):
    d = json.loads(json.dumps(CFG))
    d["train"].update(train)
    return jconfig.from_dict(d), tconfig.from_dict(d)


def _enc_kw(**kw):
    base = dict(vocab_size=VOCAB, max_position_embeddings=68, num_layers=2, num_heads=4,
                hidden_size=64, intermediate_size=128, dropout_rate=0.0)
    base.update(kw)
    return base


def _model_cfgs(dropout=0.0, **enc):
    jenc = jtfm.TransformerConfig.tiny(**_enc_kw(dropout_rate=dropout, **enc))
    tenc = TransformerConfig.tiny(**_enc_kw(dropout_rate=dropout, **enc))
    kw = dict(graph_hidden_dim=8, graph_n_steps=3, graph_input_dim=INPUT_DIM,
              head_dropout=dropout)
    return jcmb.CombinedConfig(encoder=jenc, **kw), CombinedConfig(encoder=tenc, **kw)


def _snippet(rng, n_tokens):
    lines, line = [], []
    for w in rng.choice(WORDS, n_tokens):
        line.append(str(w))
        if w in (";", "{", "}"):
            lines.append(" ".join(line))
            line = []
    lines.append(" ".join(line))
    return "\n".join(lines) + "\n"


def _graph_kw(rng, gid):
    n = int(rng.integers(2, 30))
    e = int(rng.integers(1, 2 * n))
    return dict(graph_id=gid, node_feats=rng.integers(0, INPUT_DIM, (n, 4)).astype(np.int32),
                node_vuln=np.zeros((n,), np.int32),
                edge_src=rng.integers(0, n, (e,)).astype(np.int32),
                edge_dst=rng.integers(0, n, (e,)).astype(np.int32), label=float(gid % 2))


@functools.lru_cache(maxsize=None)
def _corpus(n=40, seed=0):
    """(texts, ids [n, 64], labels, graph kwargs by id; every 5th row has
    no graph)."""
    rng = np.random.default_rng(seed)
    texts = [_snippet(rng, int(rng.integers(1, 62))) for _ in range(n)]
    ids = HashTokenizer(vocab_size=VOCAB).batch_encode(texts, 64)
    labels = [int(i % 3 == 0) for i in range(n)]
    graphs = {i: _graph_kw(rng, i) for i in range(n) if i % 5}
    return texts, ids, labels, graphs


def _batches(port=True, ids_sel=None):
    """Bucketed batches of the corpus from either package (the
    reference's with its leading shard axis)."""
    _, ids, labels, graphs = _corpus()
    sel = list(range(len(labels))) if ids_sel is None else ids_sel
    text = ttext if port else jtext
    spec = TSpec if port else JSpec
    return list(text.bucketed_collate_batches(
        {i: ids[i] for i in sel}, {i: labels[i] for i in sel}, sel,
        {i: spec(**kw) for i, kw in graphs.items()}, BUCKETS, TOKEN_BUDGET, 1,
        NODE_BUDGET, EDGE_BUDGET))


TEXT_FIELDS = ("input_ids", "labels", "row_mask", "has_graph")
GRAPH_FIELDS = ("node_feats", "node_vuln", "node_graph", "node_mask", "edge_src", "edge_dst",
                "edge_mask", "graph_label", "graph_mask", "graph_ids")


# -- the bucket planner --------------------------------------------------------


def test_bucket_planner_and_collater_equal_reference():
    _, ids, labels, _ = _corpus()
    order = list(range(len(labels)))[::-1]
    tok = {i: ids[i] for i in order}
    lengths = ttext.lengths_for(tok, order, 1)
    assert lengths == jtext.lengths_for(tok, order, 1)
    for shards in (1, 2):
        got_stats, want_stats = {}, {}
        got = list(ttext.plan_bucketed_batches(lengths, order, BUCKETS, TOKEN_BUDGET, shards,
                                               NODE_BUDGET, EDGE_BUDGET, stats=got_stats))
        want = list(jtext.plan_bucketed_batches(lengths, order, BUCKETS, TOKEN_BUDGET, shards,
                                                NODE_BUDGET, EDGE_BUDGET, stats=want_stats))
        assert [dataclasses.astuple(p) for p in got] == [dataclasses.astuple(p) for p in want]
        assert got_stats == want_stats and got_stats["rows"] == len(order)
    with pytest.raises(ValueError, match="largest bucket"):
        list(ttext.plan_bucketed_batches([70], [0], BUCKETS, TOKEN_BUDGET, 1, 1, 1))
    got, want = _batches(True), _batches(False)
    assert len(got) == len(want) > 3
    assert {b.input_ids.shape[1] for b in got} == set(BUCKETS)
    for g, w in zip(got, want):
        for f in TEXT_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f)[0], err_msg=f)
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(g.graphs, f), getattr(w.graphs, f)[0],
                                          err_msg=f)
        assert ttext.batch_token_counts(g.input_ids, g.row_mask, 1) == \
            jtext.batch_token_counts(w.input_ids, w.row_mask, 1)
    plan = ttext.TextBatchPlan((0,), 16, 4, 2, NODE_BUDGET, EDGE_BUDGET)
    with pytest.raises(NotImplementedError, match="one logical shard"):
        ttext.collate_plan(plan, {0: ids[0]}, {0: 0}, {})


# -- training-mode forwards and dropout --------------------------------------------


def _port_model(tmcfg, seed=0):
    return CombinedModel(tmcfg, generator=torch.Generator().manual_seed(seed))


def test_training_mode_without_dropout_gives_the_eval_logits():
    """Rates 0 with a dropout key, or rate 0.1 without one: the same
    bits as the eval forward, for the encoder and the combined model."""
    batch = _batches(True)[0].to("cpu")
    _, tm0 = _model_cfgs(0.0)
    for tmcfg, key in ((tm0, 123), (_model_cfgs(0.1)[1], None)):
        model = _port_model(tmcfg)
        with torch.inference_mode():
            want = model.eval()(batch.input_ids, batch.graphs, batch.has_graph)
            want_h = model.encoder.encode(batch.input_ids)
        got = model.train()(batch.input_ids, batch.graphs, batch.has_graph, dropout_key=key)
        got_h = model.encoder.encode(batch.input_ids, dropout_key=key)
        assert torch.equal(got, want) and torch.equal(got_h, want_h)


def _grads(model, batch, key):
    model.zero_grad(set_to_none=True)
    logits = model(batch.input_ids, batch.graphs, batch.has_graph, dropout_key=key)
    loss = torch.nn.functional.cross_entropy(logits, batch.labels.long(), reduction="none")
    (loss * batch.row_mask).sum().backward()
    return logits.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_dropout_repeats_per_seed_and_under_remat():
    """One seed gives the same masks (logits and gradients bit-equal), a
    new step seed new masks, and remat on and off the same gradients to
    the bit: the checkpointed layers redraw the masks from their seeds."""
    batch = _batches(True)[1].to("cpu")
    _, tm = _model_cfgs(0.1)
    model = _port_model(tm).train()
    l1, g1 = _grads(model, batch, fold_seed(7, 0))
    l2, g2 = _grads(model, batch, fold_seed(7, 0))
    assert torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k]) for k in g1)
    l3, _ = _grads(model, batch, fold_seed(7, 1))
    assert not torch.equal(l1, l3)
    with torch.inference_mode():
        clean = model(batch.input_ids, batch.graphs, batch.has_graph)
    assert not torch.equal(l1, clean)  # dropout ran
    no_remat = _port_model(dataclasses.replace(
        tm, encoder=dataclasses.replace(tm.encoder, remat=False))).train()
    no_remat.load_state_dict(model.state_dict())
    l4, g4 = _grads(no_remat, batch, fold_seed(7, 0))
    assert torch.equal(l1, l4) and all(torch.equal(g1[k], g4[k]) for k in g1)


def test_bf16_activations_give_fp32_gradients_at_the_leaves():
    _, tm = _model_cfgs(0.1, dtype="bfloat16")
    model = _port_model(tm).train()
    logits, grads = _grads(model, _batches(True)[0].to("cpu"), 11)
    assert logits.dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.dtype == grads[name].dtype == torch.float32, name
        assert torch.isfinite(grads[name]).all(), name
    assert grads["encoder.layers.0.wqkv"].abs().sum() > 0


# -- against the reference ------------------------------------------------------


def _leaf_errors(got: dict, want: dict) -> dict:
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


def test_whole_model_gradients_match_reference():
    jmcfg, tmcfg = _model_cfgs(0.0)
    params = jax.tree.map(np.asarray, jcmb.init_params(jmcfg, jax.random.key(4)))
    ref_b, port_b = _batches(False)[2], _batches(True)[2].to("cpu")
    local = jax.tree.map(lambda x: x[0], ref_b)

    def loss(p):
        logits = jcmb.forward(jmcfg, p, local.input_ids, local.graphs, local.has_graph)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, local.labels)
        m = local.row_mask.astype(per.dtype)
        return (per * m).sum() / jnp.maximum(m.sum(), 1.0)

    want_loss, jgrads = jax.value_and_grad(loss)(params)
    want = {k: v.numpy() for k, v in from_jax_combined_params(
        jax.tree.map(np.asarray, jgrads)).items()}
    _, tcfg = _cfgs()
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=1, device="cpu")
    state = trainer.init_state(params=from_jax_combined_params(params))
    got_loss = trainer.forward_loss(state, port_b, None)
    got_loss.backward()
    got = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= 1e-4, errs


def test_adamw_trajectory_stays_close_to_reference_trainer():
    """5 AdamW steps (warmup 0.2, clip 1.0, decay 0.01) of the reference
    CombinedTrainer (one-device mesh) and the port's, from the same
    weights over the same batches."""
    jcfg, tcfg = _cfgs()
    jmcfg, tmcfg = _model_cfgs(0.0)
    jtr = JTrainer(jcfg, jmcfg, mesh=make_mesh(jcfg.train.mesh, devices=jax.devices()[:1]),
                   total_steps=5)
    jstate = jtr.init_state()
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=5, device="cpu")
    state = trainer.init_state(params=from_jax_combined_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))))
    ref_bs, port_bs = _batches(False), _batches(True)
    jl, tl = [], []
    for i in range(5):
        jstate, loss = jtr.train_step(jstate, jtr.place_batch(ref_bs[i]), jax.random.key(i))
        jl.append(float(loss))
        tl.append(float(trainer.train_step(state, port_bs[i].to("cpu"), fold_seed(0, i))))
    assert len(set(np.round(tl, 5))) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert state.step == 5 and sum(trainer.signature_stats[k]["train_steps"]
                                   for k in trainer.signature_stats) == 5


def test_freeze_graph_keeps_the_graph_branch_bit_equal():
    _, tcfg = _cfgs()
    _, tmcfg = _model_cfgs(0.1)
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=4, freeze_graph=True, device="cpu")
    state = trainer.init_state()
    # a trained DeepDFA's encoder weights, spliced in (its head is dropped)
    dd = DeepDFA(INPUT_DIM, 8, 3, concat_all_absdf=True,
                 generator=torch.Generator().manual_seed(9))
    sub = graph_encoder_subset(dd.state_dict())
    assert sub and not any(k.startswith("head.") for k in sub)
    state = trainer.load_graph_encoder_params(state, dd.state_dict())
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for k, v in sub.items():
        assert torch.equal(before[f"graph.{k}"], v)
    n_opt = sum(p.numel() for g in state.optimizer.param_groups for p in g["params"])
    n_graph = sum(p.numel() for p in state.model.graph.parameters())
    assert n_opt == sum(p.numel() for p in state.model.parameters()) - n_graph
    for i, b in enumerate(_batches(True)[:3]):
        trainer.train_step(state, b.to("cpu"), fold_seed(1, i))
    after = state.model.state_dict()
    for k in before:
        frozen = k.startswith("graph.")
        assert torch.equal(after[k], before[k]) == frozen or k.endswith("ln1_bias"), k
    with pytest.raises(KeyError, match="missing"):
        graph_encoder_subset({k: v for k, v in dd.state_dict().items()
                              if not k.startswith("ggnn.")})
    with pytest.raises(ValueError, match="checkpoint"):
        load_graph_encoder(state.model, {**sub, "ggnn.etype_bias": torch.zeros(3, 3)})


# -- the examples reader and the command line -------------------------------------


def _reference_examples():
    texts, _, labels, _ = _corpus()
    return [jpipeline.Example(id=i, code=t, label=float(y), vuln_lines=frozenset({1}))
            for i, (t, y) in enumerate(zip(texts, labels))]


def test_load_examples_reads_reference_pickles_without_the_reference(tmp_path):
    path = tmp_path / "examples.pkl"
    with path.open("wb") as f:
        pickle.dump(_reference_examples(), f)
    code = (
        "import sys\n"
        "from deepdfa_tpu_torch.data.examples import load_examples\n"
        f"rows = load_examples({str(path)!r})\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'deepdfa_tpu'], 'imported'\n"
        "assert 'jax' not in sys.modules\n"
        "print(len(rows), type(rows[0]).__module__, rows[3].label, sorted(rows[3].vuln_lines))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["40", "deepdfa_tpu_torch.data.examples", "1.0", "[1]"]
    rows = load_examples(path)
    assert isinstance(rows[0], Example) and rows[5].code == _corpus()[0][5]
    with path.open("wb") as f:  # any other class of the reference is refused
        pickle.dump([JSpec(**_graph_kw(np.random.default_rng(0), 1))], f)
    with pytest.raises(pickle.UnpicklingError, match="Example rows only"):
        load_examples(path)


def _processed_dir(tmp_path, tcfg):
    out = tmp_path / "processed" / "bigvul"
    out.mkdir(parents=True)
    with (out / "examples.pkl").open("wb") as f:
        pickle.dump(_reference_examples(), f)
    _, _, _, graphs = _corpus()
    JStore(out / cli.graphs_dirname(tcfg)).write([JSpec(**kw) for kw in graphs.values()])
    splits = {str(i): ("train", "train", "train", "val", "test")[i % 5] for i in range(40)}
    (out / "splits.json").write_text(json.dumps(splits))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(CFG))
    return cfg_path


@pytest.mark.parametrize("bucketed", [True, False], ids=["bucketed", "fixed_16_rows"])
def test_cli_train_combined_on_a_reference_processed_dir(tmp_path, monkeypatch, capsys,
                                                         bucketed):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    _, tcfg = _cfgs()
    cfg_path = _processed_dir(tmp_path, tcfg)
    extra = ([f"data.seq_buckets={json.dumps(list(BUCKETS))}",
              f"data.token_budget={TOKEN_BUDGET}"] if bucketed else [])
    cli.main(["train-combined", "--config", str(cfg_path), "--device", "cpu",
              "--max-length", "64", "--encoder", "tiny", "train.log_every_steps=1", *extra])
    assert "best:" in capsys.readouterr().out
    run = tmp_path / "runs" / "port-combined"
    records = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [0]
    rec = epochs[0]
    assert np.isfinite(rec["train_loss"]) and "val_f1" in rec and np.isfinite(rec["val_loss"])
    assert rec["real_tokens"] > 0 and 0.0 <= rec["padding_waste"] < 1.0
    sigs = sorted(rec["step_signatures"])
    assert sigs == (["T16xR16xG16", "T32xR8xG8", "T64xR4xG4"] if bucketed else ["T64xR16xG16"])
    assert any("warmup_signatures" in r for r in records) == bucketed
    manifest = json.loads((run / cli.COMBINED_CHECKPOINTS_DIR / "manifest.json").read_text())
    assert manifest["best"] is not None
    assert tconfig.load(run / "config.json").run_name == "port-combined"


@pytest.mark.parametrize("flags", [["--sp-variant", "ulysses"]], ids=["ulysses"])
def test_cli_refuses_what_the_port_does_not_run(tmp_path, monkeypatch, flags):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    with pytest.raises(NotImplementedError, match="not ported"):
        cli.main(["train-combined", "--device", "cpu", *flags])


def _hf_state_dict(tmp_path, arch: str) -> Path:
    """A randomly initialised Hugging Face encoder at the CLI's tiny
    width, saved as a torch state_dict: RobertaModel for roberta (the
    hash tokenizer's 4096 ids, positions for --max-length 64),
    T5EncoderModel for t5."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if arch == "t5":
        hf = transformers.T5EncoderModel(transformers.T5Config(
            vocab_size=4096, d_model=64, num_layers=2, num_heads=4, d_kv=16, d_ff=128,
            relative_attention_num_buckets=32, relative_attention_max_distance=128,
            dropout_rate=0.0, feed_forward_proj="relu"))
    else:
        hf = transformers.RobertaModel(transformers.RobertaConfig(
            vocab_size=4096, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, max_position_embeddings=68, type_vocab_size=1,
            pad_token_id=1), add_pooling_layer=True)
    path = tmp_path / f"hf_{arch}.pt"
    torch.save(hf.state_dict(), path)
    return path


def _train_log_losses(run: Path) -> list:
    return [r["loss"] for r in map(json.loads, (run / "train_log.jsonl").read_text().splitlines())
            if "loss" in r]


@pytest.mark.parametrize("case", ["t5", "bpe", "pretrained", "attn_saved"])
def test_cli_runs_what_was_refused(tmp_path, monkeypatch, capsys, case):
    """What `train-combined` refused before this slice now trains end to
    end: `--arch t5 --pretrained`, `--tokenizer` (the shipped BPE; its
    manifest rebuilds the same tokenizer), `--pretrained` (with a zero
    learning rate the best checkpoint's encoder is the imported weights,
    bit for bit) and `--remat-policy attn_saved` (the same step losses,
    bit for bit, as "full")."""
    from deepdfa_tpu.data.tokenizer import BpeTokenizer as JBpe
    from deepdfa_tpu_torch.data.tokenizer import BPE_C_DIR, BpeTokenizer, bpe_files
    from deepdfa_tpu_torch.models import t5 as tt5, transformer as ttfm
    from deepdfa_tpu_torch.serve.cascade import load_model_setup
    from deepdfa_tpu_torch.train import CheckpointManager

    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    _, tcfg = _cfgs()
    cfg_path = _processed_dir(tmp_path, tcfg)
    run = tmp_path / "runs" / "port-combined"
    base = ["train-combined", "--config", str(cfg_path), "--device", "cpu", "--max-length", "64",
            "--encoder", "tiny"]
    log = "train.log_every_steps=1"  # overrides go last: they are the positionals
    if case in ("t5", "pretrained"):
        arch = "t5" if case == "t5" else "roberta"
        sd = torch.load(_hf_state_dict(tmp_path, arch), weights_only=True)
        cli.main([*base, "--arch", arch, "--pretrained", str(tmp_path / f"hf_{arch}.pt"), log,
                  "train.optim.learning_rate=0.0"])
        family = "t5" if arch == "t5" else "combined"
        _, mcfg, _ = load_model_setup(run, family)
        want = (tt5 if arch == "t5" else ttfm).params_from_hf_torch(mcfg.encoder, sd)
        best = CheckpointManager(run / cli.COMBINED_CHECKPOINTS_DIR).restore("best")["model"]
        got = {k[len("encoder."):]: v for k, v in best.items() if k.startswith("encoder.")}
        assert set(got) == {k for k in want if not k.startswith("pooler_")}
        assert all(torch.equal(got[k], want[k]) for k in got)
    elif case == "bpe":
        cli.main([*base, "--tokenizer", str(BPE_C_DIR), log])
        tok, mcfg, max_length = load_model_setup(run, "combined")
        assert isinstance(tok, BpeTokenizer) and max_length == 64
        assert mcfg.encoder.vocab_size == tok.vocab_size
        text = _corpus()[0][3]
        assert np.array_equal(tok.encode(text, 64), JBpe(*bpe_files(BPE_C_DIR)).encode(text, 64))
        assert np.isfinite(_train_log_losses(run)).all()
    else:
        cli.main([*base, log, 'run_name="full"'])
        cli.main([*base, "--remat-policy", "attn_saved", log, 'run_name="saved"'])
        full = _train_log_losses(tmp_path / "runs" / "full")
        assert full and _train_log_losses(tmp_path / "runs" / "saved") == full
    assert "best:" in capsys.readouterr().out


@pytest.mark.parametrize("what", ["dp2", "resilience", "obs", "ep"])
def test_trainer_refuses_what_the_port_does_not_run(what):
    """A mesh beyond one card is refused. The resilient runtime and the
    obs instruments run in the combined trainer since the runtime-hooks
    slice (tests/test_torch_resilience.py, test_torch_obs.py); the
    generation trainer still refuses them."""
    from deepdfa_tpu_torch.models import GenConfig, T5Config
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    _, tmcfg = _model_cfgs()
    train = {"dp2": {"mesh": {"dp": 2}}, "resilience": {"resilience": {"enabled": True}},
             "ep": {"mesh": {"dp": 1, "ep": 2}}}
    _, tcfg = _cfgs(**train.get(what, {}))
    if what == "obs":
        tcfg = tconfig.apply_overrides(tcfg, ["obs.metrics=true"])
    if what == "ep":
        # the MoE adapter runs (tests/test_torch_moe.py); an ep mesh over it
        # is multi-device work
        tmcfg = dataclasses.replace(tmcfg, moe_experts=4)
    if what in ("resilience", "obs"):
        CombinedTrainer(tcfg, tmcfg, device="cpu")
        with pytest.raises(NotImplementedError, match="item 10"):
            GenTrainer(tcfg, GenConfig(encoder=T5Config()), device="cpu")
        return
    with pytest.raises(NotImplementedError):
        CombinedTrainer(tcfg, tmcfg, device="cpu")


def test_trainer_takes_attn_saved_for_the_t5_family():
    """The T5 family under remat_policy="attn_saved": a training step's
    loss and every gradient equal "full"'s to the bit."""
    from deepdfa_tpu_torch.models import DefectConfig, T5Config

    _, tcfg = _cfgs()
    batch = _batches(True)[1].to("cpu")
    out = {}
    for policy in ("full", "attn_saved"):
        tmcfg = DefectConfig(encoder=T5Config.tiny(remat_policy=policy, dropout_rate=0.1),
                             graph_hidden_dim=8, graph_n_steps=3, graph_input_dim=INPUT_DIM)
        trainer = CombinedTrainer(tcfg, tmcfg, total_steps=4, device="cpu")
        state = trainer.init_state(seed=3)
        loss = trainer.forward_loss(state, batch, fold_seed(9, 0))
        loss.backward()
        out[policy] = (loss.detach(), {k: p.grad.clone() for k, p in state.model.named_parameters()
                                       if p.grad is not None})
    (l1, g1), (l2, g2) = out["full"], out["attn_saved"]
    assert torch.equal(l1, l2) and g1.keys() == g2.keys() and len(g1) > 10
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


def test_encoder_seeds_fold_per_layer_and_site():
    """The encoder's masks differ per layer (each folds its own seed),
    and a given key reproduces them."""
    enc = RobertaEncoder(TransformerConfig.tiny(**_enc_kw(dropout_rate=0.5)),
                         generator=torch.Generator().manual_seed(2))
    ids = torch.from_numpy(_corpus()[1][:4])
    with torch.no_grad():
        a, b = enc.encode(ids, dropout_key=3), enc.encode(ids, dropout_key=3)
        c = enc.encode(ids, dropout_key=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len({fold_seed(3, 1, i) for i in range(4)} | {fold_seed(3, 0)}) == 5
