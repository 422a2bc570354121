"""The port's CodeT5+DeepDFA training path on the CPU against the
reference: the gradient of every leaf (the relative-position table
included, whose gradient comes through dbias) against `jax.grad` of the
reference's loss, a 4-step SGD trajectory of the reference
`CombinedTrainer` with a `DefectConfig`, remat on and off, graph-encoder
transfer into a `DefectModel`, and `cli train-combined --arch t5` on a
reference-written processed dir.

The reference runs its flash kernel (bias, dbias) in interpret mode
(DEEPDFA_TPU_FLASH_INTERPRET=1). Parity runs at dropout 0: the
reference's masks come from `jax.random`, the port's from its own seeds.
Tolerances: gradients fp32 within 1e-4 of each leaf's scale (floored at
1e-3 of the largest gradient, as tests/test_torch_combined_train.py
holds them); the SGD losses rtol 1e-4; remat on and off bit-equal."""

import dataclasses
import json
import pickle

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
from deepdfa_tpu.models import t5 as jt5  # noqa: E402
from deepdfa_tpu.parallel import make_mesh  # noqa: E402
from deepdfa_tpu.train.combined_loop import CombinedTrainer as JTrainer  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.data import text as ttext  # noqa: E402
from deepdfa_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec as TSpec  # noqa: E402
from deepdfa_tpu_torch.models import (  # noqa: E402
    DeepDFA,
    DefectConfig,
    DefectModel,
    T5Config,
    from_jax_defect_params,
)
from deepdfa_tpu_torch.nn.dropout import fold_seed  # noqa: E402
from deepdfa_tpu_torch.train import CombinedTrainer  # noqa: E402

VOCAB = 256
BUCKETS = (16, 32, 64)
TOKEN_BUDGET = 256  # rows per bucket: 16, 8, 4
NODE_BUDGET, EDGE_BUDGET = 512, 2048
INPUT_DIM = 52
WORDS = ("int", "char", "*", "buf", "=", "malloc", "(", "len", ")", ";", "if", "{",
         "}", "return", "memcpy", "src", "0", "42", "+", "-", "[", "]", "free", "n")
CFG = {
    "run_name": "port-t5",
    "data": {
        "feat": {"limit_all": INPUT_DIM - 2, "limit_subkeys": INPUT_DIM - 2},
        "undersample": False,
        "batch": {"graphs_per_batch": 16, "node_budget": NODE_BUDGET,
                  "edge_budget": EDGE_BUDGET},
    },
    "model": {"hidden_dim": 8, "n_steps": 5},
    "train": {"max_epochs": 1, "monitor": "val_f1", "monitor_mode": "max", "seed": 5,
              "optim": {"name": "sgd", "learning_rate": 0.05, "weight_decay": 0.0,
                        "warmup_frac": 0.0, "grad_clip_norm": 1.0},
              "mesh": {"dp": 1}},
}


@pytest.fixture
def flash_interpret(monkeypatch):
    monkeypatch.setenv("DEEPDFA_TPU_FLASH_INTERPRET", "1")


def _cfgs():
    return jconfig.from_dict(CFG), tconfig.from_dict(CFG)


def _model_cfgs(dropout=0.0, **enc):
    """(reference, port) configs. The reference runs without remat (its
    interpret-mode kernel cannot sit under `jax.checkpoint`), the port
    with it (remat on and off give the same bits, tested below)."""
    base = dict(vocab_size=VOCAB, dropout_rate=dropout)
    base.update(enc)
    kw = dict(graph_hidden_dim=8, graph_input_dim=INPUT_DIM)
    return (jt5.DefectConfig(encoder=jt5.T5Config.tiny(**{**base, "remat": False}), **kw),
            DefectConfig(encoder=T5Config.tiny(**base), **kw))


def _graph_kw(rng, gid):
    n = int(rng.integers(2, 30))
    e = int(rng.integers(1, 2 * n))
    return dict(graph_id=gid, node_feats=rng.integers(0, INPUT_DIM, (n, 4)).astype(np.int32),
                node_vuln=np.zeros((n,), np.int32),
                edge_src=rng.integers(0, n, (e,)).astype(np.int32),
                edge_dst=rng.integers(0, n, (e,)).astype(np.int32), label=float(gid % 2))


def _corpus(n=40, seed=0):
    """(texts, T5-framed ids [n, 64], labels, graph kwargs by id; every
    5th row has no graph)."""
    rng = np.random.default_rng(seed)
    texts = [" ".join(str(w) for w in rng.choice(WORDS, int(rng.integers(1, 62))))
             for _ in range(n)]
    ids = HashTokenizer(vocab_size=VOCAB, t5_frame=True).batch_encode(texts, 64)
    labels = [int(i % 3 == 0) for i in range(n)]
    graphs = {i: _graph_kw(rng, i) for i in range(n) if i % 5}
    return texts, ids, labels, graphs


def _batches(port: bool):
    _, ids, labels, graphs = _corpus()
    sel = list(range(len(labels)))
    text, spec = (ttext, TSpec) if port else (jtext, JSpec)
    return list(text.bucketed_collate_batches(
        {i: ids[i] for i in sel}, {i: labels[i] for i in sel}, sel,
        {i: spec(**kw) for i, kw in graphs.items()}, BUCKETS, TOKEN_BUDGET, 1,
        NODE_BUDGET, EDGE_BUDGET, pad_id=0))


def _leaf_errors(got: dict, want: dict) -> dict:
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


def test_defect_gradients_match_reference(flash_interpret):
    """Every leaf's gradient, rel_bias included (through dbias and the
    one-hot product), against jax.grad of the reference's masked mean
    cross-entropy on a bucketed batch with graphs."""
    jmcfg, tmcfg = _model_cfgs()
    params = jax.tree.map(np.asarray, jt5.init_defect_params(jmcfg, jax.random.key(4)))
    ref_b, port_b = _batches(False)[2], _batches(True)[2].to("cpu")
    local = jax.tree.map(lambda x: x[0], ref_b)

    def loss(p):
        logits = jt5.defect_forward(jmcfg, p, local.input_ids, local.graphs, local.has_graph)
        per = optax.softmax_cross_entropy_with_integer_labels(logits, local.labels)
        m = local.row_mask.astype(per.dtype)
        return (per * m).sum() / jnp.maximum(m.sum(), 1.0)

    want_loss, jgrads = jax.value_and_grad(loss)(params)
    want = {k: v.numpy() for k, v in from_jax_defect_params(
        jax.tree.map(np.asarray, jgrads)).items()}
    _, tcfg = _cfgs()
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=1, device="cpu")
    state = trainer.init_state(params=from_jax_defect_params(params))
    assert isinstance(state.model, DefectModel)
    got_loss = trainer.forward_loss(state, port_b, None)
    got_loss.backward()
    got = {k: p.grad.numpy() for k, p in state.model.named_parameters()}
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= 1e-4, errs
    assert np.abs(got["encoder.rel_bias"]).max() > 0


def test_sgd_trajectory_matches_reference_trainer(flash_interpret):
    """4 SGD steps (clip 1.0) of the reference CombinedTrainer with a
    DefectConfig (one-device mesh) and the port's, from the same weights
    over the same batches."""
    jcfg, tcfg = _cfgs()
    jmcfg, tmcfg = _model_cfgs()
    jtr = JTrainer(jcfg, jmcfg, mesh=make_mesh(jcfg.train.mesh, devices=jax.devices()[:1]),
                   total_steps=4)
    jstate = jtr.init_state()
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=4, device="cpu")
    state = trainer.init_state(params=from_jax_defect_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))))
    ref_bs, port_bs = _batches(False), _batches(True)
    jl, tl = [], []
    for i in range(4):
        jstate, loss = jtr.train_step(jstate, jtr.place_batch(ref_bs[i]), jax.random.key(i))
        jl.append(float(loss))
        tl.append(float(trainer.train_step(state, port_bs[i].to("cpu"), fold_seed(0, i))))
    assert len(set(np.round(tl, 5))) > 1
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    want = {k: v.numpy() for k, v in from_jax_defect_params(
        jax.tree.map(np.asarray, jax.device_get(jstate.params))).items()}
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= 1e-4, errs


def _grads(model, batch, key):
    model.zero_grad(set_to_none=True)
    logits = model(batch.input_ids, batch.graphs, batch.has_graph, dropout_key=key)
    loss = torch.nn.functional.cross_entropy(logits, batch.labels.long(), reduction="none")
    (loss * batch.row_mask).sum().backward()
    return logits.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


def test_remat_on_and_off_give_bit_equal_gradients():
    """With dropout on, one seed gives the same logits and gradients to
    the bit with remat on and off (the checkpointed layers redraw their
    masks from their seeds; the bias is built once, outside them); a new
    seed gives new masks; without a key the training forward is the eval
    forward."""
    batch = _batches(True)[1].to("cpu")
    _, tm = _model_cfgs(0.1)
    model = DefectModel(tm, generator=torch.Generator().manual_seed(0)).train()
    no_remat = DefectModel(dataclasses.replace(
        tm, encoder=dataclasses.replace(tm.encoder, remat=False))).train()
    no_remat.load_state_dict(model.state_dict())
    l1, g1 = _grads(model, batch, fold_seed(7, 0))
    l2, g2 = _grads(no_remat, batch, fold_seed(7, 0))
    assert torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k]) for k in g1)
    assert g1["encoder.rel_bias"].abs().sum() > 0
    l3, _ = _grads(model, batch, fold_seed(7, 1))
    assert not torch.equal(l1, l3)
    with torch.inference_mode():
        clean = model.eval()(batch.input_ids, batch.graphs, batch.has_graph)
    assert not torch.equal(l1, clean)  # dropout ran
    assert torch.equal(model.train()(batch.input_ids, batch.graphs, batch.has_graph).detach(),
                       clean)


def test_bf16_defect_model_gives_fp32_gradients():
    _, tm = _model_cfgs(0.1, dtype="bfloat16")
    model = DefectModel(tm, generator=torch.Generator().manual_seed(1)).train()
    logits, grads = _grads(model, _batches(True)[0].to("cpu"), 11)
    assert logits.dtype == torch.float32
    for name, p in model.named_parameters():
        assert p.dtype == grads[name].dtype == torch.float32, name
        assert torch.isfinite(grads[name]).all(), name
    assert grads["encoder.rel_bias"].abs().sum() > 0


def test_graph_encoder_transfer_and_freeze_into_a_defect_model():
    _, tcfg = _cfgs()
    _, tmcfg = _model_cfgs(0.1)
    trainer = CombinedTrainer(tcfg, tmcfg, total_steps=3, freeze_graph=True, device="cpu")
    state = trainer.init_state()
    dd = DeepDFA(INPUT_DIM, 8, 5, concat_all_absdf=True,
                 generator=torch.Generator().manual_seed(9))
    state = trainer.load_graph_encoder_params(state, dd.state_dict())
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for i, b in enumerate(_batches(True)[:3]):
        trainer.train_step(state, b.to("cpu"), fold_seed(1, i))
    after = state.model.state_dict()
    for k in before:
        assert torch.equal(after[k], before[k]) == k.startswith("graph."), k


# -- the command line -------------------------------------------------------------


def _processed_dir(tmp_path, tcfg):
    out = tmp_path / "processed" / "bigvul"
    out.mkdir(parents=True)
    texts, _, labels, graphs = _corpus()
    rows = [jpipeline.Example(id=i, code=t, label=float(y), vuln_lines=frozenset({1}))
            for i, (t, y) in enumerate(zip(texts, labels))]
    with (out / "examples.pkl").open("wb") as f:
        pickle.dump(rows, f)
    JStore(out / cli.graphs_dirname(tcfg)).write([JSpec(**kw) for kw in graphs.values()])
    splits = {str(i): ("train", "train", "train", "val", "test")[i % 5] for i in range(40)}
    (out / "splits.json").write_text(json.dumps(splits))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(CFG))
    return cfg_path


def test_cli_train_combined_arch_t5_end_to_end(tmp_path, monkeypatch, capsys):
    """`train-combined --arch t5 --encoder tiny --device cpu` over a
    reference-written processed dir: one epoch over the three buckets,
    validation, a checkpoint of a DefectModel."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    _, tcfg = _cfgs()
    cfg_path = _processed_dir(tmp_path, tcfg)
    cli.main(["train-combined", "--arch", "t5", "--encoder", "tiny", "--config", str(cfg_path),
              "--device", "cpu", "--max-length", "64", "train.log_every_steps=1",
              f"data.seq_buckets={json.dumps(list(BUCKETS))}",
              f"data.token_budget={TOKEN_BUDGET}"])
    assert "best:" in capsys.readouterr().out
    run = tmp_path / "runs" / "port-t5"
    records = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch" in r]
    rec = epochs[0]
    assert [r["epoch"] for r in epochs] == [0]
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"])
    assert sorted(rec["step_signatures"]) == ["T16xR16xG16", "T32xR8xG8", "T64xR4xG4"]
    manifest = json.loads((run / cli.COMBINED_CHECKPOINTS_DIR / "manifest.json").read_text())
    assert manifest["best"] is not None
    tok, mcfg = cli.combined_setup(cli.build_parser().parse_args(
        ["train-combined", "--arch", "t5", "--max-length", "64"]), tcfg)
    assert isinstance(mcfg, DefectConfig) and tok.pad_id == 0
    assert mcfg.encoder.max_sequence_length == 64 and mcfg.encoder.pad_token_id == 0
    from deepdfa_tpu_torch.train import CheckpointManager

    best = CheckpointManager(run / cli.COMBINED_CHECKPOINTS_DIR).restore("best")["model"]
    DefectModel(mcfg).load_state_dict(best)  # strict: the checkpoint is a DefectModel
    with pytest.raises(SystemExit):
        cli.main(["train-combined", "--arch", "t5", "--encoder", "codebert-base",
                  "--device", "cpu"])
    # a BPE vocabulary frames RoBERTa's specials: refused for t5, as the
    # reference refuses it (`--arch t5 --pretrained` trains: see
    # test_torch_combined_train.py::test_cli_runs_what_was_refused[t5])
    with pytest.raises(SystemExit, match="hash tokenizer"):
        cli.main(["train-combined", "--arch", "t5", "--device", "cpu", "--tokenizer", "vocab"])
