"""The GGNN at `model.param_dtype="bfloat16"` in the port against the
reference: the same bf16 weights (moved by `models/convert.py` bit for
bit) through both models, their gradients and three AdamW steps against
optax, the checkpoint round trip, and serving (the registry, `cli
score`'s drive and a `tag@int8` entry over a bf16 checkpoint).

Tolerances: with the reference's GGNN kernel path (`ggnn_kernel=true`,
which casts the bf16 weights and state up to fp32 as the port always
does) the logits 1e-5; against its lax path, which computes in bf16,
5e-2. Gradients are bf16 leaves on both sides, formed in fp32 and
rounded once: within 1e-2 of each leaf's scale (a bf16 ulp is 2^-8 =
3.9e-3). Three AdamW steps (bf16 moments on both sides): losses and
parameters within 5e-2. Conversion and checkpoints: exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import optax  # noqa: E402

from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu.serve import quant as ref_quant  # noqa: E402
from deepdfa_tpu.train import losses as jlosses, state as jstate  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.models.convert import _t  # noqa: E402
from deepdfa_tpu_torch.serve import quant  # noqa: E402
from deepdfa_tpu_torch.train import CheckpointManager, GraphTrainer  # noqa: E402
from tests.test_torch_train import VOCAB, _batch_pair, _cfgs  # noqa: E402

LOGIT_TOL = 1e-5
LAX_TOL = POLICY_TOL = 5e-2
GRAD_TOL = 1e-2
BF16 = "bfloat16"


def _leaf_errors(got, want):
    """max |got - want| / max |want| per leaf, in fp32, the scale floored
    at 1e-3 of the largest magnitude over all leaves."""
    want = {k: v.float().numpy() for k, v in want.items()}
    got = {k: v.float().numpy() for k, v in got.items()}
    floor = 1e-3 * max(float(np.abs(v).max()) for v in want.values())
    return {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), floor)
            for k, w in want.items()}


def _models(ggnn_kernel: bool):
    jcfg, tcfg = _cfgs()
    jmodel = JDeepDFA.from_config(jcfg.model, input_dim=VOCAB, ggnn_kernel=ggnn_kernel,
                                  param_dtype=jnp.bfloat16)
    jb, tb = _batch_pair(np.random.default_rng(8))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(4), jb))
    assert {np.asarray(x).dtype.name for x in jax.tree.leaves(params)} == {BF16}
    cfg = tconfig.apply_overrides(tcfg, [f"model.param_dtype={BF16}"])
    port = DeepDFA.from_config(cfg.model, VOCAB)
    port.load_state_dict(from_jax_params(params), strict=True)
    return jmodel, params, jb, port, tb.to("cpu"), cfg


@pytest.mark.parametrize("ggnn_kernel", [True, False], ids=["kernel", "lax"])
def test_bf16_model_matches_reference(ggnn_kernel):
    jmodel, params, jb, port, tb, _ = _models(ggnn_kernel)
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}
    want = np.asarray(jmodel.apply(params, jb), np.float32)
    with torch.inference_mode():
        got = port(tb)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    tol = LOGIT_TOL if ggnn_kernel else LAX_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _loss_fn(jmodel, jb):
    def loss(p):
        logits = jmodel.apply(p, jb)
        per = jlosses.bce_elements(logits, jlosses.graph_labels(jb), 1.0)
        m = jnp.asarray(jb.graph_mask, jnp.float32)
        return (per * m).sum() / jnp.maximum(m.sum(), 1.0)

    return loss


def test_bf16_grads_are_bf16_leaves_matching_reference():
    jmodel, params, jb, port, tb, cfg = _models(True)
    want_loss, want = jax.value_and_grad(_loss_fn(jmodel, jb))(params)
    want = from_jax_params(jax.tree.map(np.asarray, want))
    trainer = GraphTrainer(port, cfg, device="cpu")
    state = trainer.init_state(params=from_jax_params(params))
    loss = trainer.forward_loss(state, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.bfloat16}
    assert {v.dtype for v in want.values()} == {torch.bfloat16}
    errs = _leaf_errors(grads, want)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_bf16_adamw_three_steps_match_optax():
    """The port's AdamW keeps its moments in bf16, as optax does; three
    updates on the same batch from the same weights."""
    jcfg, _ = _cfgs(optim={"name": "adamw", "learning_rate": 1e-2, "weight_decay": 1e-2})
    _, tcfg = _cfgs(optim={"name": "adamw", "learning_rate": 1e-2, "weight_decay": 1e-2})
    jmodel, params, jb, _, tb, _ = _models(True)
    cfg = tconfig.apply_overrides(tcfg, [f"model.param_dtype={BF16}"])
    tx = jstate.make_optimizer(jcfg.train.optim, total_steps=3)
    opt_state = tx.init(params)
    loss_fn = jax.jit(jax.value_and_grad(_loss_fn(jmodel, jb)))
    trainer = GraphTrainer(DeepDFA.from_config(cfg.model, VOCAB), cfg, device="cpu")
    state = trainer.init_state(params=from_jax_params(params))
    jl, tl = [], []
    for _ in range(3):
        loss, grads = loss_fn(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        jl.append(float(loss))
        tl.append(float(trainer.train_step(state, tb)))
    moments = [s["exp_avg"].dtype for s in state.optimizer.state.values()]
    assert moments and set(moments) == {torch.bfloat16}
    np.testing.assert_allclose(tl, jl, rtol=POLICY_TOL, atol=POLICY_TOL)
    want = from_jax_params(jax.tree.map(np.asarray, params))
    got = trainer.model.state_dict()
    assert {v.dtype for v in got.values()} == {torch.bfloat16}
    for k, w in want.items():
        np.testing.assert_allclose(got[k].float().numpy(), w.float().numpy(), rtol=0,
                                   atol=POLICY_TOL, err_msg=k)


def test_checkpoint_round_trip_keeps_bf16(tmp_path):
    _, _, _, port, tb, cfg = _models(True)
    trainer = GraphTrainer(port, cfg, device="cpu")
    state = trainer.init_state(seed=0)
    ckpts = trainer.make_checkpoints(tmp_path / "ckpt")
    trainer.fit(state, lambda epoch: [tb], checkpoints=ckpts, max_epochs=1)
    restored = CheckpointManager(tmp_path / "ckpt").restore("epoch-0000")["model"]
    saved = trainer.model.state_dict()
    assert restored.keys() == saved.keys()
    for k, v in restored.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, saved[k].cpu()), k
    fresh = DeepDFA.from_config(cfg.model, VOCAB)
    fresh.load_state_dict(restored)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), restored.values()))


def test_convert_moves_bf16_bits_exactly():
    raw = np.array([0x0000, 0x8000, 0x0001, 0x807F, 0x3F80, 0xC2F7, 0x7F7F, 0x7F80, 0xFF80,
                    0x7FC1, 0x1234], np.uint16)
    a = raw.view(ml_dtypes.bfloat16)  # zero, -0, subnormals, 1, -123.5, max, +-inf, a nan
    t = _t(a)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), raw)
    _, params, _, _, _, _ = _models(True)
    sd = from_jax_params(params)
    gate = params["params"]["pooling"]["gate_nn"]["kernel"]
    assert np.array_equal(sd["pooling.gate_nn.weight"].T.contiguous().view(torch.int16).numpy(),
                          np.asarray(gate).view(np.int16))
    assert _t(np.ones(3, np.float32)).dtype == torch.float32


def test_int8_entry_of_a_bf16_checkpoint_is_the_reference():
    """The reference's quantizer passes ml_dtypes bf16 leaves through
    (numpy does not count them as floats) and serving upcasts them: the
    port's `@int8` tree of a bf16 state dict is those bf16 tensors, and
    the quantized model scores what the bf16 model scores."""
    _, params, _, port, tb, _ = _models(True)
    ref_tree = ref_quant.quantize_params(params)
    assert not any(ref_quant.is_quantized_leaf(x) for x in jax.tree.leaves(
        ref_tree, is_leaf=ref_quant.is_quantized_leaf))
    qtree = quant.quantize_params(port.state_dict())
    want = from_jax_params(jax.tree.map(np.asarray, ref_tree))
    assert qtree.keys() == want.keys()
    for k, v in qtree.items():
        assert not quant.is_quantized_leaf(v) and v.dtype == torch.bfloat16
        assert torch.equal(v, want[k]), k
    deq = quant.dequantize_params(qtree)
    assert {v.dtype for v in deq.values()} == {torch.float32}
    assert quant.quant_report(port.state_dict(), qtree).bytes_fraction == 1.0
    served = quant.QuantizedModel(DeepDFA.from_config(_models(True)[5].model, VOCAB), qtree)
    with torch.inference_mode():
        got, plain = served(tb), port.eval()(tb)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_registry_and_score_serve_a_bf16_run(tmp_path, monkeypatch):
    """A bf16 run trained by the port serves through the registry and
    `run_score` (the `cli score` drive), plain and `@int8`, on the CPU."""
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.serve.driver import build_smoke_run, run_score

    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cfg, run_dir, src = build_smoke_run(n_examples=12, max_epochs=1, device="cpu",
                                        extra_overrides=[f"model.param_dtype={BF16}"])
    sources = [(p.name, p.read_text()) for p in sorted(src.glob("*.c"))[:4]]
    plain = run_score(cfg, run_dir, sources, out_path=run_dir / "plain.jsonl", device="cpu")
    int8 = run_score(config_mod.apply_overrides(cfg, ['serve.checkpoint="best@int8"']),
                     run_dir, sources, out_path=run_dir / "int8.jsonl", device="cpu")
    assert plain["serve_scored"] == int8["serve_scored"] == 4
    assert int8["quant"]["quant_drift"] <= LOGIT_TOL
    rows = [(run_dir / f"{n}.jsonl").read_text().splitlines() for n in ("plain", "int8")]
    assert len(rows[0]) == len(rows[1]) == 4
