"""The DeepDFA model, serving and `cli train` under the mxu scatter
(`model.ggnn_kernel_scatter="mxu"`) on the CPU, against the reference's
`DeepDFA(ggnn_kernel_scatter="mxu")` (its Pallas kernel in interpret
mode) and the port's own per-step path.

- the logits at rtol = atol = 1e-4 over N_STEPS = 3 steps (bf16 and
  int8 round or quantize each step's rows anew; three steps keep a flip
  between the packages' fp32 orders within that bound);
- `model.ggnn_kernel_block_edges` reaches the scatter through the
  config;
- `score_graphs` in one batch gives the model's own probabilities, and
  `cli train` under int8 mxu gives the per-step run's losses fused.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from deepdfa_tpu.graphs import pack as jpack  # noqa: E402
from deepdfa_tpu.models import DeepDFA as JDeepDFA  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.graphs import pack as tpack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.serve import score_graphs  # noqa: E402
from deepdfa_tpu_torch.serve.driver import SUMMARY_KEYS  # noqa: E402

from test_torch_ggnn_fused import _store  # noqa: E402
from test_torch_ggnn_policy import INPUT_DIM, NODE_BUDGET, _model_specs  # noqa: E402

LOGITS_TOL = 1e-4
N_STEPS = 3


@functools.lru_cache(maxsize=None)
def _ref_model(accum, block_edges, unroll="per_step"):
    model = JDeepDFA(input_dim=INPUT_DIM, hidden_dim=8, n_steps=N_STEPS, ggnn_kernel=True,
                     ggnn_kernel_accum=accum, ggnn_kernel_scatter="mxu",
                     ggnn_kernel_block_edges=block_edges, ggnn_kernel_unroll=unroll)
    init = jpack(_model_specs(3)[0], 4, NODE_BUDGET, 2048)
    params = jax.tree.map(np.asarray, model.init(jax.random.key(4), init))
    return jax.jit(model.apply), params


@pytest.mark.parametrize("accum, unroll", [("fp32", "per_step"), ("bf16", "per_step"),
                                           ("int8", "per_step"), ("int8", "fused")])
def test_deepdfa_logits_match_reference(accum, unroll):
    apply, params = _ref_model(accum, 128, unroll)
    ref, port = _model_specs(4)
    jb = jpack(ref, 4, NODE_BUDGET, 2048)
    tb = tpack(port, 4, NODE_BUDGET, 2048).to("cpu")
    model = DeepDFA(INPUT_DIM, 8, N_STEPS, ggnn_kernel=True, ggnn_kernel_accum=accum,
                    ggnn_kernel_scatter="mxu", ggnn_kernel_block_edges=128,
                    ggnn_kernel_unroll=unroll)
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.inference_mode():
        got = model(tb).numpy()
    np.testing.assert_allclose(got, np.asarray(apply(params, jb)), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)


def test_block_edges_in_the_config_moves_int8_like_the_reference():
    """model.ggnn_kernel_block_edges reaches the mxu scatter through
    DeepDFA.from_config: under int8 mxu it changes the logits (as the
    reference's propagate does, test_torch_ggnn_mxu.py); under fold it
    changes nothing."""
    _, port = _model_specs(4)
    tb = tpack(port, 4, NODE_BUDGET, 2048).to("cpu")
    _, params = _ref_model("int8", 128)
    logits = {}
    for scatter in ("mxu", "fold"):
        for be in (128, 512):
            cfg = tconfig.apply_overrides(tconfig.Config(), [
                "model.hidden_dim=8", f"model.n_steps={N_STEPS}", "model.ggnn_kernel=true",
                'model.ggnn_kernel_accum="int8"',
                f'model.ggnn_kernel_scatter="{scatter}"', f"model.ggnn_kernel_block_edges={be}"])
            model = DeepDFA.from_config(cfg.model, INPUT_DIM)
            assert model.ggnn.block_edges == be and model.ggnn.scatter == scatter
            model.load_state_dict(from_jax_params(params), strict=True)
            with torch.inference_mode():
                logits[scatter, be] = model(tb).numpy()
    assert not np.array_equal(logits["mxu", 128], logits["mxu", 512])
    np.testing.assert_array_equal(logits["fold", 128], logits["fold", 512])


@pytest.mark.parametrize("unroll", ["per_step", "fused"])
def test_score_graphs_under_mxu(unroll):
    """score_graphs on the CPU under (int8, mxu): every request scored in
    one batch, the probabilities of the model's own forward on that batch
    (rtol 1e-5: the same function on the same padded batch), and no
    kernel counted (the plain path)."""
    _, specs = _model_specs(6)
    cfg = tconfig.apply_overrides(tconfig.Config(), [
        "model.hidden_dim=8", "model.n_steps=3", "model.ggnn_kernel=true",
        'model.ggnn_kernel_accum="int8"', 'model.ggnn_kernel_scatter="mxu"',
        f'model.ggnn_kernel_unroll="{unroll}"', "serve.max_batch_graphs=8",
        "serve.node_budget=512", "serve.edge_budget=2048", "serve.max_batch_delay_ms=1000.0"])
    model = DeepDFA.from_config(cfg.model, INPUT_DIM, generator=torch.Generator().manual_seed(0))
    summary = score_graphs(model, specs, cfg, device="cpu")
    # one batch: under int8 mxu a score depends on its batch's edge blocks
    assert summary["serve_scored"] == len(specs) and summary["serve_batches"] == 1
    assert all(summary[k] == 0 for k in SUMMARY_KEYS.values())
    with torch.inference_mode():
        want = torch.sigmoid(model(tpack(specs, 8, 512, 2048).to("cpu"))).numpy()[:len(specs)]
    np.testing.assert_allclose(summary["probs"], want, rtol=1e-5, atol=1e-6)


def test_cli_train_under_mxu_matches_per_step(tmp_path, monkeypatch, capsys):
    """`cli train` with model.ggnn_kernel_scatter=mxu (int8, edge block
    128) trains, and the fused unroll logs the per-step run's losses bit
    for bit."""
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    path = _store(tmp_path)
    losses = {}
    for unroll in ("per_step", "fused"):
        run = f"mxu-{unroll}"
        cli.main(["train", "--config", str(path), "--device", "cpu", "model.ggnn_kernel=true",
                  'model.ggnn_kernel_accum="int8"', 'model.ggnn_kernel_scatter="mxu"',
                  "model.ggnn_kernel_block_edges=128", f'model.ggnn_kernel_unroll="{unroll}"',
                  f'run_name="{run}"'])
        assert "best:" in capsys.readouterr().out
        saved = tconfig.load(tmp_path / "runs" / run / "config.json")
        assert (saved.model.ggnn_kernel_scatter, saved.model.ggnn_kernel_block_edges) == \
            ("mxu", 128)
        log = (tmp_path / "runs" / run / "train_log.jsonl").read_text().splitlines()
        losses[unroll] = [json.loads(x)["train_loss"] for x in log if "epoch" in json.loads(x)]
    assert len(losses["fused"]) == 2 and all(np.isfinite(losses["fused"]))
    assert losses["fused"] == losses["per_step"]
