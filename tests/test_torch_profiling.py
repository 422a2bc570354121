"""The counted cost (deepdfa_tpu_torch/obs/cost.py, the kernels' work
formulas, eval/profiling.py) on the CPU: the flagship GGNN's counted
FLOPs held against the reference's `eval/profiling.py:compiled_cost`
(XLA's cost analysis of the lax path) within 5%, forward and training
step; the formulas equal to the ones `chip_smoke.py` computed its bounds
from before they moved into the package; every kernel's report under a
count; Table 5's record through `cli test --profile`, and the ledger's
sites through `cli score`."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.eval import profiling  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec, GraphStore, pack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA, from_jax_params  # noqa: E402
from deepdfa_tpu_torch.nn import flash_attention as fa  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as gk  # noqa: E402
from deepdfa_tpu_torch.nn import setops  # noqa: E402
from deepdfa_tpu_torch.obs import cost, ledger  # noqa: E402

FLAGSHIP = "configs/bigvul_deepdfa.json"
COUNT_TOL = 0.05


def _specs(spec_cls, G, N, E, vocab=1000, seed=0):
    """G graphs filling N nodes and E edges (self loops included) of one
    batch, the reference's scratch batch."""
    rng = np.random.default_rng(seed)
    out = []
    for gid in range(G):
        n = N // G - 1
        e = E // G - n - 1
        out.append(spec_cls(graph_id=gid, node_feats=rng.integers(2, vocab, (n, 4)).astype(np.int32),
                            node_vuln=np.zeros(n, np.int32),
                            edge_src=rng.integers(0, n, e).astype(np.int32),
                            edge_dst=rng.integers(0, n, e).astype(np.int32), label=float(gid % 2)))
    return out


@pytest.mark.parametrize("G, N, E", [(4, 256, 1024), (16, 1024, 4096)], ids=["small", "scratch"])
def test_counted_flops_are_within_5_percent_of_the_references_compiled_cost(G, N, E):
    """The flagship GGNN (hidden 32, 5 steps, d 128, 1000-row tables).
    Forward: the port's count (kernel 1's formula a step + the aten
    products) against XLA's count of the reference's lax path, within
    5%. Training step: the same, after taking out the work the port's
    kernels do that the lax path does not — B3 recomputes the two gate
    products (12*N*d^2 a step) and the message weights' cotangent is a
    product over every edge slot (2*E*d^2*T a step) where the lax path
    multiplies per node (2*N*d^2*T)."""
    import jax
    import jax.numpy as jnp

    from deepdfa_tpu.core import config as jconfig
    from deepdfa_tpu.eval.profiling import compiled_cost as jcompiled_cost
    from deepdfa_tpu.graphs import GraphSpec as JSpec, pack as jpack
    from deepdfa_tpu.models import DeepDFA as JDeepDFA
    from deepdfa_tpu.train import losses as jlosses

    jcfg = jconfig.load(FLAGSHIP)
    jb = jpack(_specs(JSpec, G, N, E), G, N, E)
    jmodel = JDeepDFA.from_config(jcfg.model, input_dim=1002, ggnn_kernel=False)
    params = jmodel.init(jax.random.key(0), jb)

    def jloss(p, b):
        per = jlosses.bce_elements(jmodel.apply(p, b), jlosses.graph_labels(b), 1.0)
        m = jnp.asarray(b.graph_mask, jnp.float32)
        return (per * m).sum() / jnp.maximum(m.sum(), 1.0)

    want_fwd = jcompiled_cost(lambda p, b: jmodel.apply(p, b), params, jb)["flops"]
    want_train = jcompiled_cost(jax.value_and_grad(jloss), params, jb)["flops"]

    cfg = tconfig.load(FLAGSHIP)
    from deepdfa_tpu_torch.train import GraphTrainer

    model = DeepDFA.from_config(cfg.model, 1002)
    trainer = GraphTrainer(model, cfg, device="cpu")
    state = trainer.init_state(params=from_jax_params(jax.tree.map(np.asarray, params)))
    b = pack(_specs(GraphSpec, G, N, E), G, N, E).to("cpu")

    def fwd(batch):
        with torch.inference_mode():
            return model(batch)

    got_fwd = profiling.compiled_cost(fwd, b)["flops"]
    assert abs(got_fwd - want_fwd) <= COUNT_TOL * want_fwd, (got_fwd, want_fwd)

    def step(batch):
        trainer.forward_loss(state, batch).backward()

    _, counted = cost.count_cost(step, b)
    d, steps, t = 4 * cfg.model.hidden_dim, cfg.model.n_steps, cfg.model.n_etypes
    extra = steps * (12 * N * d * d + 2 * E * d * d * t - 2 * N * d * d * t)
    got_train = counted["flops"] - extra
    assert abs(got_train - want_train) <= COUNT_TOL * want_train, (got_train, want_train)
    assert {k: v["launches"] for k, v in counted["kernels"].items()} == {
        "ggnn_step": steps, "gru_bwd": steps, "dmsg": steps}


# -- the formulas, as chip_smoke.py computed its bounds before they moved --------


def _former_step(n, e_live, d, t, with_aggregate):
    flops = 2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d
    weights = t * d * d + t * d + 2 * (3 * d * d + 3 * d)
    nbytes = 4 * (
        n * d * (3 if with_aggregate else 2) + e_live * (1 + t) + (n + 1) + weights
    )
    return flops, nbytes


def _former_gru_bwd(n, d):
    return 36 * n * d * d, 4 * (5 * n * d + 2 * (2 * 3 * d * d + 2 * 3 * d))


def _former_dmsg(n, e_live, d, t, add=False):
    flops = 2 * n * d * d * t + 2 * e_live * d
    nbytes = 4 * ((3 if add else 2) * n * d + e_live * (1 + t) + (n + 1) + t * d * d)
    return flops, nbytes


def _former_policy_step(n, e_live, d, t, accum):
    flops = 2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[accum]
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d) + (t * d if accum == "int8" else 0))
    nbytes = 4 * (2 * n * d + e_live * (1 + t) + (n + 1)) + weights + itemsize * t * d * d
    return flops, nbytes


def _former_fused(n, e_live, d, t, accum, n_steps, chain):
    flops = n_steps * (2 * e_live * d + 2 * n * d * d * t + 12 * n * d * d)
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[accum]
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d)) + itemsize * t * d * d
    nbytes = 4 * ((2 + (n_steps if chain else 0)) * n * d + e_live * (1 + t) + (n + 1)) + weights
    return flops, nbytes


def _former_mxu(n, e_live, d, t, accum, n_steps=1, chain=False):
    msg = n_steps * 2 * e_live * d * d * t
    other = n_steps * (12 * n * d * d + 2 * e_live * d)
    itemsize = {"fp32": 4, "bf16": 2, "int8": 1}[accum]
    weights = 4 * (t * d + 2 * (3 * d * d + 3 * d) + (t * d if accum == "int8" else 0))
    nbytes = (4 * ((2 + (n_steps if chain else 0)) * n * d + e_live * (1 + t) + (n + 1))
              + weights + itemsize * t * d * d)
    return msg, other, nbytes


def _former_gather_sum(n, e_live, b):
    return e_live * b, 4 * (2 * n * b + e_live + n + 1)


def _former_flash(B, H, Tq, Tk_live, D, itemsize, extra_bytes=0, pairs=None):
    flops = 4 * H * D * (Tq * sum(Tk_live) if pairs is None else pairs)
    Tk = max(Tk_live + [1])
    nbytes = (itemsize * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * Tk + 4 * B * H * Tq
              + extra_bytes)
    return flops, nbytes


def _former_flash_bwd(B, H, Tq, Tk_live, D, itemsize, products, out_tokens, extra_bytes=0,
                      pairs=None):
    flops = 2 * products * H * D * (Tq * sum(Tk_live) if pairs is None else pairs)
    Tk = max(Tk_live + [1])
    nbytes = (itemsize * B * H * D * (2 * Tq + 2 * Tk + out_tokens) + 8 * B * H * Tq
              + 4 * B * Tk + extra_bytes)
    return flops, nbytes


GGNN_SHAPES = [(16384, 40884, 128, 1), (16384, 65536, 128, 3), (4096, 3000, 288, 3),
               (200, 0, 32, 1), (1024, 4080, 96, 2)]


@pytest.mark.parametrize("n, e, d, t", GGNN_SHAPES)
def test_ggnn_formulas_equal_the_former_bounds(n, e, d, t):
    for agg in (False, True):
        assert gk.step_work(n, e, d, t, agg) == _former_step(n, e, d, t, agg)
    assert gk.gru_bwd_work(n, d) == _former_gru_bwd(n, d)
    for add in (False, True):
        assert gk.dmsg_work(n, e, d, t, add) == _former_dmsg(n, e, d, t, add)
    for accum in ("fp32", "bf16", "int8"):
        assert gk.policy_step_work(n, e, d, t, accum) == _former_policy_step(n, e, d, t, accum)
        for steps, chain in ((1, False), (5, False), (5, True)):
            assert gk.fused_work(n, e, d, t, accum, steps, chain) == \
                _former_fused(n, e, d, t, accum, steps, chain)
            assert gk.mxu_work(n, e, d, t, accum, steps, chain) == \
                _former_mxu(n, e, d, t, accum, steps, chain)
    assert setops.gather_sum_work(n, e, 64) == _former_gather_sum(n, e, 64)


@pytest.mark.parametrize("B, H, T, lens, D, itemsize, pairs", [
    (16, 12, 512, [512] * 16, 64, 2, None), (64, 12, 128, [100, 128] * 32, 64, 2, None),
    (16, 12, 128, [128] * 16, 64, 4, 16 * 128 * 129 // 2), (3, 2, 40, [1, 17, 40], 32, 4, 9)])
def test_flash_formulas_equal_the_former_bounds(B, H, T, lens, D, itemsize, pairs):
    bias = itemsize * H * T * T
    for extra in (0, bias):
        assert fa.flash_work(B, H, T, lens, D, itemsize, extra, pairs) == \
            _former_flash(B, H, T, lens, D, itemsize, extra, pairs)
        for products, out in ((3, T), (4, 2 * T), (2, 0)):
            assert fa.flash_bwd_work(B, H, T, lens, D, itemsize, products, out, extra, pairs) \
                == _former_flash_bwd(B, H, T, lens, D, itemsize, products, out, extra, pairs)


def test_chip_smoke_bounds_read_the_package_formulas():
    import chip_smoke as cs

    n, e, d, t = 16384, 40884, 128, 1
    assert cs.step_bound(n, e, d, t, True) == cs.roofline(*gk.step_work(n, e, d, t, True))
    assert cs.gru_bwd_bound(n, d) == cs.roofline(*gk.gru_bwd_work(n, d))
    assert cs.dmsg_bound(n, e, d, t, True) == cs.roofline(*gk.dmsg_work(n, e, d, t, True))
    assert cs.fused_bound(n, e, d, t, "bf16", 5, True) == \
        cs.roofline(*gk.fused_work(n, e, d, t, "bf16", 5, True))
    assert cs.gather_sum_bound(n, e, 64) == cs.roofline(*setops.gather_sum_work(n, e, 64))
    assert cs.flash_bound(16, 12, 512, [512] * 16, 64, 2) == cs.roofline(
        *fa.flash_work(16, 12, 512, [512] * 16, 64, 2), cs.PEAK_BF16_FLOPS)
    msg, other, nbytes = gk.mxu_work(n, e, d, t, "int8", 5, True)
    t_ops = (msg / cs.MSG_PEAK["int8"] + other / cs.PEAK_FP32_FLOPS) * 1e3
    assert cs.mxu_bound(n, e, d, t, "int8", 5, True)[0] == max(
        t_ops, nbytes / cs.PEAK_HBM_BYTES * 1e3)
    mask = torch.tensor([[1, 1, 0], [1, 1, 1]], dtype=torch.bool)
    assert cs.live_pairs(torch, mask, 3, True) == fa.live_pairs(mask, 3, True) == 3 + 2 + 6


# -- the reports under a count -------------------------------------------------------


def test_every_kernel_reports_its_formula_and_hides_its_plain_version():
    rng = np.random.default_rng(3)
    n, d, t = 64, 32, 2
    src = torch.from_numpy(rng.integers(0, n, 100).astype(np.int32))
    dst = torch.sort(torch.from_numpy(rng.integers(0, n, 100).astype(np.int32))).values
    mask = torch.arange(100) < 90
    etype = torch.from_numpy(rng.integers(0, t, 100).astype(np.int32))
    edges = gk.prepare_edges(src, dst, mask, etype, n, t, transpose=True)
    p = [torch.randn(t, d, d), torch.randn(t, d), torch.randn(d, 3 * d), torch.randn(d, 3 * d),
         torch.randn(3 * d), torch.randn(3 * d)]
    h = torch.randn(n, d)
    assert not cost.counting()
    with cost.CostCounter() as c:
        gk.ggnn_step(h, edges, *p, with_aggregate=True)
        gk.ggnn_step(h, edges, *p, accum="int8", scatter="mxu", block_e=50)
        gk.ggnn_fused(h, edges, *p, n_steps=3, with_chain=True)
        gk.gru_bwd(h, h, p[2], p[3], p[4], p[5], h, weights=False)
        gk.dmsg(h, edges, p[0], torch.zeros_like(h))
        ptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
        setops.gather_sum(torch.randn(6, 8), torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32),
                          ptr)
    r = c.result()
    assert r["aten_flops"] == 0.0  # every plain version hidden
    k = r["kernels"]
    assert k["ggnn_step"]["launches"] == 2 and k["ggnn_fused"]["launches"] == 1
    msg, other, mxu_bytes = gk.mxu_work(n, 90, d, t, "int8")
    assert k["ggnn_step"]["flops"] == gk.step_work(n, 90, d, t, True)[0] + msg + other
    assert k["ggnn_step"]["by_precision"]["int8"] == msg
    assert k["ggnn_step"]["bytes"] == gk.step_work(n, 90, d, t, True)[1] + mxu_bytes
    assert (k["ggnn_fused"]["flops"], k["ggnn_fused"]["bytes"]) == \
        gk.fused_work(n, 90, d, t, "fp32", 3, True)
    assert (k["gru_bwd"]["flops"], k["gru_bwd"]["bytes"]) == gk.gru_bwd_work(n, d, False)
    assert (k["dmsg"]["flops"], k["dmsg"]["bytes"]) == gk.dmsg_work(n, 90, d, t, True)
    assert (k["gather_sum"]["flops"], k["gather_sum"]["bytes"]) == setops.gather_sum_work(3, 5, 8)
    assert r["flops"] == sum(v["flops"] for v in k.values())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_reports_live_pairs_forward_and_backward(causal):
    B, H, T, D = 2, 2, 16, 8
    q, k, v = (torch.randn(B, H, T, D, requires_grad=True) for _ in range(3))
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[0, 10:] = False
    bias = torch.randn(H, T, T, requires_grad=True)
    with cost.CostCounter() as c:
        o = fa.flash_attention(q, k, v, mask, bias=bias, causal=causal)
        o.sum().backward()
    r = c.result()
    pairs = fa.live_pairs(mask, T, causal)
    lens = [10, 16]
    extra = 4 * H * T * T
    assert r["kernels"]["flash_fwd"]["flops"] == fa.flash_work(B, H, T, lens, D, 4, extra,
                                                                 pairs)[0]
    for kernel, products in (("flash_dq", 3), ("flash_dkv", 4), ("flash_dbias", 2)):
        assert r["kernels"][kernel]["launches"] == 1
        assert r["kernels"][kernel]["flops"] == 2 * products * H * D * pairs
    assert r["flops_by_precision"]["fp32"] == r["flops"]


# -- Table 5's record ---------------------------------------------------------------


def test_profile_model_record_and_the_aggregate(tmp_path):
    cfg = tconfig.load(FLAGSHIP)
    model = DeepDFA.from_config(cfg.model, 1002)
    model.reset_parameters(torch.Generator().manual_seed(0))
    b = pack(_specs(GraphSpec, 4, 256, 1024), 4, 256, 1024).to("cpu")

    def fwd(batch):
        with torch.inference_mode():
            return model(batch)

    rec = profiling.profile_model(fwd, (b,), examples_per_call=4, out_path=tmp_path / "p.jsonl")
    assert rec["gflops_per_example"] == pytest.approx(rec["gflops_per_call"] / 4)
    assert rec["ms_per_call"] > 0 and rec["p95_ms_per_call"] >= 0 and rec["bytes_accessed"] > 0
    profiling.ProfileWriter(tmp_path / "p.jsonl").write(rec)
    agg = profiling.aggregate_report(tmp_path / "p.jsonl")
    assert agg["records"] == 2 and agg["total_examples"] == 8
    assert agg["avg_gflops_per_example"] == pytest.approx(rec["gflops_per_example"])
    m = profiling.measure_matmul_ceiling(n=64, chain=2, reps=1, dtype="float32")
    assert m["matmul_tflops_measured"] >= 0
    g = profiling.measure_gather_bandwidth(rows=64, dim=8, idx_len=128, chain=1, reps=1)
    assert g["gather_gbps_measured"] >= 0


def _store(tmp_path):
    d = {"run_name": "prof", "data": {"feat": {"limit_all": 18, "limit_subkeys": 18},
                                       "batch": {"graphs_per_batch": 4, "node_budget": 64,
                                                 "edge_budget": 256}},
         "model": {"hidden_dim": 8, "n_steps": 3},
         "train": {"mesh": {"dp": 1}, "max_epochs": 1}}
    cfg = tconfig.from_dict(d)
    rng = np.random.default_rng(1)
    specs = []
    for gid in range(24):
        m = int(rng.integers(4, 10))
        specs.append(GraphSpec(graph_id=gid, node_feats=rng.integers(2, 20, (m, 4)).astype(np.int32),
                               node_vuln=np.zeros(m, np.int32),
                               edge_src=np.arange(m - 1, dtype=np.int32),
                               edge_dst=np.arange(1, m, dtype=np.int32), label=float(gid % 2)))
    out = tmp_path / "processed" / "bigvul"
    GraphStore(out / cli.graphs_dirname(cfg)).write(specs)
    (out / "splits.json").write_text(json.dumps(
        {str(g.graph_id): ("train", "train", "val", "test")[g.graph_id % 4] for g in specs}))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(d))
    return path


def test_cli_test_profile_and_xprof_dir(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cli.main(["train", "--config", str(_store(tmp_path)), "--device", "cpu"])
    cli.main(["test", "--device", "cpu", "--profile", "--xprof-dir", str(tmp_path / "xp"),
              'run_name="prof"'])
    out = capsys.readouterr().out
    rec = json.loads((tmp_path / "runs" / "prof" / "profiledata.jsonl").read_text())
    for key in ("gflops_per_call", "gflops_per_example", "ms_per_call", "ms_per_example",
                "p95_ms_per_call"):
        assert rec[key] > 0 and f'"{key}"' in out
    assert rec["examples_per_call"] == 4
    assert json.loads((tmp_path / "xp" / "trace.json").read_text())["traceEvents"]


def test_cli_score_books_one_ledger_site_a_rung(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    ledger.disable()
    cli.main(["score", "--smoke", "--device", "cpu", "--override", "obs.ledger=true"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    sites = summary["ledger"]["sites"]
    # the smoke serves a pow2 ladder: one site a warmed rung
    assert len(sites) >= 2 and set(sites) == {f"serve_score/G{2 ** i}" for i in range(len(sites))}
    assert all(s["flops"] > 0 and s["compiles"] == 1 for s in sites.values())
    executed = {k for k, s in sites.items() if s["executions"]}
    assert executed and set(summary["ledger_mfu"]) == executed  # FLOP/s on the CPU
    assert not ledger.enabled()  # the session closed it
