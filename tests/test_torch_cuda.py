"""Tests of the port that need a CUDA card (the `cuda` marker); without
one they skip. They import no JAX, so they run on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX for the reference's
tests.) The CUDA kernel is held against its plain PyTorch version on
the card at fp32 rtol 1e-4, atol 1e-5: the plain version's matmuls sum
in another order than the kernel's FMA loops."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu_torch.core.config import Config, ServeConfig  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec, pack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as gk  # noqa: E402
from deepdfa_tpu_torch.serve import DynamicBatcher, GgnnExecutor, score_graphs  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graphs(rng, count, n_etypes=1, max_nodes=60):
    out = []
    for gid in range(count):
        n = int(rng.integers(1, max_nodes))
        e = int(rng.integers(0, 3 * n))
        out.append(GraphSpec(
            graph_id=gid,
            node_feats=rng.integers(0, 52, (n, 4)).astype(np.int32),
            node_vuln=np.zeros((n,), np.int32),
            edge_src=rng.integers(0, n, (e,)).astype(np.int32),
            edge_dst=rng.integers(0, n, (e,)).astype(np.int32),
            label=0.0,
            edge_type=rng.integers(0, n_etypes, (e,)).astype(np.int32) if n_etypes > 1 else None,
        ))
    return out


def _params(rng, d, t, device):
    s = d ** -0.5
    shapes = (((t, d, d), s), ((t, d), 0.1), ((d, 3 * d), s), ((d, 3 * d), s),
              ((3 * d,), 0.1), ((3 * d,), 0.1))
    return [torch.from_numpy((rng.standard_normal(sh) * sc).astype(np.float32)).to(device)
            for sh, sc in shapes]


@pytest.mark.parametrize(
    "n, d, n_etypes, count",
    [(512, 128, 1, 8), (512, 128, 3, 8), (200, 32, 1, 4), (512, 256, 2, 8),
     (512, 96, 1, 8), (512, 128, 1, 0)],
    ids=["d128", "d128_t3", "partial_tile_d32", "d256_t2", "d96", "all_padding"],
)
def test_kernel_matches_plain(card, n, d, n_etypes, count):
    rng = np.random.default_rng(n + d + n_etypes)
    b = pack(_graphs(rng, count, n_etypes), max(count, 1), n, 4 * n,
             etypes=n_etypes > 1).to(card)
    params = _params(rng, d, n_etypes, card)
    h = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(card)
    edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, n_etypes)
    before = gk.LAUNCHES
    with torch.inference_mode():
        h_k, a_k = gk.ggnn_step(h, edges, *params, with_aggregate=True)
        h_p, a_p = gk.ggnn_step_plain(h, edges, *params)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before + 1
    torch.testing.assert_close(h_k, h_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
    with torch.inference_mode():
        again, _ = gk.ggnn_step(h, edges, *params)
    assert torch.equal(again, h_k)  # no atomics: the same bits every run


def test_kernel_wrapper_refuses_what_it_cannot_take(card):
    rng = np.random.default_rng(0)
    b = pack(_graphs(rng, 2), 2, 128, 512).to(card)
    edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, None, 128)
    h = torch.zeros(128, 48, device=card)
    with pytest.raises(ValueError, match="multiple of 32"):
        gk.ggnn_step(h, edges, *_params(rng, 48, 1, card))
    params = _params(rng, 32, 1, card)
    h = torch.zeros(128, 32, device=card)
    bad = gk.EdgeIndex(edges.src.long(), edges.dst, edges.w2, edges.rowptr)
    with pytest.raises(TypeError, match="src"):
        gk.ggnn_step(h, bad, *params)
    with pytest.raises(ValueError, match="contiguous"):
        gk.ggnn_step(h, edges, params[0], params[1], params[2].T.contiguous().T,
                     *params[3:])
    with pytest.raises(ValueError, match="is on"):
        gk.ggnn_step(h, edges, params[0].cpu(), *params[1:])
    # the backward kernels check their operands the same way
    g = torch.zeros(128, 32, device=card)
    with pytest.raises(TypeError, match="needs torch.float32"):
        gk.gru_bwd(h, g.double(), *params[2:], g)
    with pytest.raises(ValueError, match="transpose=True"):
        gk.dmsg(g, edges, params[0])


def test_serving_on_card_matches_cpu(card):
    rng = np.random.default_rng(1)
    specs = _graphs(rng, 20)
    cfg = Config(serve=ServeConfig(max_batch_graphs=4, node_budget=512, edge_budget=2048,
                                   max_batch_delay_ms=2.0))
    model = DeepDFA(52, 8, 3, generator=torch.Generator().manual_seed(0))
    cpu = GgnnExecutor(DeepDFA(52, 8, 3, generator=torch.Generator().manual_seed(0)),
                       512, 2048, 4, device="cpu")
    summary = score_graphs(model, specs, cfg)  # the default device is the card
    assert summary["device"].startswith("cuda")
    assert summary["ggnn_step_launches"] == summary["serve_batches"] * 3
    want = [r.wait(0) for r in DynamicBatcher(cpu).score_all(specs)]
    np.testing.assert_allclose(summary["probs"], want, rtol=RTOL, atol=ATOL)


def _bwd_case(rng, n, d, n_etypes, count, device):
    b = pack(_graphs(rng, count, n_etypes), max(count, 1), n, 4 * n,
             etypes=n_etypes > 1).to(device)
    edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n,
                             n_etypes, transpose=True)
    h, a, g = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
               for _ in range(3))
    return edges, h, a, g


@pytest.mark.parametrize(
    "n, d, n_etypes, count",
    [(512, 128, 1, 8), (512, 128, 3, 8), (200, 32, 1, 4), (512, 256, 2, 8),
     (512, 96, 1, 8), (512, 128, 1, 0)],
    ids=["d128", "d128_t3", "partial_tile_d32", "d256_t2", "d96", "all_padding"],
)
def test_backward_kernels_match_plain(card, n, d, n_etypes, count):
    """B3 (gru_bwd) and B4 (dmsg) against their plain versions on the
    card, each counted once per call and the same bits on a rerun."""
    rng = np.random.default_rng(n + d + n_etypes + 7)
    edges, h, a, g = _bwd_case(rng, n, d, n_etypes, count, card)
    params = _params(rng, d, n_etypes, card)
    wm, gru = params[0], params[2:]
    before = (gk.GRU_BWD_LAUNCHES, gk.DMSG_LAUNCHES)
    got = gk.gru_bwd(h, a, *gru, g)
    got_msg = gk.dmsg(a, edges, wm)
    want = gk.gru_bwd_plain(h, a, *gru, g)
    want_msg = gk.dmsg_plain(a, edges, wm)
    torch.cuda.synchronize()
    assert (gk.GRU_BWD_LAUNCHES, gk.DMSG_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for name, x, y in zip(("da", "dh", "dwih", "dwhh", "dbih", "dbhh"), got, want):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL * max(1.0, y.abs().max().item()),
                                   msg=lambda m: f"{name}: {m}")
    torch.testing.assert_close(got_msg, want_msg, rtol=RTOL, atol=ATOL)
    again = gk.gru_bwd(h, a, *gru, g)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert torch.equal(gk.dmsg(a, edges, wm), got_msg)


def _train_model_and_batch(device):
    rng = np.random.default_rng(3)
    specs = _graphs(rng, 8)
    for i, s in enumerate(specs):
        s.node_vuln[:] = 0
        if i % 2:
            s.node_vuln[0] = 1
    b = pack(specs, 8, 512, 2048).to(device)
    model = DeepDFA(52, 32, 3, generator=torch.Generator().manual_seed(0)).to(device)
    return model, b


def _grads(model, batch):
    from deepdfa_tpu_torch.train.losses import classifier_loss

    model.zero_grad(set_to_none=True)
    loss, _, _ = classifier_loss(model(batch), batch)
    loss.backward()
    return loss.detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def test_grad_propagate_runs_the_three_kernels(card):
    """A grad-enabled forward and backward of DeepDFA on the card runs
    the step kernel with its aggregate, then B3 and B4, n_steps times
    each, and its gradients match the same model on the CPU."""
    model, b = _train_model_and_batch(card)
    before = (gk.LAUNCHES, gk.GRU_BWD_LAUNCHES, gk.DMSG_LAUNCHES)
    loss, grads = _grads(model, b)
    torch.cuda.synchronize()
    after = (gk.LAUNCHES, gk.GRU_BWD_LAUNCHES, gk.DMSG_LAUNCHES)
    assert [x - y for x, y in zip(after, before)] == [3, 3, 3]
    cpu_model, cpu_b = _train_model_and_batch("cpu")
    cpu_loss, cpu_grads = _grads(cpu_model, cpu_b)
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-5, atol=1e-6)
    for k, g in cpu_grads.items():
        # the gate's bias gradient vanishes (the softmax is shift
        # invariant): its fp32 noise is held against a floor of 1e-5
        scale = max(g.abs().max().item(), 1e-5)
        assert (grads[k].cpu() - g).abs().max().item() / scale < 1e-4, k


def test_backward_is_deterministic(card, monkeypatch):
    """Under torch.use_deterministic_algorithms(True) the whole backward
    runs (nothing in it is refused as nondeterministic) and two passes
    give the same bits."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model, b = _train_model_and_batch(card)
    torch.use_deterministic_algorithms(True)
    try:
        _, first = _grads(model, b)
        _, second = _grads(model, b)
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(first[k], second[k]) for k in first)


def test_failed_build_and_launch_raise(card, tmp_path, monkeypatch):
    from deepdfa_tpu_torch.nn import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "broken.cu").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build.build(("broken",))
    monkeypatch.undo()
    lib = gk._library("ggnn_bwd")
    x = torch.zeros(64, 48, device=card)
    rc = lib.ggnn_dmsg_f32(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                           x.data_ptr(), x.data_ptr(), x.data_ptr(), 64, 64, 48, 1,
                           torch.cuda.current_stream().cuda_stream)
    assert rc != 0  # d = 48 has no kernel instance
    with pytest.raises(RuntimeError, match="launch failed"):
        gk._raise_on(rc, "dmsg", lib, "ggnn_bwd_error_string")
