"""Tests of the port that need a CUDA card (the `cuda` marker); without
one they skip. They import no JAX, so they run on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX for the reference's
tests.) The GGNN kernels are held against their plain PyTorch versions
on the card at fp32 rtol 1e-4, atol 1e-5: the plain version's matmuls
sum in another order than the kernel's FMA loops (under bf16 and int8
too: both round or quantize the same rows). The whole-unroll kernel is
held to the bits of five step launches. The flash-attention kernel is
held at 1e-5 in fp32 and 2e-2 in bf16 (it rounds p to bf16
against a running max, the plain version against the row's max)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu_torch.core.config import Config, ServeConfig  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec, pack  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.nn import flash_attention as fa  # noqa: E402
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
     (512, 96, 1, 8), (512, 128, 1, 0), (512, 288, 1, 8), (200, 288, 2, 4)],
    ids=["d128", "d128_t3", "partial_tile_d32", "d256_t2", "d96", "all_padding", "d288",
         "partial_tile_d288_t2"],
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
    # past the widest instance (d 288) every kernel refuses, none falls back
    wide = _params(rng, 320, 1, card)
    h = torch.zeros(128, 320, device=card)
    with pytest.raises(ValueError, match="up to 288"):
        gk.ggnn_step(h, edges, *wide)
    with pytest.raises(ValueError, match="up to 288"):
        gk.ggnn_fused(h, edges, *wide, n_steps=2)
    with pytest.raises(ValueError, match="up to 288"):
        gk.gru_bwd(h, h, *wide[2:], h)
    with pytest.raises(ValueError, match="up to 288"):
        gk.dmsg(h, gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, None, 128,
                                    transpose=True), wide[0])
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
    # the step kernels stage the weights 16 bytes at a time
    off_grid = torch.zeros(32 * 32 + 1, device=card)[1:].view(1, 32, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gk.ggnn_step(h, edges, off_grid, *params[1:])
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
     (512, 96, 1, 8), (512, 128, 1, 0), (512, 288, 1, 8), (200, 288, 2, 4)],
    ids=["d128", "d128_t3", "partial_tile_d32", "d256_t2", "d96", "all_padding", "d288",
         "partial_tile_d288_t2"],
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


#: B4's batches: (nodes, d, edge types, graphs or None for the hub batch,
#: edges); the flagship's budgets (16384 nodes, 65536 edges) at T 1 and
#: 3, the all-padding batch, one node holding a quarter of the edges
#: (its run cut across every warp of its block), and widths 32, 96, 256
DMSG_CASES = [(16384, 128, 1, 600, 65536), (16384, 128, 3, 600, 65536), (16384, 128, 1, 0, 65536),
              (16384, 128, 1, None, 65536), (2048, 32, 1, 80, 8192), (2048, 96, 2, 80, 8192),
              (2048, 256, 1, 80, 8192), (2048, 288, 1, 80, 8192), (16384, 288, 1, 600, 65536)]
DMSG_IDS = ["flagship", "etypes3", "all_padding", "hub", "d32", "d96_t2", "d256", "d288",
            "flagship_d288"]


@pytest.mark.parametrize("n, d, n_etypes, count, e", DMSG_CASES, ids=DMSG_IDS)
def test_dmsg_matches_plain_and_repeats(card, n, d, n_etypes, count, e):
    """B4 alone and added into a dh in place (step_bwd's call) against
    dmsg_plain on the card (rtol 1e-4, atol 1e-5), one launch a call, the
    same bits on a repeat; the in-place call returns the dh it was given.
    The hub's row sums ~16k edges, whose fp32 sums differ by order alone
    by ~1e-3 on values of ~100 (the plain version's index_add_ sums in no
    fixed order on the card): it is held against the plain version in
    float64 within 1e-5 of that row's largest magnitude, every other row
    as above."""
    rng = np.random.default_rng(n + d + n_etypes)
    if count is None:
        src = rng.integers(0, n, e)
        src[rng.random(e) < 0.25] = 7
        dst = np.sort(rng.integers(0, n, e))
        edges = gk.prepare_edges(torch.from_numpy(src).to(torch.int32).to(card),
                                 torch.from_numpy(dst).to(torch.int32).to(card),
                                 torch.ones(e, dtype=torch.bool, device=card), None, n, 1,
                                 transpose=True)
        assert int(edges.srcptr[8] - edges.srcptr[7]) > e // 5
    else:
        b = pack(_graphs(rng, count, n_etypes, max_nodes=50), max(count, 1), n, e,
                 etypes=n_etypes > 1).to(card)
        edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n,
                                 n_etypes, transpose=True)
    da, dh0 = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(card)
               for _ in range(2))
    wm = _params(rng, d, n_etypes, card)[0]
    before = gk.DMSG_LAUNCHES
    got = gk.dmsg(da, edges, wm)
    dh = dh0.clone()
    added = gk.dmsg(da, edges, wm, dh)
    torch.cuda.synchronize()
    assert gk.DMSG_LAUNCHES == before + 2 and added is dh
    want = gk.dmsg_plain(da, edges, wm)
    want_added = gk.dmsg_plain(da, edges, wm, dh0.clone())
    if count is None:
        hub = torch.zeros(n, dtype=torch.bool, device=card)
        hub[7] = True
        wide = [x.double() if x is not None and x.is_floating_point() else x
                for x in edges.tensors()]
        exact = gk.dmsg_plain(da.double(), gk.EdgeIndex(*wide), wm.double())[7]
        for x in (got[7], added[7] - dh0[7]):
            assert (x.double() - exact).abs().max() <= 1e-5 * exact.abs().max()
        got, want, added, want_added = got[~hub], want[~hub], added[~hub], want_added[~hub]
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(added, want_added, rtol=RTOL, atol=ATOL)
    if count == 0:
        assert (got == 0).all() and torch.equal(added, dh0)
    assert torch.equal(gk.dmsg(da, edges, wm), gk.dmsg(da, edges, wm))
    assert torch.equal(gk.dmsg(da, edges, wm, dh0.clone()), gk.dmsg(da, edges, wm, dh0.clone()))


def _gru_operands(rng, n, d, device):
    h, a, g = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
               for _ in range(3))
    return h, a, g, _params(rng, d, 1, device)[2:]


def _check_gru_bwd(got, want):
    for name, x, y in zip(("da", "dh", "dwih", "dwhh", "dbih", "dbhh"), got, want):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL * max(1.0, y.abs().max().item()),
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("n, d", [(1000, 128), (16384 - 37, 128), (1000, 32), (1000, 96),
                                  (1000, 256), (1, 64), (1000, 288), (16384 - 37, 288)],
                         ids=["n1000_d128", "flagship_less_37", "d32", "d96", "d256", "one_node",
                              "d288", "flagship_less_37_d288"])
def test_gru_bwd_at_ragged_node_counts_matches_plain(card, n, d):
    """B3 at node counts that are no multiple of its 64-node tiles or its
    weight pass's 32-node panels, at widths whose weight tiles are 32 rows
    (d 32, 96) or 64: against its plain version, each launch counted, and
    five runs the same bits (its split-K partials are summed in order)."""
    rng = np.random.default_rng(n + d)
    h, a, g, gru = _gru_operands(rng, n, d, card)
    before = gk.GRU_BWD_LAUNCHES
    runs = [gk.gru_bwd(h, a, *gru, g) for _ in range(5)]
    want = gk.gru_bwd_plain(h, a, *gru, g)
    torch.cuda.synchronize()
    assert gk.GRU_BWD_LAUNCHES == before + 5
    _check_gru_bwd(runs[0], want)
    assert all(torch.equal(x, y) for r in runs[1:] for x, y in zip(runs[0], r))


def test_gru_bwd_of_all_padding_nodes_is_zero(card):
    """A batch of padding only (h = a = 0, no gradient reaching it) gives
    B3 exact zeros in every output, as its plain version does."""
    rng = np.random.default_rng(5)
    n, d = 4096, 128
    h, a, g = (torch.zeros(n, d, device=card) for _ in range(3))
    gru = _params(rng, d, 1, card)[2:]
    got = gk.gru_bwd(h, a, *gru, g)
    _check_gru_bwd(got, gk.gru_bwd_plain(h, a, *gru, g))
    assert all(bool((x == 0).all()) for x in got)


def test_gru_bwd_refuses_unaligned_operands(card):
    """The kernel stages h, a, g and the weights 16 bytes at a time: an
    operand off the 16-byte grid is refused, not read wrong."""
    rng = np.random.default_rng(6)
    h, a, g, gru = _gru_operands(rng, 65, 32, card)
    off = torch.zeros(65 * 32 + 1, device=card)[1:].view(65, 32)
    off.copy_(h)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gk.gru_bwd(off, a, *gru, g)


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
                           x.data_ptr(), x.data_ptr(), 0, 64, 64, 48, 1,
                           torch.cuda.current_stream().cuda_stream)
    assert rc != 0  # d = 48 has no kernel instance
    with pytest.raises(RuntimeError, match="launch failed"):
        gk._raise_on(rc, "dmsg", lib, "ggnn_bwd_error_string")


# -- kernel 1's bf16/int8 instances and kernel 2 (the whole unroll) ----------

POLICY_CASES = [(512, 128, 1, 8), (512, 128, 3, 8), (200, 32, 1, 4), (512, 256, 2, 8),
                (512, 96, 1, 8), (512, 128, 1, 0), (512, 288, 1, 8), (200, 288, 2, 4)]
POLICY_IDS = ["d128", "d128_t3", "partial_tile_d32", "d256_t2", "d96", "all_padding", "d288",
              "partial_tile_d288_t2"]
#: card vs CPU probabilities under bf16/int8: the two sum the fp32 state
#: in other orders, so a bf16 rounding or an int8 quantum of a state
#: element near its boundary can flip between them and move that row's
#: messages by one rounding step
POLICY_PROB_TOL = 5e-3


def _policy_case(rng, n, d, n_etypes, count, device, transpose=False):
    b = pack(_graphs(rng, count, n_etypes), max(count, 1), n, 4 * n,
             etypes=n_etypes > 1).to(device)
    edges = gk.prepare_edges(b.edge_src, b.edge_dst, b.edge_mask, b.edge_type, n, n_etypes,
                             transpose=transpose)
    h = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
    return b, edges, h, _params(rng, d, n_etypes, device)


@pytest.mark.parametrize("accum", ["bf16", "int8"])
@pytest.mark.parametrize("n, d, n_etypes, count", POLICY_CASES, ids=POLICY_IDS)
def test_policy_kernels_match_plain(card, n, d, n_etypes, count, accum):
    """Kernel 1's bf16 and int8 instances against the plain version of
    the same policy on the card (the same quantized rows: fp32 rtol
    1e-4, atol 1e-5), one count per launch, the same bits on a rerun."""
    rng = np.random.default_rng(n + d + n_etypes + 11)
    _, edges, h, params = _policy_case(rng, n, d, n_etypes, count, card)
    counter = {"bf16": "BF16_LAUNCHES", "int8": "INT8_LAUNCHES"}[accum]
    before = gk.launch_counts()
    with torch.inference_mode():
        h_k, a_k = gk.ggnn_step(h, edges, *params, accum=accum, with_aggregate=True)
        h_p, a_p = gk.ggnn_step_plain(h, edges, *params, accum)
        again, _ = gk.ggnn_step(h, edges, *params, accum=accum)
    torch.cuda.synchronize()
    after = gk.launch_counts()
    assert after[counter] == before[counter] + 2 and after["LAUNCHES"] == before["LAUNCHES"]
    torch.testing.assert_close(h_k, h_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
    assert torch.equal(again, h_k)
    if count:  # the policy is engaged: the aggregate moves off fp32's
        _, a32 = gk.ggnn_step(h, edges, *params, with_aggregate=True)
        assert not torch.equal(a_k, a32)


@pytest.mark.parametrize("accum", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("n, d, n_etypes, count", POLICY_CASES, ids=POLICY_IDS)
def test_fused_kernel_is_bit_equal_to_step_launches(card, n, d, n_etypes, count, accum):
    """Kernel 2 against 5 launches of kernel 1 of the same policy: h_out
    and every chain plane the same bits, with and without the chain and
    on a repeat; gradients through GgnnUnroll the same bits as through
    five GgnnSteps."""
    rng = np.random.default_rng(n + d + n_etypes + 13)
    b, edges, h, params = _policy_case(rng, n, d, n_etypes, count, card, transpose=True)
    with torch.inference_mode():
        states = [h]
        for _ in range(5):
            states.append(gk.ggnn_step(states[-1], edges, *params, accum=accum)[0])
        before = gk.FUSED_LAUNCHES
        h_f, chain = gk.ggnn_fused(h, edges, *params, n_steps=5, accum=accum, with_chain=True)
        h_f2, none = gk.ggnn_fused(h, edges, *params, n_steps=5, accum=accum)
        h_f3, _ = gk.ggnn_fused(h, edges, *params, n_steps=5, accum=accum)
    torch.cuda.synchronize()
    assert gk.FUSED_LAUNCHES == before + 3 and none is None
    assert torch.equal(h_f, states[-1]) and torch.equal(h_f2, h_f) and torch.equal(h_f3, h_f)
    assert all(torch.equal(chain[s], states[s]) for s in range(5))
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(card)
    grads = {}
    for unroll in ("per_step", "fused"):
        ps = [p.clone().requires_grad_() for p in params]
        f = h.clone().requires_grad_()
        out = gk.ggnn_propagate(*ps, f, b.edge_src, b.edge_dst, b.edge_mask, b.edge_type,
                                n_steps=5, n_etypes=n_etypes, accum=accum, unroll=unroll)
        out.backward(g)
        grads[unroll] = [out.detach(), f.grad, *(p.grad for p in ps)]
    assert all(torch.equal(x, y) for x, y in zip(grads["fused"], grads["per_step"]))


def test_refused_cooperative_launch_raises(card):
    rng = np.random.default_rng(5)
    _, edges, h, params = _policy_case(rng, 512, 128, 1, 8, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    before = gk.FUSED_LAUNCHES
    with pytest.raises(RuntimeError, match="ggnn_fused kernel launch failed"):
        gk.ggnn_fused(h, edges, *params, n_steps=5, grid=64 * sms)
    assert gk.FUSED_LAUNCHES == before
    h_ok, _ = gk.ggnn_fused(h, edges, *params, n_steps=5, grid=1)  # one block, every tile
    torch.cuda.synchronize()
    assert torch.equal(h_ok, gk.ggnn_fused(h, edges, *params, n_steps=5)[0])
    # the card's L2 admits the flagship's resident set under every policy
    assert gk.fused_residency_bytes(16384, 128, "int8", 5) <= gk.fused_budget_bytes(card)


@pytest.mark.parametrize("accum, unroll", [("bf16", "per_step"), ("fp32", "fused"),
                                           ("int8", "fused"), ("int8", "per_step")])
def test_serving_variants_on_card_match_cpu(card, accum, unroll):
    rng = np.random.default_rng(1)
    specs = _graphs(rng, 20)
    cfg = Config(serve=ServeConfig(max_batch_graphs=4, node_budget=512, edge_budget=2048,
                                   max_batch_delay_ms=2.0))

    def model():
        return DeepDFA(52, 8, 3, generator=torch.Generator().manual_seed(0), ggnn_kernel=True,
                       ggnn_kernel_accum=accum, ggnn_kernel_unroll=unroll)

    summary = score_graphs(model(), specs, cfg)
    fused = unroll == "fused"
    assert summary["ggnn_fused_fallbacks"] == 0
    assert summary["ggnn_fused_launches"] == (summary["serve_batches"] if fused else 0)
    key = {"fp32": "ggnn_step_launches", "bf16": "ggnn_step_bf16_launches",
           "int8": "ggnn_step_int8_launches"}[accum]
    assert summary[key] == (0 if fused else summary["serve_batches"] * 3)
    want = [r.wait(0) for r in DynamicBatcher(
        GgnnExecutor(model(), 512, 2048, 4, device="cpu")).score_all(specs)]
    if accum == "fp32":
        np.testing.assert_allclose(summary["probs"], want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(summary["probs"], want, rtol=0, atol=POLICY_PROB_TOL)


# -- the mxu scatter of kernels 1 and 2 ----------------------------------------

MXU_COUNTER = {"fp32": "MXU_LAUNCHES", "bf16": "MXU_BF16_LAUNCHES", "int8": "MXU_INT8_LAUNCHES"}


@pytest.mark.parametrize("block_e", [128, 512])
@pytest.mark.parametrize("accum", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("n, d, n_etypes, count", POLICY_CASES, ids=POLICY_IDS)
def test_mxu_kernels_match_plain(card, n, d, n_etypes, count, accum, block_e):
    """Kernel 1's mxu instances against the plain mxu of the same policy
    on the card (fp32 rtol 1e-4, atol 1e-5: the plain version's matmuls
    sum the messages' products in another order; under int8 the products
    are exact and the quanta the same), one count per launch and no fold
    count, the same bits on a rerun; int8's aggregate moves with the edge
    block, as in the reference."""
    rng = np.random.default_rng(n + d + n_etypes + 17)
    _, edges, h, params = _policy_case(rng, n, d, n_etypes, count, card)
    counter = MXU_COUNTER[accum]
    block_e = gk.edge_block(edges.src.shape[0], block_e)
    other = gk.edge_block(edges.src.shape[0], 640 - block_e)  # 512 <-> 128
    before = gk.launch_counts()
    kw = dict(accum=accum, scatter="mxu", block_e=block_e)
    with torch.inference_mode():
        h_k, a_k = gk.ggnn_step(h, edges, *params, with_aggregate=True, **kw)
        h_p, a_p = gk.ggnn_step_plain(h, edges, *params, accum, "mxu", block_e)
        again, _ = gk.ggnn_step(h, edges, *params, **kw)
        _, a_fold = gk.ggnn_step(h, edges, *params, accum=accum, with_aggregate=True)
    torch.cuda.synchronize()
    after = gk.launch_counts()
    assert after[counter] == before[counter] + 2
    torch.testing.assert_close(h_k, h_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(a_k, a_p, rtol=RTOL, atol=ATOL)
    assert torch.equal(again, h_k)
    if accum == "int8" and count:  # a different function from the fold
        assert not torch.equal(a_k, a_fold)
        _, a_other = gk.ggnn_step(h, edges, *params, accum="int8", scatter="mxu",
                                  block_e=other, with_aggregate=True)
        assert not torch.equal(a_other, a_k)


@pytest.mark.parametrize("accum", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("n, d, n_etypes, count", POLICY_CASES, ids=POLICY_IDS)
def test_mxu_fused_kernel_is_bit_equal_to_step_launches(card, n, d, n_etypes, count, accum):
    """Kernel 2's mxu instances against 5 launches of kernel 1's (edge
    blocks of about 128, so every batch spans several): h_out and the chain
    the same bits, with and without the chain; gradients through
    GgnnUnroll the bits of five GgnnSteps."""
    rng = np.random.default_rng(n + d + n_etypes + 19)
    b, edges, h, params = _policy_case(rng, n, d, n_etypes, count, card, transpose=True)
    block_e = gk.edge_block(edges.src.shape[0], 128)
    kw = dict(accum=accum, scatter="mxu", block_e=block_e)
    with torch.inference_mode():
        states = [h]
        for _ in range(5):
            states.append(gk.ggnn_step(states[-1], edges, *params, **kw)[0])
        before = gk.launch_counts()
        h_f, chain = gk.ggnn_fused(h, edges, *params, n_steps=5, with_chain=True, **kw)
        h_f2, none = gk.ggnn_fused(h, edges, *params, n_steps=5, **kw)
    torch.cuda.synchronize()
    after = gk.launch_counts()
    assert after["FUSED_MXU_LAUNCHES"] == before["FUSED_MXU_LAUNCHES"] + 2
    assert after["FUSED_LAUNCHES"] == before["FUSED_LAUNCHES"] and none is None
    assert torch.equal(h_f, states[-1]) and torch.equal(h_f2, h_f)
    assert all(torch.equal(chain[s], states[s]) for s in range(5))
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(card)
    grads = {}
    for unroll in ("per_step", "fused"):
        ps = [p.clone().requires_grad_() for p in params]
        f = h.clone().requires_grad_()
        out = gk.ggnn_propagate(*ps, f, b.edge_src, b.edge_dst, b.edge_mask, b.edge_type,
                                n_steps=5, n_etypes=n_etypes, accum=accum, scatter="mxu",
                                block_edges=128, unroll=unroll)
        out.backward(g)
        grads[unroll] = [out.detach(), f.grad, *(p.grad for p in ps)]
    assert all(torch.equal(x, y) for x, y in zip(grads["fused"], grads["per_step"]))


@pytest.mark.parametrize("accum, unroll", [("fp32", "per_step"), ("int8", "per_step"),
                                           ("int8", "fused")])
def test_mxu_serving_on_card_matches_cpu(card, accum, unroll):
    rng = np.random.default_rng(3)
    specs = _graphs(rng, 20)
    cfg = Config(serve=ServeConfig(max_batch_graphs=4, node_budget=512, edge_budget=2048,
                                   max_batch_delay_ms=2.0))

    def model():
        return DeepDFA(52, 8, 3, generator=torch.Generator().manual_seed(0), ggnn_kernel=True,
                       ggnn_kernel_accum=accum, ggnn_kernel_scatter="mxu",
                       ggnn_kernel_unroll=unroll)

    summary = score_graphs(model(), specs, cfg)
    fused = unroll == "fused"
    assert summary["ggnn_fused_fallbacks"] == 0
    assert summary["ggnn_fused_mxu_launches"] == (summary["serve_batches"] if fused else 0)
    key = {"fp32": "ggnn_step_mxu_launches", "int8": "ggnn_step_mxu_int8_launches"}[accum]
    assert summary[key] == (0 if fused else summary["serve_batches"] * 3)
    assert summary["ggnn_step_launches"] == summary["ggnn_fused_launches"] == 0
    want = [r.wait(0) for r in DynamicBatcher(
        GgnnExecutor(model(), 512, 2048, 4, device="cpu")).score_all(specs)]
    if accum == "fp32":
        np.testing.assert_allclose(summary["probs"], want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(summary["probs"], want, rtol=0, atol=POLICY_PROB_TOL)


@pytest.mark.parametrize(
    "B, H, Tq, Tk, D, dtype, lens",
    [(16, 12, 512, 512, 64, "bfloat16", [512] * 12 + [300, 65, 1, 0]),
     (8, 12, 256, 256, 64, "bfloat16", [256, 200, 17, 0] * 2),
     (4, 12, 128, 128, 64, "bfloat16", [128, 100, 1, 0]),
     (4, 12, 256, 256, 64, "float32", [256, 131, 64, 0]),
     (2, 3, 130, 77, 40, "bfloat16", [77, 0]),
     (2, 3, 100, 33, 128, "float32", [33, 5])],
    ids=["flagship_bf16", "t256", "t128", "fp32", "ragged_d40", "cross_d128_fp32"],
)
def test_flash_kernel_matches_plain(card, B, H, Tq, Tk, D, dtype, lens):
    """Kernel 5 against attention_plain on the card: o within the
    dtype's tolerance, lse within 1e-5, o == 0 on all-padding rows, one
    launch per call and the same bits on a repeat."""
    g = torch.Generator().manual_seed(B + Tq + D)
    td = getattr(torch, dtype)
    q = torch.randn(B, H, Tq, D, generator=g).to(td).to(card)
    k, v = (torch.randn(B, H, Tk, D, generator=g).to(td).to(card) for _ in range(2))
    mask = (torch.arange(Tk)[None, :] < torch.tensor(lens)[:, None]).to(card)
    before = fa.LAUNCHES
    o, lse = fa.flash_fwd(q, k, v, mask)
    po, plse = fa.attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(lse).all() and torch.isfinite(o.float()).all()
    for b, n in enumerate(lens):
        if n == 0:
            assert (o[b] == 0).all()
    o2, lse2 = fa.flash_fwd(q, k, v, mask)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_kernel_takes_the_encoders_strided_views(card):
    g = torch.Generator().manual_seed(5)
    B, T, H, D = 4, 256, 12, 64
    qkv = torch.randn(B, T, 3, H, D, generator=g).bfloat16().to(card)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    mask = (torch.arange(T)[None, :] < torch.tensor([256, 10, 0, 128])[:, None]).to(card)
    o, lse = fa.flash_fwd(q, k, v, mask)
    oc, lsec = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    torch.cuda.synchronize()
    assert o.transpose(1, 2).is_contiguous()  # written as [B, T, H, D]
    assert torch.equal(o, oc) and torch.equal(lse, lsec)


def test_flash_wrapper_refuses_what_it_cannot_take(card):
    q = torch.zeros(2, 2, 16, 64, device=card)
    mask = torch.ones(2, 16, dtype=torch.bool, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), q.half(), q.half(), mask)
    with pytest.raises(TypeError, match="share a dtype"):
        fa.flash_fwd(q, q.bfloat16(), q, mask)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(2, 2, 64, 16, device=card).transpose(2, 3)
        fa.flash_fwd(t, t, t, mask)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_fwd(q, q, q, mask.cpu())
    wide = torch.zeros(2, 2, 16, 192, device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(wide, wide, wide, mask)
    # bf16 at a tensor-core width never drops to the FMA instance: a view
    # off the 16-byte grid raises
    buf = torch.zeros(2 * 2 * 16 * 64 + 1, dtype=torch.bfloat16, device=card)
    off = buf[1:].view(2, 2, 16, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(off, off, off, mask)
    from deepdfa_tpu_torch.models.transformer import EncoderLayer, TransformerConfig

    cfg = TransformerConfig.tiny(hidden_size=384, num_heads=2, dtype="bfloat16")
    layer = EncoderLayer(cfg).to(card)
    with pytest.raises(ValueError, match="cannot tile"):  # "auto", head 192: no plain route
        layer(torch.zeros(2, 16, 384, dtype=torch.bfloat16, device=card), mask)


def test_combined_serving_on_card_matches_cpu(card):
    """A small fp32 combined model scored through score_combined on the
    card against the CPU plain path: 2 layers x (flash) and 3 GGNN steps
    per batch."""
    from deepdfa_tpu_torch.core.config import DataConfig
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import CombinedConfig, CombinedModel, TransformerConfig
    from deepdfa_tpu_torch.serve import CombinedExecutor, score_combined

    def model():
        enc = TransformerConfig.tiny(vocab_size=256, max_position_embeddings=70)
        cfg = CombinedConfig(encoder=enc, graph_hidden_dim=32, graph_n_steps=3,
                             graph_input_dim=52)
        return CombinedModel(cfg, generator=torch.Generator().manual_seed(0)).eval()

    rng = np.random.default_rng(2)
    tok = HashTokenizer(256)
    specs = _graphs(rng, 12)
    payloads = [(" ".join(["x"] * int(rng.integers(1, 60))), specs[i] if i % 3 else None)
                for i in range(12)]
    cfg = Config(data=DataConfig(seq_buckets=(16, 32, 64), token_budget=256),
                 serve=ServeConfig(node_budget=512, edge_budget=2048, max_batch_delay_ms=2.0))
    summary = score_combined(model(), payloads, cfg, tok)  # the default device is the card
    assert summary["device"].startswith("cuda") and summary["serve_scored"] == 12
    assert summary["flash_fwd_launches"] == summary["serve_batches"] * 2
    assert summary["ggnn_step_launches"] == summary["serve_batches"] * 3
    cpu = CombinedExecutor(model(), tok, (16, 32, 64), 256, 512, 2048, device="cpu")
    want = [r.wait(0) for r in DynamicBatcher(cpu).score_all(
        [(tok.encode(t, 64), s) for t, s in payloads])]
    np.testing.assert_allclose(summary["probs"], want, rtol=RTOL, atol=ATOL)


BWD_CASES = [
    (4, 12, 256, 256, 64, "bfloat16", [256, 200, 17, 0]),
    (2, 4, 130, 77, 128, "bfloat16", [77, 0]),
    (3, 2, 96, 200, 64, "float32", [200, 131, 0]),
    (2, 3, 70, 70, 40, "bfloat16", [70, 9]),
    # the FMA instances: the generation path's cross-attention call, and
    # ragged tiles (Tq 200, Tk 77) at every width class, with an
    # all-padding row
    (16, 12, 128, 256, 64, "float32", [256] * 16),
    (3, 2, 200, 77, 8, "float32", [77, 40, 0]),
    (3, 2, 200, 77, 40, "float32", [77, 40, 0]),
    (3, 2, 200, 77, 64, "float32", [77, 40, 0]),
    (3, 2, 200, 77, 72, "float32", [77, 40, 0]),
    (3, 2, 200, 77, 128, "float32", [77, 40, 0]),
]
BWD_IDS = ["t256_bf16", "cross_d128_bf16", "cross_fp32", "ragged_d40_fma", "gen_cross_fp32",
           "ragged_d8_fp32", "ragged_d40_fp32", "ragged_d64_fp32", "ragged_d72_fp32",
           "ragged_d128_fp32"]


def _bwd_inputs(card, B, H, Tq, Tk, D, dtype, lens):
    g = torch.Generator().manual_seed(B * 7 + Tq + D)
    td = getattr(torch, dtype)
    q, do = (torch.randn(B, H, Tq, D, generator=g).to(td).to(card) for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, generator=g).to(td).to(card) for _ in range(2))
    mask = (torch.arange(Tk)[None, :] < torch.tensor(lens)[:, None]).to(card)
    return q, k, v, do, mask


def _close(got, want, dtype, scale=None):
    """bf16: within 2e-2 of `scale`, by default want's largest magnitude;
    fp32: 1e-4 of it."""
    if scale is None:
        scale = want.float().abs().max().item()
    tol = (2e-2 if dtype == "bfloat16" else 1e-4) * max(scale, 1e-6)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("B, H, Tq, Tk, D, dtype, lens", BWD_CASES, ids=BWD_IDS)
def test_flash_bwd_kernels_match_plain(card, B, H, Tq, Tk, D, dtype, lens, rate):
    """Kernels 6 (dq) and 7 (dk, dv) against attention_bwd_plain on the
    card, from the kernel's own forward; with dropout both draw the
    seed's Philox mask. All-padding rows get exactly zero gradients."""
    q, k, v, do, mask = _bwd_inputs(card, B, H, Tq, Tk, D, dtype, lens)
    seed = 1234567890123
    o, lse = fa.flash_fwd(q, k, v, mask, dropout_rate=rate, seed=seed)
    bits = fa.dropout_bits(seed, B, H, Tq, Tk, card) if rate else None
    po, _ = fa.attention_plain(q, k, v, mask, dropout_rate=rate, bits=bits)
    _close(o, po, dtype)
    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    got = fa.flash_bwd(q, k, v, mask, o, lse, do, dropout_rate=rate, seed=seed)
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, dropout_rate=rate, bits=bits)
    torch.cuda.synchronize()
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert got[3] is None and want[3] is None  # no bias: no dbias, no kernel 8
    got, want = got[:3], want[:3]
    for x, y in zip(got, want):
        assert x.dtype == q.dtype and x.shape == y.shape and torch.isfinite(x.float()).all()
        _close(x, y, dtype)
    for b, n in enumerate(lens):
        if n == 0:
            assert all((x[b] == 0).all() for x in got)
    again = fa.flash_bwd(q, k, v, mask, o, lse, do, dropout_rate=rate, seed=seed)[:3]
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("T", [200, 65, 129])
def test_flash_bwd_kernels_take_the_training_strides(card, T, rate):
    """The training path's operands: q, k and v strided views of the
    fused [B, T, 3, H, D] product and do a [B, H, T, D] view of a
    [B, T, H, D] buffer; dq, dk and dv against attention_bwd_plain on
    the same views, with and without the seed's dropout mask, at T 200
    and one past the first and second 64-row tiles."""
    B, H, D = 4, 12, 64
    g = torch.Generator().manual_seed(9)
    qkv = torch.randn(B, T, 3 * H * D, generator=g).bfloat16().to(card).view(B, T, 3, H, D)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(B, T, H, D, generator=g).bfloat16().to(card).transpose(1, 2)
    assert not (q.is_contiguous() or do.is_contiguous())
    lens = torch.tensor([T, 3 * T // 4, 3, 0])
    mask = (torch.arange(T)[None, :] < lens[:, None]).to(card)
    seed = 77
    o, lse = fa.flash_fwd(q, k, v, mask, dropout_rate=rate, seed=seed)
    bits = fa.dropout_bits(seed, B, H, T, T, card) if rate else None
    got = fa.flash_bwd(q, k, v, mask, o, lse, do, dropout_rate=rate, seed=seed)[:3]
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, dropout_rate=rate, bits=bits)[:3]
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.isfinite(x.float()).all()
        _close(x, y, "bfloat16")
    assert all((x[3] == 0).all() for x in got)


#: the tensor-core dq and dk/dv tiles' edges (64-row tiles, 64-key steps):
#: one row or key, a tile's last and one past, two tiles' either side, and
#: Tq != Tk both ways
MMA_EDGE_T = [(1, 1), (1, 200), (200, 1), (63, 65), (65, 63), (127, 129), (129, 127), (200, 64),
              (64, 200)]
#: the head widths of the tensor-core instances (csrc/flash_attention.cu:
#: by_width)
MMA_WIDTHS = [16, 32, 48, 64, 80, 96, 112, 128]


def _mma_bwd_case(card, Tq, Tk, D, bias_dtype, rate, causal=False, lens=None):
    """One bf16 backward call (the tensor-core dq and dk/dv, and dbias
    with a bias; B 3, H 2; by default a full, a half and an all-padding
    batch row) against attention_bwd_plain from the kernel's own forward:
    each gradient within 2e-2 of its scale, the all-padding row's
    gradients exactly 0, the same bits on a repeat, each kernel launched
    once. With one key (Tk = 1) every live row's p is 1 and ds = p (dp -
    delta) is 0 up to rounding, so dq, dk and dbias are rounding noise in
    both versions and are held to dv's scale, the call's other
    gradient."""
    B, H = 3, 2
    g = torch.Generator().manual_seed(1000 * Tq + Tk + D)
    q, do = (torch.randn(B, H, Tq, D, generator=g).bfloat16().to(card) for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, generator=g).bfloat16().to(card) for _ in range(2))
    bias = None
    if bias_dtype is not None:
        bias = (torch.randn(H, Tq, Tk, generator=g) * 2.0).to(getattr(torch, bias_dtype)).to(card)
    lens = [Tk, (Tk + 1) // 2, 0] if lens is None else lens
    mask = (torch.arange(Tk)[None, :] < torch.tensor(lens)[:, None]).to(card)
    seed = 5551212
    scale = None if bias is None else 1.0
    kw = {"scale": scale, "dropout_rate": rate, "seed": seed, "bias": bias, "causal": causal}
    o, lse = fa.flash_fwd(q, k, v, mask, **kw)
    before = (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES)
    got = fa.flash_bwd(q, k, v, mask, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + int(bias is not None))
    bits = fa.dropout_bits(seed, B, H, Tq, Tk, card) if rate else None
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, scale, rate, bits, bias, causal)
    noise = want[2].float().abs().max().item() if Tk == 1 else None
    for name, x, y in zip(("dq", "dk", "dv", "dbias"), got, want):
        if y is None:
            assert x is None
            continue
        assert x.shape == y.shape and torch.isfinite(x.float()).all()
        _close(x, y, "bfloat16", None if name == "dv" else noise)
    for b, n in enumerate(lens):
        if n == 0:
            assert all((x[b] == 0).all() for x in got[:3])
    again = fa.flash_bwd(q, k, v, mask, o, lse, do, **kw)
    assert all(x is None or torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("bias_dtype", [None, "bfloat16"], ids=["no_bias", "bias"])
@pytest.mark.parametrize("Tq, Tk", MMA_EDGE_T, ids=[f"q{a}_k{b}" for a, b in MMA_EDGE_T])
def test_flash_bwd_mma_tile_edges_match_plain(card, Tq, Tk, bias_dtype, rate):
    """The tensor-core dq and dk/dv (D 64) where their tiles end, with and
    without T5's bf16 bias and dropout 0.1."""
    _mma_bwd_case(card, Tq, Tk, 64, bias_dtype, rate)


@pytest.mark.parametrize("bias_dtype", [None, "bfloat16", "float32"],
                         ids=["no_bias", "bf16_bias", "fp32_bias"])
@pytest.mark.parametrize("D", MMA_WIDTHS)
def test_flash_bwd_mma_every_width_matches_plain(card, D, bias_dtype):
    """Every head width the tensor-core instances take, at ragged Tq 129,
    Tk 200, dropout 0.1, without a bias and with a bf16 or fp32 one."""
    _mma_bwd_case(card, 129, 200, D, bias_dtype, 0.1)


@pytest.mark.parametrize("D", MMA_WIDTHS)
def test_flash_bwd_mma_causal_every_width_matches_plain(card, D):
    """The causal build's tensor-core dq and dk/dv at every head width: T
    129 with ragged keys and an all-padding row, the bf16 bias and dropout
    0.1."""
    _mma_bwd_case(card, 129, 129, D, "bfloat16", 0.1, causal=True, lens=[129, 70, 0])


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("D", [40, 64])
def test_flash_fp32_bwd_takes_unaligned_views(card, D, rate):
    """fp32 q, k, v and do as views that start 4 bytes past a 16-byte
    boundary with a row stride of D + 3 elements: the FMA dq and dk/dv
    stage their tiles 4 bytes a copy and give the bits of the same call
    on contiguous copies, within 1e-4 of scale of attention_bwd_plain."""
    B, H, Tq, Tk = 2, 3, 90, 77
    g = torch.Generator().manual_seed(D)

    def view(T):
        buf = torch.randn(B * H * T * (D + 3) + 1, generator=g).to(card)
        return buf[1:].as_strided((B, H, T, D), (H * T * (D + 3), T * (D + 3), D + 3, 1))

    q, do, k, v = view(Tq), view(Tq), view(Tk), view(Tk)
    assert q.data_ptr() % 16 == 4
    bias = torch.randn(H, Tq, Tk, generator=g).to(card)
    mask = (torch.arange(Tk)[None, :] < torch.tensor([77, 50])[:, None]).to(card)
    kw = {"dropout_rate": rate, "seed": 31, "bias": bias}
    o, lse = fa.flash_fwd(q, k, v, mask, **kw)
    got = fa.flash_bwd(q, k, v, mask, o, lse, do, **kw)[:3]
    dense = fa.flash_bwd(q.contiguous(), k.contiguous(), v.contiguous(), mask, o, lse,
                         do.contiguous(), **kw)[:3]
    bits = fa.dropout_bits(31, B, H, Tq, Tk, card) if rate else None
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, dropout_rate=rate, bits=bits,
                                  bias=bias)[:3]
    torch.cuda.synchronize()
    for x, y, z in zip(got, dense, want):
        assert torch.equal(x, y)
        _close(x, z, "float32")


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("biased", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("D", [40, 64])
def test_flash_fp32_fwd_takes_unaligned_and_strided_views(card, D, biased, rate):
    """The FMA forward on fp32 views that start 4 bytes past a 16-byte
    boundary with a row stride of D + 3 elements (its tiles come in 4
    bytes a copy; with the bias, a bias view of row stride Tk + 3 too) and
    on the strided views of a fused [B, T, 3, H, D] product: the bits of
    the same call on contiguous copies, o within 1e-5 and lse within 1e-5
    of attention_plain."""
    B, H, Tq, Tk = 2, 3, 90, 77
    g = torch.Generator().manual_seed(D + 2 * biased)

    def view(T):
        buf = torch.randn(B * H * T * (D + 3) + 1, generator=g).to(card)
        return buf[1:].as_strided((B, H, T, D), (H * T * (D + 3), T * (D + 3), D + 3, 1))

    q, k, v = view(Tq), view(Tk), view(Tk)
    assert q.data_ptr() % 16 == 4
    bias = None
    if biased:
        wide = torch.randn(H * Tq * (Tk + 3) + 1, generator=g).to(card)
        bias = wide[1:].as_strided((H, Tq, Tk), (Tq * (Tk + 3), Tk + 3, 1))
    mask = (torch.arange(Tk)[None, :] < torch.tensor([77, 50])[:, None]).to(card)
    kw = {"scale": 1.0, "dropout_rate": rate, "seed": 31, "bias": bias}
    o, lse = fa.flash_fwd(q, k, v, mask, **kw)
    dense = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                         **{**kw, "bias": None if bias is None else bias.contiguous()})
    qkv = torch.randn(B, Tq, 3 * H * D, generator=g).to(card).view(B, Tq, 3, H, D)
    sq, sk, sv = (qkv[:, :, i].transpose(1, 2)[:, :, :Tk] if i else qkv[:, :, i].transpose(1, 2)
                  for i in range(3))
    so, slse = fa.flash_fwd(sq, sk, sv, mask, **kw)
    sdense = fa.flash_fwd(sq.contiguous(), sk.contiguous(), sv.contiguous(), mask, **kw)
    bits = fa.dropout_bits(31, B, H, Tq, Tk, card) if rate else None
    po, plse = fa.attention_plain(q, k, v, mask, 1.0, rate, bits, bias)
    spo, splse = fa.attention_plain(sq, sk, sv, mask, 1.0, rate, bits, bias)
    torch.cuda.synchronize()
    assert torch.equal(o, dense[0]) and torch.equal(lse, dense[1])
    assert torch.equal(so, sdense[0]) and torch.equal(slse, sdense[1])
    for got, want in ((o, po), (lse, plse), (so, spo), (slse, splse)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "Tq, Tk, biased, causal",
    [(128, 128, True, True), (128, 256, False, False), (256, 256, True, False)],
    ids=["decoder_t128_causal_biased", "cross_t128x256", "encoder_t256_biased"],
)
def test_flash_fp32_fwd_at_the_generation_calls(card, Tq, Tk, biased, causal):
    """The FMA forward at the generation path's three calls (B 16, H 12,
    D 64, fp32, T5's scale 1.0, the last row's keys padded at the end):
    one launch, o within 1e-5 and lse within 1e-5 of attention_plain, the
    same bits on a repeat."""
    B, H, D = 16, 12, 64
    g = torch.Generator().manual_seed(Tq + Tk)
    q = (torch.randn(B, H, Tq, D, generator=g) * D ** -0.5).to(card)
    k, v = (torch.randn(B, H, Tk, D, generator=g).to(card) for _ in range(2))
    bias = (torch.randn(H, Tq, Tk, generator=g) * 0.5).to(card) if biased else None
    mask = (torch.arange(Tk)[None, :] < torch.tensor([Tk] * (B - 1) + [Tk - 37])[:, None])
    mask = mask.to(card)
    kw = {"scale": 1.0, "bias": bias, "causal": causal}
    before = fa.LAUNCHES
    o, lse = fa.flash_fwd(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    po, plse = fa.attention_plain(q, k, v, mask, **kw)
    torch.testing.assert_close(o, po, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    o2, lse2 = fa.flash_fwd(q, k, v, mask, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_fwd_dropout_keeps_the_philox_mask(card):
    """The forward kernel's dropout against the plain version with the
    same seed, a keep fraction near 0.9, and another seed another o."""
    B, H, T, D = 4, 12, 256, 64
    q, k, v, _, mask = _bwd_inputs(card, B, H, T, T, D, "bfloat16", [256] * 4)
    o, lse = fa.flash_fwd(q, k, v, mask, dropout_rate=0.1, seed=99)
    po, plse = fa.attention_plain(q, k, v, mask, dropout_rate=0.1,
                                  bits=fa.dropout_bits(99, B, H, T, T, card))
    _close(o, po, "bfloat16")
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    keep = (fa.dropout_bits(99, B, H, T, T, card) < fa.keep_threshold(0.1)).double().mean()
    assert abs(keep.item() - 0.9) < 2e-3
    o2, _ = fa.flash_fwd(q, k, v, mask, dropout_rate=0.1, seed=100)
    assert not torch.equal(o, o2)
    with pytest.raises(ValueError, match="debug_bits"):
        fa.flash_fwd(q, k, v, mask, dropout_rate=0.1, seed=99,
                     debug_bits=fa.dropout_bits(99, B, H, T, T, card))


def test_flash_attention_grads_repeat_bit_equal(card):
    """FlashAttention through autograd on the encoder's strided views:
    the kernels' gradients repeat bit for bit (no atomics), and the fp32
    leaves of a bf16 product get fp32 gradients."""
    B, T, H, D = 4, 200, 12, 64
    g = torch.Generator().manual_seed(8)
    x = torch.randn(B, T, 3 * H * D, generator=g).to(card).requires_grad_()
    mask = (torch.arange(T)[None, :] < torch.tensor([200, 150, 3, 0])[:, None]).to(card)
    w = torch.randn(B, H, T, D, generator=g).bfloat16().to(card)

    def grads():
        x.grad = None
        qkv = x.bfloat16().view(B, T, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = fa.flash_attention(q, k, v, mask, dropout_rate=0.1, seed=5)
        (o.float() * w.float()).sum().backward()
        return x.grad.clone()

    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
    first, second = grads(), grads()
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) == tuple(b + 2 for b in before)
    assert first.dtype == torch.float32 and torch.equal(first, second)


BIAS_CASES = [
    # B, H, Tq, Tk, D, dtype, bias dtype, real keys per row, strided
    (4, 12, 256, 256, 64, "bfloat16", "bfloat16", [256, 200, 17, 0], False),
    (4, 12, 200, 200, 64, "bfloat16", "bfloat16", [200, 150, 3, 0], True),
    (2, 4, 130, 77, 128, "bfloat16", "float32", [77, 0], False),
    (3, 2, 96, 200, 64, "float32", "float32", [200, 131, 0], False),
    (2, 3, 70, 70, 40, "bfloat16", "bfloat16", [70, 9], False),
    (16, 12, 256, 256, 64, "float32", "float32", [256] * 16, False),
]
BIAS_IDS = ["t256_bf16", "training_strides", "cross_d128_fp32_bias", "cross_fp32",
            "ragged_d40_fma", "gen_encoder_fp32"]


def _bias_inputs(card, B, H, Tq, Tk, D, dtype, bias_dtype, lens, strided):
    """q, k, v, do, mask, bias; with `strided`, q/k/v are views of a fused
    [B, T, 3, H, D] product, do a view of [B, T, H, D] and the bias a
    [H, T, T] view of a wider buffer, as the T5 training path feeds them."""
    g = torch.Generator().manual_seed(B * 11 + Tq + D)
    td = getattr(torch, dtype)
    if strided:
        qkv = torch.randn(B, Tq, 3 * H * D, generator=g).to(td).to(card).view(B, Tq, 3, H, D)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.randn(B, Tq, H, D, generator=g).to(td).to(card).transpose(1, 2)
        wide = torch.randn(H, Tq, Tk + 8, generator=g).mul(2.0).to(getattr(torch, bias_dtype))
        bias = wide.to(card)[:, :, :Tk]
        assert not (q.is_contiguous() or do.is_contiguous() or bias.is_contiguous())
    else:
        q, do = (torch.randn(B, H, Tq, D, generator=g).to(td).to(card) for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, generator=g).to(td).to(card) for _ in range(2))
        bias = (torch.randn(H, Tq, Tk, generator=g) * 2.0).to(getattr(torch, bias_dtype)).to(card)
    mask = (torch.arange(Tk)[None, :] < torch.tensor(lens)[:, None]).to(card)
    return q, k, v, do, mask, bias


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("B, H, Tq, Tk, D, dtype, bias_dtype, lens, strided", BIAS_CASES,
                         ids=BIAS_IDS)
def test_flash_biased_kernels_match_plain(card, B, H, Tq, Tk, D, dtype, bias_dtype, lens,
                                          strided, rate):
    """Kernels 5-7 with the bias and kernel 8 (dbias) against the plain
    versions on the card (T5's scale 1.0), from the kernel's own forward;
    with dropout all draw the seed's Philox mask. All-padding rows get
    o = 0 and zero gradients; padded keys add nothing to dbias; a rerun
    gives the same bits; each kernel launches once per call."""
    q, k, v, do, mask, bias = _bias_inputs(card, B, H, Tq, Tk, D, dtype, bias_dtype, lens,
                                           strided)
    seed = 987654321
    kw = {"scale": 1.0, "dropout_rate": rate, "seed": seed, "bias": bias}
    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, mask, **kw)
    got = fa.flash_bwd(q, k, v, mask, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES) == tuple(
        b + 1 for b in before)
    bits = fa.dropout_bits(seed, B, H, Tq, Tk, card) if rate else None
    po, plse = fa.attention_plain(q, k, v, mask, 1.0, rate, bits, bias)
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, rate, bits, bias)
    _close(o, po, dtype)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    assert got[3].dtype == torch.float32 and got[3].shape == (H, Tq, Tk)
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.isfinite(x.float()).all()
        _close(x, y, dtype)
    for b, n in enumerate(lens):
        if n == 0:
            assert (o[b] == 0).all() and all((x[b] == 0).all() for x in got[:3])
    assert (got[3][:, :, max(lens):] == 0).all()
    again = fa.flash_bwd(q, k, v, mask, o, lse, do, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_dbias_repeats_bit_for_bit_at_the_t5_call(card):
    """Kernel 8 at the T5 flagship call (B 16, H 12, T 512, D 64, bf16,
    scale 1.0, ragged keys): its batch loop runs in order inside each
    block, so five runs give the same bits, and match the plain dbias."""
    B, H, T, D = 16, 12, 512, 64
    lens = [512, 480, 300, 257, 129, 64, 33, 1] + [512] * 8
    q, k, v, do, mask, bias = _bias_inputs(card, B, H, T, T, D, "bfloat16", "bfloat16", lens,
                                           False)
    o, lse = fa.flash_fwd(q, k, v, mask, scale=1.0, bias=bias)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    runs = [fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, bias=bias)[3]
    _close(runs[0], want, "bfloat16")


#: the tensor-core dbias at the T5 training path's buckets (token budget
#: 8192): B, T, real keys per row, the training path's strides, dropout
#: rate; the short buckets' batches are cut into runs of rows
T5_BUCKET_CASES = [
    (64, 128, [128, 100, 65, 64, 1, 0, 127, 128] * 8, False, 0.0),
    (64, 128, [128] * 64, True, 0.1),
    (32, 256, [256, 255, 200, 129, 128, 0, 1, 256] * 4, False, 0.1),
    (32, 256, [256] * 32, True, 0.0),
    (16, 512, [512, 480, 300, 0] * 4, True, 0.1),
]
T5_BUCKET_IDS = ["t128_ragged", "t128_strided_dropout", "t256_ragged_dropout", "t256_strided",
                 "t512_strided_dropout"]


@pytest.mark.parametrize("B, T, lens, strided, rate", T5_BUCKET_CASES, ids=T5_BUCKET_IDS)
def test_mma_dbias_at_the_t5_buckets_matches_plain_and_repeats(card, B, T, lens, strided, rate):
    """Kernel 8's tensor-core instance (bf16 bias, scale 1.0, 12 heads) at
    the T5 path's three buckets, ragged and all-padding rows, the training
    path's strided views, at dropout 0 and 0.1: within 2e-2 of the plain
    dbias's largest magnitude, padded keys' columns exactly 0, one launch
    a call and five runs the same bits; T 128 and 256 cut the batch."""
    H = 12
    slices = fa._library(False).flash_dbias_workspace_floats(B, H, T, T, 64, 1) // (H * T * T)
    assert (slices > 1) == (T < 512)  # 64 x 64 tiles, ~528 live blocks
    q, k, v, do, mask, bias = _bias_inputs(card, B, H, T, T, 64, "bfloat16", "bfloat16", lens,
                                           strided)
    seed = 13579
    kw = {"scale": 1.0, "dropout_rate": rate, "seed": seed}
    o, lse = fa.flash_fwd(q, k, v, mask, bias=bias, **kw)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    before = fa.DBIAS_LAUNCHES
    runs = [fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, **kw) for _ in range(5)]
    torch.cuda.synchronize()
    assert fa.DBIAS_LAUNCHES == before + 5
    bits = fa.dropout_bits(seed, B, H, T, T, card) if rate else None
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, rate, bits, bias)[3]
    assert torch.isfinite(runs[0]).all()
    _close(runs[0], want, "bfloat16")
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert (runs[0][:, :, max(lens):] == 0).all()


DBIAS_FMA_CASES = [
    # B, Tq, Tk, D, dtype (q's and the bias's), real keys per row, causal
    (1, 100, 77, 64, "float32", [77], False),
    (3, 100, 77, 64, "float32", [77, 40, 0], False),
    (5, 100, 100, 64, "float32", [100, 60, 1, 0, 100], True),
    (3, 100, 77, 40, "bfloat16", [77, 13, 0], False),
    (4, 100, 100, 40, "bfloat16", [100, 50, 99, 0], True),
    (16, 128, 128, 64, "float32", [128] * 16, True),
]
DBIAS_FMA_IDS = ["b1_q100_k77", "q100_k77_padded", "causal_t100_padded", "bf16_d40_q100_k77",
                 "bf16_d40_causal_t100", "gen_decoder_cut_batch"]


@pytest.mark.parametrize("B, Tq, Tk, D, dtype, lens, causal", DBIAS_FMA_CASES,
                         ids=DBIAS_FMA_IDS)
def test_fma_dbias_matches_plain_and_repeats(card, B, Tq, Tk, D, dtype, lens, causal):
    """Kernel 8's FMA instance (fp32, and bf16 at a width the tensor cores
    do not take) at tiles that Tq and Tk do not fill, one batch row or a
    batch cut into slices, padded keys, an fp32 or bf16 bias, in both
    builds: within 1e-4 (fp32) or 2e-2 (bf16) of the plain dbias's largest
    magnitude, padded keys' columns and (causal) the upper triangle exactly
    0, one launch a call, and five runs the same bits."""
    _check_fma_dbias(card, B, 3, Tq, Tk, D, dtype, lens, causal)


#: batches that the FMA dbias cuts into runs of several rows (12 heads:
#: few slices fill the card): the clone path's encoder (ragged rows) and
#: causal decoder, and an odd batch whose last run is shorter
DBIAS_RUN_CASES = [
    (32, 256, "float32", [256, 255, 200, 129, 128, 64, 1, 0] * 4, False),
    (32, 256, "float32", [256] * 32, True),
    (13, 200, "float32", [200, 199, 150, 64, 1, 0, 200] * 2, True),
]
DBIAS_RUN_IDS = ["clone_encoder_b32", "clone_decoder_b32_causal", "b13_t200_causal_padded"]


@pytest.mark.parametrize("B, T, dtype, lens, causal", DBIAS_RUN_CASES, ids=DBIAS_RUN_IDS)
def test_fma_dbias_sums_runs_of_rows_in_order(card, B, T, dtype, lens, causal):
    """The FMA dbias where each block sums a run of several batch rows
    before the partials are summed in slice order: the same gates as
    test_fma_dbias_matches_plain_and_repeats (within 1e-4 of the plain
    dbias's largest magnitude, padded and causal zeros, five runs the same
    bits)."""
    H = 12
    floats = fa._library(causal).flash_dbias_workspace_floats(B, H, T, T, 64, 0)
    slices = floats // (H * T * T)
    assert 1 < slices < B  # a cut, with runs of more than one row
    _check_fma_dbias(card, B, H, T, T, 64, dtype, lens[:B], causal)


def _check_fma_dbias(card, B, H, Tq, Tk, D, dtype, lens, causal):
    g = torch.Generator().manual_seed(B * 17 + Tq + Tk + D)
    td = getattr(torch, dtype)
    q, do = (torch.randn(B, H, Tq, D, generator=g).to(td).to(card) for _ in range(2))
    k, v = (torch.randn(B, H, Tk, D, generator=g).to(td).to(card) for _ in range(2))
    bias = (torch.randn(H, Tq, Tk, generator=g) * 2.0).to(td).to(card)
    mask = (torch.arange(Tk)[None, :] < torch.tensor(lens)[:, None]).to(card)
    kw = {"scale": 1.0, "causal": causal}
    o, lse = fa.flash_fwd(q, k, v, mask, bias=bias, **kw)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    before = fa.DBIAS_LAUNCHES
    runs = [fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, **kw) for _ in range(5)]
    torch.cuda.synchronize()
    assert fa.DBIAS_LAUNCHES == before + 5
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, bias=bias, causal=causal)[3]
    assert torch.isfinite(runs[0]).all()
    _close(runs[0], want, dtype)
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert (runs[0][:, :, max(lens):] == 0).all()
    if causal:
        assert (runs[0][:, torch.ones(Tq, Tk, dtype=torch.bool, device=card).triu(1)] == 0).all()


def test_flash_attention_bias_grad_flows_on_the_card(card):
    """FlashAttention with a bias leaf on the card: the bias's gradient in
    its dtype from kernel 8, none when it needs no gradient (kernel 8
    then does not launch), and causal with Tq != Tk refused."""
    B, H, T, D = 2, 4, 96, 64
    q, k, v, do, mask, bias = _bias_inputs(card, B, H, T, T, D, "bfloat16", "bfloat16",
                                           [96, 50], False)
    leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
    o = fa.flash_attention(*leaves[:3], mask, scale=1.0, bias=leaves[3])
    o.backward(do)
    assert leaves[3].grad.dtype == torch.bfloat16
    lse = fa.flash_fwd(q, k, v, mask, scale=1.0, bias=bias)[1]
    want = fa.flash_bwd(q, k, v, mask, o.detach(), lse, do, scale=1.0, bias=bias)
    assert torch.equal(leaves[3].grad, want[3].to(torch.bfloat16))
    before = fa.DBIAS_LAUNCHES
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, mask, scale=1.0, bias=bias).backward(do)
    assert fa.DBIAS_LAUNCHES == before
    with pytest.raises(ValueError, match="causal needs Tq == Tk"):
        fa.flash_attention(q, k[:, :, :64], v[:, :, :64], mask[:, :64], causal=True)
    with pytest.raises(TypeError, match="bias"):
        fa.flash_fwd(q, k, v, mask, bias=bias.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, k, v, mask, bias=bias.transpose(1, 2))


def _defect_cfg(dtype="bfloat16", **kw):
    from deepdfa_tpu_torch.models import DefectConfig, T5Config

    enc = T5Config.tiny(vocab_size=256, hidden_size=128, num_heads=2, head_dim=64,
                        ffn_size=256, dtype=dtype, **kw)
    return DefectConfig(encoder=enc, graph_hidden_dim=32, graph_input_dim=52)


def test_defect_train_step_repeats_bit_for_bit(card):
    """Two CombinedTrainers from one seed take one DefectModel step (bf16,
    dropout 0.1, remat) on one batch: the same loss and the same weights
    after the update, to the bit; the step ran kernels 5-8 and the GGNN
    kernels."""
    from deepdfa_tpu_torch.core.config import DataConfig
    from deepdfa_tpu_torch.data.text import collate
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.train import CombinedTrainer

    rng = np.random.default_rng(3)
    tok = HashTokenizer(256, t5_frame=True)
    texts = [" ".join(["x", "y", "z"][i % 3] for i in range(int(rng.integers(5, 60))))
             for _ in range(8)]
    specs = _graphs(rng, 8)
    batch = collate(tok.batch_encode(texts, 64), [i % 2 for i in range(8)], list(range(8)),
                    {i: specs[i] for i in range(8)}, 8, 512, 2048, pad_id=0).to(card)
    cfg = Config(data=DataConfig(seq_buckets=(), token_budget=512))
    results = []
    for _ in range(2):
        trainer = CombinedTrainer(cfg, _defect_cfg(), total_steps=1, device=card)
        state = trainer.init_state(seed=0)
        before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES, gk.LAUNCHES)
        loss = trainer.train_step(state, batch, 1234)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(
            (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES, gk.LAUNCHES),
            before))
        results.append((loss.item(), {k: v.clone() for k, v in state.model.state_dict().items()}))
    assert launched == (4, 2, 2, 2, 5)  # 2 layers (+ their remat replays); 5 GGNN steps
    assert np.isfinite(results[0][0]) and results[0][0] == results[1][0]
    assert all(torch.equal(results[0][1][k], results[1][1][k]) for k in results[0][1])


def test_defect_serving_on_card_matches_cpu(card):
    """A small fp32 DefectModel scored through score_combined on the card
    against the CPU plain path: 2 biased flash launches and 5 GGNN steps
    per batch."""
    from deepdfa_tpu_torch.core.config import DataConfig
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import DefectModel
    from deepdfa_tpu_torch.serve import CombinedExecutor, score_combined

    def model():
        return DefectModel(_defect_cfg("float32"),
                           generator=torch.Generator().manual_seed(0)).eval()

    rng = np.random.default_rng(4)
    tok = HashTokenizer(256, t5_frame=True)
    specs = _graphs(rng, 12)
    payloads = [(" ".join(["x"] * int(rng.integers(1, 60))), specs[i] if i % 3 else None)
                for i in range(12)]
    cfg = Config(data=DataConfig(seq_buckets=(16, 32, 64), token_budget=256),
                 serve=ServeConfig(node_budget=512, edge_budget=2048, max_batch_delay_ms=2.0))
    summary = score_combined(model(), payloads, cfg, tok)
    assert summary["device"].startswith("cuda") and summary["serve_scored"] == 12
    assert summary["flash_fwd_launches"] == summary["serve_batches"] * 2
    assert summary["ggnn_step_launches"] == summary["serve_batches"] * 5
    cpu = CombinedExecutor(model(), tok, (16, 32, 64), 256, 512, 2048, device="cpu")
    want = [r.wait(0) for r in DynamicBatcher(cpu).score_all(
        [(tok.encode(t, 64), s) for t, s in payloads])]
    np.testing.assert_allclose(summary["probs"], want, rtol=RTOL, atol=ATOL)


CAUSAL_CASES = [
    # B, H, T, D, dtype, biased, lens, lead_pad
    (4, 3, 200, 64, "bfloat16", True, [200, 150, 64, 1], 70),
    (4, 3, 200, 64, "float32", True, [200, 150, 64, 1], 70),
    (2, 4, 256, 64, "bfloat16", False, [256, 100], 0),
    (2, 4, 130, 32, "float32", False, [130, 65], 3),
    (2, 2, 96, 40, "bfloat16", True, [96, 50], 0),
    (16, 12, 128, 64, "float32", True, [128] * 16, 0),
    # the tensor-core instances' tile edges with ragged keys
    (3, 2, 63, 64, "bfloat16", False, [63, 10, 2], 1),
    (3, 2, 65, 64, "bfloat16", True, [65, 33, 1], 7),
    (3, 2, 127, 64, "bfloat16", False, [127, 64, 65], 0),
    (3, 2, 129, 64, "bfloat16", True, [129, 128, 65], 3),
]
CAUSAL_IDS = ["bf16_T200_biased_lead_pad", "fp32_T200_biased_lead_pad", "bf16_T256",
              "fp32_T130_D32", "bf16_D40_fma", "gen_decoder_fp32", "bf16_T63_lead_pad",
              "bf16_T65_biased_lead_pad", "bf16_T127", "bf16_T129_biased_lead_pad"]


def _causal_inputs(card, B, H, T, D, dtype, biased, lens, lead_pad):
    g = torch.Generator().manual_seed(B * 13 + T + D)
    td = getattr(torch, dtype)
    q, k, v, do = (torch.randn(B, H, T, D, generator=g).to(td).to(card) for _ in range(4))
    bias = (torch.randn(H, T, T, generator=g) * 2.0).to(td).to(card) if biased else None
    mask = torch.arange(T)[None, :] < torch.tensor(lens)[:, None]
    mask[-1, :lead_pad] = False
    return q, k, v, do, mask.to(card), bias


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("B, H, T, D, dtype, biased, lens, lead_pad", CAUSAL_CASES,
                         ids=CAUSAL_IDS)
def test_flash_causal_kernels_match_plain(card, B, H, T, D, dtype, biased, lens, lead_pad,
                                          rate):
    """The causal instances of kernels 5-8 against the plain versions on
    the card: ragged T, keys padded at the end and at the start (queries
    without a live key get o = 0 and zero gradients), with and without
    the bias and dropout; dbias is exactly 0 above the diagonal; a rerun
    gives the same bits; each kernel launches once per call."""
    q, k, v, do, mask, bias = _causal_inputs(card, B, H, T, D, dtype, biased, lens, lead_pad)
    seed = 24681357
    kw = {"scale": 1.0, "dropout_rate": rate, "seed": seed, "bias": bias, "causal": True}
    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, mask, **kw)
    got = fa.flash_bwd(q, k, v, mask, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES) == tuple(
        b + n for b, n in zip(before, (1, 1, 1, int(biased))))
    bits = fa.dropout_bits(seed, B, H, T, T, card) if rate else None
    po, plse = fa.attention_plain(q, k, v, mask, 1.0, rate, bits, bias, causal=True)
    want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, 1.0, rate, bits, bias,
                                  causal=True)
    _close(o, po, dtype)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
            continue
        assert x.shape == y.shape and torch.isfinite(x.float()).all()
        _close(x, y, dtype)
    if lead_pad:
        assert (o[-1, :, :lead_pad] == 0).all() and (got[0][-1, :, :lead_pad] == 0).all()
    if biased:
        upper = torch.ones(T, T, dtype=torch.bool, device=card).triu(1)
        assert (got[3][:, upper] == 0).all()
    again = fa.flash_bwd(q, k, v, mask, o, lse, do, **kw)
    assert all(x is None or torch.equal(x, y) for x, y in zip(got, again))


def test_flash_causal_dbias_writes_every_tile(card):
    """The dead tiles of causal dbias are written (zeros), not left as
    whatever the allocator hands back: the cache is first filled with NaN,
    and at the decoder call of the gen path (fp32, B 16, H 12, T 128) and
    at the bf16 flagship (T 512) the upper triangle comes back 0."""
    for B, H, T, dtype in ((16, 12, 128, "float32"), (16, 12, 512, "bfloat16")):
        q, k, v, do, mask, bias = _causal_inputs(card, B, H, T, 64, dtype, True, [T] * B, 0)
        o, lse = fa.flash_fwd(q, k, v, mask, scale=1.0, bias=bias, causal=True)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        junk = torch.full((H, T, T), float("nan"), device=card)
        del junk  # the allocator's cache now holds NaN where dbias will land
        dbias = fa.flash_dbias(q, k, v, mask, lse, delta, do, bias, scale=1.0, causal=True)
        upper = torch.ones(T, T, dtype=torch.bool, device=card).triu(1)
        assert torch.isfinite(dbias).all() and (dbias[:, upper] == 0).all()


def test_flash_attention_causal_launches_the_causal_instances(card):
    """flash_attention(causal=True) on CUDA tensors runs the causal build
    (`flash_attention_causal`) forward and backward, and agrees with the
    plain causal version; the non-causal build is a different library."""
    assert fa._library(True).flash_causal() == 1 and fa._library(False).flash_causal() == 0
    q, k, v, do, mask, bias = _causal_inputs(card, 2, 4, 96, 64, "float32", True, [96, 40], 0)
    leaves = [x.detach().requires_grad_() for x in (q, k, v, bias)]
    before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES)
    o = fa.flash_attention(*leaves[:3], mask, scale=1.0, bias=leaves[3], causal=True)
    o.backward(do)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES) == tuple(
        b + 1 for b in before)
    want = fa.attention_plain(q, k, v, mask, 1.0, bias=bias, causal=True)[0]
    _close(o.detach(), want, "float32")
    noncausal = fa.flash_attention(q, k, v, mask, scale=1.0, bias=bias)
    assert not torch.allclose(noncausal, o.detach())


def _gen_cfg(dtype="float32"):
    from deepdfa_tpu_torch.models import GenConfig, T5Config

    enc = T5Config.tiny(vocab_size=256, hidden_size=128, num_heads=2, head_dim=64,
                        ffn_size=256, dtype=dtype)
    return GenConfig(encoder=enc, max_target_length=24, beam_size=3)


def test_gen_train_step_repeats_bit_for_bit(card):
    """Two GenTrainers from one seed take one step (fp32, dropout 0.1,
    remat) on one batch: the same loss and weights to the bit; the step
    ran kernels 5-8: per layer and its remat replay the encoder's biased
    forward, the decoder's causal biased forward and its cross forward."""
    from deepdfa_tpu_torch.data.gen_data import collate_gen
    from deepdfa_tpu_torch.train import GenTrainer

    rng = np.random.default_rng(5)
    src = rng.integers(3, 256, (6, 40)).astype(np.int32)
    tgt = rng.integers(3, 256, (6, 24)).astype(np.int32)
    src[2, 30:] = 0
    tgt[3, 10:] = 0
    batch = collate_gen(src, tgt, 8).to(card)
    results = []
    for _ in range(2):
        trainer = GenTrainer(Config(), _gen_cfg(), total_steps=1, device=card)
        state = trainer.init_state(seed=0)
        before = (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES)
        loss = trainer.train_step(state, batch, 99)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(
            (fa.LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES, fa.DBIAS_LAUNCHES), before))
        results.append((loss.item(), {k: v.clone() for k, v in state.model.state_dict().items()}))
    # 2 encoder + 2 x 2 decoder attentions, each replayed once; dbias: 2 + 2
    assert launched == (12, 6, 6, 4)
    assert np.isfinite(results[0][0]) and results[0][0] == results[1][0]
    assert all(torch.equal(results[0][1][k], results[1][1][k]) for k in results[0][1])


def _attn_saved_case(model: str, policy: str, card):
    """(trainer, state, batch) of one small model on the card under
    `policy`: the combined model (bf16, D 64), the defect model (bf16,
    biased) or the generation model (fp32, causal and cross)."""
    import dataclasses

    from deepdfa_tpu_torch.core.config import DataConfig
    from deepdfa_tpu_torch.data.gen_data import collate_gen
    from deepdfa_tpu_torch.data.text import collate
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import CombinedConfig, TransformerConfig
    from deepdfa_tpu_torch.train import CombinedTrainer, GenTrainer

    rng = np.random.default_rng(11)
    if model == "gen":
        src = rng.integers(3, 256, (6, 40)).astype(np.int32)
        tgt = rng.integers(3, 256, (6, 24)).astype(np.int32)
        src[2, 30:] = 0
        tgt[3, 10:] = 0
        gcfg = _gen_cfg()
        gcfg = dataclasses.replace(gcfg, encoder=dataclasses.replace(gcfg.encoder,
                                                                     remat_policy=policy))
        trainer = GenTrainer(Config(), gcfg, total_steps=1, device=card)
        return trainer, trainer.init_state(seed=0), collate_gen(src, tgt, 8).to(card)
    t5 = model == "t5"
    tok = HashTokenizer(256, t5_frame=t5)
    texts = [" ".join(["x", "y", "z"][i % 3] for i in range(int(rng.integers(5, 60))))
             for _ in range(8)]
    specs = _graphs(rng, 8)
    batch = collate(tok.batch_encode(texts, 64), [i % 2 for i in range(8)], list(range(8)),
                    {i: specs[i] for i in range(8)}, 8, 512, 2048, pad_id=tok.pad_id).to(card)
    if t5:
        mcfg = _defect_cfg(remat_policy=policy)
    else:
        mcfg = CombinedConfig(encoder=TransformerConfig.tiny(
            vocab_size=256, hidden_size=128, num_heads=2, intermediate_size=256,
            dtype="bfloat16", remat_policy=policy), graph_hidden_dim=32, graph_input_dim=52)
    cfg = Config(data=DataConfig(seq_buckets=(), token_budget=512))
    trainer = CombinedTrainer(cfg, mcfg, total_steps=1, device=card)
    return trainer, trainer.init_state(seed=0), batch


@pytest.mark.parametrize("model", ["combined", "t5", "gen"])
def test_attn_saved_halves_the_forward_launches_with_the_same_bits(card, model):
    """One step's loss and every gradient under remat_policy="attn_saved"
    equal "full"'s to the bit; the flash forward launches once a layer
    instead of twice (its replay takes the saved output), and dq, dk/dv
    and dbias launch as often."""
    counters = ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES", "DBIAS_LAUNCHES")
    out = {}
    for policy in ("full", "attn_saved"):
        trainer, state, batch = _attn_saved_case(model, policy, card)
        before = [getattr(fa, c) for c in counters]
        loss = trainer.forward_loss(state, batch, 1234)
        loss.backward()
        torch.cuda.synchronize()
        launched = [getattr(fa, c) - b for c, b in zip(counters, before)]
        grads = {k: p.grad.clone() for k, p in state.model.named_parameters()
                 if p.grad is not None}
        out[policy] = (loss.detach(), grads, launched)
    (l1, g1, n1), (l2, g2, n2) = out["full"], out["attn_saved"]
    assert torch.isfinite(l1) and torch.equal(l1, l2) and g1.keys() == g2.keys()
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert n1[0] == 2 * n2[0] > 0 and n1[1:] == n2[1:]


def test_cascade_on_the_card_matches_the_cpu(card, tmp_path, monkeypatch):
    """A GGNN stage 1 and a combined stage 2 (fp32) served in cascade mode
    on the card and on the CPU: the same stage for every function (the
    band's edges lie between stage-1 scores), stage-1 scores within the
    GGNN kernels' fp32 bound and stage-2 scores within the flash kernel's
    fp32 bound of the CPU's."""
    import json

    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.eval import calibrate
    from deepdfa_tpu_torch.serve import driver
    from deepdfa_tpu_torch.serve.cascade import build_stage2_smoke
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import ScoringService, score_texts

    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cfg, run_dir, src = driver.build_smoke_run(
        extra_overrides=["serve.node_budget=2048", "serve.edge_budget=8192"], device="cpu",
        vuln_rate=0.5)
    build_stage2_smoke(run_dir, cfg, family="combined")
    texts = [(p.name, p.read_text()) for p in sorted(src.glob("*.c"))]
    plain = ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), cfg)
    try:
        p1 = sorted(r["prob"] for r in score_texts(plain, texts))
    finally:
        plain.close()
    cal = calibrate.temperature_scale(p1, 1.3)
    q = len(cal) // 4
    band = [float(cal[q - 1] + cal[q]) / 2, float(cal[3 * q - 1] + cal[3 * q]) / 2]
    ccfg = config_mod.apply_overrides(cfg, [
        "serve.cascade=true", f"serve.cascade_band={json.dumps(band)}",
        "serve.cascade_temperature=1.3"])
    rows = {}
    for device in ("cpu", card):
        service = ScoringService(ModelRegistry(run_dir, cfg=ccfg, device=device), ccfg)
        try:
            rows[str(device)] = score_texts(service, texts)
        finally:
            service.close()
    cpu, got = rows["cpu"], rows[str(card)]
    assert [r["stage"] for r in got] == [r["stage"] for r in cpu]
    assert 0 < sum(r["stage"] == 2 for r in got) < len(got)
    for a, b in zip(got, cpu):
        np.testing.assert_allclose(a["stage1_prob"], b["stage1_prob"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a["prob"], b["prob"], rtol=RTOL, atol=ATOL)


# -- line-level localization ------------------------------------------------------


def _localize_case(card):
    """(model on the card, the same weights on the CPU, a batch of 8
    graphs on each): a flagship-width DeepDFA (hidden 32: d 128, 5
    steps)."""
    model = DeepDFA(52, 32, 5, generator=torch.Generator().manual_seed(0)).eval()
    cpu = DeepDFA(52, 32, 5).eval()
    cpu.load_state_dict(model.state_dict())
    packed = pack(_graphs(np.random.default_rng(9), 8), 8, 1024, 4096)
    return model.to(card), cpu, packed.to(card), packed.to("cpu")


@pytest.mark.parametrize("method", ["attention", "saliency", "input_x_gradient", "deeplift",
                                    "lig"])
def test_ggnn_attribution_on_card_matches_cpu(card, method):
    """ggnn_score_fn on the card against the CPU plain path: probabilities
    at RTOL/ATOL, node scores within 1e-4 of each graph's largest |score|,
    padding zero, the same bits on a repeat; kernel 1 with the aggregate,
    B3 and B4 5 times a gradient evaluation (3 path steps here), kernel 1
    without it 5 times a forward alone."""
    from deepdfa_tpu_torch.eval.localize import ggnn_score_fn

    model, cpu, b, cpu_b = _localize_case(card)
    run = ggnn_score_fn(method, model, n_steps=3)
    gk.reset_launch_counts()
    probs, scores = run(b)
    torch.cuda.synchronize()
    counts = {k: v for k, v in gk.launch_counts().items() if v}
    evals = {"attention": 0, "saliency": 1, "input_x_gradient": 1}.get(method, 3)
    alone = method in ("attention", "deeplift", "lig")
    want = {"LAUNCHES": 5 * (evals + alone), "AGGREGATE_LAUNCHES": 5 * evals,
            "GRU_BWD_LAUNCHES": 5 * evals, "DMSG_LAUNCHES": 5 * evals}
    assert counts == {k: v for k, v in want.items() if v}
    again = run(b)
    assert torch.equal(again[0], probs) and torch.equal(again[1], scores)
    want_p, want_s = ggnn_score_fn(method, cpu, n_steps=3)(cpu_b)
    torch.testing.assert_close(probs.cpu(), want_p, rtol=RTOL, atol=ATOL)
    graph, mask = cpu_b.node_graph.numpy(), cpu_b.node_mask.numpy()
    s, ws = scores.cpu().numpy(), want_s.numpy()
    scale = np.zeros(9)
    np.maximum.at(scale, graph, np.abs(ws))
    assert np.all(np.abs(s - ws)[mask] <= 1e-4 * scale[graph][mask])
    assert np.all(s[~mask] == 0)


@pytest.mark.parametrize("d", [128, 288])
def test_input_only_backward_on_card_keeps_the_bits(card, d):
    """step_bwd without the weights: B3 skips its weight pass, dh the same
    bits as the full backward's; one B3 and one B4 launch each."""
    rng = np.random.default_rng(5)
    b, edges, h, params = _policy_case(rng, 512, d, 1, 8, card, transpose=True)
    wm, _, wih, whh, bih, bhh = params
    a = torch.randn_like(h)
    g = torch.randn_like(h)
    full = gk.step_bwd(h, a, g, edges, wm, wih, whh, bih, bhh)
    before = gk.launch_counts()
    only = gk.step_bwd(h, a, g, edges, wm, wih, whh, bih, bhh, weights=False)
    torch.cuda.synchronize()
    after = gk.launch_counts()
    assert torch.equal(full[0], only[0]) and all(x is None for x in only[1:])
    assert after["GRU_BWD_LAUNCHES"] - before["GRU_BWD_LAUNCHES"] == 1
    assert after["DMSG_LAUNCHES"] - before["DMSG_LAUNCHES"] == 1


def test_served_lines_on_card_equal_the_offline_program(card):
    """A function attributed alone by the served localizer on the card is
    the offline ggnn_score_fn at rung 1 to the bit; co-batched, the same
    line ranking and rtol 1e-5."""
    from deepdfa_tpu_torch.eval.localize import ggnn_score_fn, node_line_attributions
    from deepdfa_tpu_torch.serve.frontend import Features
    from deepdfa_tpu_torch.serve.localize import GgnnLocalizer

    model, _, _, _ = _localize_case(card)
    rng = np.random.default_rng(11)
    feats = [Features(s, rng.integers(1, 12, s.num_nodes).astype(np.int32))
             for s in _graphs(rng, 4)]
    loc = GgnnLocalizer(model, 1024, 4096, sizes=(1, 2, 4), method="lig", n_steps=3, top_k=0,
                        device=card)
    loc.warmup()
    offline = ggnn_score_fn("lig", model, n_steps=3)
    alone = []
    for f in feats:
        _, scores = offline(pack([f.spec], 1, 1024, 4096).to(card))
        want = node_line_attributions(scores.cpu().numpy()[:f.spec.num_nodes], f.node_lines)
        [(_, lines)] = loc.attribute([f])
        assert lines == want
        alone.append(lines)
    for (_, lines), ref in zip(loc.attribute(feats), alone):
        assert [d["line"] for d in lines] == [d["line"] for d in ref]
        np.testing.assert_allclose([d["score"] for d in lines], [d["score"] for d in ref],
                                   rtol=1e-5, atol=1e-7)


# -- host speed: pinned copies, events, streams, int8 entries ------------------


def test_pinned_batches_copy_without_blocking_and_keep_the_bits(card):
    """`GraphBatch.pinned()` / `TextBatch.pinned()` lie in page-locked
    memory, and `to(cuda, non_blocking=True)` from them gives the pageable
    copy's tensors."""
    from deepdfa_tpu_torch.data.text import collate

    rng = np.random.default_rng(30)
    b = pack(_graphs(rng, 6, n_etypes=2), 8, 512, 2048, etypes=True)
    host = b.pinned()
    assert host.node_feats.is_pinned() and host.edge_type.is_pinned()
    fast, slow = host.to(card, non_blocking=True), b.to(card)
    torch.cuda.synchronize()
    for f in ("node_feats", "node_graph", "edge_src", "edge_dst", "edge_mask", "edge_type"):
        assert torch.equal(getattr(fast, f), getattr(slow, f)), f
    tb = collate(rng.integers(4, 100, (3, 16)).astype(np.int32), [0, 1, 0], [0, 1, 2],
                 {0: _graphs(rng, 1)[0]}, 4, 256, 1024)
    thost = tb.pinned()
    assert thost.input_ids.is_pinned() and thost.graphs.node_feats.is_pinned()
    moved = thost.to(card, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(moved.input_ids.cpu(), torch.from_numpy(tb.input_ids))


def test_pipelined_executor_waits_on_its_event_and_keeps_the_bits(card):
    """The GGNN executor's dispatch returns before the card is done (a
    pinned output behind a CUDA event), fetch waits on that event, and
    depth 2 scores equal depth 0's bit for bit on the card."""
    from deepdfa_tpu_torch.serve.batcher import DeviceResult

    rng = np.random.default_rng(31)
    specs = _graphs(rng, 21)
    model = DeepDFA(52, 32, 5, generator=torch.Generator().manual_seed(1))
    ex = GgnnExecutor(model, 1024, 4096, 4, device=card)
    ex.warmup()
    _, packed = ex.pack_chunk("graph", specs[:4])
    assert packed[1].node_feats.is_pinned()
    handle = ex.dispatch("graph", packed)
    assert isinstance(handle, DeviceResult) and handle._event is not None
    assert ex.fetch(handle, 4).shape == (4,)
    want = [r.result for r in DynamicBatcher(ex, max_batch_delay_s=3600.0).score_all(specs)]
    for depth in (1, 2):
        got = DynamicBatcher(ex, max_batch_delay_s=3600.0, pipeline_depth=depth)
        assert [r.result for r in got.score_all(specs)] == want
        assert got.stats()["pipeline_in_flight_peak"] == depth


def test_prefetched_training_keeps_the_losses_on_the_card(card):
    """GraphTrainer.fit with prefetch 0 and 2 (two producers copying on a
    side stream, the consumer waiting on each copy's event) gives the
    same losses bit for bit on the card."""
    from deepdfa_tpu_torch.core import config as config_mod
    from deepdfa_tpu_torch.graphs import shard_bucket_batches
    from deepdfa_tpu_torch.train import GraphTrainer

    rng = np.random.default_rng(32)
    batches = list(shard_bucket_batches(_graphs(rng, 80), 8, 512, 2048))
    out = []
    for depth in (0, 2):
        cfg = config_mod.apply_overrides(Config(), [
            "model.hidden_dim=32", "model.n_steps=5", "train.log_every_steps=1",
            f"train.prefetch_batches={depth}", "train.prefetch_producers=2"])
        trainer = GraphTrainer(DeepDFA(52, 32, 5), cfg, total_steps=2 * len(batches),
                               device=card)
        state = trainer.init_state(seed=4)
        logged = []
        trainer.fit(state, lambda epoch: iter(batches), log_fn=logged.append, max_epochs=2)
        out.append([r["loss"] for r in logged if "step" in r])
    assert out[0] == out[1] and len(out[0]) == 2 * len(batches)


def test_quantized_model_on_card_matches_the_cpu(card):
    """An int8 tree served from the card: the dequantized weights are the
    CPU's bit for bit, and the scores agree within fp32 tolerance."""
    from deepdfa_tpu_torch.serve import quant

    rng = np.random.default_rng(33)
    model = DeepDFA(52, 32, 5, generator=torch.Generator().manual_seed(2)).eval()
    qtree = quant.quantize_params(model.state_dict())
    on_card = quant.QuantizedModel(DeepDFA(52, 32, 5), quant.tree_to(qtree, card))
    on_cpu = quant.QuantizedModel(DeepDFA(52, 32, 5), qtree)
    deq_card, deq_cpu = (quant.dequantize_params(m.qtree) for m in (on_card, on_cpu))
    assert all(torch.equal(deq_card[k].cpu(), deq_cpu[k]) for k in deq_cpu)
    b = pack(_graphs(rng, 8), 8, 1024, 4096)
    before = gk.LAUNCHES
    with torch.inference_mode():
        got = on_card(b.to(card)).cpu()
        want = on_cpu(b.to("cpu"))
    assert gk.LAUNCHES - before == 5
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


# -- the remaining model code: bit supervision, bf16 parameters, MoE ---------


def _bit_problem(rng, n_graphs=12, bits=16):
    """Graphs with random CFG edges and 0/1 gen and kill bits, packed
    without self-loops."""
    specs = []
    for gid in range(n_graphs):
        n = int(rng.integers(2, 40))
        e = int(rng.integers(1, 3 * n))
        specs.append(GraphSpec(
            graph_id=gid, node_feats=rng.integers(0, 52, (n, 4)).astype(np.int32),
            node_vuln=np.zeros((n,), np.int32),
            edge_src=rng.integers(0, n, (e,)).astype(np.int32),
            edge_dst=rng.integers(0, n, (e,)).astype(np.int32), label=0.0,
            node_gen=(rng.random((n, bits)) < 0.1).astype(np.float32),
            node_kill=(rng.random((n, bits)) < 0.1).astype(np.float32),
            node_bits_in=np.zeros((n, bits), np.float32),
            node_bits_out=np.zeros((n, bits), np.float32)))
    return pack(specs, n_graphs, 1024, 4096, add_self_loops=False)


@pytest.mark.parametrize("union_type", ["simple", "relu"])
def test_segment_union_and_bitprop_on_card_match_cpu(card, union_type):
    """The segment-sum kernel gives the plain version's bits (the same
    additions in the same order), forward and backward, and the learned
    gate's propagation on the card the CPU's gradients within 1e-5; twice
    the same bits."""
    from deepdfa_tpu_torch.nn import setops
    from deepdfa_tpu_torch.nn.bitprop import BitvectorPropagation

    rng = np.random.default_rng(31)
    b = _bit_problem(rng)
    msgs = torch.from_numpy(rng.random((b.edge_budget, 16)).astype(np.float32))
    init = torch.from_numpy(rng.random((b.node_budget, 16)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((b.node_budget, 16)).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda", "cuda"):
        m = msgs.detach().to(dev).requires_grad_(True)
        i = init.detach().to(dev).requires_grad_(True)
        y = setops.segment_union(m, i, torch.as_tensor(b.edge_dst).to(dev),
                                 torch.as_tensor(b.edge_mask).to(dev), union_type)
        y.backward(cot.to(dev))
        got = [t.detach().cpu() for t in (y, m.grad, i.grad)]
        if dev in out:
            assert all(torch.equal(x, z) for x, z in zip(got, out[dev]))
        out[dev] = got
    for x, z in zip(out["cuda"], out["cpu"]):
        assert torch.allclose(x, z, rtol=0, atol=1e-6)
    feats = torch.from_numpy(rng.standard_normal((b.node_budget, 24)).astype(np.float32))
    prop = BitvectorPropagation(6, union_type, learned_gate=True, width=24)
    prop.reset_parameters(torch.Generator().manual_seed(0))
    res = {}
    for dev in ("cpu", "cuda", "cuda"):
        bd = b.to(dev)
        p = prop.to(dev)
        p.zero_grad()
        f = feats.detach().to(dev).requires_grad_(True)
        i_s, o_s = p(bd.node_gen, bd.node_kill, bd.edge_src, bd.edge_dst, bd.edge_mask, f)
        (i_s.square().sum() + o_s.sum()).backward()
        got = [t.detach().cpu() for t in (i_s, o_s, f.grad, p.kill_gate.weight.grad)]
        if dev in res:
            assert all(torch.equal(x, z) for x, z in zip(got, res[dev]))
        res[dev] = got
    for x, z in zip(res["cuda"], res["cpu"]):
        assert torch.allclose(x, z, rtol=1e-5, atol=1e-5)


def test_gather_sum_launches_its_kernel_and_refuses_other_dtypes(card):
    from deepdfa_tpu_torch.nn import setops

    y = torch.rand(10, 8, device=card)
    idx, ptr = setops.csr_layout(torch.tensor([3, 1, 3, 0], device=card),
                                 torch.ones(4, dtype=torch.bool, device=card), 10)
    setops.reset_launch_counts()
    got = setops.gather_sum(y, idx, ptr)
    assert setops.LAUNCHES == 1
    assert torch.equal(got.cpu(), setops.gather_sum_plain(y.cpu(), idx.cpu(), ptr.cpu()))
    with pytest.raises(TypeError):
        setops.gather_sum(y.double(), idx, ptr)


def test_bf16_ggnn_train_step_runs_the_kernels(card):
    """A bf16-parameter DeepDFA's training step on the card: kernel 1, B3
    and B4 launch, the gradients are bf16 leaves within 1e-2 of each
    leaf's scale of the CPU plain path's (as tests/test_torch_param_dtype.py
    holds them against the reference: the embedding tables' gradients
    sum repeated rows in bf16, in another order on the card), twice the
    same bits."""
    from deepdfa_tpu_torch.core.config import ModelConfig

    rng = np.random.default_rng(33)
    batch = pack(_graphs(rng, 8), 8, 512, 2048)
    model = DeepDFA.from_config(ModelConfig(hidden_dim=8, n_steps=3, param_dtype="bfloat16"), 52,
                                generator=torch.Generator().manual_seed(1))
    grads = {}
    for dev in ("cpu", "cuda", "cuda"):
        m = model.to(dev)
        m.zero_grad()
        gk.reset_launch_counts()
        torch.sigmoid(m(batch.to(dev))).sum().backward()
        got = {k: p.grad.detach().cpu() for k, p in m.named_parameters()}
        if dev == "cuda":
            counts = gk.launch_counts()
            assert counts["LAUNCHES"] == counts["GRU_BWD_LAUNCHES"] == counts["DMSG_LAUNCHES"] == 3
        if dev in grads:
            assert all(torch.equal(got[k], grads[dev][k]) for k in got)
        grads[dev] = got
    assert {g.dtype for g in grads["cuda"].values()} == {torch.bfloat16}
    for k, g in grads["cuda"].items():
        w = grads["cpu"][k].float()
        scale = max(float(w.abs().max()), 1e-6)
        assert float((g.float() - w).abs().max()) <= 1e-2 * scale, k


def test_moe_dispatch_and_output_on_card_match_cpu(card):
    from deepdfa_tpu_torch.parallel import moe

    cfg = moe.MoEConfig(hidden_size=64, intermediate_size=128, num_experts=8, top_k=2)
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(2))
    x = torch.randn(16, 64, generator=torch.Generator().manual_seed(3))
    x[8:] = x[7]  # identical rows tie, as a serving bucket's padding does
    cap = moe.capacity(cfg, 16)
    d_cpu, c_cpu, a_cpu = moe._route(cfg, params["router"], x, cap)
    out_cpu, _ = moe.moe_ffn(cfg, params, x)
    on_card = {k: v.to(card) for k, v in params.items()}
    d_card, c_card, a_card = moe._route(cfg, on_card["router"], x.to(card), cap)
    out_card, _ = moe.moe_ffn(cfg, on_card, x.to(card))
    again, _ = moe.moe_ffn(cfg, on_card, x.to(card))
    assert torch.equal(d_card.cpu(), d_cpu) and torch.equal(out_card, again)
    assert torch.allclose(c_card.cpu(), c_cpu, rtol=1e-5, atol=1e-5)
    assert torch.allclose(out_card.cpu(), out_cpu, rtol=1e-5, atol=1e-5)
    assert abs(float(a_card) - float(a_cpu)) <= 1e-5


# -- the runtime hooks (the counted cost, the guarded update) ------------------


def _flagship_model(card):
    from deepdfa_tpu_torch.core.config import ModelConfig

    model = DeepDFA.from_config(ModelConfig(hidden_dim=32, n_steps=5), 1002)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(card).eval()


def test_counted_flops_equal_on_card_and_cpu(card):
    """The counted cost of one forward (the kernels' formulas from the
    wrappers' reports plus FlopCounterMode's aten ops) is the same number
    on the card, where the kernels launch, and on the CPU, where the
    plain versions run hidden from the counter; and so is the count of a
    training step's forward and backward."""
    from deepdfa_tpu_torch.obs.cost import count_cost

    rng = np.random.default_rng(22)
    b = pack(_graphs(rng, 16), 16, 1024, 4096)
    model = _flagship_model(card)

    def fwd(m, batch):
        with torch.inference_mode():
            return m(batch)

    _, on_card = count_cost(fwd, model, b.to(card))
    _, on_cpu = count_cost(fwd, model.cpu(), b.to("cpu"))
    assert on_card["flops"] == on_cpu["flops"] > 1e9
    assert on_card["kernels"] == on_cpu["kernels"]
    assert on_card["kernels"]["ggnn_step"]["launches"] == 5

    def step(m, batch):
        m.train()
        out = m(batch).sum()
        out.backward()
        return out

    model = _flagship_model(card)
    _, train_card = count_cost(step, model, b.to(card))
    _, train_cpu = count_cost(step, model.cpu(), b.to("cpu"))
    assert train_card["flops"] == train_cpu["flops"]
    assert {k: v["launches"] for k, v in train_card["kernels"].items()} == {
        "ggnn_step": 5, "gru_bwd": 5, "dmsg": 5}


def _sync_calls(fn, steps):
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(steps):
                fn(k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def test_guarded_steps_add_no_synchronizing_call(card):
    """N guarded training steps, the runner reading each ok flag a step
    late, make as many synchronizing calls as N unguarded ones (none);
    an `.item()` counts as one."""
    from deepdfa_tpu_torch.core.config import ResilienceConfig
    from deepdfa_tpu_torch.train import GraphTrainer
    from deepdfa_tpu_torch.train.resilience import ResilientRunner, ResumeCursor

    rng = np.random.default_rng(23)
    cfg = Config()
    batches = [pack(_graphs(rng, 16), 16, 1024, 4096).to(card) for _ in range(4)]
    trainer_g = GraphTrainer(DeepDFA.from_config(cfg.model, 1002), cfg, device=card)
    state_g = trainer_g.init_state()
    trainer_u = GraphTrainer(DeepDFA.from_config(cfg.model, 1002), cfg, device=card)
    state_u = trainer_u.init_state()
    runner = ResilientRunner(ResilienceConfig(enabled=True), None)

    def guarded(k):
        _, ok = trainer_g.train_step_guarded(state_g, batches[k % 4], runner.lr_scale())
        runner.after_step(state_g, ok, ResumeCursor(0, k + 1, state_g.step))

    def plain(k):
        trainer_u.train_step(state_u, batches[k % 4])

    guarded(0)
    plain(0)
    assert _sync_calls(guarded, 8) == _sync_calls(plain, 8) == 0
    assert _sync_calls(lambda k: float(trainer_u.train_step(state_u, batches[0])), 1) == 1
    assert runner.skipped_steps == 0


def test_guarded_step_skips_on_the_card_without_moving_anything(card):
    from deepdfa_tpu_torch.train import GraphTrainer

    rng = np.random.default_rng(24)
    cfg = Config()
    batch = pack(_graphs(rng, 16), 16, 1024, 4096)
    trainer = GraphTrainer(DeepDFA.from_config(cfg.model, 1002), cfg, device=card)
    state = trainer.init_state()
    _, ok = trainer.train_step_guarded(state, batch.to(card))
    assert bool(ok)
    before = state.state_dict()
    poisoned = batch.to(card)
    poisoned.graph_label.fill_(float("nan"))
    loss, ok = trainer.train_step_guarded(state, poisoned)
    assert not bool(ok) and not torch.isfinite(loss)
    after = state.state_dict()
    assert all(torch.equal(before["model"][k], after["model"][k]) for k in before["model"])
    for i, st in before["optimizer"]["state"].items():
        assert all(torch.equal(st[k], after["optimizer"]["state"][i][k]) for k in st)
    assert after["schedule_count"] == 1 and after["step"] == 2


def _gen_batches(card, n=4):
    from deepdfa_tpu_torch.data.gen_data import collate_gen

    rng = np.random.default_rng(25)
    out = []
    for _ in range(n):
        src = rng.integers(3, 256, (8, 40)).astype(np.int32)
        tgt = rng.integers(3, 256, (8, 24)).astype(np.int32)
        src[2, 30:] = 0
        tgt[3, 10:] = 0
        out.append(collate_gen(src, tgt, 8).to(card))
    return out


def test_generation_guarded_steps_add_no_synchronizing_call(card):
    """The generation trainer's guarded steps (fp32, dropout 0.1, the
    runner reading each ok flag a step late) make as many synchronizing
    calls as its unguarded ones (none); a poisoned batch's step is
    skipped on the card with nothing moved."""
    from deepdfa_tpu_torch.core.config import ResilienceConfig
    from deepdfa_tpu_torch.testing.faults import poison_batch
    from deepdfa_tpu_torch.train import GenTrainer
    from deepdfa_tpu_torch.train.resilience import ResilientRunner, ResumeCursor

    batches = _gen_batches(card)
    trainer = GenTrainer(Config(), _gen_cfg(), total_steps=100, device=card)
    state_g, state_u = trainer.init_state(seed=0), trainer.init_state(seed=0)
    runner = ResilientRunner(ResilienceConfig(enabled=True), None)

    def guarded(k):
        _, ok = trainer.train_step_guarded(state_g, batches[k % 4], 7 + k, runner.lr_scale())
        runner.after_step(state_g, ok, ResumeCursor(0, k + 1, state_g.step))

    def plain(k):
        trainer.train_step(state_u, batches[k % 4], 7 + k)

    guarded(0)
    plain(0)
    assert _sync_calls(guarded, 8) == _sync_calls(plain, 8) == 0
    assert runner.skipped_steps == 0
    runner.finish(state_g, ResumeCursor(1, 0, state_g.step))
    before = state_g.state_dict()
    loss, ok = trainer.train_step_guarded(state_g, poison_batch(batches[0]).to(card), 99)
    assert not bool(ok) and not torch.isfinite(loss)
    after = state_g.state_dict()
    assert all(torch.equal(before["model"][k], after["model"][k]) for k in before["model"])
    for i, st in before["optimizer"]["state"].items():
        assert all(torch.equal(st[k], after["optimizer"]["state"][i][k]) for k in st)
    assert after["schedule_count"] == before["schedule_count"]


def test_counted_flops_of_a_generation_step_equal_on_card_and_cpu(card):
    """The counted cost of one generation training step (the flash
    kernels' work formulas from the wrappers' reports plus
    FlopCounterMode's aten products) is the same number on the card,
    where kernels 5-8 launch, and on the CPU, where their plain versions
    run hidden from the counter."""
    from deepdfa_tpu_torch.obs.cost import count_cost
    from deepdfa_tpu_torch.train import GenTrainer

    batch = _gen_batches(card, 1)[0]
    counts = {}
    for dev in (card, "cpu"):
        trainer = GenTrainer(Config(), _gen_cfg(), total_steps=1, device=dev)
        state = trainer.init_state(seed=0)
        _, counts[str(dev)] = count_cost(lambda: trainer.train_step(state, batch.to(dev), 3))
    on_card, on_cpu = counts[str(card)], counts["cpu"]
    assert on_card["flops"] == on_cpu["flops"] > 0
    assert on_card["kernels"] == on_cpu["kernels"]
    assert {k: v["launches"] for k, v in on_card["kernels"].items()} == {
        "flash_fwd": 12, "flash_dq": 6, "flash_dkv": 6, "flash_dbias": 4}


def test_step_timer_reads_event_times_without_a_synchronize(card):
    from deepdfa_tpu_torch.obs import metrics
    from deepdfa_tpu_torch.obs.xprof import StepTimer

    reg = metrics.MetricsRegistry()
    timer = StepTimer(lag=1, registry=reg, cuda=True)
    x = torch.randn(2048, 2048, device=card)

    def step(k):
        timer.begin()
        (x @ x).sum()
        timer.dispatched(None, 0.0)

    step(0)
    assert _sync_calls(step, 4) == 0
    timer.drain()
    snap = reg.snapshot()
    assert snap["obs/step/seconds/count"] == 5 and snap["obs/step/seconds/mean"] > 0
