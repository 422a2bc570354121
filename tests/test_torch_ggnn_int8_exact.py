"""The premise of the int8 mxu messages on the card's integer tensor cores
(csrc/ggnn_step.cu: `imma_products`), on the CPU.

The int8 messages multiply quanta by quantized weights, both in
[-127, 127], so every partial sum of a product over d <= 256 terms is an
integer below 2^24: the fp32 FMA chain of the first kernel design was
exact, in any k order, and the int32 product of `mma.sync` s8.s8.s32
converted to float gives the same bits. The kernel's fragment layout (a
lane's A and B words carry the same 8 consecutive k; Wq_t^T staged with
its 8-byte words XOR-swizzled by row) is checked here as index arithmetic
against the PTX fragment layout of m16n8k32, and its half-warp reads
against the 16 bank pairs of shared memory."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu_torch.nn import ggnn_kernel as gk  # noqa: E402

WIDTHS = [32, 64, 96, 128, 160, 192, 224, 256]
KINDS = ["all_plus", "all_minus", "alternating", "random"]


def _operands(kind: str, d: int, rows: int, seed: int):
    """(quanta [rows, d], weights [d, d]) int8 at the extremes or at random."""
    rng = np.random.default_rng(seed)
    if kind == "all_plus":
        q, w = np.full((rows, d), 127), np.full((d, d), 127)
    elif kind == "all_minus":
        q, w = np.full((rows, d), -127), np.full((d, d), 127)
    elif kind == "alternating":
        sign = np.where(np.arange(d) % 2 == 0, 127, -127)
        q, w = np.tile(sign, (rows, 1)), np.tile(sign[:, None], (1, d))
    else:
        q, w = rng.integers(-127, 128, (rows, d)), rng.integers(-127, 128, (d, d))
    return torch.from_numpy(q.astype(np.int8)), torch.from_numpy(w.astype(np.int8))


def _fma_chain(q: np.ndarray, w: np.ndarray, order) -> np.ndarray:
    """The first design's fp32 chain, acc = fmaf(q_k, w_k, acc) over k in
    `order`: each product is an exact integer, so fmaf is one fp32 add."""
    acc = np.zeros((q.shape[0], w.shape[1]), np.float32)
    for k in order:
        acc = (acc + (q[:, k:k + 1] * w[k:k + 1, :]).astype(np.float32)).astype(np.float32)
    return acc


def test_every_partial_sum_stays_below_two_to_the_24():
    assert gk.MAX_WIDTH * 127 * 127 < 2 ** 24


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_int32_product_as_float_is_the_fp32_product(d, kind):
    q, w = _operands(kind, d, 16, d)
    exact = (q.to(torch.int32) @ w.to(torch.int32)).to(torch.float32)
    assert torch.equal(exact, q.to(torch.float32) @ w.to(torch.float32))
    chain = _fma_chain(q.numpy().astype(np.int64), w.numpy().astype(np.int64), range(d))
    assert np.array_equal(exact.numpy(), chain)
    if kind == "all_plus":
        assert exact.max().item() == d * 127 * 127


@pytest.mark.parametrize("d", WIDTHS)
def test_any_k_order_gives_the_same_bits(d):
    """The tensor-core path sums k in its fragments' order (8 consecutive
    k a lane, 4 lanes, then the k steps): integers, so any order."""
    q, w = _operands("random", d, 8, d + 1)
    qn, wn = q.numpy().astype(np.int64), w.numpy().astype(np.int64)
    order = np.random.default_rng(d).permutation(d)
    assert np.array_equal(_fma_chain(qn, wn, range(d)), _fma_chain(qn, wn, order))


def _edges(n: int, e: int, live: int, n_etypes: int, seed: int):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e))
    dst[live:] = n - 1
    src = rng.integers(0, n, e)
    mask = np.arange(e) < live
    etype = rng.integers(0, n_etypes, e) if n_etypes > 1 else None
    return gk.prepare_edges(
        torch.from_numpy(src.astype(np.int32)), torch.from_numpy(dst.astype(np.int32)),
        torch.from_numpy(mask), None if etype is None else torch.from_numpy(etype), n,
        n_etypes)


@pytest.mark.parametrize("d, n_etypes", [(32, 1), (128, 1), (128, 3), (256, 2)])
def test_mxu_messages_plain_int8_is_its_int32_product(d, n_etypes):
    """`mxu_messages_plain(..., "int8")` unchanged when its product is
    taken in int32: ((q @ Wq_t) * s_src * ws_t + bm_t) * w, bit for bit."""
    rng = np.random.default_rng(d + n_etypes)
    n, e = 40, 96
    edges = _edges(n, e, 80, n_etypes, d)
    h = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    wm = torch.from_numpy((rng.standard_normal((n_etypes, d, d)) * d ** -0.5).astype(np.float32))
    bm = torch.from_numpy((rng.standard_normal((n_etypes, d)) * 0.1).astype(np.float32))
    got = gk.mxu_messages_plain(h, edges, wm, bm, "int8")
    q, s = gk.quant_rows(h)
    wq, ws = gk.quant_wm(wm)
    src = edges.src.long()
    want = []
    for t in range(n_etypes):
        m = (q[src].to(torch.int32) @ wq[t].to(torch.int32)).to(torch.float32)
        m = m * s[src] * ws[t]
        want.append((m + bm[t]) * edges.w2[t][:, None])
    assert torch.equal(got, torch.stack(want))


def _swizzle(d: int, r: int) -> int:
    """csrc/ggnn_step.cu:wqt_swizzle: the XOR on row r's 8-byte word index."""
    if d % 128 == 0:
        return 4 * (r & 3)
    if d % 64 == 0:
        return 4 * ((r >> 1) & 1)
    return 0


def _stage_wqt(wqt: np.ndarray) -> np.ndarray:
    """csrc/ggnn_step.cu:stage_wqt: Wq_t^T [d, d] bytes into a [d * d]
    buffer, 16-byte chunk m of row r at chunk m ^ (swizzle(r) >> 1)."""
    d = wqt.shape[0]
    out = np.zeros(d * d, np.int8)
    for r in range(d):
        for m in range(d // 16):
            pm = m ^ (_swizzle(d, r) >> 1)
            out[r * d + 16 * pm:r * d + 16 * pm + 16] = wqt[r, 16 * m:16 * m + 16]
    return out


@pytest.mark.parametrize("d", WIDTHS)
def test_imma_fragments_compute_the_product(d):
    """csrc/ggnn_step.cu:imma_products' index arithmetic through the PTX
    fragment layout of mma m16n8k32 .row.col s8: lane (g, q) holds A's
    row g at k 4q..4q+3 (a0) and 16+4q.. (a2), B's column g at k 4q..
    (b0) and 16+4q.. (b1), and D's row g at columns 2q, 2q+1 (c0, c1).
    The kernel fills a0/a2 with bytes 32ks + 8q .. +7 of edge g's quanta
    and b0/b1 with the same bytes of Wq_t^T's row 8nt + g, so each lane
    pair carries one set of 8 k; the stage gets c0, c1 as floats."""
    rng = np.random.default_rng(d + 5)
    n, cnt = 20, 6  # a chunk of 6 live edges; rows 6, 7 and 8-15 zero
    table = rng.integers(-127, 128, (n, d)).astype(np.int8)
    wq = rng.integers(-127, 128, (d, d)).astype(np.int8)  # [in, out]
    staged = _stage_wqt(np.ascontiguousarray(wq.T))
    u = rng.integers(0, n, 8)
    stage = np.zeros((8, d), np.float32)
    for nt in range(d // 8):
        acc = np.zeros((32, 4), np.int64)
        for ks in range(d // 32):
            a_mat = np.zeros((16, 32), np.int64)
            b_mat = np.zeros((32, 8), np.int64)
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                lo = hi = np.zeros(4, np.int64)
                if g < cnt:
                    word = table[u[g], 32 * ks + 8 * q:32 * ks + 8 * q + 8].astype(np.int64)
                    lo, hi = word[:4], word[4:]
                r = 8 * nt + g
                p = (4 * ks + q) ^ _swizzle(d, r)
                b = staged[r * d + 8 * p:r * d + 8 * p + 8].astype(np.int64)
                a_mat[g, 4 * q:4 * q + 4] = lo          # a0 (a1: row g + 8, zero)
                a_mat[g, 16 + 4 * q:16 + 4 * q + 4] = hi  # a2 (a3: zero)
                b_mat[4 * q:4 * q + 4, g] = b[:4]       # b0
                b_mat[16 + 4 * q:16 + 4 * q + 4, g] = b[4:]  # b1
            prod = a_mat @ b_mat
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                acc[lane] += [prod[g, 2 * q], prod[g, 2 * q + 1], prod[g + 8, 2 * q],
                              prod[g + 8, 2 * q + 1]]
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            stage[g, 8 * nt + 2 * q:8 * nt + 2 * q + 2] = acc[lane, :2]
    want = table[u[:cnt]].astype(np.int64) @ wq.astype(np.int64)
    assert np.array_equal(stage[:cnt], want.astype(np.float32))
    assert not stage[cnt:].any()


@pytest.mark.parametrize("d", WIDTHS)
def test_imma_b_reads_hit_sixteen_bank_pairs_a_half_warp(d):
    """Each 8-byte B read of a half warp (lanes 16h .. 16h+15: rows 8nt + g,
    words 4ks + q) falls in its own one of the 16 bank pairs."""
    for nt in range(d // 8):
        for ks in range(d // 32):
            for half in (0, 1):
                pairs = set()
                for lane in range(16 * half, 16 * half + 16):
                    g, q = lane >> 2, lane & 3
                    r = 8 * nt + g
                    p = (4 * ks + q) ^ _swizzle(d, r)
                    assert 0 <= p < d // 8
                    pairs.add((r * d + 8 * p) // 8 % 16)
                assert len(pairs) == 16, (d, nt, ks, half)
