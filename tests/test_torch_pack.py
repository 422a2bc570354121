"""The port's `pack` (deepdfa_tpu_torch/graphs/batch.py) against the
reference's (deepdfa_tpu/graphs/batch.py): equal array for array and
bit for bit — packing is integer/copy work, so no tolerance applies.
Also the `to(device)` conversion and its edge-layout check."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.graphs import batch as jb  # noqa: E402
from deepdfa_tpu_torch.graphs import batch as tb  # noqa: E402


def _specs(rng, count, typed=False, bits=None, max_nodes=12):
    """The same graphs as a (reference, port) pair of GraphSpec lists."""
    ref, port = [], []
    for gid in range(count):
        n = int(rng.integers(1, max_nodes))
        e = int(rng.integers(0, 3 * n))
        kw = dict(
            graph_id=gid,
            node_feats=rng.integers(0, 50, (n, 4)).astype(np.int32),
            node_vuln=rng.integers(0, 2, (n,)).astype(np.int32),
            edge_src=rng.integers(0, n, (e,)).astype(np.int32),
            edge_dst=rng.integers(0, n, (e,)).astype(np.int32),
            label=float(gid % 2),
            edge_type=rng.integers(0, 3, (e,)).astype(np.int32) if typed else None,
        )
        if bits:
            for f in ("node_gen", "node_kill", "node_bits_in", "node_bits_out"):
                kw[f] = rng.integers(0, 2, (n, bits)).astype(np.float32)
        ref.append(jb.GraphSpec(**kw))
        port.append(tb.GraphSpec(**kw))
    return ref, port


def _assert_same(got, want):
    assert got.num_graphs == want.num_graphs
    assert tb.ARRAY_FIELDS == jb.ARRAY_FIELDS
    for f in tb.ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize(
    "case",
    ["random", "typed", "bits", "empty", "empty_typed", "single_node", "no_self_loops"],
)
def test_pack_matches_reference(case):
    rng = np.random.default_rng(7)
    kw = {}
    if case == "empty":
        ref, port = [], []
    elif case == "empty_typed":
        ref, port = [], []
        kw = dict(etypes=True, feat_width=4)
    elif case == "single_node":
        ref, port = _specs(rng, 1, max_nodes=2)
    else:
        ref, port = _specs(rng, 5, typed=case == "typed", bits=3 if case == "bits" else None)
    if case == "no_self_loops":
        kw = dict(add_self_loops=False)
    want = jb.pack(ref, 8, 96, 384, **kw)
    got = tb.pack(port, 8, 96, 384, **kw)
    _assert_same(got, want)


def test_pack_budget_errors_match():
    rng = np.random.default_rng(3)
    ref, port = _specs(rng, 4)
    for args in ((3, 96, 384), (8, 4, 384), (8, 96, 8)):
        with pytest.raises(jb.BudgetExceeded) as want:
            jb.pack(ref, *args)
        with pytest.raises(tb.BudgetExceeded) as got:
            tb.pack(port, *args)
        assert str(got.value) == str(want.value)


def test_to_device_keeps_dtypes_and_values():
    rng = np.random.default_rng(1)
    _, port = _specs(rng, 3, typed=True)
    batch = tb.pack(port, 4, 64, 256)
    moved = batch.to("cpu")
    assert moved.num_graphs == batch.num_graphs
    for f in tb.ARRAY_FIELDS:
        v = getattr(batch, f)
        t = getattr(moved, f)
        if v is None:
            assert t is None
            continue
        assert isinstance(t, torch.Tensor)
        assert t.numpy().dtype == v.dtype, f
        assert np.array_equal(t.numpy(), v), f


def test_to_device_rejects_broken_edge_layout():
    rng = np.random.default_rng(2)
    _, port = _specs(rng, 2)
    batch = tb.pack(port, 2, 32, 128)
    mask = batch.edge_mask.copy()
    mask[0] = False  # a hole in the live prefix
    with pytest.raises(ValueError, match="prefix"):
        tb.GraphBatch(**{**batch.__dict__, "edge_mask": mask}).to("cpu")
    dst = batch.edge_dst.copy()
    dst[0], dst[1] = 5, 0
    with pytest.raises(ValueError, match="non-decreasing"):
        tb.GraphBatch(**{**batch.__dict__, "edge_dst": dst}).to("cpu")
