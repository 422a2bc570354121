"""The port's autotuner (deepdfa_tpu_torch/tune/) against the reference's
(deepdfa_tpu/tune/) on the same inputs.

- the ladder fits and the log/manifest readers give exactly the
  reference's rungs, edges and wastes;
- the numerics verdict, the validator's problems and the overrides a
  record applies are the reference's (the hardware key aside: the port
  keys on torch_version and the card, the reference on jax_version);
- the loud fallbacks: a missing file, a key mismatch, a record the
  reference wrote, a corrupt records list, a serve ladder fitted at
  another capacity; a failed search never replaces a good record;
- enumeration under the card's legality rules, each pruned row with its
  reason; a candidate failing its verdict never wins;
- `cli tune --smoke` end to end on the CPU (plain versions);
- `GgnnExecutor(ladder=)` gives the pow2 ladder's bits on a rung both
  ladders have.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.core import config as jconfig  # noqa: E402
from deepdfa_tpu.serve import batcher as jbatcher  # noqa: E402
from deepdfa_tpu.tune import cache as jcache  # noqa: E402
from deepdfa_tpu.tune import driver as jdriver  # noqa: E402
from deepdfa_tpu.tune import kernel as jkernel  # noqa: E402
from deepdfa_tpu.tune import ladder as jladder  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as tconfig  # noqa: E402
from deepdfa_tpu_torch.graphs import GraphSpec  # noqa: E402
from deepdfa_tpu_torch.models import DeepDFA  # noqa: E402
from deepdfa_tpu_torch.nn import ggnn_kernel as gk  # noqa: E402
from deepdfa_tpu_torch.serve import batcher as tbatcher  # noqa: E402
from deepdfa_tpu_torch.tune import cache as tcache  # noqa: E402
from deepdfa_tpu_torch.tune import driver as tdriver  # noqa: E402
from deepdfa_tpu_torch.tune import kernel as tkernel  # noqa: E402
from deepdfa_tpu_torch.tune import ladder as tladder  # noqa: E402

NODE_BUDGET, EDGE_BUDGET = 2048, 8192
CPU = "cpu"

DISTRIBUTIONS = {
    "skewed": [5] * 50 + [9] * 30 + [3] * 10 + [16] * 5,
    "smoke": tdriver.skewed_smoke_sizes(0),
    "uniform": list(np.random.default_rng(3).integers(1, 33, 200)),
    "one_size": [7] * 12,
    "empty": [],
}


@pytest.mark.parametrize("name", list(DISTRIBUTIONS))
@pytest.mark.parametrize("max_rungs", [1, 3, 6])
def test_ladder_fits_equal_the_reference(name, max_rungs):
    sizes = [int(x) for x in DISTRIBUTIONS[name]]
    cap = 32 if name == "uniform" else 16
    assert tladder.pow2_rungs(cap) == jladder.pow2_rungs(cap)
    rungs = tladder.fit_rungs(sizes, max_rungs, cap)
    assert rungs == jladder.fit_rungs(sizes, max_rungs, cap)
    assert tladder.padding_waste(sizes, rungs) == jladder.padding_waste(sizes, rungs)
    assert all(tladder.rung_for(s, rungs) == jladder.rung_for(s, rungs) for s in range(1, cap + 1))
    assert tladder.fit_serve_ladder(sizes, cap, max_rungs, 10.0, 3.0) == \
        jladder.fit_serve_ladder(sizes, cap, max_rungs, 10.0, 3.0)
    lengths = [min(64, 2 + s * 3) for s in sizes] or [2]
    assert tladder.fit_seq_buckets(lengths, 64, max_rungs) == \
        jladder.fit_seq_buckets(lengths, 64, max_rungs)


def test_ladder_guards_and_budgets_equal_the_reference():
    for mod in (tladder, jladder):
        with pytest.raises(ValueError):
            mod.fit_rungs([32], max_rungs=2, capacity=16)
    for args in ((10.0, 3.0, 6), (0.0, 3.0, 6), (1.0, 3.0, 6), (100.0, 0.0, 4)):
        assert tladder.max_rungs_for_budget(*args) == jladder.max_rungs_for_budget(*args)
    assert tdriver.skewed_smoke_sizes(0) == jdriver.skewed_smoke_sizes(0)
    assert tdriver.lognormal_smoke_lengths() == jdriver.lognormal_smoke_lengths()
    assert tdriver.SMOKE_BUDGETS == jdriver.SMOKE_BUDGETS
    assert [c.label for c in tdriver.SMOKE_CANDIDATES] == \
        [c.label for c in jdriver.SMOKE_CANDIDATES]


def test_log_and_manifest_readers_equal_the_reference(tmp_path):
    log = tmp_path / "serve_log.jsonl"
    entries = ([{"request": {"id": f"a{i}", "batch_size": 4}} for i in range(8)]
               + [{"request": {"id": "b", "batch_size": 1}}]
               + [{"request": {"id": f"c{i}", "batch_size": 3}} for i in range(7)]
               + [{"serve_slo": {"60s": {}}}, {"not": "json-request"}])
    log.write_text("\n".join(json.dumps(e) for e in entries) + "\nnot json\n")
    assert tladder.batch_sizes_from_log(log) == jladder.batch_sizes_from_log(log) == [1, 3, 3, 4, 4]
    arr = tmp_path / "lengths.json"
    arr.write_text("[4, 9, 12]")
    jl = tmp_path / "manifest.jsonl"
    jl.write_text('{"length": 7}\n{"tokens": 3}\n{"other": 1}\n5\n{"token_length": 11}\n')
    for path in (arr, jl):
        assert tladder.lengths_from_manifest(path) == jladder.lengths_from_manifest(path)


@pytest.mark.parametrize("scatter, accum", [("fold", "bf16"), ("mxu", "fp32"), ("mxu", "bf16"),
                                            ("fold", "int8"), ("mxu", "int8")])
def test_numerics_verdict_equals_the_reference(scatter, accum):
    ref = np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8)
    for bump in (0.0, 1e-6, 1e-3, 4e-2, 0.5):
        got = ref.copy()
        got[3, 3] += bump
        t = tkernel.numerics_verdict(got, ref, tkernel.Candidate(64, 512, scatter, accum))
        j = jkernel.numerics_verdict(got, ref, jkernel.Candidate(64, 512, scatter, accum))
        assert t == j


def test_tolerance_table_differs_only_in_the_fold_fp32_row():
    """The reference holds fold/fp32 to bit identity (its fold repeats
    XLA's update order); the CUDA fold reassociates, so the port holds
    that row to its fp32 contract, 1e-5. Every other row is the
    reference's, and int8's bound is the drift bound of both packages."""
    assert tkernel.DEFAULT_TOLERANCES[("fold", "fp32")] == 1e-5
    assert jkernel.DEFAULT_TOLERANCES[("fold", "fp32")] == 0.0
    others = {k: v for k, v in tkernel.DEFAULT_TOLERANCES.items() if k != ("fold", "fp32")}
    assert others == {k: v for k, v in jkernel.DEFAULT_TOLERANCES.items() if k != ("fold", "fp32")}
    assert tkernel.INT8_TOLERANCE == jkernel.INT8_TOLERANCE == gk.INT8_DRIFT_BOUND
    c = tkernel.Candidate(64, 512, "fold", "fp32")
    ref = np.ones((4, 4), np.float32)
    assert tkernel.numerics_verdict(ref * (1 + 5e-6), ref, c)["ok"]
    assert not tkernel.numerics_verdict(ref * (1 + 5e-5), ref, c)["ok"]


def _record(cache, hw, sig="2048x8192x32", winner=("fold", "fp32", None), step_us=100.0,
            waste=0.1):
    scatter, accum, unroll = winner
    label = f"bn64-be512-{scatter}-{accum}" + (f"-{unroll}" if unroll == "fused" else "")
    sr = {"winner": label, "winner_step_us": step_us, "winner_block_n": 64,
          "winner_block_e": 512, "winner_scatter": scatter, "winner_accum": accum,
          "candidates": [{"candidate": label, "step_us": step_us,
                          "numerics": {"ok": True, "rel_err": 0.0}}]}
    if unroll:
        sr["winner_unroll"] = unroll
    return cache.make_record(
        hw, kernel={sig: sr},
        ladders={"serve": {"rungs": [1, 3, 4], "pow2_rungs": [1, 2, 4], "padding_waste": waste,
                           "pow2_padding_waste": 0.3, "samples": 10, "capacity": 4},
                 "seq_buckets": {"edges": [24, 64], "pow2_edges": [2, 64], "padding_waste": 0.1,
                                 "pow2_padding_waste": 0.2, "samples": 5, "max_length": 64}},
        search_seconds=1.5)


def _jhw():
    return jcache.hardware_key(NODE_BUDGET, EDGE_BUDGET)


def _thw():
    return tcache.hardware_key(NODE_BUDGET, EDGE_BUDGET, CPU)


def _damage(doc, what):
    doc = json.loads(json.dumps(doc))
    rec = doc["records"][0]
    sr = rec["kernel"]["2048x8192x32"]
    if what == "device_kind":
        del rec["hardware"]["device_kind"]
    elif what == "numerics":
        del sr["candidates"][0]["numerics"]
    elif what == "winner":
        del sr["winner"]
    elif what == "foreign_winner":
        sr["winner"] = "bn1-be1-fold-fp32"
    elif what == "pow2_waste":
        del rec["ladders"]["serve"]["pow2_padding_waste"]
    elif what == "unroll":
        sr["candidates"][0]["unroll"] = "chunked"
    elif what == "accum":
        sr["candidates"][0]["accum"] = "fp8"
    elif what == "rungs":
        rec["ladders"]["serve"]["rungs"] = [4, 3]
    elif what == "version":
        doc["version"] = 2
    elif what == "search_seconds":
        del rec["search_seconds"]
    elif what == "no_records":
        doc["records"] = []
    return doc


@pytest.mark.parametrize("what", ["none", "device_kind", "numerics", "winner", "foreign_winner",
                                  "pow2_waste", "unroll", "accum", "rungs", "version",
                                  "search_seconds", "no_records"])
def test_validate_tuned_names_the_reference_problems(what):
    docs = {}
    for name, cache, hw in (("port", tcache, _thw()), ("ref", jcache, _jhw())):
        good = cache.upsert_record(cache.empty_doc(), _record(cache, hw))
        docs[name] = cache.validate_tuned(_damage(good, what))
    assert docs["port"] == docs["ref"]
    assert docs["port"]["ok"] == (what == "none")


@pytest.mark.parametrize("winner", [("fold", "fp32", None), ("mxu", "int8", "fused"),
                                    ("mxu", "bf16", "per_step"), ("fold", "int8", "fused")])
def test_apply_to_config_gives_the_reference_overrides(tmp_path, winner):
    """The same record (each package's own hardware key) folds the same
    overrides into the same config: the whole kernel layout and the
    seq-bucket edges; the port's config loads them."""
    sig = f"{NODE_BUDGET}x{EDGE_BUDGET}x128"  # the default model's GGNN width
    ov = ["tune.enabled=true", f'data.batch={{"node_budget": {NODE_BUDGET}, '
          f'"edge_budget": {EDGE_BUDGET}}}', "data.seq_buckets=[16, 64]"]
    reports = {}
    for name, cache, cfgmod, hw in (("port", tcache, tconfig, _thw()),
                                    ("ref", jcache, jconfig, _jhw())):
        path = tmp_path / f"{name}.json"
        cache.save_tuned(path, cache.upsert_record(cache.empty_doc(),
                                                   _record(cache, hw, sig, winner)))
        cfg = cfgmod.apply_overrides(cfgmod.Config(), [*ov, f"tune.path={json.dumps(str(path))}"])
        kw = {"device": CPU} if name == "port" else {}
        tuned, report = cache.apply_to_config(cfg, **kw)
        reports[name] = report
        assert report["matched"]
        assert tuned.model.ggnn_kernel_scatter == winner[0]
        assert tuned.model.ggnn_kernel_accum == winner[1]
        assert tuned.model.ggnn_kernel_unroll == (winner[2] or "per_step")
        assert (tuned.model.ggnn_kernel_block_nodes, tuned.model.ggnn_kernel_block_edges) == \
            (64, 512)
        assert tuned.data.seq_buckets == (24, 64)
    assert reports["port"] == reports["ref"]
    assert tcache.kernel_layout_from(_record(tcache, _thw(), sig, winner), NODE_BUDGET,
                                     EDGE_BUDGET, 128) == \
        jcache.kernel_layout_from(_record(jcache, _jhw(), sig, winner), NODE_BUDGET,
                                  EDGE_BUDGET, 128)


def test_seq_bucket_guards_keep_the_configured_edges(tmp_path):
    path = tmp_path / "tuned.json"
    tcache.save_tuned(path, tcache.upsert_record(tcache.empty_doc(),
                                                 _record(tcache, _thw())))
    base = [f"tune.path={json.dumps(str(path))}", "tune.enabled=true",
            f'data.batch={{"node_budget": {NODE_BUDGET}, "edge_budget": {EDGE_BUDGET}}}']
    for buckets, want in (("[16, 128]", (16, 128)), ("[]", ())):
        cfg = tconfig.apply_overrides(tconfig.Config(), [*base, f"data.seq_buckets={buckets}"])
        assert tcache.apply_to_config(cfg, device=CPU)[0].data.seq_buckets == want
    cfg = tconfig.apply_overrides(tconfig.Config(), [*base, "data.seq_buckets=[16, 64]"])
    kern, _ = tcache.apply_to_config(cfg, sections=("kernel",), device=CPU)
    assert kern.data.seq_buckets == (16, 64)


def _warned(caplog, text):
    return any(text in r.getMessage() for r in caplog.records)


def test_loud_fallbacks(tmp_path, caplog):
    hw = _thw()
    path = tmp_path / "tuned.json"
    tcache.save_tuned(path, tcache.upsert_record(tcache.empty_doc(), _record(tcache, hw)))
    assert tcache.validate_tuned(tcache.load_tuned(path))["ok"]
    cfg = tconfig.apply_overrides(tconfig.Config(), [
        "tune.enabled=true", f"tune.path={json.dumps(str(path))}"])
    assert tcache.record_for_config(cfg, NODE_BUDGET, EDGE_BUDGET, CPU) is not None
    # other budgets: the key mismatches, loudly
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=tcache.__name__):
        assert tcache.record_for_config(cfg, 64, 128, CPU) is None
    assert _warned(caplog, "no tuned record matches")
    # a missing file
    missing = tconfig.apply_overrides(cfg, [f"tune.path={json.dumps(str(tmp_path / 'x.json'))}"])
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=tcache.__name__):
        assert tcache.record_for_config(missing, NODE_BUDGET, EDGE_BUDGET, CPU) is None
    assert _warned(caplog, "no usable tuned.json")
    # a corrupt records list
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "records": [None, "x"]}))
    corrupt = tconfig.apply_overrides(cfg, [f"tune.path={json.dumps(str(bad))}"])
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=tcache.__name__):
        assert tcache.record_for_config(corrupt, NODE_BUDGET, EDGE_BUDGET, CPU) is None
    assert _warned(caplog, "no tuned record matches")
    # unreadable JSON
    (tmp_path / "junk.json").write_text("{not json")
    assert tcache.load_tuned(tmp_path / "junk.json") is None


def test_a_record_the_reference_wrote_never_matches(tmp_path, caplog):
    """A record keyed by the reference (jax_version, its platform) falls
    back loudly and names the fields, never raises."""
    path = tmp_path / "tuned.json"
    jcache.save_tuned(path, jcache.upsert_record(jcache.empty_doc(), _record(jcache, _jhw())))
    cfg = tconfig.apply_overrides(tconfig.Config(), [
        "tune.enabled=true", f"tune.path={json.dumps(str(path))}"])
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=tcache.__name__):
        assert tcache.record_for_config(cfg, NODE_BUDGET, EDGE_BUDGET, CPU) is None
        tuned, report = tcache.apply_to_config(cfg, node_budget=NODE_BUDGET,
                                               edge_budget=EDGE_BUDGET, device=CPU)
    assert report == {"matched": False, "overrides": []} and tuned == cfg
    assert _warned(caplog, "torch_version") and _warned(caplog, "no tuned record matches")
    assert set(tcache.REQUIRED_HW_FIELDS) - set(jcache.REQUIRED_HW_FIELDS) == {"torch_version"}


def test_hardware_key_on_the_cpu():
    hw = _thw()
    assert set(hw) == set(tcache.REQUIRED_HW_FIELDS)
    assert (hw["device_kind"], hw["platform"], hw["n_devices"]) == ("cpu", "cpu", 1)
    assert hw["torch_version"] == torch.__version__
    assert (hw["node_budget"], hw["edge_budget"]) == (NODE_BUDGET, EDGE_BUDGET)
    assert tcache.hw_mismatch(hw, dict(hw, node_budget=1)) == \
        [f"node_budget: record={NODE_BUDGET!r} vs ours=1"]


def test_serve_rungs_and_upsert_like_the_reference(caplog):
    for cache, hw in ((tcache, _thw()), (jcache, _jhw())):
        rec = cache.make_record(hw, ladders={"serve": {
            "rungs": [3, 5, 9, 16, 32], "pow2_rungs": [1, 2, 4, 32], "padding_waste": 0.05,
            "pow2_padding_waste": 0.2, "samples": 40, "capacity": 32}}, search_seconds=1.0)
        assert cache.serve_rungs_from(rec, 32) == (3, 5, 9, 16, 32)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=cache.__name__):
            assert cache.serve_rungs_from(rec, 4) is None
        assert _warned(caplog, "fitted at capacity")
        doc = cache.upsert_record(cache.empty_doc(), _record(cache, hw, step_us=100.0))
        doc = cache.upsert_record(doc, _record(cache, hw, step_us=90.0))
        assert len(doc["records"]) == 1
        assert doc["records"][0]["kernel"]["2048x8192x32"]["winner_step_us"] == 90.0
        assert len(cache.upsert_record(doc, _record(cache, dict(hw, node_budget=64)))["records"]) == 2
    for ladder, cap in (((3, 5, 99), 8), (None, 8), ((8,), 8), ((0, 2), 4)):
        assert tbatcher._ladder_sizes(ladder, cap) == jbatcher._ladder_sizes(ladder, cap)


def test_failed_search_never_clobbers_a_good_record(tmp_path, caplog):
    path = tmp_path / "tuned.json"
    tcache.save_tuned(path, tcache.upsert_record(tcache.empty_doc(), _record(tcache, _thw())))
    before = path.read_text()
    cfg = tconfig.apply_overrides(tconfig.Config(), [
        f'data.batch={{"node_budget": {NODE_BUDGET}, "edge_budget": {EDGE_BUDGET}}}'])
    with caplog.at_level(logging.WARNING, logger=tdriver.__name__):
        report = tdriver.run_tune(cfg, out_path=path, skip_kernel=True, device=CPU)
    assert not report["valid"] and path.read_text() == before
    assert _warned(caplog, "not persisting invalid")


def test_enumeration_under_the_card_rules():
    """At the flagship budgets the default grid keeps the 64-node tile
    only, one fold row per (accum, unroll) at block_e 512, and every mxu
    block; each pruned row names its reason."""
    n, e, d = 16384, 65536, 128
    cands, pruned = tkernel.enumerate_candidates(n, e, d, n_steps=5)
    assert {c.block_n for c in cands} == {gk.NODE_TILE}
    fold = [c for c in cands if c.scatter == "fold"]
    assert sorted((c.accum, c.unroll) for c in fold) == sorted(
        (a, u) for a in tkernel.DEFAULT_ACCUMS for u in tkernel.DEFAULT_UNROLLS)
    assert {c.block_e for c in fold} == {gk.edge_block(e)} == {512}
    mxu = {(c.block_e, c.accum, c.unroll) for c in cands if c.scatter == "mxu"}
    assert mxu == {(b, a, u) for b in tkernel.DEFAULT_BLOCK_EDGES
                   for a in tkernel.DEFAULT_ACCUMS for u in tkernel.DEFAULT_UNROLLS}
    assert len(cands) + len(pruned) == 4 * 4 * 2 * 3 * 2
    reasons = {p["candidate"]: p["reason"] for p in pruned}
    assert "the CUDA kernels tile 64 nodes" in reasons["bn128-be512-mxu-fp32"]
    assert reasons["bn64-be128-fold-int8"].startswith("duplicate: under fold block_e")
    # indivisible blocks, and a budget that refuses the fused residency
    _, pruned2 = tkernel.enumerate_candidates(300, 1000, 32, block_nodes=(64,),
                                              block_edges=(128, 250))
    assert any("block_e 128 does not divide edge budget 1000" == p["reason"] for p in pruned2)
    need = gk.fused_residency_bytes(n, d, "int8", 5)
    cands3, pruned3 = tkernel.enumerate_candidates(
        n, e, d, block_nodes=(64,), block_edges=(512,), accums=("int8",), n_steps=5,
        budget_bytes=need)
    assert {c.label for c in cands3} == {"bn64-be512-fold-int8", "bn64-be512-fold-int8-fused",
                                          "bn64-be512-mxu-int8"}
    [row] = pruned3  # int8 mxu fused also keeps each step's column maxima
    assert row["candidate"] == "bn64-be512-mxu-int8-fused"
    assert "fused unroll residency" in row["reason"] and "5 steps" in row["reason"]
    assert all(isinstance(p["reason"], str) and p["reason"] for p in pruned)


def test_search_carries_verdicts_and_a_failing_candidate_never_wins(monkeypatch):
    broken = tkernel.Candidate(64, 256, "mxu", "fp32")
    real = tkernel.numerics_verdict

    def rigged(got, ref, cand, tolerances=None):
        v = real(got, ref, cand, tolerances=tolerances)
        return {**v, "ok": False, "rel_err": 1.0} if cand == broken else v

    monkeypatch.setattr(tkernel, "numerics_verdict", rigged)
    cands = [broken, tkernel.Candidate(64, 256), tkernel.Candidate(64, 256, "mxu", "int8"),
             tkernel.Candidate(64, 256, "fold", "int8", "fused")]
    out = tkernel.search_kernel([(128, 256, 32)], n_steps=2, candidates=cands, reps=1,
                                device=CPU, ceiling_flops_per_sec=1e9)
    rec = out["128x256x32"]
    rows = {r["candidate"]: r for r in rec["candidates"]}
    assert set(rows) == {c.label for c in cands}
    assert rows[broken.label]["numerics"]["ok"] is False and "step_us" in rows[broken.label]
    assert rec["winner"] != broken.label and rows[rec["winner"]]["numerics"]["ok"]
    assert rows["bn64-be256-fold-fp32"]["numerics"]["rel_err"] == 0.0  # the CPU runs the oracle
    assert rows["bn64-be256-mxu-int8"]["numerics"]["rel_err"] <= tkernel.INT8_TOLERANCE
    assert rows["bn64-be256-fold-int8-fused"]["residency_bytes"] > 0
    assert rec["device"] == CPU and rec["lax_step_us"] > 0
    assert all("mfu_vs_measured_ceiling" in r for r in rows.values())
    assert rec["winner_unroll"] in ("per_step", "fused")


def test_cli_tune_smoke_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    cli.main(["tune", "--smoke", "--device", "cpu"])
    report = json.loads([x for x in capsys.readouterr().out.splitlines() if x.startswith("{")][-1])
    assert report["valid"] and report["winner"] and report["device"] == "cpu"
    assert report["candidates_timed"] == len(tdriver.SMOKE_CANDIDATES)
    assert report["tuned_ladder_padding_waste"] < report["pow2_ladder_padding_waste"]
    path = tmp_path / "tuned.json"
    assert report["tuned_path"] == str(path)
    verdict = tcache.validate_tuned_file(path)
    assert verdict["ok"] and verdict["candidates"] == len(tdriver.SMOKE_CANDIDATES)
    rows = tcache.load_tuned(path)["records"][0]["kernel"]["256x512x32"]["candidates"]
    assert {r["candidate"] for r in rows} == {c.label for c in tdriver.SMOKE_CANDIDATES}
    assert all(r["numerics"]["ok"] for r in rows)


def test_cli_tune_then_train_applies_the_record(tmp_path, monkeypatch, capsys):
    """`cli tune --skip-kernel --serve-log` writes a ladder-only record at
    the config's budgets; `cli tune` refuses a search without evidence;
    `cli train` with tune.enabled prints what it applied."""
    from test_torch_ggnn_fused import _store

    monkeypatch.setenv("DEEPDFA_TPU_STORAGE", str(tmp_path))
    path = _store(tmp_path)
    log = tmp_path / "serve_log.jsonl"
    log.write_text("\n".join(json.dumps({"request": {"batch_size": b}})
                             for b in [3] * 9 + [5] * 10))
    cli.main(["tune", "--config", str(path), "--device", "cpu", "--skip-kernel",
              "--serve-log", str(log)])
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["valid"] and report["serve_ladder"]["rungs"][-1] == 16
    with pytest.raises(SystemExit, match="failed validation"):
        cli.main(["tune", "--config", str(path), "--device", "cpu", "--skip-kernel"])
    capsys.readouterr()
    # a kernel record at the training budgets, then train under it
    cfg = tconfig.load(path)
    hw = tcache.hardware_key(cfg.data.batch.node_budget, cfg.data.batch.edge_budget, CPU)
    sig = f"{cfg.data.batch.node_budget}x{cfg.data.batch.edge_budget}x32"
    rec = _record(tcache, hw, sig, ("mxu", "int8", "fused"))
    rec["kernel"][sig]["winner_block_e"] = 128
    tcache.save_tuned(tmp_path / "tuned.json",
                      tcache.upsert_record(tcache.empty_doc(), rec))
    cli.main(["train", "--config", str(path), "--device", "cpu", "model.ggnn_kernel=true",
              "tune.enabled=true", 'run_name="tuned"'])
    out = capsys.readouterr().out
    applied = json.loads(next(x for x in out.splitlines() if x.startswith("[tune] "))[7:])
    assert applied["matched"] and 'model.ggnn_kernel_scatter="mxu"' in applied["overrides"]
    saved = tconfig.load(tmp_path / "runs" / "tuned" / "config.json")
    assert (saved.model.ggnn_kernel_scatter, saved.model.ggnn_kernel_accum,
            saved.model.ggnn_kernel_unroll, saved.model.ggnn_kernel_block_edges) == \
        ("mxu", "int8", "fused", 128)
    assert "best:" in out


def test_tuned_ladder_gives_the_pow2_ladder_bits():
    """GgnnExecutor(ladder=) warms exactly the tuned rungs (clamped to
    capacity) and scores a chunk that lands on a rung both ladders have
    (1, 4) with the pow2 ladder's bits. A chunk of 2 or 3 pads to 3 here
    and to 2 or 4 there: padding slots are masked out of every reduction,
    but the pooling's one-hot product changes shape, so those scores
    agree to fp32 reassociation (rtol 1e-6), as the batcher promises."""
    rng = np.random.default_rng(4)
    specs = []
    for gid in range(7):
        n = int(rng.integers(2, 30))
        e = int(rng.integers(1, 3 * n))
        specs.append(GraphSpec(graph_id=gid, node_feats=rng.integers(0, 52, (n, 4)).astype(np.int32),
                               node_vuln=np.zeros((n,), np.int32),
                               edge_src=rng.integers(0, n, (e,)).astype(np.int32),
                               edge_dst=rng.integers(0, n, (e,)).astype(np.int32), label=0.0))
    model = DeepDFA(52, 8, 3, generator=torch.Generator().manual_seed(0))
    tuned = tbatcher.GgnnExecutor(model, 512, 2048, 4, device="cpu", ladder=(1, 3, 9))
    pow2 = tbatcher.GgnnExecutor(model, 512, 2048, 4, device="cpu")
    assert tuned.sizes == (1, 3, 4) and pow2.sizes == (1, 2, 4)
    assert set(tuned.warmup()) == {"G1", "G3", "G4"}
    for chunk in (specs[:1], specs[1:3], specs[3:6], specs[:4], specs[3:7]):
        sig, packed = tuned.pack_chunk("graph", chunk)
        got = tuned.fetch(tuned.dispatch("graph", packed), len(chunk))
        want = pow2.fetch(pow2.dispatch("graph", pow2.pack_chunk("graph", chunk)[1]), len(chunk))
        if sig == pow2.pack_chunk("graph", chunk)[0]:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_tune_section_is_the_reference_section():
    port, ref = tconfig.TuneConfig(), jconfig.TuneConfig()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for override in ("tune.reps=5", "tune.enabled=true", "tune.path=\"/x\"", "tune.reps=1.5",
                     "tune.enabled=1", "tune.max_rungs=true", "tune.nope=1"):
        try:
            want = jconfig.apply_overrides(jconfig.Config(), [override]).tune
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            with pytest.raises(type(e)):
                tconfig.apply_overrides(tconfig.Config(), [override])
            continue
        got = tconfig.apply_overrides(tconfig.Config(), [override]).tune
        assert dataclasses.asdict(got) == dataclasses.asdict(want), override
