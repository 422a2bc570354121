"""The two-stage cascade (deepdfa_tpu_torch/serve/cascade.py:CascadeStage2,
serve/server.py, serve/driver.py:run_score, `cli score` with
`serve.cascade=true`) on the CPU, for both stage-2 families (combined,
t5).

Stage 1 is a GGNN trained on seeded synthetic functions, stage 2 a real
checkpoint that `build_stage2_smoke` lays down. The verdicts are held
against the reference's own rule: a row escalates exactly when the
reference's `eval/calibrate.py` `in_band(temperature_scale(p1, T),
band)` says so (the reference's registry restore is not used: it fails
with the installed orbax, ROADMAP queue C). An escalated row
serves the stage-2 model's score for that function alone, a screened
one the GGNN's, bit for bit; a shed or a failed stage-2 pass serves the
stage-1 score; the counters add up; the `serve.cascade_*` fields take
the reference's defaults and override rules.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from deepdfa_tpu.core import config as ref_config  # noqa: E402
from deepdfa_tpu.eval import calibrate as ref_calibrate  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.core import config as config_mod  # noqa: E402
from deepdfa_tpu_torch.serve import driver  # noqa: E402
from deepdfa_tpu_torch.serve.cascade import CascadeStage2, build_stage2_smoke  # noqa: E402
from deepdfa_tpu_torch.serve.registry import ModelRegistry  # noqa: E402
from deepdfa_tpu_torch.serve.server import ScoringService, score_texts  # noqa: E402

CASCADE_FIELDS = ("cascade", "cascade_band", "cascade_temperature", "cascade_run_dir",
                  "cascade_family", "cascade_checkpoint", "cascade_timeout_s",
                  "cascade_shed_depth_fraction")
TEMPERATURE = 1.7


def test_cascade_fields_take_the_reference_defaults_and_overrides():
    port, ref = config_mod.Config().serve, ref_config.Config().serve
    for name in CASCADE_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    overrides = ["serve.cascade=true", "serve.cascade_band=[0.2, 0.8]",
                 "serve.cascade_temperature=2", 'serve.cascade_run_dir="/runs/x"',
                 'serve.cascade_family="t5"', 'serve.cascade_checkpoint="last"',
                 "serve.cascade_timeout_s=5", "serve.cascade_shed_depth_fraction=0.5"]
    got = config_mod.apply_overrides(config_mod.Config(), overrides).serve
    want = ref_config.apply_overrides(ref_config.Config(), overrides).serve
    for name in CASCADE_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    for bad in ("serve.cascade_temperature=\"hot\"", "serve.cascade=1"):
        with pytest.raises(TypeError):
            config_mod.apply_overrides(config_mod.Config(), [bad])
        with pytest.raises(TypeError):
            ref_config.apply_overrides(ref_config.Config(), [bad])


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """(cfg, run_dir, [(name, code)], stage-1 probabilities by name) of a
    tiny GGNN run under a storage root of this module's."""
    root = tmp_path_factory.mktemp("storage")
    mp = pytest.MonkeyPatch()
    mp.setenv("DEEPDFA_TPU_STORAGE", str(root))
    try:
        cfg, run_dir, src = driver.build_smoke_run(
            extra_overrides=["serve.node_budget=2048", "serve.edge_budget=8192"],
            device="cpu", vuln_rate=0.5)
        texts = [(p.name, p.read_text()) for p in sorted(src.glob("*.c"))]
        service = ScoringService(ModelRegistry(run_dir, cfg=cfg, device="cpu"), cfg)
        try:
            p1 = {r["name"]: r["prob"] for r in score_texts(service, texts)}
        finally:
            service.close()
        yield cfg, run_dir, texts, p1
    finally:
        mp.undo()


def _stage2(smoke, family):
    cfg, run_dir, _, _ = smoke
    stage2 = run_dir.parent / f"stage2-{family}"
    if not stage2.exists():
        stage2.mkdir()
        config_mod.to_json(cfg, stage2 / "config.json")
        build_stage2_smoke(stage2, cfg, family=family)
    return stage2


def _band(p1: dict) -> list:
    """A band over the calibrated stage-1 scores that holds about half."""
    cal = np.sort(ref_calibrate.temperature_scale(list(p1.values()), TEMPERATURE))
    return [float(cal[len(cal) // 4]), float(cal[3 * len(cal) // 4])]


def _cascade_cfg(smoke, family, *extra):
    cfg, _, _, p1 = smoke
    return config_mod.apply_overrides(cfg, [
        "serve.cascade=true", f"serve.cascade_band={json.dumps(_band(p1))}",
        f"serve.cascade_temperature={TEMPERATURE}",
        f'serve.cascade_run_dir="{_stage2(smoke, family)}"',
        f'serve.cascade_family="{family}"', *extra])


def _reference_stage(p1: float, band) -> int:
    cal = ref_calibrate.temperature_scale([p1], TEMPERATURE)[0]
    return 2 if ref_calibrate.in_band(cal, tuple(band)) else 1


def _stage2_alone(smoke, family, texts) -> dict:
    cfg = config_mod.load(_stage2(smoke, family) / "config.json")
    service = ScoringService(ModelRegistry(_stage2(smoke, family), family=family, cfg=cfg,
                                           device="cpu"), cfg)
    try:
        return {r["name"]: r["prob"] for r in score_texts(service, texts)}
    finally:
        service.close()


@pytest.mark.parametrize("family", ["combined", "t5"])
def test_offline_verdicts_equal_the_reference_rule(smoke, family):
    cfg, run_dir, texts, p1 = smoke
    ccfg = _cascade_cfg(smoke, family)
    service = ScoringService(ModelRegistry(run_dir, cfg=ccfg, device="cpu"), ccfg)
    try:
        rows = score_texts(service, texts)
        counters = service.cascade.counters()
        health = service.healthz()["cascade"]
    finally:
        service.close()
    band = ccfg.serve.cascade_band
    alone = _stage2_alone(smoke, family, texts)
    stages = []
    for r in rows:
        want_stage = _reference_stage(p1[r["name"]], band)
        assert r["ok"] and r["stage"] == want_stage and r["stage1_prob"] == p1[r["name"]]
        want_cal = round(float(ref_calibrate.temperature_scale([p1[r["name"]]],
                                                               TEMPERATURE)[0]), 6)
        assert r["calibrated_prob"] == want_cal
        assert r["prob"] == (alone[r["name"]] if want_stage == 2 else p1[r["name"]])
        stages.append(want_stage)
    n2 = stages.count(2)
    assert 0 < n2 < len(rows)
    assert counters == {"requests": len(rows), "escalations": n2, "sheds": 0, "failures": 0,
                        "escalation_rate": round(n2 / len(rows), 4)}
    assert health["stage2_family"] == family and health["band"] == list(band)
    assert health["temperature"] == TEMPERATURE and health["stage2_checkpoint_step"] == 1


@pytest.mark.parametrize("family", ["combined", "t5"])
def test_online_decide_sheds_and_degrades_to_stage_one(smoke, family, monkeypatch):
    cfg, run_dir, texts, p1 = smoke
    ccfg = _cascade_cfg(smoke, family)
    band = ccfg.serve.cascade_band
    up = [(n, c) for n, c in texts if _reference_stage(p1[n], band) == 2]
    service = ScoringService(ModelRegistry(run_dir, cfg=ccfg, device="cpu"), ccfg)
    alone = _stage2_alone(smoke, family, up[:3])
    casc = service.cascade
    service.start()
    try:
        # escalated online: the stage-2 batcher's score for that function
        name, code = up[0]
        prob, info, extra = service.cascade_decide(code, p1[name], "r0")
        assert (prob, info["stage"]) == (alone[name], 2) and extra["cascade_stage2"] > 0
        # the stage-2 queue at its shed fraction: answered with stage 1
        monkeypatch.setattr(casc, "overloaded", lambda: True)
        name, code = up[1]
        prob, info, _ = casc.decide(code, p1[name], "r1")
        assert (prob, info["stage"], info["cascade_shed"]) == (p1[name], 1, 1)
        monkeypatch.undo()
        # a stage-2 executor failure degrades to stage 1, never fails
        def broken(*_a, **_k):
            raise RuntimeError("stage-2 device lost")

        monkeypatch.setattr(casc.service.executor, "dispatch", broken)
        name, code = up[2]
        prob, info, _ = casc.decide(code, p1[name], "r2")
        assert (prob, info["stage"], info["cascade_failed"]) == (p1[name], 1, 1)
    finally:
        service.close()
    c = casc.counters()
    assert c == {"requests": 3, "escalations": 1, "sheds": 1, "failures": 1,
                 "escalation_rate": round(1 / 3, 4)}
    assert c["requests"] == c["escalations"] + c["sheds"] + c["failures"]


def test_escalate_many_degrades_a_failed_pass_offline(smoke, monkeypatch):
    cfg, run_dir, texts, p1 = smoke
    ccfg = _cascade_cfg(smoke, "combined")
    service = ScoringService(ModelRegistry(run_dir, cfg=ccfg, device="cpu"), ccfg)

    def broken(*_a, **_k):
        raise RuntimeError("stage-2 device lost")

    monkeypatch.setattr(service.cascade.service.executor, "dispatch", broken)
    try:
        rows = score_texts(service, texts)
        counters = service.cascade.counters()
    finally:
        service.close()
    failed = [r for r in rows if r.get("cascade_failed")]
    assert failed and all(r["ok"] and r["prob"] == r["stage1_prob"] == p1[r["name"]]
                          and r["stage"] == 1 for r in failed)
    assert counters["failures"] == len(failed) and counters["escalations"] == 0
    assert counters["requests"] == len(rows)


def test_queue_limit_sheds_before_a_stage_two_batch(smoke):
    """`overloaded` reads the stage-2 batcher's queue depth against
    serve.queue_limit times the shed fraction (a shed fraction of 0 sheds
    every escalation)."""
    cfg, run_dir, texts, p1 = smoke
    ccfg = _cascade_cfg(smoke, "combined", "serve.cascade_shed_depth_fraction=0.0")
    service = ScoringService(ModelRegistry(run_dir, cfg=ccfg, device="cpu"), ccfg)
    try:
        assert isinstance(service.cascade, CascadeStage2) and service.cascade.overloaded()
        rows = score_texts(service, texts)
        counters = service.cascade.counters()
    finally:
        service.close()
    shed = [r for r in rows if r.get("cascade_shed")]
    assert shed and all(r["stage"] == 1 and r["prob"] == p1[r["name"]] for r in rows)
    assert counters["sheds"] == len(shed) and counters["escalations"] == 0


def test_cli_score_with_the_cascade_reports_rows_per_stage(smoke, tmp_path):
    cfg, run_dir, texts, p1 = smoke
    ccfg = _cascade_cfg(smoke, "combined")
    src = run_dir / "smoke_src"
    args = ["score", str(src), "--device", "cpu", "--out", str(tmp_path / "s.jsonl"),
            "--override", f'run_name="{cfg.run_name}"', "--override", "serve.cascade=true"]
    for name in ("cascade_band", "cascade_temperature", "cascade_run_dir"):
        args += ["--override", f"serve.{name}={json.dumps(getattr(ccfg.serve, name))}"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(args)
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    rows = [json.loads(x) for x in (tmp_path / "s.jsonl").read_text().splitlines()]
    casc = summary["cascade"]
    assert casc["stage1_rows"] + casc["stage2_rows"] == len(rows) == len(texts)
    assert casc["stage2_rows"] == casc["escalations"] == sum(r["stage"] == 2 for r in rows)
    assert casc["requests"] == casc["stage1_rows"] + casc["escalations"]
    assert casc["band"] == list(ccfg.serve.cascade_band)
    assert [r["stage"] for r in rows] == [_reference_stage(p1[r["name"].split("/")[-1]],
                                                           ccfg.serve.cascade_band)
                                          for r in rows]


def test_stage_two_config_turns_the_cascade_off(smoke):
    cfg, run_dir, _, _ = smoke
    ccfg = _cascade_cfg(smoke, "combined", "serve.request_log=true", "serve.hot_swap=true")
    casc = CascadeStage2.from_config(ccfg, run_dir, device="cpu")
    try:
        s2 = casc.service.cfg.serve
        assert (s2.cascade, s2.lines, s2.request_log, s2.hot_swap) == (False,) * 4
        assert casc.service.cascade is None and casc.band == tuple(ccfg.serve.cascade_band)
        assert dataclasses.asdict(casc.service.registry.model_cfg)["encoder"]["num_layers"] == 1
    finally:
        casc.close()
