"""The cascade's calibration (deepdfa_tpu_torch/eval/calibrate.py) and
`cli cascade-calibrate` against the reference's, on the CPU: every
function's output equals the reference's bit for bit (floats compared
with ==, arrays with array_equal), on seeded score sets that are
calibrated, over- and under-confident, tied, one-sided and tiny; and the
command prints the same JSON line and writes the same file for the same
JSONL."""

import argparse
import contextlib
import io
import json

import numpy as np
import pytest

from deepdfa_tpu.eval import calibrate as ref  # noqa: E402
from deepdfa_tpu_torch import cli  # noqa: E402
from deepdfa_tpu_torch.eval import calibrate as cal  # noqa: E402


def _scores(kind: str, n: int = 300, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.3).astype(np.int64)
    z = rng.normal(0.0, 1.0, n) + 1.5 * (2 * y - 1)
    if kind == "overconfident":
        z = 4.0 * z
    elif kind == "underconfident":
        z = 0.25 * z
    elif kind == "tied":
        z = np.round(z)
    elif kind == "extreme":
        z = 30.0 * z  # probabilities at 0 and 1, clipped by the logit
    p = 1.0 / (1.0 + np.exp(-z))
    if kind == "tiny":
        p, y = p[:3], np.array([0, 1, 0])
    return p, y


KINDS = ["calibrated", "overconfident", "underconfident", "tied", "extreme", "tiny"]


@pytest.mark.parametrize("kind", KINDS)
def test_fits_equal_the_reference_bit_for_bit(kind):
    p, y = _scores(kind)
    t = cal.fit_temperature(p, y)
    assert t == ref.fit_temperature(p, y)
    assert cal.nll(p, y, t) == ref.nll(p, y, t)
    assert np.array_equal(cal.temperature_scale(p, t), ref.temperature_scale(p, t))
    for target in (0.0, 0.1, 0.3, 0.5, 1.0, 1.5):
        band = cal.fit_band(p, y, temperature=t, target_escalation=target)
        assert band == ref.fit_band(p, y, temperature=t, target_escalation=target)
        scaled = cal.temperature_scale(p, t)
        assert [cal.in_band(q, band) for q in scaled] == [ref.in_band(q, band) for q in scaled]
    assert cal.auc(p, y) == ref.auc(p, y)
    assert cal.calibrate(p, y, 0.3) == ref.calibrate(p, y, 0.3)


def test_one_class_and_degenerate_inputs_behave_as_the_reference():
    p = np.array([0.2, 0.4, 0.9])
    with pytest.raises(ValueError, match="BOTH classes"):
        cal.fit_temperature(p, [1, 1, 1])
    with pytest.raises(ValueError, match="BOTH classes"):
        ref.fit_temperature(p, [1, 1, 1])
    assert cal.auc(p, [0, 0, 0]) is None and ref.auc(p, [0, 0, 0]) is None
    assert cal.fit_band(p, temperature=2.0, target_escalation=0.0) == (0.5, 0.5)
    assert not cal.in_band(0.5, (0.5, 0.5))  # half-open: an empty band


def _write_scores(path, kind, extra_rows=()):
    p, y = _scores(kind)
    rows = [{"name": f"f{i}.c", "prob": float(a), "label": int(b)} for i, (a, b) in
            enumerate(zip(p, y))]
    rows += list(extra_rows)
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")


@pytest.mark.parametrize("target", [0.1, 0.3, 0.6])
def test_cascade_calibrate_prints_and_writes_what_the_reference_does(tmp_path, target):
    from deepdfa_tpu.cli.main import cmd_cascade_calibrate

    scores = tmp_path / "scores.jsonl"
    # rows without a label (an unparseable function) are skipped by both
    _write_scores(scores, "overconfident", [{"name": "bad.c", "ok": False},
                                            {"name": "x.c", "prob": 0.5}])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["cascade-calibrate", "--scores", str(scores), "--target-escalation",
                  str(target), "--out", str(tmp_path / "port.json")])
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        cmd_cascade_calibrate(argparse.Namespace(
            scores=str(scores), prob_key="prob", label_key="label",
            target_escalation=target, out=str(tmp_path / "ref.json")))
    assert out.getvalue() == ref_out.getvalue()
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    result = json.loads(out.getvalue())
    assert result["overrides"] == [f"serve.cascade_temperature={result['temperature']}",
                                   f"serve.cascade_band={json.dumps(result['band'])}"]


def test_cascade_calibrate_refuses_a_file_without_labels(tmp_path):
    scores = tmp_path / "scores.jsonl"
    scores.write_text(json.dumps({"prob": 0.4}) + "\n")
    with pytest.raises(SystemExit, match="carry both"):
        cli.main(["cascade-calibrate", "--scores", str(scores)])
