"""kernel_trial.py, the layout trials of the port's kernels, on the CPU:
every edit of every layout finds its text exactly once in the source it
edits (so a layout still builds the variant it names after the source
moves on), two runs of a call merge as the script reports them, and the
script refuses options that do not apply and a machine without a card."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("kernel_trial", ROOT / "kernel_trial.py")
kt = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kt)

LAYOUTS = [(mode, label) for mode, trial in kt.TRIALS.items() for label in trial["layouts"]]


@pytest.mark.parametrize("mode, label", LAYOUTS, ids=[f"{m}-{l}" for m, l in LAYOUTS])
def test_every_layout_edits_its_source_once(mode, label):
    text = (kt.CSRC / kt.TRIALS[mode]["source"]).read_text()
    out = kt.edited(mode, label, text)
    assert (out == text) == (label == "as_is")
    for _, new in kt.TRIALS[mode]["layouts"][label]:
        assert new in out


def test_an_edit_that_misses_the_source_is_refused():
    with pytest.raises(ValueError, match="exactly once"):
        kt.edited("dbias", "dbias_no_split", "constexpr int kDbSplitBlocks = 64;")


def test_two_runs_merge_as_reported():
    """Times as their mean, errors their larger, flags both, the rest
    (the batch cut, the launch split) the first run's; the dbias mode
    weights the four calls it times."""
    first = {"ms": 1.0, "dq_ms": 0.5, "err_of_scale": {"dq": 1e-6, "dk": 3e-6}, "o_err": 1e-6,
             "repeat_equal": True, "within_gate": True, "cut": {"slices": 4, "per": 4}}
    second = {"ms": 3.0, "dq_ms": 0.25, "err_of_scale": {"dq": 2e-6, "dk": 1e-6}, "o_err": 2e-6,
              "repeat_equal": False, "within_gate": True, "cut": {"slices": 8, "per": 2}}
    merged = {k: kt.merge(first[k], second[k], k) for k in first}
    assert merged == {"ms": 2.0, "dq_ms": 0.375, "err_of_scale": {"dq": 2e-6, "dk": 3e-6},
                      "o_err": 2e-6, "repeat_equal": False, "within_gate": True,
                      "cut": {"slices": 4, "per": 4}}
    assert set(kt.TRIALS["dbias"]["weights"]) == set(kt.DBIAS_CALLS)


@pytest.mark.parametrize("argv, says", [
    (["fwd", "--tree", "parent=."], "--tree applies to gru"),
    (["dbias", "--source", "parent=x.cu"], "--source applies to fwd and bwd"),
    (["gru", "--layouts", "w2048"], "has no layouts"),
    (["gru", "--layouts", "as_is"], "no CUDA card"),
])
def test_options_that_do_not_apply_are_refused(argv, says):
    if says == "no CUDA card":
        torch = pytest.importorskip("torch")
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present; the trial would run for real")
    res = subprocess.run([sys.executable, str(ROOT / "kernel_trial.py"), *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and says in res.stderr
    assert res.stdout == ""
    if says == "no CUDA card":  # refused before it writes a copy
        assert not (kt.trial_dir("gru", "as_is") / "ggnn_bwd.cu").exists()
