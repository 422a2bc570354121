"""NNI hyperparameter-tuning protocol bridge (the port's copy of the
reference's `deepdfa_tpu/train/nni_bridge.py`).

The reference integrates NNI directly into its CLI: `get_next_parameter()`
mutates the run config before training (DDFA/code_gnn/main_cli.py:110-120),
every validation epoch reports an intermediate result
(base_module.py:346), and the post-fit best metric is the final report
(main_cli.py:184). This bridge provides the same protocol surface against
the typed config, degrading to a no-op when the `nni` package or runtime
is absent — the in-process Tuner (train/tuning.py) is the search driver
for environments without an NNI experiment manager.

NNI parameters are dotted config keys (e.g. "train.optim.learning_rate",
"data.feat.limit_all"): the structured config replaces the reference's
string-encoded feat rewriting, so a tuned limit flows into
`data.feat.limit_all` (input_dim derives from it) instead of being
spliced into `_ABS_DATAFLOW_..._limitall_<N>_...`.
"""

from __future__ import annotations

import logging
import os
from typing import Callable

logger = logging.getLogger(__name__)


def _nni():
    """The nni module when running under an NNI experiment, else None."""
    if not os.environ.get("NNI_PLATFORM"):
        return None
    try:
        import nni  # noqa: PLC0415

        return nni
    except ImportError:
        logger.warning("NNI_PLATFORM set but the nni package is missing")
        return None


def active() -> bool:
    return _nni() is not None


def get_next_parameters() -> dict:
    """Next trial's parameters ({} outside an NNI experiment)."""
    nni = _nni()
    if nni is None:
        return {}
    params = nni.get_next_parameter() or {}
    logger.info("nni trial parameters: %s", params)
    return params


def nni_overrides() -> list[str]:
    """Trial parameters as dotted key=value config overrides.

    Values are always JSON-encoded: apply_overrides json-parses the value
    side, and only JSON spellings survive the typed-config checks
    (json.dumps(True) == "true"; Python's str(True) == "True" would not
    parse and the bool-mismatch check would kill the trial)."""
    import json

    return [f"{k}={json.dumps(v)}" for k, v in get_next_parameters().items()]


def report_intermediate(value: float) -> None:
    nni = _nni()
    if nni is not None:
        nni.report_intermediate_result(float(value))


def report_final(value: float) -> None:
    nni = _nni()
    if nni is not None:
        nni.report_final_result(float(value))


def intermediate_log_fn(
    monitor: str = "val_loss", inner: Callable[[dict], None] | None = None
) -> Callable[[dict], None]:
    """A train-loop log_fn that mirrors the reference's per-val-epoch
    report_intermediate_result (base_module.py:346), chaining to `inner`."""

    def log_fn(record: dict) -> None:
        if monitor in record:
            report_intermediate(record[monitor])
        if inner is not None:
            inner(record)

    return log_fn
