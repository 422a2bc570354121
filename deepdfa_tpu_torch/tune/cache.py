"""tuned.json: winning layouts persisted per hardware generation (the
port's `deepdfa_tpu/tune/cache.py`).

One document holds one record per hardware key, {device_kind, platform,
n_devices, torch_version, node_budget, edge_budget}: a layout measured
on one card at one pair of budgets says nothing about another. A
consumer uses a record only when the key matches its own exactly, and
otherwise falls back to the default layouts LOUDLY (a warning naming
every mismatched field). The reference keys on `jax_version` where the
port keys on `torch_version`, and its `platform` is JAX's ("tpu") where
the card's is "gpu": a record written by the reference never matches
here, and loads with the same loud fallback, never an error.

Consumers (behind `cfg.tune.enabled`): `cli train` and `train-combined`
fold the record's kernel layout (`model.ggnn_kernel_*`) and seq-bucket
edges into the config (`apply_to_config`); `GgnnExecutor(ladder=)`
takes the fitted serve rungs (`serve_rungs_from`).
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any

import torch

logger = logging.getLogger(__name__)

#: the document's shape version (the reference's)
TUNED_VERSION = 1

#: the fields of a hardware key; a record matches on exact equality of all
REQUIRED_HW_FIELDS = (
    "device_kind", "platform", "n_devices", "torch_version", "node_budget", "edge_budget",
)


def hardware_key(node_budget: int, edge_budget: int,
                 device: str | torch.device | None = None) -> dict:
    """The hardware key of this process on `device` (None: the card):
    the card's name, platform "gpu" and the visible card count, or "cpu"
    for the CPU; the torch version; the budgets the layouts are measured
    at."""
    from deepdfa_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        kind, platform, count = torch.cuda.get_device_name(dev), "gpu", torch.cuda.device_count()
    else:
        kind, platform, count = "cpu", "cpu", 1
    return {
        "device_kind": str(kind),
        "platform": platform,
        "n_devices": int(count),
        "torch_version": str(torch.__version__),
        "node_budget": int(node_budget),
        "edge_budget": int(edge_budget),
    }


def empty_doc() -> dict:
    return {"version": TUNED_VERSION, "records": []}


def load_tuned(path: str | Path) -> dict | None:
    path = Path(path)
    if not path.exists():
        return None
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        logger.warning("tuned.json at %s unreadable (%s)", path, e)
        return None
    return doc if isinstance(doc, dict) else None


def save_tuned(path: str | Path, doc: dict) -> Path:
    """Write `doc` to `path` atomically (a temporary file, then a rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(doc, indent=1))
    os.replace(tmp, path)
    return path


def hw_mismatch(record_hw: dict, hw: dict) -> list[str]:
    """The mismatched fields between a record's key and ours ([] = an
    exact match); a missing field is a mismatch."""
    return [f"{f}: record={record_hw.get(f)!r} vs ours={hw.get(f)!r}"
            for f in REQUIRED_HW_FIELDS if record_hw.get(f) != hw.get(f)]


def find_record(doc: dict, hw: dict) -> dict | None:
    """The newest record whose hardware key matches exactly."""
    best = None
    for rec in doc.get("records", []):
        if isinstance(rec, dict) and not hw_mismatch(rec.get("hardware") or {}, hw):
            best = rec
    return best


def upsert_record(doc: dict, record: dict) -> dict:
    """Replace the record with the same hardware key (or append)."""
    hw = record.get("hardware") or {}
    records = [r for r in doc.get("records", []) if hw_mismatch(r.get("hardware") or {}, hw)]
    records.append(record)
    return {"version": TUNED_VERSION, "records": records}


def make_record(hardware: dict, kernel: dict | None = None, ladders: dict | None = None,
                search_seconds: float = 0.0) -> dict:
    rec: dict = {
        "hardware": dict(hardware),
        "created_unix": round(time.time(), 3),
        "search_seconds": round(float(search_seconds), 3),
    }
    if kernel:
        rec["kernel"] = kernel
    if ladders:
        rec["ladders"] = ladders
    return rec


def _ascending(xs) -> bool:
    xs = list(xs)
    return all(isinstance(x, int) and not isinstance(x, bool) for x in xs) and xs == sorted(set(xs))


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_tuned(doc: Any) -> dict:
    """Structural validation of a tuned.json document (the reference's
    rules): hardware key complete, every timed candidate row carrying its
    numerics verdict, a recorded winner per signature, ladder records
    with their pow2 baseline."""
    problems: list[str] = []
    n_signatures = n_candidates = 0
    if isinstance(doc, dict) and "tuned" in doc and "records" not in doc:
        doc = doc["tuned"]
    if not isinstance(doc, dict):
        return {"ok": False, "problems": ["document is not an object"]}
    if doc.get("version") != TUNED_VERSION:
        problems.append(f"version {doc.get('version')!r} != {TUNED_VERSION}")
    records = doc.get("records")
    if not isinstance(records, list) or not records:
        problems.append("no records")
        records = []
    for ri, rec in enumerate(records):
        where = f"records[{ri}]"
        if not isinstance(rec, dict):
            problems.append(f"{where}: not an object")
            continue
        hw = rec.get("hardware")
        if not isinstance(hw, dict):
            problems.append(f"{where}: missing hardware key")
        else:
            problems += [f"{where}: hardware key incomplete — missing {f}"
                         for f in REQUIRED_HW_FIELDS if hw.get(f) in (None, "")]
        if not _number(rec.get("search_seconds")):
            problems.append(f"{where}: missing search_seconds")
        kernel = rec.get("kernel")
        if kernel is not None:
            if not isinstance(kernel, dict):
                problems.append(f"{where}: kernel is not an object")
                kernel = {}
            for sig, sr in kernel.items():
                n_signatures += 1
                sw = f"{where}.kernel[{sig}]"
                if not isinstance(sr, dict):
                    problems.append(f"{sw}: not an object")
                    continue
                cands = sr.get("candidates")
                if not isinstance(cands, list) or not cands:
                    problems.append(f"{sw}: no candidate rows")
                    cands = []
                labels = set()
                for ci, row in enumerate(cands):
                    cw = f"{sw}.candidates[{ci}]"
                    if not isinstance(row, dict):
                        problems.append(f"{cw}: not an object")
                        continue
                    n_candidates += 1
                    labels.add(row.get("candidate"))
                    for axis, allowed in (("accum", ("fp32", "bf16", "int8")),
                                          ("unroll", ("per_step", "fused"))):
                        if axis in row and row[axis] not in allowed:
                            problems.append(f"{cw}[{row.get('candidate')}]: unknown {axis} "
                                            f"{row[axis]!r}")
                    if "skipped" in row or "error" in row:
                        continue  # never timed: no verdict to carry
                    verdict = row.get("numerics")
                    if not isinstance(verdict, dict) or not isinstance(verdict.get("ok"), bool):
                        problems.append(f"{cw}[{row.get('candidate')}]: missing "
                                        "numerics-contract verdict")
                winner = sr.get("winner")
                if winner is None:
                    problems.append(f"{sw}: no winner")
                elif winner not in labels:
                    problems.append(f"{sw}: winner {winner!r} is not a recorded candidate")
        ladders = rec.get("ladders")
        if ladders is not None:
            if not isinstance(ladders, dict):
                problems.append(f"{where}: ladders is not an object")
                ladders = {}
            for name, lr in ladders.items():
                lw = f"{where}.ladders[{name}]"
                if not isinstance(lr, dict):
                    problems.append(f"{lw}: not an object")
                    continue
                rungs = lr.get("rungs") or lr.get("edges")
                if not rungs or not _ascending(rungs):
                    problems.append(f"{lw}: rungs/edges missing or not ascending unique ints")
                problems += [f"{lw}: missing {f}" for f in ("padding_waste", "pow2_padding_waste")
                             if not _number(lr.get(f))]
        if kernel is None and ladders is None:
            problems.append(f"{where}: neither kernel nor ladders")
    return {"ok": not problems, "problems": problems, "records": len(records),
            "signatures": n_signatures, "candidates": n_candidates}


def validate_tuned_file(path: str | Path) -> dict:
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return {"ok": False, "problems": [f"unreadable: {e}"]}
    return {**validate_tuned(doc), "path": str(path)}


# ---------------------------------------------------------------------------
# config-facing consumers (everything behind cfg.tune.enabled)


def tuned_path(cfg) -> Path:
    """cfg.tune.path, else <storage>/tuned.json."""
    if cfg.tune.path:
        return Path(cfg.tune.path)
    from deepdfa_tpu_torch.cli import storage_root

    return storage_root() / "tuned.json"


#: record_for_config's memo, keyed by (path, mtime, budgets, device): one
#: read and one loud warning per process for the same question
_RECORD_MEMO: dict[tuple, dict | None] = {}


def record_for_config(cfg, node_budget: int, edge_budget: int,
                      device: str | torch.device | None = None) -> dict | None:
    """The tuned record matching this process's hardware key on `device`,
    or None, with the reference's loud fallbacks: a missing or unreadable
    file and a key mismatch each log a warning naming themselves."""
    path = tuned_path(cfg)
    try:
        mtime = path.stat().st_mtime_ns
    except OSError:
        mtime = None
    key = (str(path), mtime, int(node_budget), int(edge_budget), str(device))
    if key not in _RECORD_MEMO:
        if len(_RECORD_MEMO) > 16:
            _RECORD_MEMO.clear()
        _RECORD_MEMO[key] = _record_for_config_uncached(path, node_budget, edge_budget, device)
    return _RECORD_MEMO[key]


def _record_for_config_uncached(path: Path, node_budget: int, edge_budget: int,
                                device) -> dict | None:
    doc = load_tuned(path)
    if doc is None:
        logger.warning("tune.enabled but no usable tuned.json at %s — running the default "
                       "layouts (run `python -m deepdfa_tpu_torch.cli tune`)", path)
        return None
    hw = hardware_key(node_budget, edge_budget, device)
    rec = find_record(doc, hw)
    if rec is None:
        nearest = (doc.get("records") or [{}])[-1]
        if not isinstance(nearest, dict):
            nearest = {}
        logger.warning(
            "tune.enabled but no tuned record matches this hardware generation — falling "
            "back to default layouts. ours=%s; nearest record mismatches: %s", hw,
            hw_mismatch(nearest.get("hardware") or {}, hw) or ["<no records>"])
    return rec


def serve_rungs_from(record: dict | None, capacity: int) -> tuple[int, ...] | None:
    """The tuned serve rungs for `capacity`, normalized as
    `serve/batcher.py:_ladder_sizes` does; None (loudly) when the ladder
    was fitted at another capacity, where its rungs would lose the small
    rungs the pow2 default keeps."""
    if not record:
        return None
    lr = (record.get("ladders") or {}).get("serve")
    if not isinstance(lr, dict) or not lr.get("rungs"):
        return None
    fitted_cap = lr.get("capacity", max(int(r) for r in lr["rungs"]))
    if int(fitted_cap) != int(capacity):
        logger.warning(
            "tuned serve ladder was fitted at capacity %s but serve.max_batch_graphs=%s — "
            "falling back to the pow2 default ladder (re-run `tune` at this capacity)",
            fitted_cap, capacity)
        return None
    from deepdfa_tpu_torch.serve.batcher import _ladder_sizes

    return _ladder_sizes(lr["rungs"], int(capacity))


def seq_edges_from(record: dict | None) -> tuple[int, ...] | None:
    """The tuned data.seq_buckets edges, if the record fitted them."""
    if not record:
        return None
    lr = (record.get("ladders") or {}).get("seq_buckets")
    if not isinstance(lr, dict) or not lr.get("edges"):
        return None
    return tuple(int(e) for e in lr["edges"])


def ggnn_feature_width(model_cfg) -> int:
    """The GGNN feature width d the kernel signatures key on: half of
    `DeepDFA.out_dim`, the [ggnn_out, feat_embed] concat."""
    from deepdfa_tpu_torch.models import DeepDFA

    return DeepDFA.from_config(model_cfg, input_dim=1).out_dim // 2


def kernel_layout_from(record: dict | None, n: int, e: int, d: int) -> dict | None:
    """The whole winning layout for one signature (blocks and
    scatter/accum/unroll, measured jointly, so applied together), or
    None when the record has none."""
    if not record:
        return None
    sr = (record.get("kernel") or {}).get(f"{n}x{e}x{d}")
    if not isinstance(sr, dict) or not sr.get("winner"):
        return None
    bn, be = sr.get("winner_block_n"), sr.get("winner_block_e")
    if not isinstance(bn, int) or not isinstance(be, int):
        return None
    out = {"block_n": int(bn), "block_e": int(be)}
    for axis in ("scatter", "accum", "unroll"):
        if isinstance(sr.get(f"winner_{axis}"), str):
            out[axis] = sr[f"winner_{axis}"]
    return out


def apply_to_config(cfg, sections=("kernel", "seq_buckets"), node_budget: int | None = None,
                    edge_budget: int | None = None, device: str | torch.device | None = None):
    """(cfg', report): fold the matching record's kernel layout
    (model.ggnn_kernel_block_nodes/_block_edges/_scatter/_accum/_unroll)
    and, with "seq_buckets" in `sections`, its fitted data.seq_buckets
    edges into `cfg`, keyed at the given budgets (default data.batch.*)
    on `device`. A no-op, loudly, when nothing matches; the edges are
    kept off when the fit's top edge is not the configured one or no
    buckets are configured. report = {"matched", "overrides"}."""
    from deepdfa_tpu_torch.core import config as config_mod

    if node_budget is None:
        node_budget = cfg.data.batch.node_budget
    if edge_budget is None:
        edge_budget = cfg.data.batch.edge_budget
    rec = record_for_config(cfg, node_budget, edge_budget, device)
    report: dict = {"matched": rec is not None, "overrides": []}
    if rec is None:
        return cfg, report
    overrides: list[str] = []
    if "kernel" in sections:
        layout = kernel_layout_from(rec, node_budget, edge_budget, ggnn_feature_width(cfg.model))
        if layout is not None:
            overrides += [f"model.ggnn_kernel_block_nodes={layout['block_n']}",
                          f"model.ggnn_kernel_block_edges={layout['block_e']}"]
            overrides += [f"model.ggnn_kernel_{axis}={json.dumps(layout[axis])}"
                          for axis in ("scatter", "accum", "unroll") if axis in layout]
    if "seq_buckets" in sections:
        edges = seq_edges_from(rec)
        if edges is not None and cfg.data.seq_buckets:
            fit_max = ((rec.get("ladders") or {}).get("seq_buckets") or {}).get(
                "max_length", edges[-1])
            want_max = int(cfg.data.seq_buckets[-1])
            if int(fit_max) != want_max:
                logger.warning(
                    "tuned seq buckets were fitted at max_length %s but data.seq_buckets "
                    "tops at %s — keeping the configured edges (re-run `tune` with a "
                    "manifest at this length)", fit_max, want_max)
                edges = None
        elif edges is not None:
            logger.warning("tuned seq buckets present but data.seq_buckets is unset — not "
                           "applying (set data.seq_buckets to anchor the max edge)")
            edges = None
        if edges is not None:
            overrides.append("data.seq_buckets=" + json.dumps([int(x) for x in edges]))
    if overrides:
        cfg = config_mod.apply_overrides(cfg, overrides)
        logger.info("tuned layout applied: %s", overrides)
    report["overrides"] = overrides
    return cfg, report
