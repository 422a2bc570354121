"""Experiment-matrix runner (the port's copy of the reference's
`deepdfa_tpu/train/experiments.py`, the role of CodeT5/sh/run_exp.py:7-167).

The sweep layer expands a (model x task x sub_task) matrix into per-run
commands with task-specific default hyperparameters and runs them,
logging each run under a tag. Here it runs over the port's CLI:

- a matrix spec is a list of runs, each {"name": ..., "cmd": <subcommand>,
  "args": [...]} built either from a JSON file or from the built-in
  defaults table below (task -> subcommand + hyperparameters, the role of
  run_exp.py:get_args_by_task_model);
- runs execute sequentially as `python -m deepdfa_tpu_torch.cli <cmd>
  <args>` subprocesses, which inherit this process's environment (the
  storage root, the visible card);
- each run's final JSON/`best:` line is parsed into a summary table
  written to <runs>/experiments/<tag>/summary.jsonl (run_exp.py's
  saved_models/<tag> layout).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Sequence

#: task -> (cli subcommand, default args) — the get_args_by_task_model
#: defaults table, in the port's CLI flags
TASK_DEFAULTS: dict[str, tuple[str, list[str]]] = {
    "deepdfa": ("train", []),
    "combined": ("train-combined", ["--encoder", "tiny"]),
    "combined-t5": ("train-combined", ["--arch", "t5", "--encoder", "tiny"]),
    "defect-gen": ("train-gen", ["--task", "defect", "--tiny"]),
    "summarize": ("train-gen", ["--task", "summarize", "--tiny"]),
    "translate": ("train-gen", ["--task", "translate", "--tiny"]),
    "refine": ("train-gen", ["--task", "refine", "--tiny"]),
    "concode": ("train-gen", ["--task", "concode", "--tiny"]),
    "clone": ("train-clone", ["--tiny"]),
}


@dataclasses.dataclass(frozen=True)
class Run:
    name: str
    cmd: str
    args: tuple[str, ...]

    def argv(self) -> list[str]:
        return [sys.executable, "-m", "deepdfa_tpu_torch.cli", self.cmd, *self.args]


def expand_matrix(
    tasks: Sequence[str],
    seeds: Sequence[int] = (0,),
    extra_args: Sequence[str] = (),
    overrides: Sequence[str] = (),
) -> list[Run]:
    """tasks x seeds -> Runs with per-task defaults + shared extras.

    `overrides` are dotted config overrides appended last (they are
    positional in the CLI); run_name is forced per run so artifacts never
    collide (run_exp.py tags runs the same way)."""
    runs = []
    for task in tasks:
        if task not in TASK_DEFAULTS:
            raise ValueError(
                f"unknown task {task!r} (choose from {sorted(TASK_DEFAULTS)})"
            )
        cmd, defaults = TASK_DEFAULTS[task]
        for seed in seeds:
            name = f"{task}_seed{seed}"
            runs.append(
                Run(
                    name=name,
                    cmd=cmd,
                    args=tuple(defaults)
                    + tuple(extra_args)
                    + tuple(overrides)
                    + (f"train.seed={seed}", f"run_name={name}"),
                )
            )
    return runs


def load_matrix(path: str | Path) -> list[Run]:
    """JSON spec: [{"name": ..., "cmd": ..., "args": [...]}, ...]."""
    rows = json.loads(Path(path).read_text())
    return [Run(name=r["name"], cmd=r["cmd"], args=tuple(r["args"])) for r in rows]


_RESULT_RE = re.compile(r"^(?:best: )?(\{.*\})\s*$")


def parse_result(stdout: str) -> dict | None:
    """Last parseable JSON (or `best: {...}` repr) line of a run."""
    for line in reversed(stdout.strip().splitlines()):
        m = _RESULT_RE.match(line.strip())
        if not m:
            continue
        text = m.group(1)
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            try:
                # `best: {'val_f1': ...}` python-repr dicts
                return json.loads(text.replace("'", '"'))
            except json.JSONDecodeError:
                continue
    return None


def run_matrix(
    runs: Sequence[Run],
    out_dir: str | Path,
    dry_run: bool = False,
    env: dict | None = None,
    timeout: float | None = None,
) -> list[dict]:
    """Execute runs sequentially; write summary.jsonl; return summaries."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    summaries = []
    for run in runs:
        if dry_run:
            print(" ".join(run.argv()))
            summaries.append({"name": run.name, "dry_run": True})
            continue
        t0 = time.time()
        try:
            proc = subprocess.run(
                run.argv(),
                capture_output=True,
                text=True,
                env={**os.environ, **(env or {})},
                timeout=timeout,
            )
        except subprocess.TimeoutExpired as exc:
            # a hung run must not abort the rest of the matrix — record it
            # as a failed row and move on
            out = (exc.stdout or b"")
            err = (exc.stderr or b"")
            (out_dir / f"{run.name}.log").write_text(
                (out if isinstance(out, str) else out.decode(errors="replace"))
                + (err if isinstance(err, str) else err.decode(errors="replace"))
            )
            summary = {
                "name": run.name,
                "cmd": run.cmd,
                "rc": None,
                "timeout": True,
                "seconds": round(time.time() - t0, 1),
                "result": None,
            }
            summaries.append(summary)
            with (out_dir / "summary.jsonl").open("a") as f:
                f.write(json.dumps(summary) + "\n")
            print(json.dumps(summary))
            continue
        (out_dir / f"{run.name}.log").write_text(proc.stdout + proc.stderr)
        summary = {
            "name": run.name,
            "cmd": run.cmd,
            "rc": proc.returncode,
            "seconds": round(time.time() - t0, 1),
            "result": parse_result(proc.stdout),
        }
        summaries.append(summary)
        with (out_dir / "summary.jsonl").open("a") as f:
            f.write(json.dumps(summary) + "\n")
        print(json.dumps(summary))
    return summaries
