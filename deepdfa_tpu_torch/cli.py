"""Command line of the port: train and test the DeepDFA GGNN on one
device (the reference's `deepdfa-tpu train` and `deepdfa-tpu test`,
`deepdfa_tpu/cli/main.py:cmd_train` and `cmd_test`).

    python -m deepdfa_tpu_torch.cli train --config configs/bigvul_deepdfa.json [key=value ...]
    python -m deepdfa_tpu_torch.cli test --checkpoint best --split test [--export]

Both read the processed-dir layout the reference's `prepare` and
`extract` write under the storage root (`$DEEPDFA_TPU_STORAGE`, else
`storage/` at the repo root): `processed/<dataset>/splits.json` and the
graph store `processed/<dataset>/graphs<feat name>[_gtype_<gtype>]/`.
A run writes `runs/<run_name>/config.json`, `train_log.jsonl` and
torch checkpoints under `runs/<run_name>/checkpoints-torch/` (the
reference's orbax `checkpoints/` of the same run stay untouched).
The card is the default device; `--device cpu` runs the plain path.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from pathlib import Path

import numpy as np

from deepdfa_tpu_torch.core import config as config_mod
from deepdfa_tpu_torch.core.config import Config

CHECKPOINTS_DIR = "checkpoints-torch"


# -- storage layout (own copy of the reference's core/paths.py) -------------


def storage_root() -> Path:
    root = os.environ.get("DEEPDFA_TPU_STORAGE")
    return Path(root) if root else Path(__file__).resolve().parents[1] / "storage"


def _sub(kind: str, name: str | None = None) -> Path:
    p = storage_root() / kind
    if name is not None:
        p = p / name
    p.mkdir(parents=True, exist_ok=True)
    return p


def processed_dir(dataset: str) -> Path:
    return _sub("processed", dataset)


def runs_dir(run_name: str) -> Path:
    return _sub("runs", run_name)


def graphs_dirname(cfg: Config) -> str:
    suffix = "" if cfg.data.gtype == "cfg" else f"_gtype_{cfg.data.gtype}"
    return f"graphs{cfg.data.feat.name}{suffix}"


# -- data ---------------------------------------------------------------------


def load_graph_splits(cfg: Config) -> dict[str, list]:
    from deepdfa_tpu_torch.graphs import GraphStore

    out_dir = processed_dir(cfg.data.dataset)
    splits = json.loads((out_dir / "splits.json").read_text())
    store = GraphStore(out_dir / graphs_dirname(cfg))
    by_id = store.load_all()
    if not by_id:
        raise SystemExit(
            f"no graphs in {store.directory} — run the reference's `extract` "
            "with the same data.feat.* / data.gtype settings as this command"
        )
    out = {"train": [], "val": [], "test": []}
    for gid, spec in by_id.items():
        s = splits.get(str(gid))
        if s in out:
            out[s].append(spec)
    return out


def epoch_batches(cfg: Config, specs, shuffle_epoch: int | None = None,
                  phase: str = "train", lazy: bool = False):
    """Budget-aware batches for one pass over `specs`: over-budget graphs
    are dropped in training and get their own pow2-budget batches in
    evaluation; with data.undersample, a training epoch draws its 1:1
    selection from (epoch, data.seed)."""
    from deepdfa_tpu_torch.graphs import shard_bucket_batches
    from deepdfa_tpu_torch.train import undersample_epoch

    bcfg = cfg.data.batch

    def build():
        if shuffle_epoch is not None and cfg.data.undersample:
            labels = np.array([s.label for s in specs])
            sel = [specs[i] for i in undersample_epoch(labels, shuffle_epoch, seed=cfg.data.seed)]
        else:
            sel = list(specs)
        stats: dict = {}
        yield from shard_bucket_batches(
            sel, bcfg.graphs_per_batch, bcfg.node_budget, bcfg.edge_budget,
            oversized="drop" if phase == "train" else "singleton", stats=stats,
        )
        if stats.get("dropped"):
            print(f"[batch] dropped {stats['dropped']}/{len(sel)} over-budget graphs "
                  "(training only; eval scores every example)")

    return build() if lazy else list(build())


def _load_config(args) -> Config:
    cfg = config_mod.load(args.config) if args.config else Config()
    return config_mod.apply_overrides(cfg, args.overrides)


def _load_run_config(args) -> Config:
    """The run's saved config.json when no --config is given, so model
    and data dims match the checkpoint; overrides apply on top."""
    cfg = _load_config(args)
    if args.config is None:
        saved = runs_dir(cfg.run_name) / "config.json"
        if saved.exists():
            cfg = config_mod.apply_overrides(config_mod.load(saved), args.overrides)
    return cfg


def _model(cfg: Config):
    """The configured DeepDFA; `init_state` or a checkpoint sets its weights."""
    from deepdfa_tpu_torch.models import DeepDFA

    return DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim)


class RunLog:
    """Appends each record to `train_log.jsonl` in the run dir."""

    def __init__(self, run_dir: Path):
        self._f = open(run_dir / "train_log.jsonl", "a")

    def log(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def cmd_train(args) -> None:
    from deepdfa_tpu_torch.train import GraphTrainer, positive_weight

    cfg = _load_config(args)
    split_specs = load_graph_splits(cfg)
    run_dir = runs_dir(cfg.run_name)
    config_mod.to_json(cfg, run_dir / "config.json")
    pw = None
    if cfg.train.pos_weight is None and not cfg.data.undersample:
        pw = positive_weight(np.array([s.label for s in split_specs["train"]]))
    batches0 = epoch_batches(cfg, split_specs["train"], shuffle_epoch=0)
    trainer = GraphTrainer(
        _model(cfg), cfg, pos_weight=pw,
        total_steps=len(batches0) * max(1, cfg.train.max_epochs), device=args.device,
    )
    state = trainer.init_state()
    ckpts = trainer.make_checkpoints(run_dir / CHECKPOINTS_DIR)
    run_log = RunLog(run_dir)
    try:
        trainer.fit(
            state,
            lambda epoch: epoch_batches(cfg, split_specs["train"], epoch, lazy=True),
            val_batches=lambda: epoch_batches(cfg, split_specs["val"], phase="eval"),
            checkpoints=ckpts,
            log_fn=run_log.log,
        )
    finally:
        run_log.close()
    print("best:", ckpts.best_metrics())


def cmd_test(args) -> None:
    from deepdfa_tpu_torch.train import GraphTrainer, classification_report

    cfg = _load_run_config(args)
    split_specs = load_graph_splits(cfg)
    run_dir = runs_dir(cfg.run_name)
    trainer = GraphTrainer(_model(cfg), cfg, total_steps=1, device=args.device)
    ckpts = trainer.make_checkpoints(run_dir / CHECKPOINTS_DIR)
    trainer.model.load_state_dict(ckpts.restore(args.checkpoint)["model"])
    batches = epoch_batches(cfg, split_specs[args.split], phase="eval")
    metrics, m = trainer.evaluate(batches)
    print(classification_report(m))
    print(json.dumps(metrics, indent=2))
    (run_dir / f"test_metrics_{args.split}.json").write_text(json.dumps(metrics))

    curve = m.pr_curve()
    with (run_dir / f"pr_{args.split}.csv").open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["threshold", "precision", "recall"])
        for t, p, r in zip(curve["thresholds"], curve["precision"], curve["recall"]):
            w.writerow([f"{t:.4f}", f"{p:.6f}", f"{r:.6f}"])

    if args.export:
        rows = []
        for batch in batches:
            probs, labels, mask, _ = (
                x.cpu().numpy() for x in trainer.eval_step(batch.to(trainer.device))
            )
            for gid, p, y, v in zip(np.asarray(batch.graph_ids), probs, labels, mask):
                if v and gid >= 0:
                    rows.append((int(gid), float(p), int(y)))
        with (run_dir / f"predictions_{args.split}.csv").open("w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["id", "prob", "label"])
            w.writerows(sorted(rows))
        print(f"exported {len(rows)} predictions")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m deepdfa_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--config", default=None, help="json config file")
        p.add_argument("--device", default=None,
                       help="cuda (default) or cpu (the plain PyTorch path)")
        p.add_argument("overrides", nargs="*", default=[],
                       help="dotted key=value overrides")

    p = sub.add_parser("train")
    common(p)
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("test")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--split", default="test")
    p.add_argument("--export", action="store_true",
                   help="write per-example predictions csv")
    common(p)
    p.set_defaults(fn=cmd_test)
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
