"""Command line of the port: train and test the DeepDFA GGNN, train the
combined DeepDFA+LineVul and CodeT5+DeepDFA models, and train and decode
the CodeT5 generation family, on one device (the reference's
`deepdfa-tpu train`, `test`, `train-combined`, `train-gen`,
`train-multi-gen`, `train-clone` and `tune`,
`deepdfa_tpu/cli/main.py:cmd_train`, `cmd_test`, `cmd_train_combined`,
`cmd_train_gen`, `cmd_train_multi_gen`, `cmd_train_clone` and
`cmd_tune`), and tune the GGNN kernel layout on the card.

    python -m deepdfa_tpu_torch.cli train --config configs/bigvul_deepdfa.json [key=value ...]
    python -m deepdfa_tpu_torch.cli test --checkpoint best --split test [--export]
    python -m deepdfa_tpu_torch.cli train-combined --config configs/bigvul_combined.json \
        [--arch roberta|t5] --encoder codebert-base|codet5-base|tiny \
        [--graph-checkpoint RUN [--freeze-graph]] [key=value ...]
    python -m deepdfa_tpu_torch.cli train-gen --task summarize --train-file F \
        [--dev-file F] [--test-file F] [--do-eval-bleu] [--tiny] [key=value ...]
    python -m deepdfa_tpu_torch.cli train-multi-gen --task-spec NAME=TRAIN[:DEV] ...
    python -m deepdfa_tpu_torch.cli train-clone --train-file F [--dev-file F] [--test-file F]
    python -m deepdfa_tpu_torch.cli tune [--smoke] [--out F] [--serve-log F] [--manifest F] \
        [--skip-kernel] [--config F] [--override key=value ...] [--device cpu]

They read the processed-dir layout the reference's `prepare` and
`extract` write under the storage root (`$DEEPDFA_TPU_STORAGE`, else
`storage/` at the repo root): `processed/<dataset>/splits.json`, the
graph store `processed/<dataset>/graphs<feat name>[_gtype_<gtype>]/` and,
for `train-combined`, `processed/<dataset>/examples.pkl`. A run writes
`runs/<run_name>/config.json`, `train_log.jsonl` and torch checkpoints
under `runs/<run_name>/checkpoints-torch/` (GGNN) or
`checkpoints-combined-torch/` (combined); the reference's orbax
checkpoints of the same run stay untouched. The card is the default
device; `--device cpu` runs the plain path.

`train-combined` takes the reference's arguments. `--arch t5` builds
the CodeT5+DeepDFA defect model (`--encoder tiny|codet5-base`, the
T5-framed hash tokenizer, `max_sequence_length = --max-length`), as the
reference does without `--pretrained` (`cli/main.py:771-815`). Not ported
yet, and refused: `--tokenizer` (BPE; no vocabulary is in the
repository), `--pretrained` (no CodeBERT or CodeT5 weights either),
`--sp-variant ulysses` and `--remat-policy attn_saved`. Rows are
bucketed by `data.seq_buckets` (the largest edge equal to
`--max-length`) or padded to `--max-length` in fixed 16-row batches.

The generation commands read the reference's task files
(`data/gen_data.py`) and build the T5 encoder-decoder with the reference's
defaults (`--tiny`, else codet5-base width; fp32 activations; the
T5-framed hash tokenizer at `--vocab-size`). `train-gen` keeps the
best-ppl checkpoint in `runs/<run>/checkpoints-gen-torch/` (and with
`--do-eval-bleu` the best BLEU+EM one in `checkpoints-gen-bleu-torch/`),
and with `--test-file` restores the best-ppl checkpoint, decodes the test
set by beam search and writes `results/test_best-ppl.{output,gold}`.
`train-multi-gen` keeps `checkpoints-multi-<task>-torch/`, `train-clone`
`checkpoints-clone-torch/`. Refused (`NotImplementedError`):
`--pretrained` and `--tokenizer bpe` (ROADMAP queue A, item 4), and the
training options `core/config.py:refuse_unported_training` names.

`tune` searches the GGNN kernel layouts (fold and mxu scatter, fp32,
bf16 and int8 policies, per step and fused) at the serving budgets on
the card and writes the winner, with every candidate's time and
numerics verdict, into a hardware-keyed `tuned.json`
(`<storage>/tuned.json` or `tune.path`); with `tune.enabled=true`,
`train` and `train-combined` fold the record matching this card into
their config first and print `[tune] {"matched", "overrides"}`.
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
COMBINED_CHECKPOINTS_DIR = "checkpoints-combined-torch"
#: rows of a fixed (unbucketed) combined batch: the LineVul recipe's 16
FIXED_ROWS = 16


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
    cfg = config_mod.apply_overrides(cfg, args.overrides)
    config_mod.validate(cfg)
    return cfg


def _load_run_config(args) -> Config:
    """The run's saved config.json when no --config is given, so model
    and data dims match the checkpoint; overrides apply on top."""
    cfg = _load_config(args)
    if args.config is None:
        saved = runs_dir(cfg.run_name) / "config.json"
        if saved.exists():
            cfg = config_mod.apply_overrides(config_mod.load(saved), args.overrides)
            config_mod.validate(cfg)
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


def _apply_tuned(cfg: Config, device) -> Config:
    """Under tune.enabled, fold the tuned.json record matching this
    card and the data.batch budgets into the config (the reference's
    `_apply_tuned`): the winning kernel layout and fitted seq-bucket
    edges; printed as `[tune] ...`. A mismatch or a missing file falls
    back to the config as it is, loudly (tune/cache.py)."""
    if not cfg.tune.enabled:
        return cfg
    from deepdfa_tpu_torch.tune import cache as tune_cache

    cfg, report = tune_cache.apply_to_config(cfg, device=device)
    print("[tune] " + json.dumps(report), flush=True)
    return cfg


def cmd_train(args) -> None:
    from deepdfa_tpu_torch.train import GraphTrainer, positive_weight

    cfg = _apply_tuned(_load_config(args), args.device)
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


def combined_setup(args, cfg: Config):
    """(tokenizer, model config) of `train-combined` (the reference's
    `_combined_setup`): a CombinedConfig for `--arch roberta`, a
    DefectConfig for `--arch t5`; the options the port does not run raise
    NotImplementedError."""
    import dataclasses

    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import CombinedConfig, DefectConfig, T5Config, TransformerConfig

    refused = {
        "--tokenizer (BPE: no vocabulary in the repository)": args.tokenizer is not None,
        "--pretrained (no CodeBERT or CodeT5 weights in the repository)":
            args.pretrained is not None,
        "--sp-variant ulysses (multi-device slice)": args.sp_variant != "ring",
        "--remat-policy attn_saved (ROADMAP queue A, item 4)": args.remat_policy != "full",
    }
    for what, asked in refused.items():
        if asked:
            raise NotImplementedError(f"train-combined {what} is not ported yet")
    widths = {"roberta": ("tiny", "codebert-base"), "t5": ("tiny", "codet5-base")}[args.arch]
    if args.encoder not in widths:
        raise SystemExit(f"--encoder {args.encoder} is not valid for --arch {args.arch} "
                         f"(choose from {widths})")
    kw = dict(attn_impl=args.attn_impl, remat_policy=args.remat_policy)
    graph = dict(graph_hidden_dim=cfg.model.hidden_dim, graph_input_dim=cfg.data.feat.input_dim,
                 use_graph=not args.no_graph)
    if args.arch == "t5":
        tok = HashTokenizer(vocab_size=4096, t5_frame=True)
        enc_cfg = (T5Config(dtype="bfloat16", **kw) if args.encoder == "codet5-base"
                   else T5Config.tiny(vocab_size=tok.vocab_size, **kw))
        # the relative bias has no positional capacity of its own: bound T
        # by the recipe's max_length, as the reference's CLI does
        enc_cfg = dataclasses.replace(enc_cfg, max_sequence_length=args.max_length)
        return tok, DefectConfig(encoder=enc_cfg, **graph)
    tok = HashTokenizer(vocab_size=4096)
    if args.encoder == "codebert-base":
        enc_cfg = TransformerConfig(dtype="bfloat16", **kw)
    else:
        enc_cfg = TransformerConfig.tiny(vocab_size=tok.vocab_size,
                                         max_position_embeddings=args.max_length + 4, **kw)
    return tok, CombinedConfig(encoder=enc_cfg, **graph)


def cmd_train_combined(args) -> None:
    from deepdfa_tpu_torch.data import (
        bucketed_collate_batches,
        collate,
        lengths_for,
        load_examples,
        plan_bucketed_batches,
    )
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.train import CheckpointManager, CombinedTrainer, undersample_epoch

    cfg = _apply_tuned(_load_config(args), args.device)
    if cfg.data.gtype != "cfg":
        raise SystemExit(f"train-combined supports data.gtype=cfg only (got {cfg.data.gtype!r})")
    tok, mcfg = combined_setup(args, cfg)
    out_dir = processed_dir(cfg.data.dataset)
    run_dir = runs_dir(cfg.run_name)
    config_mod.to_json(cfg, run_dir / "config.json")
    examples = load_examples(out_dir / "examples.pkl")
    splits = json.loads((out_dir / "splits.json").read_text())
    graphs_by_id = {} if args.no_graph else GraphStore(out_dir / graphs_dirname(cfg)).load_all()

    by_id = {e.id: e for e in examples}
    used = {int(k) for k, v in splits.items() if v in ("train", "val") and int(k) in by_id}
    token_ids = {e.id: tok.encode(e.code, max_length=args.max_length)
                 for e in examples if e.id in used}
    labels = {e.id: int(e.label or 0) for e in examples if e.id in used}
    bcfg = cfg.data.batch
    buckets = tuple(int(b) for b in cfg.data.seq_buckets)
    lengths_by_id: dict[int, int] = {}
    if buckets:
        if buckets[-1] != args.max_length:
            raise SystemExit(
                f"data.seq_buckets largest edge {buckets[-1]} != --max-length "
                f"{args.max_length}: the largest bucket must equal the tokenizer frame"
            )
        order = sorted(token_ids)
        lengths_by_id = dict(zip(order, lengths_for(token_ids, order, tok.pad_id)))

    def split_ids(name):
        return [int(k) for k, v in splits.items() if v == name and int(k) in by_id]

    train_ids = split_ids("train")
    train_labels = np.array([labels[i] for i in train_ids])

    def epoch_ids(epoch):
        if cfg.data.undersample and len(train_ids):
            return [train_ids[i] for i in undersample_epoch(train_labels, epoch,
                                                            seed=cfg.data.seed)]
        return list(train_ids)

    def plan_count(ids):
        return max(1, sum(1 for _ in plan_bucketed_batches(
            [lengths_by_id[i] for i in ids], ids, buckets, cfg.data.token_budget, 1,
            bcfg.node_budget, bcfg.edge_budget)))

    n_epochs = max(1, cfg.train.max_epochs)
    # the warmup/decay schedule spans the steps the run really takes
    if buckets and cfg.data.undersample:  # each epoch's selection buckets its own way
        total_steps = sum(plan_count(epoch_ids(e)) for e in range(n_epochs))
    elif buckets:
        total_steps = plan_count(epoch_ids(0)) * n_epochs
    else:
        total_steps = max(1, -(-len(epoch_ids(0)) // FIXED_ROWS)) * n_epochs
    trainer = CombinedTrainer(cfg, mcfg, total_steps=total_steps,
                              freeze_graph=args.freeze_graph, device=args.device)

    def batches(ids):
        ids = list(ids)
        if buckets:
            return bucketed_collate_batches(
                token_ids, labels, ids, graphs_by_id, buckets, cfg.data.token_budget, 1,
                bcfg.node_budget, bcfg.edge_budget, pad_id=tok.pad_id,
                lengths=[lengths_by_id[i] for i in ids])
        return [collate(np.stack([token_ids[i] for i in ids[k:k + FIXED_ROWS]]),
                        [labels[i] for i in ids[k:k + FIXED_ROWS]], ids[k:k + FIXED_ROWS],
                        graphs_by_id, FIXED_ROWS, bcfg.node_budget, bcfg.edge_budget,
                        pad_id=tok.pad_id)
                for k in range(0, len(ids), FIXED_ROWS)]

    state = trainer.init_state()
    if args.graph_checkpoint:
        ckpt_dir = Path(args.graph_checkpoint)
        if not ckpt_dir.exists():
            ckpt_dir = runs_dir(args.graph_checkpoint) / CHECKPOINTS_DIR
        state = trainer.load_graph_encoder_params(
            state, CheckpointManager(ckpt_dir).restore("best")["model"])
        print(f"loaded graph encoder from {ckpt_dir}"
              + (" (frozen)" if args.freeze_graph else ""))
    ckpts = trainer.make_checkpoints(run_dir / COMBINED_CHECKPOINTS_DIR)
    run_log = RunLog(run_dir)
    try:
        trainer.fit(state, lambda epoch: batches(epoch_ids(epoch)),
                    val_batches=lambda: batches(split_ids("val")), checkpoints=ckpts,
                    log_fn=run_log.log)
    finally:
        run_log.close()
    print("best:", ckpts.best_metrics())


# -- the generation family -------------------------------------------------


GEN_CHECKPOINTS_DIR = "checkpoints-gen-torch"
GEN_BLEU_CHECKPOINTS_DIR = "checkpoints-gen-bleu-torch"
CLONE_CHECKPOINTS_DIR = "checkpoints-clone-torch"


def _gen_tokenizer_and_encoder(args):
    """(tokenizer, T5Config) of the generation commands: the T5-framed
    hash tokenizer at --vocab-size and the tiny or codet5-base config
    (fp32 activations, the reference's default); --pretrained and
    --tokenizer bpe raise NotImplementedError."""
    from deepdfa_tpu_torch.data.tokenizer import HashTokenizer
    from deepdfa_tpu_torch.models import T5Config

    if args.tokenizer == "bpe":
        raise NotImplementedError(
            f"{args.cmd} --tokenizer bpe is not ported yet: the port has no BpeTokenizer "
            "(ROADMAP queue A, item 4)")
    if args.pretrained is not None:
        raise NotImplementedError(
            f"{args.cmd} --pretrained is not ported yet: the port has no "
            "gen_params_from_hf_torch (ROADMAP queue A, item 4)")
    tok = HashTokenizer(vocab_size=args.vocab_size, t5_frame=True)
    kw = dict(vocab_size=tok.vocab_size, pad_token_id=tok.pad_id, eos_token_id=tok.sep_id)
    return tok, (T5Config.tiny(**kw) if args.tiny else T5Config(**kw))


def _gen_setup(args, cfg: Config, total_steps: int | None = None):
    """(tokenizer, GenConfig, GenTrainer, fresh state, rows per batch) of
    `train-gen` and `train-multi-gen` (the reference's `_gen_setup`)."""
    from deepdfa_tpu_torch.models import GenConfig
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    tok, enc_cfg = _gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=enc_cfg, max_target_length=args.max_target_length,
                     beam_size=args.beam_size)
    config_mod.one_card(cfg.train.mesh)
    trainer = GenTrainer(cfg, gcfg, total_steps=total_steps, device=args.device)
    return tok, gcfg, trainer, trainer.init_state(), max(1, args.batch_size)


def _gen_encode_file(args, tok, task_name: str, filename: str,
                     max_target_length: int | None = None):
    """(examples, source ids, target ids) of one task file, the sources
    prefixed "<family>: " as the reference's `_utils.py:24-29` does."""
    from deepdfa_tpu_torch.data import gen_data

    family = task_name.split("_")[0]
    if family not in gen_data.READERS:
        raise SystemExit(f"unknown task family {family!r} (task {task_name!r}); "
                         f"known: {sorted(gen_data.READERS)}")
    ex = gen_data.READERS[family](filename, args.data_num)
    src = tok.batch_encode([f"{family}: {e.source}" for e in ex],
                           max_length=args.max_source_length)
    tgt = tok.batch_encode([e.target for e in ex],
                           max_length=max_target_length or args.max_target_length)
    return ex, src.astype(np.int32), tgt.astype(np.int32)


def cmd_train_gen(args) -> None:
    """Seq2seq training and test decoding (CodeT5's run_gen.py)."""
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.models import t5_gen as genm

    cfg = _load_config(args)
    run_dir = runs_dir(cfg.run_name)
    total_steps = 1  # an eval-only run steps nothing
    if args.train_file:
        family = args.task.split("_")[0]
        n_train = len(gen_data.READERS[family](args.train_file, args.data_num))
        total_steps = max(1, -(-n_train // max(1, args.batch_size))) * max(1, cfg.train.max_epochs)
    tok, gcfg, trainer, state, rows = _gen_setup(args, cfg, total_steps=total_steps)

    def load(filename):
        return _gen_encode_file(args, tok, args.task, filename)

    if args.train_file:
        config_mod.to_json(cfg, run_dir / "config.json")
        _, train_src, train_tgt = load(args.train_file)
        dev = load(args.dev_file) if args.dev_file else None
        val_batches = val_decode = None
        if dev is not None:
            dev_batches = gen_data.batches_of(dev[1], dev[2], 1, rows, pad_id=tok.pad_id)
            val_batches = lambda: dev_batches  # noqa: E731
            if args.do_eval_bleu:
                val_decode = (dev[1], genm.trim_at_eos(dev[2], tok.sep_id, tok.pad_id))
        ckpts = trainer.make_checkpoints(run_dir / GEN_CHECKPOINTS_DIR)
        bleu_ckpts = (trainer.make_checkpoints(run_dir / GEN_BLEU_CHECKPOINTS_DIR,
                                               monitor="val_bleu_em", mode="max")
                      if args.do_eval_bleu else None)
        run_log = RunLog(run_dir)
        try:
            state = trainer.fit(
                state,
                lambda epoch: gen_data.batches_of(train_src, train_tgt, 1, rows,
                                                  pad_id=tok.pad_id,
                                                  shuffle_seed=cfg.train.seed + epoch),
                val_batches=val_batches, val_decode=val_decode, checkpoints=ckpts,
                bleu_checkpoints=bleu_ckpts, patience=args.patience, log_fn=run_log.log)
        finally:
            run_log.close()
        print("best:", ckpts.best_metrics())

    if args.test_file:
        ex, test_src, test_tgt = load(args.test_file)
        # decode from the best-ppl weights, not the last epoch's (run_gen.py
        # reloads checkpoint-best-ppl before test decoding)
        if (run_dir / GEN_CHECKPOINTS_DIR / "best").exists():
            best = trainer.make_checkpoints(run_dir / GEN_CHECKPOINTS_DIR).restore("best")
            state = trainer.load_params(state, best["model"])
        refs = genm.trim_at_eos(test_tgt, tok.sep_id, tok.pad_id)
        scores = trainer.eval_bleu_em(state, test_src, refs, return_preds=True)
        preds = scores.pop("preds")
        res_dir = run_dir / "results"
        res_dir.mkdir(parents=True, exist_ok=True)
        with (res_dir / "test_best-ppl.output").open("w") as f_out, (
            res_dir / "test_best-ppl.gold"
        ).open("w") as f_gold:
            for e, pr, r in zip(ex, preds, refs):
                f_out.write(f"{e.idx}\t{' '.join(map(str, pr))}\n")
                f_gold.write(f"{e.idx}\t{' '.join(map(str, r))}\n")
        print(json.dumps({"test_em": scores["em"], "test_bleu": scores["bleu"]}))


def cmd_train_multi_gen(args) -> None:
    """Multi-task generation training (CodeT5's run_multi_gen.py):
    --task-spec name=train_file[:dev_file], repeatable; the name's family
    picks the reader, the patience and the target length."""
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.models import t5_gen as genm
    from deepdfa_tpu_torch.train.multi_gen import GenTask, fit_multi, task_target_length

    cfg = _load_config(args)
    run_dir = runs_dir(cfg.run_name)
    specs: list[tuple[str, str, str | None]] = []
    for spec in args.task_spec:
        name, _, files = spec.partition("=")
        if not files:
            raise SystemExit(f"--task-spec {spec!r}: expected name=train[:dev]")
        if name.split("_")[0] not in gen_data.READERS:
            raise SystemExit(f"--task-spec {spec!r}: unknown task family "
                             f"{name.split('_')[0]!r}; known: {sorted(gen_data.READERS)}")
        train_file, _, dev_file = files.partition(":")
        specs.append((name, train_file, dev_file or None))
    tok, gcfg, trainer, state, rows = _gen_setup(args, cfg, total_steps=max(1, args.max_steps))

    def load(name, filename):
        _, src, tgt = _gen_encode_file(
            args, tok, name, filename,
            max_target_length=min(args.max_target_length, task_target_length(name)))
        return src, tgt

    tasks = []
    for name, train_file, dev_file in specs:
        src, tgt = load(name, train_file)

        def factory(epoch, _src=src, _tgt=tgt):
            return gen_data.batches_of(_src, _tgt, 1, rows, pad_id=tok.pad_id,
                                       shuffle_seed=cfg.train.seed + epoch)

        val_batches = val_decode = None
        if dev_file:
            dsrc, dtgt = load(name, dev_file)
            dev = gen_data.batches_of(dsrc, dtgt, 1, rows, pad_id=tok.pad_id)
            val_batches = lambda _dev=dev: _dev  # noqa: E731
            if args.do_eval_bleu:
                val_decode = (dsrc, genm.trim_at_eos(dtgt, tok.sep_id, tok.pad_id))
        tasks.append(GenTask(name, factory, size=src.shape[0], val_batches=val_batches,
                             val_decode=val_decode))

    def checkpoints(task_name, monitor, mode):
        return trainer.make_checkpoints(run_dir / f"checkpoints-multi-{task_name}-torch",
                                        monitor=monitor, mode=mode)

    config_mod.to_json(cfg, run_dir / "config.json")
    run_log = RunLog(run_dir)
    try:
        state, summary = fit_multi(trainer, state, tasks, max_steps=args.max_steps,
                                   eval_every=args.eval_every, checkpoints=checkpoints,
                                   seed=cfg.train.seed, log_fn=run_log.log)
    finally:
        run_log.close()
    print(json.dumps({"tasks": summary}, default=float))


def cmd_train_clone(args) -> None:
    """Pairwise clone-detection training (CodeT5's run_clone.py): best-F1
    checkpoints and test precision / recall / F1."""
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.models import CloneConfig
    from deepdfa_tpu_torch.train.clone_loop import CloneTrainer, clone_batches_of

    cfg = _load_config(args)
    run_dir = runs_dir(cfg.run_name)
    tok, enc_cfg = _gen_tokenizer_and_encoder(args)
    ccfg = CloneConfig(encoder=enc_cfg)

    def load(filename):
        ex = gen_data.read_clone_examples(filename, args.data_num)
        a = tok.batch_encode([f"clone: {e.source}" for e in ex],
                             max_length=args.max_source_length)
        b = tok.batch_encode([f"clone: {e.target}" for e in ex],
                             max_length=args.max_source_length)
        return ex, np.stack([a, b], axis=1).astype(np.int32), np.array(
            [e.label for e in ex], np.int32)

    config_mod.one_card(cfg.train.mesh)
    rows = max(1, args.batch_size)
    total_steps = 1
    if args.train_file:
        n_train = len(gen_data.read_clone_examples(args.train_file, args.data_num))
        total_steps = max(1, -(-n_train // rows)) * max(1, cfg.train.max_epochs)
    trainer = CloneTrainer(cfg, ccfg, total_steps=total_steps, device=args.device)
    state = trainer.init_state()
    ckpt_dir = run_dir / CLONE_CHECKPOINTS_DIR
    if args.train_file:
        config_mod.to_json(cfg, run_dir / "config.json")
        _, train_pairs, train_labels = load(args.train_file)
        val_batches = None
        if args.dev_file:
            _, dev_pairs, dev_labels = load(args.dev_file)
            dev = clone_batches_of(dev_pairs, dev_labels, 1, rows, pad_id=tok.pad_id)
            val_batches = lambda: dev  # noqa: E731
        ckpts = trainer.make_checkpoints(ckpt_dir)
        run_log = RunLog(run_dir)
        try:
            state = trainer.fit(
                state,
                lambda epoch: clone_batches_of(train_pairs, train_labels, 1, rows,
                                               pad_id=tok.pad_id,
                                               shuffle_seed=cfg.train.seed + epoch),
                val_batches=val_batches, checkpoints=ckpts, patience=args.patience,
                log_fn=run_log.log)
        finally:
            run_log.close()
        print("best:", ckpts.best_metrics())

    if args.test_file:
        _, test_pairs, test_labels = load(args.test_file)
        if (ckpt_dir / "best").exists():
            best = trainer.make_checkpoints(ckpt_dir).restore("best")
            state = trainer.load_params(state, best["model"])
        metrics, _ = trainer.evaluate(
            state, clone_batches_of(test_pairs, test_labels, 1, rows, pad_id=tok.pad_id))
        print(json.dumps({f"test_{k}": v for k, v in metrics.items()}))


def cmd_tune(args) -> None:
    """The offline autotuner (the reference's `cmd_tune`): time every
    card-legal GGNN kernel layout under the numerics contract, fit the
    serve rungs and seq-bucket edges to observed sizes, and write a
    hardware-keyed tuned.json. `--smoke` is the reference's acceptance
    drive (reduced candidates, synthetic skewed distributions): it fails
    unless a real search picked a winner, the fitted ladder beats pow2
    and the record is valid."""
    from deepdfa_tpu_torch.tune import cache as tune_cache
    from deepdfa_tpu_torch.tune import driver as tune_driver

    if args.smoke:
        report = tune_driver.run_tune_smoke(out_path=args.out, device=args.device)
        print(json.dumps(report), flush=True)
        if (not report["valid"] or report["winner"] is None or report["candidates_timed"] == 0
                or not report["tuned_ladder_padding_waste"] < report["pow2_ladder_padding_waste"]
                or not (report["seq_bucket_padding_waste"]
                        <= report["seq_bucket_pow2_padding_waste"])):
            raise SystemExit("tune smoke contract violated (see report)")
        return
    cfg = _load_run_config(args)
    report = tune_driver.run_tune(cfg, serve_logs=args.serve_log, manifest=args.manifest,
                                  out_path=args.out, skip_kernel=args.skip_kernel,
                                  device=args.device)
    if not report["valid"]:
        raise SystemExit("tuned.json failed validation: " + "; ".join(report["problems"]))
    verdict = tune_cache.validate_tuned_file(report["tuned_path"])
    if not verdict["ok"]:
        raise SystemExit("tuned.json on disk failed validation: "
                         + "; ".join(verdict["problems"]))


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

    p = sub.add_parser("train-combined")
    p.add_argument("--arch", default="roberta", choices=["roberta", "t5"],
                   help="roberta (LineVul style) or t5 (CodeT5 DefectModel style)")
    p.add_argument("--encoder", default="tiny",
                   help="tiny | codebert-base (roberta) | codet5-base (t5)")
    p.add_argument("--pretrained", default=None,
                   help="a torch state_dict for the encoder (not ported yet)")
    p.add_argument("--tokenizer", default=None,
                   help="dir with vocab.json + merges.txt (not ported yet; default: hash)")
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--sp-variant", default="ring", choices=["ring", "ulysses"])
    p.add_argument("--attn-impl", default="auto", choices=["auto", "xla", "flash"],
                   help="encoder attention: auto/flash = the flash kernels on the card")
    p.add_argument("--remat-policy", default="full", choices=["full", "attn_saved"])
    p.add_argument("--no-graph", action="store_true")
    p.add_argument("--graph-checkpoint", default=None,
                   help="run name or checkpoints dir of a trained port DeepDFA "
                        f"({CHECKPOINTS_DIR}) to load into the graph branch")
    p.add_argument("--freeze-graph", action="store_true",
                   help="freeze the loaded graph encoder (reference --freeze_graph)")
    common(p)
    p.set_defaults(fn=cmd_train_combined)

    def gen_model_args(p):
        p.add_argument("--tiny", action="store_true", help="tiny T5 config (tests, smoke)")
        p.add_argument("--tokenizer", choices=("hash", "bpe"), default="hash",
                       help="hash (default); bpe is not ported yet")
        p.add_argument("--vocab-size", type=int, default=4096)
        p.add_argument("--vocab-file", default=None)
        p.add_argument("--merges-file", default=None)
        p.add_argument("--pretrained", default=None,
                       help="HF torch T5ForConditionalGeneration state_dict (not ported yet)")

    p = sub.add_parser("train-gen")
    p.add_argument("--task", required=True,
                   choices=sorted(("summarize", "translate", "refine", "concode", "defect")))
    p.add_argument("--train-file", default=None)
    p.add_argument("--dev-file", default=None)
    p.add_argument("--test-file", default=None)
    p.add_argument("--data-num", type=int, default=-1)
    p.add_argument("--max-source-length", type=int, default=256)
    p.add_argument("--max-target-length", type=int, default=128)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patience", type=int, default=2)
    p.add_argument("--do-eval-bleu", action="store_true")
    gen_model_args(p)
    common(p)
    p.set_defaults(fn=cmd_train_gen)

    p = sub.add_parser("train-multi-gen")
    p.add_argument("--task-spec", action="append", required=True,
                   help="name=train_file[:dev_file]; the name's <family>_* prefix picks "
                        "reader, patience and target length (repeatable)")
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--data-num", type=int, default=-1)
    p.add_argument("--max-source-length", type=int, default=256)
    p.add_argument("--max-target-length", type=int, default=128)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--do-eval-bleu", action="store_true")
    gen_model_args(p)
    common(p)
    p.set_defaults(fn=cmd_train_multi_gen)

    p = sub.add_parser("train-clone")
    p.add_argument("--train-file", default=None)
    p.add_argument("--dev-file", default=None)
    p.add_argument("--test-file", default=None)
    p.add_argument("--data-num", type=int, default=-1)
    p.add_argument("--max-source-length", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patience", type=int, default=2)
    gen_model_args(p)
    common(p)
    p.set_defaults(fn=cmd_train_clone)

    p = sub.add_parser("tune", help="offline autotuner: GGNN kernel layouts and batch "
                                    "ladders fitted to observed traffic, in tuned.json")
    p.add_argument("--serve-log", action="append", default=[], metavar="PATH",
                   help="serve log (request entries with batch_size) to replay the observed "
                        "batch sizes from (repeatable)")
    p.add_argument("--manifest", default=None, metavar="PATH",
                   help="token lengths (JSON array, or JSONL with a length/tokens field) for "
                        "the seq-bucket fit")
    p.add_argument("--out", default=None,
                   help="tuned.json path (default tune.path, else <storage>/tuned.json)")
    p.add_argument("--skip-kernel", action="store_true",
                   help="ladder fits only (no kernel search)")
    p.add_argument("--smoke", action="store_true",
                   help="acceptance drive: the reference's reduced search and synthetic "
                        "distributions; asserts a winner, fit-beats-pow2 and a valid file")
    p.add_argument("--config", default=None, help="json config file")
    p.add_argument("--override", action="append", default=[], dest="overrides",
                   help="dotted key=value config override (repeatable)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain PyTorch path)")
    p.set_defaults(fn=cmd_tune)
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
