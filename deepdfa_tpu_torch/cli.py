"""Command line of the port: prepare a dataset and extract its graphs
from C sources, train and test the DeepDFA GGNN, train the
combined DeepDFA+LineVul and CodeT5+DeepDFA models, and train and decode
the CodeT5 generation family, on one device (the reference's
`deepdfa-tpu prepare`, `extract-vocab`, `extract`, `train`, `test`,
`train-combined`, `train-gen`, `train-multi-gen`, `train-clone` and
`tune`, `deepdfa_tpu/cli/main.py:cmd_prepare`, `cmd_extract_vocab`,
`cmd_extract`, `cmd_train`, `cmd_test`, `cmd_train_combined`,
`cmd_train_gen`, `cmd_train_multi_gen`, `cmd_train_clone` and
`cmd_tune`), tune the GGNN kernel layout on the card, score and serve C
sources against a trained run (`score`, `serve`: `cmd_score`,
`cmd_serve`), scan a whole repository (`scan`: `cmd_scan`), fit the
two-stage cascade's calibration (`cascade-calibrate`:
`cmd_cascade_calibrate`), rank the lines of a combined run's
functions by their attributions (`localize`: `cmd_localize`), score
generated code with CodeBLEU (`codebleu`: `cmd_codebleu`), audit a
store's abstract-dataflow coverage (`coverage`: `cmd_coverage`), dump
IVDetect's per-line features (`ivdetect`: `cmd_ivdetect`) and run a
task x seed matrix of these commands (`run-exp`: `cmd_run_exp`).

    python -m deepdfa_tpu_torch.cli prepare --source synthetic|CSV|JSON [--n-examples N] \
        [--synthetic-v2] [--format F] [--splits CSV | --cross-project] [--dep-closure] \
        [--sample N] [--mutated-jsonl F [--mutated-flip]] [--export-codet5] [key=value ...]
    python -m deepdfa_tpu_torch.cli extract-vocab [--workers N] [key=value ...]
    python -m deepdfa_tpu_torch.cli extract [--workers N] [--num-shards K --shard I] \
        [--vocab-from VOCAB_JSON] [key=value ...]
    python -m deepdfa_tpu_torch.cli train --config configs/bigvul_deepdfa.json [key=value ...]
    python -m deepdfa_tpu_torch.cli test --checkpoint best --split test [--export]
    python -m deepdfa_tpu_torch.cli train-combined --config configs/bigvul_combined.json \
        [--arch roberta|t5] --encoder codebert-base|codet5-base|tiny [--tokenizer DIR] \
        [--pretrained STATE_DICT] [--remat-policy full|attn_saved] \
        [--graph-checkpoint RUN [--freeze-graph]] [key=value ...]
    python -m deepdfa_tpu_torch.cli train-gen --task summarize --train-file F \
        [--dev-file F] [--test-file F] [--do-eval-bleu] [--tiny] \
        [--tokenizer bpe --vocab-file F --merges-file F] [--pretrained STATE_DICT] \
        [--remat-policy full|attn_saved] [key=value ...]
    python -m deepdfa_tpu_torch.cli train-multi-gen --task-spec NAME=TRAIN[:DEV] ...
    python -m deepdfa_tpu_torch.cli train-clone --train-file F [--dev-file F] [--test-file F]
    python -m deepdfa_tpu_torch.cli tune [--smoke] [--out F] [--serve-log F] [--manifest F] \
        [--skip-kernel] [--config F] [--override key=value ...] [--device cpu]
    python -m deepdfa_tpu_torch.cli score SRC... [--family deepdfa|combined|t5] [--out F] \
        [--smoke] [--config F] [--override key=value ...] [--device cpu]
    python -m deepdfa_tpu_torch.cli scan REPO [--out F] [--sarif F] [--lines] \
        [--no-incremental] [--smoke] [--family deepdfa] [--config F] [--override k=v ...] \
        [--device cpu]
    python -m deepdfa_tpu_torch.cli serve [--host H] [--port P] [--family F] [--smoke] \
        [--config F] [--override key=value ...] [--device cpu]
    python -m deepdfa_tpu_torch.cli cascade-calibrate --scores F [--prob-key prob] \
        [--label-key label] [--target-escalation 0.3] [--out F]
    python -m deepdfa_tpu_torch.cli localize [--arch roberta|t5] [--no-graph] \
        [--method saliency|attention|input_x_gradient|lig|deeplift|deeplift_shap|gradient_shap] \
        [--checkpoint best] [--split test] [--encoder tiny|codebert-base|codet5-base] \
        [--tokenizer DIR] [--max-length 512] [--limit N] [--device cpu] [key=value ...]
    python -m deepdfa_tpu_torch.cli codebleu --refs F [F ...] --hyp F \
        [--lang c|cpp|java|c_sharp|javascript|php|go|ruby|python] [--params a,b,g,t]
    python -m deepdfa_tpu_torch.cli coverage [--config F] [key=value ...]
    python -m deepdfa_tpu_torch.cli ivdetect SRC... [--out-dir D]
    python -m deepdfa_tpu_torch.cli run-exp (--matrix F | --tasks T... [--seeds N...]) \
        [--extra-arg=FLAG ...] [--override key=value ...] [--tag TAG] [--dry-run]

`prepare`, `extract-vocab` and `extract` are host commands (no
`--device`). `prepare` reads a dataset (the seeded synthetic corpus, a
Big-Vul csv, a Devign json, a DbgBench csv) and writes
`processed/<dataset>/examples.pkl` (the port's `Example` rows),
`splits.json` and, with `--export-codet5`, `codet5/{train,valid,test}.jsonl`
under the storage root (`$DEEPDFA_TPU_STORAGE`, else `storage/` at the
repo root). `extract` parses every function with the port's C frontend
and writes the graph store `processed/<dataset>/graphs<feat
name>[_gtype_<gtype>]/`, its `missing_ids[-<tag>].txt` and
`vocab<feat name>.json`; `--workers` fans extraction out over forked
processes. Sharded extraction builds the train split's vocabularies once
(`extract-vocab`), then each `extract --num-shards K --shard I` encodes
every K-th example against them into `graphs-shard<I>-*.npz`. The
outputs equal the reference's commands' (the stores member for member).
`data.feat.struct_feats=true` appends the five structural channels
(frontend/structfeat.py) to every node's features; a run trained on such
a store sets `model.struct_feats=true` (its GGNN then runs at 9 x
`model.hidden_dim`). `data.feat.max_defs=N` attaches the reaching-
definitions bit labels of N definition sites (the store directory takes
`_maxdefs_N`); a run trained on such a store may set
`model.label_style=dataflow_solution_in` or `_out`, whose `test` scores
every node's bits (and refuses `--export`, which writes one row a
function). The other commands read that layout, and the reference's outputs
the same way: `splits.json`, the graph store and, for `train-combined`,
`examples.pkl`. A run writes
`runs/<run_name>/config.json`, `train_log.jsonl` and torch checkpoints
under `runs/<run_name>/checkpoints-torch/` (GGNN) or
`checkpoints-combined-torch/` (combined); the reference's orbax
checkpoints of the same run stay untouched. The card is the default
device; `--device cpu` runs the plain path.

The runtime hooks (`train`, `train-combined`, `train-gen`):
`train.resilience.enabled=true` runs the resilient runtime
(train/resilience.py: the on-device divergence guard, step checkpoints
every `train.resilience.step_checkpoint_every` steps under
`runs/<run>/checkpoints-torch-step/`, `checkpoints-combined-torch-step/`
or `checkpoints-gen-torch-step/`, resume on the next run of the same
command, rollback, the watchdog); a preempted run (SIGTERM) checkpoints
and exits 143, a watchdog abort exits 113. `DEEPDFA_FAULTS` (e.g.
`"nan@3,sigterm@6"`, testing/faults.py) injects faults into the train
stream. The `obs.*` switches (obs/) open a telemetry session for the
run (also for `score` and `serve`): trace spans, the metrics snapshot,
`torch.profiler` captures, the efficiency ledger (`obs.ledger`, with
measured ceilings under `obs.ledger_ceilings`) and the flight recorder.
`train.debug_nans` and `train.enable_checks` run the sanitizers
(core/sanitize.py) in every training command. `test --profile` prints
Table 5's record (GFLOPs and ms a call and an example, p95) of the first
batch's forward and appends it to `profiledata.jsonl`; `--xprof-dir D`
writes a `torch.profiler` Chrome trace of the evaluation to
`D/trace.json`.

`train-combined` takes the reference's arguments. `--arch t5` builds
the CodeT5+DeepDFA defect model (`--encoder tiny|codet5-base`, the
T5-framed hash tokenizer, `max_sequence_length = --max-length`), as the
reference does (`cli/main.py:771-815`). `--tokenizer DIR` tokenizes with
the byte-level BPE of DIR's `*vocab.json` + `*merges.txt` (the port
ships one, `data/assets/bpe_c/`; refused with `--arch t5`, as in the
reference); `--pretrained F` loads a Hugging Face torch state_dict
(`RobertaModel`, or `T5EncoderModel`/`T5Model` for t5; weights only)
into the encoder; `--remat-policy attn_saved` keeps the flash kernel's
output across each layer checkpoint. `--sp-variant ulysses` is refused.
Rows are bucketed by `data.seq_buckets` (the largest edge equal to
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
`checkpoints-clone-torch/`. `--tokenizer bpe --vocab-file F
--merges-file F` tokenizes with a byte-level BPE, `--pretrained F` loads
a Hugging Face `T5ForConditionalGeneration` state_dict and
`--remat-policy attn_saved` keeps the attention output across the layer
checkpoints. `train-gen` runs the runtime hooks above; `train-multi-gen`
and `train-clone` run the sanitizers and refuse (`NotImplementedError`)
`train.resilience.enabled` and the `obs` switches, which the reference's
loops do not run either (`core/config.py:refuse_unported_training`).

Every training command appends its records to
`runs/<run>/train_log.jsonl` through train/logging.py:RunLogger; `train`
also mirrors them into TensorBoard event files under `runs/<run>/tb/`
where `torch.utils.tensorboard` imports, as the reference's `cmd_train`.
Under an NNI experiment (`NNI_PLATFORM` set, the `nni` package
importable) the trial's parameters override the config, each validation epoch reports `train.monitor` and the best
checkpoint's value is the final report (train/nni_bridge.py); otherwise
the hooks do nothing. `run-exp` expands `--tasks` x `--seeds` with each
task's defaults (train/experiments.py:TASK_DEFAULTS), runs each as a
`python -m deepdfa_tpu_torch.cli` subprocess that inherits this
process's environment, and writes each run's log, its parsed last
result line and its exit code to `runs/experiments/<tag>/` (one row a
run in `summary.jsonl`). `coverage` prints each split's definition-node
and known-hash counts over the graph store; `ivdetect` writes
`<stem>.ivdetect.json` beside each source (or in `--out-dir`).

`codebleu --refs F [F ...] --hyp F --lang L` prints CodeBLEU's n-gram,
weighted n-gram, syntax and dataflow matches and their composite
(`--params`) as JSON, for c, cpp, java, c_sharp, javascript, php, go,
ruby and python (eval/codebleu.py).

`tune` searches the GGNN kernel layouts (fold and mxu scatter, fp32,
bf16 and int8 policies, per step and fused) at the serving budgets on
the card and writes the winner, with every candidate's time and
numerics verdict, into a hardware-keyed `tuned.json`
(`<storage>/tuned.json` or `tune.path`); with `tune.enabled=true`,
`train` and `train-combined` fold the record matching this card into
their config first and print `[tune] {"matched", "overrides"}`.

`score` and `serve` restore `runs/<run_name>/` (`--override
run_name='"..."'`; its saved `config.json` unless `--config` is given)
through `serve/registry.py`: the `serve.checkpoint` tag of
`checkpoints-torch/` (`--family deepdfa`) or, with the run's
`model_cfg.json` that `train-combined` writes, of
`checkpoints-combined-torch/` (`combined`, `t5`), and the run's
vocabulary. `score` writes `scores.jsonl` ({"name", "request_id", "ok",
"prob" | "error"} a source) and prints the summary; `serve` answers
`POST /score` {"code": ...}, `GET /healthz` and `GET /stats` with the
reference's status codes (serve/server.py). `serve.hot_swap=true`
reloads a moved tag between batches. `serve.cascade=true` (with
`serve.cascade_band`, `cascade_temperature`, `cascade_run_dir`, ...)
scores every source with the GGNN and escalates the calibrated
uncertainty band to a combined or t5 run (serve/cascade.py); the fit
comes from `cascade-calibrate` over `score` rows joined with labels.
`serve.lines=true` (with `serve.lines_method`, `lines_steps`,
`lines_top_k`) also answers {"code": ..., "lines": true} with the GGNN's
ranked line attributions. `serve.pipeline_depth=N` keeps up to N
batches dispatched and not yet fetched (the same bits as 0), and a
`serve.checkpoint` tag with the suffix `@int8` serves the quantized
entry within `serve.quant_drift_bound` (serve/quant.py).
`serve.use_joern=true` extracts every function through a pool of
`serve.joern_pool_size` Joern sessions (`serve.joern_timeout_s` a
command) instead of the built-in parser; it needs a `joern` binary on
PATH and raises without one (serve/frontend.py).

`scan REPO` scores every C/C++ function of a repository with a GGNN
run through the same registry, frontend and batcher (`scan.*`: suffixes,
excluded directories, the file-size cap, the SARIF threshold; `--lines`
for line attributions, `--no-incremental` to ignore the manifest) and
writes `runs/<run>/scan/findings.jsonl` and `findings.sarif` (or --out,
--sarif), the manifest under `runs/<run>/scan_state/` and a summary in
`scan_log.jsonl`; a re-scan extracts only changed functions. --smoke
trains a tiny run, scans a synthetic repository cold, edits one
function and scans again.

`localize` restores a `train-combined` run (`--arch`, `--encoder`,
`--tokenizer`, `--no-graph` and `--max-length` as it was trained) from
`checkpoints-combined-torch/`, attributes the vulnerable-class logit to
the tokens of every `--split` function that has labelled lines
(eval/localize.py:token_scores, `--method`), ranks each function's lines
and writes `runs/<run>/localize_<split>_<method>.json` (top-k accuracy,
IFA, effort@20% recall, recall@1% LOC, `n_examples`, `method`) and
`runs/<run>/ifa_records/ifa_<method>.txt`, as the reference does.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import sys
from pathlib import Path

import numpy as np

from deepdfa_tpu_torch.core import config as config_mod
from deepdfa_tpu_torch.core.config import Config
from deepdfa_tpu_torch.core.paths import (
    CHECKPOINTS_DIR,
    COMBINED_CHECKPOINTS_DIR,
    COMBINED_STEP_CHECKPOINTS_DIR,
    STEP_CHECKPOINTS_DIR,
    cache_dir,
    graphs_dirname,
    processed_dir,
    runs_dir,
)

#: rows of a fixed (unbucketed) combined batch: the LineVul recipe's 16
FIXED_ROWS = 16


# -- data ---------------------------------------------------------------------


def load_graph_splits(cfg: Config) -> dict[str, list]:
    from deepdfa_tpu_torch.graphs import GraphStore

    out_dir = processed_dir(cfg.data.dataset)
    splits = json.loads((out_dir / "splits.json").read_text())
    store = GraphStore(out_dir / graphs_dirname(cfg))
    by_id = store.load_all()
    if not by_id:
        raise SystemExit(
            f"no graphs in {store.directory} — run `python -m deepdfa_tpu_torch.cli "
            "extract` with the same data.feat.* / data.gtype settings as this command"
        )
    out = {"train": [], "val": [], "test": []}
    for gid, spec in by_id.items():
        s = splits.get(str(gid))
        if s in out:
            out[s].append(spec)
    return out


class BatchStream:
    """A single-use lazy batch stream whose `source_stage` tells the
    prefetch pipeline where to book its pull time: "pack" for live
    packing, "load" for a warm cache replay."""

    def __init__(self, it, source_stage: str):
        self._it = iter(it)
        self.source_stage = source_stage

    def __iter__(self):
        return self._it


def epoch_batches(cfg: Config, specs, shuffle_epoch: int | None = None,
                  phase: str = "train", lazy: bool = False, source_digest: str | None = None,
                  packer=None):
    """Budget-aware batches for one pass over `specs`: over-budget graphs
    are dropped in training and get their own pow2-budget batches in
    evaluation; with data.undersample, a training epoch draws its 1:1
    selection from (epoch, data.seed).

    The host pipeline's knobs (the reference's `_epoch_batches`):
    `data.pack_workers > 1` packs on a spawn process pool (pass a
    long-lived `packer`, an MpPacker bound to `specs`, to keep one pool
    for every epoch); `data.packed_cache` with a `source_digest` of the
    corpus writes the packed stream through and replays it when the
    content key matches (the selection is a function of epoch and seed,
    which the key covers). `lazy` gives a `BatchStream`."""
    from deepdfa_tpu_torch.graphs import shard_bucket_batches
    from deepdfa_tpu_torch.train import undersample_epoch

    if packer is not None and packer.graphs is not specs:
        raise ValueError("packer must be bound to the same corpus as `specs`: its plans "
                         "index into the corpus it was built with")
    bcfg = cfg.data.batch
    batcher = dict(num_shards=1, num_graphs=bcfg.graphs_per_batch,
                   node_budget=bcfg.node_budget, edge_budget=bcfg.edge_budget,
                   oversized="drop" if phase == "train" else "singleton")
    # per-epoch undersampling is the only reason the stream varies across
    # epochs; without it one cache entry serves every epoch and re-run
    undersampling = bool(shuffle_epoch is not None and cfg.data.undersample)

    def build():
        idx = None
        if undersampling:
            labels = np.array([s.label for s in specs])
            idx = undersample_epoch(labels, shuffle_epoch, seed=cfg.data.seed)
            sel = [specs[i] for i in idx]
        else:
            sel = list(specs)
        stats: dict = {}
        args = {k: v for k, v in batcher.items() if k != "num_shards"}
        if packer is not None:
            it = packer.shard_bucket_batches(stats=stats, select=idx, **args)
        elif cfg.data.pack_workers > 1:
            from deepdfa_tpu_torch.data.mp_pack import mp_shard_bucket_batches

            it = mp_shard_bucket_batches(sel, stats=stats, workers=cfg.data.pack_workers,
                                         **args)
        else:
            it = shard_bucket_batches(sel, stats=stats, **args)
        yield from it
        if stats.get("dropped"):
            print(f"[batch] dropped {stats['dropped']}/{len(sel)} over-budget graphs "
                  "(training only; eval scores every example)")

    if cfg.data.packed_cache and source_digest is not None:
        from deepdfa_tpu_torch.data.packed_cache import PackedBatchCache, cache_key

        rcfg = cfg.train.resilience
        cache = PackedBatchCache(cache_dir(cfg.data.dataset) / "packed",
                                 max_entries=cfg.data.packed_cache_max_entries,
                                 io_retries=rcfg.io_retries, io_backoff_s=rcfg.io_backoff_s)
        key = cache_key(dict(
            batcher,
            add_self_loops=packer.add_self_loops if packer is not None else True,
            phase=phase,
            # epoch shapes the stream only when undersampling resamples
            epoch=shuffle_epoch if undersampling else None,
            undersample=undersampling,
            data_seed=cfg.data.seed,
        ), source_digest)
        stage = "load" if cache.has(key) else "pack"
        stream = cache.get_or_pack(key, build)
    else:
        stage, stream = "pack", build()
    return BatchStream(stream, stage) if lazy else list(stream)


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
    """The configured DeepDFA; `init_state` or a checkpoint sets its
    weights. The dataflow styles take their bit width from the store's
    extraction (`data.feat.max_defs`)."""
    from deepdfa_tpu_torch.models import DeepDFA

    return DeepDFA.from_config(cfg.model, cfg.data.feat.input_dim,
                               max_defs=cfg.data.feat.max_defs)


# -- data preparation (the reference's cmd_prepare, cmd_extract_vocab,
# cmd_extract) ---------------------------------------------------------------


def cmd_prepare(args) -> None:
    import dataclasses
    import pickle

    from deepdfa_tpu_torch.data import readers, synthetic

    cfg = _load_config(args)
    out_dir = processed_dir(cfg.data.dataset)
    fmt = args.format
    if fmt == "auto":
        if args.source == "synthetic":
            fmt = "synthetic"
        elif args.source.endswith(".json"):
            fmt = "devign"
        else:
            fmt = "bigvul"
    if fmt == "synthetic":
        if not args.synthetic_v2 and (args.lookalike_rate != 0.5 or args.label_noise != 0.02):
            raise SystemExit(
                "--lookalike-rate/--label-noise only apply with "
                "--synthetic-v2 (the v1 generator has neither knob)"
            )
        if args.synthetic_v2:
            synth = synthetic.generate_v2(
                args.n_examples, seed=cfg.data.seed,
                lookalike_rate=args.lookalike_rate, label_noise=args.label_noise,
            )
        else:
            synth = synthetic.generate(args.n_examples, seed=cfg.data.seed)
        examples = synthetic.to_examples(synth)
    elif fmt == "devign":
        examples = readers.read_devign(args.source, sample=args.sample)
    elif fmt == "dbgbench":
        examples = readers.read_dbgbench(args.source, sample=args.sample)
    else:
        examples = readers.read_bigvul(args.source, sample=args.sample)
    if args.mutated_jsonl:
        # mutated subdatasets replace each example's code via id join
        examples = readers.read_mutated(args.mutated_jsonl, examples, flip=args.mutated_flip)
    if args.dep_closure:
        # statement labels: changed lines plus the lines data/control
        # dependent on them (the reference's dep-add closure)
        from deepdfa_tpu_torch.frontend import parse_function
        from deepdfa_tpu_torch.frontend.deps import dependent_lines

        enriched = []
        for e in examples:
            if e.vuln_lines:
                try:
                    extra = dependent_lines(parse_function(e.code), set(e.vuln_lines))
                    e = dataclasses.replace(e, vuln_lines=frozenset(set(e.vuln_lines) | extra))
                except ValueError:
                    pass
            enriched.append(e)
        examples = enriched

    if args.splits:
        splits = readers.read_splits_csv(args.splits)
    elif args.cross_project:
        if args.source == "synthetic" or args.source.endswith(".json"):
            raise SystemExit("--cross-project requires a Big-Vul csv with a `project` column")
        splits = readers.cross_project_splits(args.source, seed=cfg.data.seed)
    else:
        splits = readers.random_splits([e.id for e in examples], seed=cfg.data.seed)
    with (out_dir / "examples.pkl").open("wb") as f:
        pickle.dump(examples, f)
    (out_dir / "splits.json").write_text(json.dumps({str(k): v for k, v in splits.items()}))
    if args.export_codet5:
        # per-split defect jsonl {"idx", "code", "target"}: the corpus in
        # the format the defect task reader (data/gen_data.py) consumes
        c5_dir = out_dir / "codet5"
        c5_dir.mkdir(parents=True, exist_ok=True)
        counts = {}
        for split, fname in {"train": "train", "val": "valid", "test": "test"}.items():
            rows = [e for e in examples if splits.get(e.id) == split]
            with (c5_dir / f"{fname}.jsonl").open("w") as f:
                for e in rows:
                    f.write(json.dumps({"idx": e.id, "code": e.code,
                                        "target": int(e.label)}) + "\n")
            counts[fname] = len(rows)
        print(f"codet5 export -> {c5_dir}: {counts}")
    print(f"prepared {len(examples)} examples -> {out_dir}")


def _prepared(cfg: Config):
    """(processed dir, examples, train ids) of a prepared dataset."""
    from deepdfa_tpu_torch.data import load_examples

    out_dir = processed_dir(cfg.data.dataset)
    examples = load_examples(out_dir / "examples.pkl")
    splits = json.loads((out_dir / "splits.json").read_text())
    return out_dir, examples, [int(k) for k, v in splits.items() if v == "train"]


def _vocab_json(vocabs) -> str:
    return json.dumps({k: v.to_json() for k, v in vocabs.items()})


def cmd_extract_vocab(args) -> None:
    """Build the shared train-split vocabularies (run once before sharded
    extraction; unsharded `extract` does this itself)."""
    from deepdfa_tpu_torch.data.pipeline import build_corpus_vocabs

    cfg = _load_config(args)
    out_dir, examples, train_ids = _prepared(cfg)
    vocabs = build_corpus_vocabs(
        examples, train_ids=train_ids, limit_all=cfg.data.feat.limit_all,
        limit_subkeys=cfg.data.feat.limit_subkeys, workers=args.workers,
    )
    vocab_path = out_dir / f"vocab{cfg.data.feat.name}.json"
    vocab_path.write_text(_vocab_json(vocabs))
    print(f"built vocabularies -> {vocab_path}")


def _write_missing_ids(store_dir: Path, examples, specs, tag: str | None = None) -> None:
    """Record the ids the frontend could not turn into graphs, inside the
    graph store (the failure set differs by gtype)."""
    got = {s.graph_id for s in specs}
    missing = sorted(e.id for e in examples if e.id not in got)
    name = f"missing_ids-{tag}.txt" if tag else "missing_ids.txt"
    (store_dir / name).write_text("".join(f"{i}\n" for i in missing))


def cmd_extract(args) -> None:
    from deepdfa_tpu_torch.data.pipeline import build_dataset, encode_corpus
    from deepdfa_tpu_torch.frontend.vocab import AbsDfVocab
    from deepdfa_tpu_torch.graphs import GraphStore

    cfg = _load_config(args)
    feat = cfg.data.feat
    out_dir, examples, train_ids = _prepared(cfg)
    vocab_path = out_dir / f"vocab{feat.name}.json"
    store = GraphStore(out_dir / graphs_dirname(cfg))

    # fixed vocabularies: another dataset's (--vocab-from, the
    # cross-dataset workflow) or this dataset's own pre-built ones
    # (sharded extraction); shard jobs write tagged npz files
    fixed_vocab_src = None
    if args.vocab_from:
        fixed_vocab_src = Path(args.vocab_from)
    elif args.num_shards > 1:
        if not vocab_path.exists():
            raise SystemExit(f"sharded extract requires {vocab_path}; run "
                             "`python -m deepdfa_tpu_torch.cli extract-vocab` first")
        fixed_vocab_src = vocab_path

    if fixed_vocab_src is not None:
        vocabs = {k: AbsDfVocab.from_json(v)
                  for k, v in json.loads(fixed_vocab_src.read_text()).items()}
        sel = [e for i, e in enumerate(examples) if i % args.num_shards == args.shard]
        specs = encode_corpus(sel, vocabs, workers=args.workers, max_defs=feat.max_defs,
                              gtype=cfg.data.gtype, struct_feats=feat.struct_feats)
        tag = f"shard{args.shard:04d}" if args.num_shards > 1 else None
        store.write(specs, tag=tag)
        _write_missing_ids(store.directory, sel, specs, tag=tag)
        if fixed_vocab_src != vocab_path:
            vocab_path.write_text(fixed_vocab_src.read_text())
        print(f"extracted shard {args.shard}/{args.num_shards}: {len(specs)}/{len(sel)} "
              f"graphs (vocab: {fixed_vocab_src}) -> {store.directory}")
        return

    specs, vocabs = build_dataset(
        examples, train_ids=train_ids, limit_all=feat.limit_all,
        limit_subkeys=feat.limit_subkeys, workers=args.workers, max_defs=feat.max_defs,
        gtype=cfg.data.gtype, struct_feats=feat.struct_feats,
    )
    store.write(specs)
    _write_missing_ids(store.directory, examples, specs)
    vocab_path.write_text(_vocab_json(vocabs))
    print(f"extracted {len(specs)}/{len(examples)} graphs -> {store.directory}")


def _apply_tuned(cfg: Config, device, serve_side: bool = False) -> Config:
    """Under tune.enabled, fold the tuned.json record matching this
    card into the config (the reference's `_apply_tuned`); printed as
    `[tune] ...`. Training takes the winning kernel layout and the
    fitted seq-bucket edges, keyed at the data.batch budgets; serving
    (`score`, `serve`) takes the kernel layout only, keyed at the serve
    budgets (its ladder rungs and bucket edges reach the executors
    through ScoringService, so the registry's digest never sees a tuned
    data section). A mismatch or a missing file falls back to the
    config as it is, loudly (tune/cache.py)."""
    if not cfg.tune.enabled:
        return cfg
    from deepdfa_tpu_torch.tune import cache as tune_cache

    if serve_side:
        node_budget, edge_budget = config_mod.serve_budgets(cfg)
        cfg, report = tune_cache.apply_to_config(cfg, sections=("kernel",),
                                                 node_budget=node_budget,
                                                 edge_budget=edge_budget, device=device)
    else:
        cfg, report = tune_cache.apply_to_config(cfg, device=device)
    print("[tune] " + json.dumps(report), flush=True)
    return cfg


def cmd_train(args) -> None:
    from deepdfa_tpu_torch import obs
    from deepdfa_tpu_torch.testing.faults import injector_from_env
    from deepdfa_tpu_torch.train import GraphTrainer, nni_bridge, positive_weight
    from deepdfa_tpu_torch.train.logging import RunLogger
    from deepdfa_tpu_torch.train.resilience import make_runner

    cfg = _load_config(args)
    # under an NNI experiment the trial's parameters override the config
    # and the monitored value goes back each validation epoch and at the end
    if nni_bridge.active():
        cfg = config_mod.apply_overrides(cfg, nni_bridge.nni_overrides())
    cfg = _apply_tuned(cfg, args.device)
    split_specs = load_graph_splits(cfg)
    run_dir = runs_dir(cfg.run_name)
    config_mod.to_json(cfg, run_dir / "config.json")
    pw = None
    if cfg.train.pos_weight is None and not cfg.data.undersample:
        pw = positive_weight(np.array([s.label for s in split_specs["train"]]))
    # content digests key the packed-batch cache (once a run: any
    # re-extraction changes them)
    train_digest = val_digest = None
    if cfg.data.packed_cache:
        from deepdfa_tpu_torch.data.packed_cache import corpus_digest

        train_digest = corpus_digest(split_specs["train"])
        val_digest = corpus_digest(split_specs["val"])
    # one spawn pool a split for the whole run, started lazily: a run
    # whose epochs all replay the cache never spawns a worker
    packer = val_packer = None
    if cfg.data.pack_workers > 1:
        from deepdfa_tpu_torch.data.mp_pack import MpPacker

        packer = MpPacker(split_specs["train"], workers=cfg.data.pack_workers)
        val_packer = MpPacker(split_specs["val"], workers=cfg.data.pack_workers)
    run_log = None
    obs_cm = obs.session(cfg, run_dir)
    obs_cm.__enter__()
    try:
        batches0 = epoch_batches(cfg, split_specs["train"], shuffle_epoch=0,
                                 source_digest=train_digest, packer=packer)
        trainer = GraphTrainer(
            _model(cfg), cfg, pos_weight=pw,
            total_steps=len(batches0) * max(1, cfg.train.max_epochs), device=args.device,
        )
        state = trainer.init_state()
        ckpts = trainer.make_checkpoints(run_dir / CHECKPOINTS_DIR)

        def val_batches():
            out = epoch_batches(cfg, split_specs["val"], phase="eval",
                                source_digest=val_digest, packer=val_packer)
            if cfg.data.packed_cache and val_packer is not None:
                # the eval entry is cached now: release the idle pool
                val_packer.close()
            return out

        # the resilient runtime (off unless train.resilience.enabled) and
        # the fault injector (armed only by DEEPDFA_FAULTS)
        res = make_runner(cfg, run_dir / STEP_CHECKPOINTS_DIR,
                          rng={"feat_dropout_seed": cfg.train.seed + 7919})
        injector = injector_from_env()

        def train_stream(epoch):
            s = epoch_batches(cfg, split_specs["train"], epoch, lazy=True,
                              source_digest=train_digest, packer=packer)
            return injector.wrap(s) if injector is not None else s

        run_log = RunLogger(run_dir)
        trainer.fit(
            state,
            train_stream,
            val_batches=val_batches,
            checkpoints=ckpts,
            log_fn=nni_bridge.intermediate_log_fn(cfg.train.monitor, run_log.log),
            resilience=res,
        )
    finally:
        try:
            if run_log is not None:
                run_log.close()
            for p in (packer, val_packer):
                if p is not None:
                    p.close()
        finally:
            obs_cm.__exit__(None, None, None)
    best = ckpts.best_metrics()
    if best and cfg.train.monitor in best:
        nni_bridge.report_final(best[cfg.train.monitor])
    print("best:", best)


def cmd_test(args) -> None:
    from deepdfa_tpu_torch.train import GraphTrainer, classification_report

    cfg = _load_run_config(args)
    if args.export and cfg.model.label_style != "graph":
        raise SystemExit(f"test --export writes one prediction a function; "
                         f"label_style={cfg.model.label_style!r} scores nodes")
    split_specs = load_graph_splits(cfg)
    run_dir = runs_dir(cfg.run_name)
    trainer = GraphTrainer(_model(cfg), cfg, total_steps=1, device=args.device)
    ckpts = trainer.make_checkpoints(run_dir / CHECKPOINTS_DIR)
    trainer.model.load_state_dict(ckpts.restore(args.checkpoint)["model"])
    batches = epoch_batches(cfg, split_specs[args.split], phase="eval")
    trace_ctx = contextlib.nullcontext()
    if args.xprof_dir:
        # the device timeline of the evaluation (the reference's xprof dump)
        from deepdfa_tpu_torch.eval.profiling import xprof_trace

        trace_ctx = xprof_trace(args.xprof_dir)
    with trace_ctx:
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

    if args.profile:
        # Table 5's record: the first batch's forward, its counted FLOPs
        # (the kernels' formulas + the aten ops) and its device time
        import torch

        from deepdfa_tpu_torch.eval.profiling import profile_model

        batch = batches[0].to(trainer.device)
        trainer.model.eval()

        def fwd(b):
            with torch.inference_mode():
                return trainer.model(b)

        rec = profile_model(fwd, (batch,),
                            examples_per_call=int(np.asarray(batches[0].graph_mask).sum()),
                            out_path=run_dir / "profiledata.jsonl")
        print(json.dumps(rec, indent=2))


def combined_setup(args, cfg: Config):
    """(tokenizer, model config) of `train-combined` (the reference's
    `_combined_setup`): a CombinedConfig for `--arch roberta`, a
    DefectConfig for `--arch t5`; `--tokenizer DIR` is the byte-level BPE
    of DIR's `*vocab.json` + `*merges.txt` (roberta only, as in the
    reference). `--sp-variant ulysses` raises NotImplementedError."""
    import dataclasses

    from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer, HashTokenizer
    from deepdfa_tpu_torch.models import CombinedConfig, DefectConfig, T5Config, TransformerConfig

    if args.sp_variant != "ring":
        raise NotImplementedError("train-combined --sp-variant ulysses (the multi-device "
                                  "slice, ROADMAP queue A, item 9) is not ported yet")
    widths = {"roberta": ("tiny", "codebert-base"), "t5": ("tiny", "codet5-base")}[args.arch]
    if args.encoder not in widths:
        raise SystemExit(f"--encoder {args.encoder} is not valid for --arch {args.arch} "
                         f"(choose from {widths})")
    if args.arch == "t5" and args.tokenizer:
        raise SystemExit(
            "--arch t5 supports only the built-in hash tokenizer for now: BPE vocab.json "
            "assets use the RoBERTa special-id layout, which conflicts with T5's "
            "pad=0/eos=2 attention-mask convention")
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
    tok = BpeTokenizer.from_dir(args.tokenizer) if args.tokenizer else HashTokenizer(4096)
    if args.encoder == "codebert-base":
        enc_cfg = TransformerConfig(dtype="bfloat16", **kw)
    else:
        enc_cfg = TransformerConfig.tiny(vocab_size=tok.vocab_size,
                                         max_position_embeddings=args.max_length + 4, **kw)
    return tok, CombinedConfig(encoder=enc_cfg, **graph)


def load_hf_state_dict(path) -> dict:
    """A Hugging Face torch state_dict file (weights only, on the CPU),
    as the reference's `--pretrained` reads it."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def encoder_from_hf(enc_cfg, path) -> dict:
    """The encoder state dict of `--pretrained PATH`: a `RobertaModel`
    state_dict for a TransformerConfig, a `T5EncoderModel` / `T5Model`
    one for a T5Config."""
    from deepdfa_tpu_torch.models import T5Config, t5, transformer

    importer = t5.params_from_hf_torch if isinstance(enc_cfg, T5Config) else \
        transformer.params_from_hf_torch
    return importer(enc_cfg, load_hf_state_dict(path))


def cmd_train_combined(args) -> None:
    from deepdfa_tpu_torch.data import (
        bucketed_collate_batches,
        collate,
        lengths_for,
        load_examples,
        plan_bucketed_batches,
    )
    from deepdfa_tpu_torch.data.tokenizer import bpe_files
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch import obs
    from deepdfa_tpu_torch.serve.cascade import save_model_setup
    from deepdfa_tpu_torch.testing.faults import injector_from_env
    from deepdfa_tpu_torch.train import CheckpointManager, CombinedTrainer, undersample_epoch
    from deepdfa_tpu_torch.train.logging import RunLogger
    from deepdfa_tpu_torch.train.resilience import make_runner

    cfg = _apply_tuned(_load_config(args), args.device)
    if cfg.data.gtype != "cfg":
        raise SystemExit(f"train-combined supports data.gtype=cfg only (got {cfg.data.gtype!r})")
    tok, mcfg = combined_setup(args, cfg)
    out_dir = processed_dir(cfg.data.dataset)
    run_dir = runs_dir(cfg.run_name)
    config_mod.to_json(cfg, run_dir / "config.json")
    # the run-dir model manifest: serving rebuilds the tokenizer and the
    # encoder config from it, never from re-supplied CLI arguments
    if args.tokenizer:
        vocab, merges = bpe_files(args.tokenizer)
        tok_desc = {"kind": "bpe", "vocab": str(vocab.resolve()),
                    "merges": str(merges.resolve())}
    else:
        tok_desc = {"kind": "hash", "vocab_size": tok.vocab_size, "t5_frame": args.arch == "t5"}
    save_model_setup(run_dir, "t5" if args.arch == "t5" else "combined", mcfg, tok_desc,
                     args.max_length)
    examples = load_examples(out_dir / "examples.pkl")
    splits = json.loads((out_dir / "splits.json").read_text())
    store = None if args.no_graph else GraphStore(out_dir / graphs_dirname(cfg))
    graphs_by_id = {} if store is None else store.load_all()

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

    # bucketed streams take the graph path's host levers: a spawn-pool
    # collater (data.pack_workers) and the packed-batch cache
    # (data.packed_cache), the bucket layout in its key
    text_packer = text_cache = source_digest = None
    if buckets and cfg.data.pack_workers > 1:
        from deepdfa_tpu_torch.data.mp_pack import TextMpPacker

        text_packer = TextMpPacker(token_ids, labels, graphs_by_id, pad_id=tok.pad_id,
                                   workers=cfg.data.pack_workers)
    if buckets and cfg.data.packed_cache:
        from deepdfa_tpu_torch.data.packed_cache import PackedBatchCache, text_corpus_digest

        rcfg = cfg.train.resilience
        text_cache = PackedBatchCache(cache_dir(cfg.data.dataset) / "packed-text",
                                      max_entries=cfg.data.packed_cache_max_entries,
                                      io_retries=rcfg.io_retries, io_backoff_s=rcfg.io_backoff_s)
        source_digest = (text_corpus_digest(token_ids, labels) + ":"
                         + (store.digest() if store is not None else ""))

    def bucketed(ids, phase, epoch):
        def build():
            sel_lengths = [lengths_by_id[i] for i in ids]
            if text_packer is not None:
                return text_packer.bucketed_batches(ids, buckets, cfg.data.token_budget, 1,
                                                    bcfg.node_budget, bcfg.edge_budget,
                                                    lengths=sel_lengths)
            return bucketed_collate_batches(
                token_ids, labels, ids, graphs_by_id, buckets, cfg.data.token_budget, 1,
                bcfg.node_budget, bcfg.edge_budget, pad_id=tok.pad_id, lengths=sel_lengths)

        if text_cache is None:
            return BatchStream(build(), "pack")
        import hashlib

        from deepdfa_tpu_torch.data.packed_cache import cache_key

        undersampling = bool(phase == "train" and cfg.data.undersample)
        key = cache_key(dict(
            kind="text", seq_buckets=list(buckets), token_budget=cfg.data.token_budget,
            num_shards=1, node_budget=bcfg.node_budget, edge_budget=bcfg.edge_budget,
            pad_id=tok.pad_id, max_length=args.max_length, phase=phase,
            # the ordered selection itself: the source digest covers the
            # train+val union, so a repartition or a reorder must miss
            ids_digest=hashlib.sha256(np.asarray(ids, np.int64).tobytes()).hexdigest(),
            epoch=epoch if undersampling else None,
            undersample=undersampling,
            data_seed=cfg.data.seed,
        ), source_digest)
        stage = "load" if text_cache.has(key) else "pack"
        return BatchStream(text_cache.get_or_pack(key, build), stage)

    def batches(ids, phase="train", epoch=None):
        ids = list(ids)
        if buckets:
            return bucketed(ids, phase, epoch)
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
    if args.pretrained:
        state = trainer.load_encoder(state, encoder_from_hf(mcfg.encoder, args.pretrained))
    ckpts = trainer.make_checkpoints(run_dir / COMBINED_CHECKPOINTS_DIR)
    # the resilient runtime (off unless train.resilience.enabled), the fault
    # injector (armed only by DEEPDFA_FAULTS) and the telemetry session
    res = make_runner(cfg, run_dir / COMBINED_STEP_CHECKPOINTS_DIR, rng={"dropout_seed": 0})
    injector = injector_from_env()

    def train_stream(epoch):
        s = batches(epoch_ids(epoch), epoch=epoch)
        return injector.wrap(s) if injector is not None else s

    run_log = RunLogger(run_dir, tensorboard=False)
    try:
        with obs.session(cfg, run_dir):
            trainer.fit(state, train_stream,
                        val_batches=lambda: batches(split_ids("val"), phase="eval"),
                        checkpoints=ckpts, log_fn=run_log.log, resilience=res)
    finally:
        run_log.close()
        if text_packer is not None:
            text_packer.close()
    print("best:", ckpts.best_metrics())


def cmd_localize(args) -> None:
    """Line-level localization over a trained combined model: token
    attributions -> per-line ranking -> top-k / IFA / effort metrics
    against the labelled vulnerable lines (the reference's
    `cmd_localize`)."""
    from deepdfa_tpu_torch.data import collate, load_examples
    from deepdfa_tpu_torch.data.tokenizer import split_lines
    from deepdfa_tpu_torch.eval.localize import aggregate_line_scores, token_scores
    from deepdfa_tpu_torch.eval.statements import (
        RankedExample,
        per_example_ifa,
        statement_report,
    )
    from deepdfa_tpu_torch.graphs import GraphStore
    from deepdfa_tpu_torch.train import CombinedTrainer

    cfg = _load_run_config(args)
    if cfg.data.gtype != "cfg":
        raise SystemExit(f"localize supports data.gtype=cfg only (got {cfg.data.gtype!r})")
    out_dir = processed_dir(cfg.data.dataset)
    run_dir = runs_dir(cfg.run_name)
    examples = load_examples(out_dir / "examples.pkl")
    splits = json.loads((out_dir / "splits.json").read_text())
    tok, mcfg = combined_setup(args, cfg)
    trainer = CombinedTrainer(cfg, mcfg, total_steps=1, device=args.device)
    model = trainer.init_state().model
    ckpts = trainer.make_checkpoints(run_dir / COMBINED_CHECKPOINTS_DIR)
    model.load_state_dict(ckpts.restore(args.checkpoint)["model"])
    model.eval()
    graphs_by_id = {} if not mcfg.use_graph else \
        GraphStore(out_dir / graphs_dirname(cfg)).load_all()

    targets = [e for e in examples if splits.get(str(e.id)) == args.split and e.vuln_lines]
    if args.limit:
        targets = targets[:args.limit]
    bcfg = cfg.data.batch
    ranked = []
    for e in targets:
        ids, tok_lines = tok.encode_with_lines(e.code, max_length=args.max_length)
        b = collate(ids[None], [int(e.label or 0)], [e.id], graphs_by_id, batch_rows=1,
                    node_budget=bcfg.node_budget, edge_budget=bcfg.edge_budget,
                    pad_id=tok.pad_id).to(trainer.device)
        scores = token_scores(args.method, args.arch, model, b.input_ids,
                              b.graphs if mcfg.use_graph else None,
                              b.has_graph if mcfg.use_graph else None)
        # \n-only numbering: the coordinates of e.vuln_lines
        n_lines = len(split_lines(e.code))
        line_scores = aggregate_line_scores(scores[0], tok_lines, n_lines)
        flagged = np.zeros(n_lines, bool)
        for ln in e.vuln_lines:
            if 1 <= ln <= n_lines:
                flagged[ln - 1] = True
        ranked.append(RankedExample(line_scores, flagged))

    report = statement_report(ranked)
    report["n_examples"] = len(ranked)
    report["method"] = args.method
    print(json.dumps(report, indent=2))
    (run_dir / f"localize_{args.split}_{args.method}.json").write_text(json.dumps(report))
    # per-example IFA (the reference's ifa_records/ifa_<method>.txt)
    ifa_dir = run_dir / "ifa_records"
    ifa_dir.mkdir(parents=True, exist_ok=True)
    (ifa_dir / f"ifa_{args.method}.txt").write_text(
        "\n".join(str(v) for v in per_example_ifa(ranked)) + "\n")


# -- the generation family -------------------------------------------------


GEN_CHECKPOINTS_DIR = "checkpoints-gen-torch"
GEN_BLEU_CHECKPOINTS_DIR = "checkpoints-gen-bleu-torch"
CLONE_CHECKPOINTS_DIR = "checkpoints-clone-torch"
#: `train-gen`'s step checkpoints under train.resilience.enabled
GEN_STEP_CHECKPOINTS_DIR = "checkpoints-gen-torch-step"


def _gen_tokenizer_and_encoder(args):
    """(tokenizer, T5Config) of the generation commands: the T5-framed
    hash tokenizer at --vocab-size, or with `--tokenizer bpe` the
    byte-level BPE of --vocab-file and --merges-file (its pad and eos ids
    frame the model), and the tiny or codet5-base config (fp32
    activations, the reference's default) under `--remat-policy`."""
    from deepdfa_tpu_torch.data.tokenizer import BpeTokenizer, HashTokenizer
    from deepdfa_tpu_torch.models import T5Config

    if args.tokenizer == "bpe":
        if not (args.vocab_file and args.merges_file):
            raise SystemExit(f"{args.cmd} --tokenizer bpe needs --vocab-file and --merges-file")
        tok = BpeTokenizer(args.vocab_file, args.merges_file)
    else:
        tok = HashTokenizer(vocab_size=args.vocab_size, t5_frame=True)
    kw = dict(vocab_size=tok.vocab_size, pad_token_id=tok.pad_id, eos_token_id=tok.sep_id,
              remat_policy=args.remat_policy)
    return tok, (T5Config.tiny(**kw) if args.tiny else T5Config(**kw))


def _gen_setup(args, cfg: Config, total_steps: int | None = None):
    """(tokenizer, GenConfig, GenTrainer, fresh state, rows per batch) of
    `train-gen` and `train-multi-gen` (the reference's `_gen_setup`)."""
    from deepdfa_tpu_torch.models import GenConfig
    from deepdfa_tpu_torch.models import t5_gen as genm
    from deepdfa_tpu_torch.train.gen_loop import GenTrainer

    tok, enc_cfg = _gen_tokenizer_and_encoder(args)
    gcfg = GenConfig(encoder=enc_cfg, max_target_length=args.max_target_length,
                     beam_size=args.beam_size)
    config_mod.one_card(cfg.train.mesh)
    trainer = GenTrainer(cfg, gcfg, total_steps=total_steps, device=args.device)
    state = trainer.init_state()
    if args.pretrained:
        state = trainer.load_params(
            state, genm.gen_params_from_hf_torch(gcfg, load_hf_state_dict(args.pretrained)))
    return tok, gcfg, trainer, state, max(1, args.batch_size)


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
    """Seq2seq training and test decoding (CodeT5's run_gen.py), under the
    runtime hooks as the reference's `cmd_train_gen` runs them (`:1351-
    1372`): the resilient runtime, the fault injector and the telemetry
    session."""
    from deepdfa_tpu_torch import obs
    from deepdfa_tpu_torch.data import gen_data
    from deepdfa_tpu_torch.models import t5_gen as genm
    from deepdfa_tpu_torch.testing.faults import injector_from_env
    from deepdfa_tpu_torch.train.logging import RunLogger
    from deepdfa_tpu_torch.train.resilience import make_runner

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
        # the resilient runtime (off unless train.resilience.enabled), the
        # fault injector (armed only by DEEPDFA_FAULTS) and the telemetry
        # session; the dropout streams are functions of (seed 0, step)
        res = make_runner(cfg, run_dir / GEN_STEP_CHECKPOINTS_DIR, rng={"dropout_seed": 0})
        injector = injector_from_env()

        def train_stream(epoch):
            s = gen_data.batches_of(train_src, train_tgt, 1, rows, pad_id=tok.pad_id,
                                    shuffle_seed=cfg.train.seed + epoch)
            return injector.wrap(s) if injector is not None else s

        run_log = RunLogger(run_dir, tensorboard=False)
        try:
            with obs.session(cfg, run_dir):
                state = trainer.fit(
                    state, train_stream, val_batches=val_batches, val_decode=val_decode,
                    checkpoints=ckpts, bleu_checkpoints=bleu_ckpts, patience=args.patience,
                    log_fn=run_log.log, resilience=res)
        finally:
            run_log.close()
        print("best:", ckpts.best_metrics())

    if args.test_file:
        ex, test_src, test_tgt = load(args.test_file)
        # decode from the best-ppl weights, not the last epoch's or a resumed
        # state's (run_gen.py reloads checkpoint-best-ppl before test decoding)
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
    from deepdfa_tpu_torch.train.logging import RunLogger
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
    run_log = RunLogger(run_dir, tensorboard=False)
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
    from deepdfa_tpu_torch.train.logging import RunLogger

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
    if args.pretrained:
        from deepdfa_tpu_torch.models import GenConfig, t5_gen as genm

        state = trainer.load_seq2seq(state, genm.gen_params_from_hf_torch(
            GenConfig(encoder=enc_cfg), load_hf_state_dict(args.pretrained)))
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
        run_log = RunLogger(run_dir, tensorboard=False)
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


# -- scoring and serving C sources (the reference's cmd_score, cmd_serve) -----


def cmd_cascade_calibrate(args) -> None:
    """Fit the cascade's temperature and uncertainty band from a labeled
    dev set: a JSONL of {"prob": p, "label": 0|1} rows (`score`'s output
    joined with labels) -> one JSON line with the fit and the
    `serve.cascade_temperature` / `serve.cascade_band` overrides to
    serve with (the reference's `cmd_cascade_calibrate`)."""
    from deepdfa_tpu_torch.eval import calibrate as calibrate_mod

    probs, labels = [], []
    with open(args.scores) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            p, y = row.get(args.prob_key), row.get(args.label_key)
            if p is None or y is None:
                continue
            probs.append(float(p))
            labels.append(int(y))
    if not probs:
        raise SystemExit(f"no rows in {args.scores} carry both {args.prob_key!r} and "
                         f"{args.label_key!r}")
    result = calibrate_mod.calibrate(probs, labels, target_escalation=args.target_escalation)
    result["overrides"] = [
        f"serve.cascade_temperature={result['temperature']}",
        f"serve.cascade_band={json.dumps(result['band'])}",
    ]
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))


def cmd_codebleu(args) -> None:
    """Score a hypothesis file against one or more reference files, one
    example a line (the reference's `cmd_codebleu`, CodeT5's
    calc_code_bleu.py:66-81): CodeBLEU's four components and the
    composite under `--params` (alpha,beta,gamma,theta), as JSON."""
    from deepdfa_tpu_torch.eval.codebleu import get_codebleu

    refs_per_file = [[line.strip() for line in Path(f).read_text().splitlines()]
                     for f in args.refs]
    hyps = [line.strip() for line in Path(args.hyp).read_text().splitlines()]
    for rr in refs_per_file:
        if len(rr) != len(hyps):
            raise SystemExit("refs and hyp must have equal line counts")
    references = [[rr[i] for rr in refs_per_file] for i in range(len(hyps))]
    out = get_codebleu(references, hyps, lang=args.lang,
                       params=tuple(float(x) for x in args.params.split(",")))
    print(json.dumps(out, indent=2))


def cmd_score(args) -> None:
    """Offline scoring of C source files against a trained checkpoint
    through the online path (cached frontend -> dynamic batcher -> the
    model on the card): one row a source in `scores.jsonl` (or --out)
    and the summary on stdout. --smoke trains a tiny run first and
    fails unless every source scored."""
    from deepdfa_tpu_torch import obs
    from deepdfa_tpu_torch.serve import driver

    if args.smoke:
        cfg, run_dir, sources_dir = driver.build_smoke_run(extra_overrides=args.overrides,
                                                           device=args.device)
        sources = driver.collect_sources([str(sources_dir)])
    else:
        if not args.sources:
            raise SystemExit("score needs source files/dirs (or --smoke)")
        cfg = _apply_tuned(_load_run_config(args), args.device, serve_side=True)
        run_dir = runs_dir(cfg.run_name)
        sources = driver.collect_sources(args.sources)
    with obs.session(cfg, run_dir):
        summary = driver.run_score(cfg, run_dir, sources, out_path=args.out,
                                   family=args.family, device=args.device)
    print(json.dumps(summary), flush=True)
    if args.smoke and summary["serve_scored"] != len(sources):
        raise SystemExit(f"score smoke contract violated: {summary['serve_scored']} of "
                         f"{len(sources)} sources scored")


def cmd_serve(args) -> None:
    """The online scoring service: stdlib HTTP `POST /score`, `GET
    /healthz` and `GET /stats` over the dynamic batcher, on --host and
    --port (0 picks a free port; the first stdout line names it).
    --smoke serves a tiny run on a free port, round-trips real requests
    and exits non-zero unless every status is the contract's."""
    from deepdfa_tpu_torch import obs
    from deepdfa_tpu_torch.serve import driver
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import ScoringService, serve_forever

    if args.smoke:
        report = driver.run_serve_smoke(extra_overrides=args.overrides, device=args.device)
        print(json.dumps(report), flush=True)
        health = report["healthz"]
        bad = (
            any(s["status"] != 200 for s in report["scored"])
            or report["reject_status"] != 422
            or report["bad_json_status"] != 400
            or report["no_code_status"] != 400
            or report["unknown_route_status"] != 404
            or report["healthz_status"] != 200
            or any(health.get(k) is None for k in ("checkpoint", "checkpoint_step",
                                                   "config_digest"))
            or report["stats_status"] != 200
        )
        if bad:
            raise SystemExit("serve smoke contract violated (see report)")
        return
    cfg = _apply_tuned(_load_run_config(args), args.device, serve_side=True)
    with obs.session(cfg, runs_dir(cfg.run_name)):
        registry = ModelRegistry(runs_dir(cfg.run_name), family=args.family,
                                 checkpoint=cfg.serve.checkpoint, cfg=cfg, device=args.device)
        serve_forever(ScoringService(registry, cfg), args.host, args.port)


def cmd_scan(args) -> None:
    """Whole-repo incremental scanning: walk a repository, split its
    C/C++ sources into functions, score each through the serving stack
    on the card, write findings JSONL and SARIF 2.1.0. --smoke trains a
    tiny checkpoint, scans a synthetic repo cold, edits one function and
    fails unless the incremental contract holds."""
    from deepdfa_tpu_torch.scan import scanner as scan_mod

    if args.smoke:
        report = scan_mod.run_scan_smoke(extra_overrides=args.overrides, device=args.device)
        print(json.dumps(report), flush=True)
        problems = scan_mod.smoke_problems(report)
        if problems:
            raise SystemExit(f"scan smoke contract violated: {problems}")
        return
    if not args.repo:
        raise SystemExit("scan needs a repository path (or --smoke)")
    cfg = _apply_tuned(_load_run_config(args), args.device, serve_side=True)
    if args.lines:
        cfg = config_mod.apply_overrides(cfg, ["scan.lines=true"])
    if args.no_incremental:
        cfg = config_mod.apply_overrides(cfg, ["scan.incremental=false"])
    from deepdfa_tpu_torch.serve.registry import ModelRegistry
    from deepdfa_tpu_torch.serve.server import ScoringService

    registry = ModelRegistry(runs_dir(cfg.run_name), family=args.family,
                             checkpoint=cfg.serve.checkpoint, cfg=cfg, device=args.device)
    service = ScoringService(registry, cfg)
    try:
        summary = scan_mod.RepoScanner(service, cfg).scan(args.repo, out_jsonl=args.out,
                                                          sarif_out=args.sarif)
    finally:
        service.close()
    print(json.dumps(summary), flush=True)


def cmd_coverage(args) -> None:
    """Per split: graphs, nodes, definition nodes, known and unknown
    hashes, and the known-definition coverage (eval/coverage.py)."""
    from deepdfa_tpu_torch.eval.coverage import coverage_report

    cfg = _load_config(args)
    print(json.dumps(coverage_report(load_graph_splits(cfg)), indent=2))


def cmd_ivdetect(args) -> None:
    """Per-line IVDetect features of each C file into
    `<out-dir or the file's dir>/<stem>.ivdetect.json` (eval/ivdetect.py);
    prints each path written."""
    from deepdfa_tpu_torch.eval.ivdetect import dump_features

    for src in args.sources:
        src = Path(src)
        out = Path(args.out_dir) if args.out_dir else src.parent
        out.mkdir(parents=True, exist_ok=True)
        dest = out / f"{src.stem}.ivdetect.json"
        dump_features(src.read_text(), dest)
        print(dest)


def cmd_run_exp(args) -> None:
    """Experiment-matrix runner: --matrix <json> (explicit runs) or
    --tasks/--seeds (train/experiments.py:TASK_DEFAULTS); runs each as a
    `python -m deepdfa_tpu_torch.cli` subprocess and writes per-run logs
    and summary.jsonl under <runs>/experiments/<tag>."""
    from deepdfa_tpu_torch.train.experiments import Run, expand_matrix, load_matrix, run_matrix

    if args.matrix:
        runs = load_matrix(args.matrix)
        if args.override:
            runs = [Run(r.name, r.cmd, r.args + tuple(args.override)) for r in runs]
    elif args.tasks:
        runs = expand_matrix(args.tasks, seeds=args.seeds, extra_args=args.extra_arg,
                             overrides=args.override)
    else:
        raise SystemExit("pass --matrix or --tasks")
    run_matrix(runs, runs_dir("experiments") / args.tag, dry_run=args.dry_run)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m deepdfa_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--config", default=None, help="json config file")
        p.add_argument("--device", default=None,
                       help="cuda (default) or cpu (the plain PyTorch path)")
        p.add_argument("overrides", nargs="*", default=[],
                       help="dotted key=value overrides")

    def host_common(p):
        p.add_argument("--config", default=None, help="json config file")
        p.add_argument("overrides", nargs="*", default=[],
                       help="dotted key=value overrides")

    p = sub.add_parser("prepare", help="read + clean a dataset, line labels, splits")
    p.add_argument("--source", required=True, help="csv/json path or 'synthetic'")
    p.add_argument("--splits", default=None, help="optional splits csv")
    p.add_argument("--cross-project", action="store_true",
                   help="project-disjoint splits from the csv's project column")
    p.add_argument("--dep-closure", action="store_true",
                   help="expand line labels with data/control dependents")
    p.add_argument("--sample", type=int, default=None)
    p.add_argument("--n-examples", type=int, default=2000)
    p.add_argument("--synthetic-v2", action="store_true",
                   help="hardened synthetic corpus: order-sensitive bug families + "
                        "benign lookalikes + label noise")
    p.add_argument("--lookalike-rate", type=float, default=0.5)
    p.add_argument("--label-noise", type=float, default=0.02)
    p.add_argument("--format", default="auto",
                   choices=("auto", "bigvul", "devign", "dbgbench", "synthetic"),
                   help="source format (auto: by file extension)")
    p.add_argument("--mutated-jsonl", default=None,
                   help="mutated-variant jsonl to join onto the base dataset")
    p.add_argument("--mutated-flip", action="store_true",
                   help="use the jsonl 'source' field (the *_flip variants)")
    p.add_argument("--export-codet5", action="store_true",
                   help="also write per-split CodeT5 defect jsonl (idx/code/target)")
    host_common(p)
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("extract", help="C frontend: CPG -> features -> vocab -> graph shards")
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--shard", type=int, default=0, help="job-array shard id")
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--vocab-from", default=None,
                   help="encode with another dataset's vocab json (cross-dataset evaluation)")
    host_common(p)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("extract-vocab", help="the train split's vocabularies, once, "
                                             "before sharded extraction")
    p.add_argument("--workers", type=int, default=0)
    host_common(p)
    p.set_defaults(fn=cmd_extract_vocab)

    p = sub.add_parser("train")
    common(p)
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("test")
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--split", default="test")
    p.add_argument("--export", action="store_true",
                   help="write per-example predictions csv")
    p.add_argument("--profile", action="store_true",
                   help="FLOPs + latency of the first batch's forward (Table 5's record)")
    p.add_argument("--xprof-dir", default=None,
                   help="write a torch.profiler Chrome trace of the evaluation here")
    common(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("train-combined")
    p.add_argument("--arch", default="roberta", choices=["roberta", "t5"],
                   help="roberta (LineVul style) or t5 (CodeT5 DefectModel style)")
    p.add_argument("--encoder", default="tiny",
                   help="tiny | codebert-base (roberta) | codet5-base (t5)")
    p.add_argument("--pretrained", default=None,
                   help="a Hugging Face torch state_dict for the encoder (RobertaModel, or "
                        "T5EncoderModel/T5Model for --arch t5)")
    p.add_argument("--tokenizer", default=None,
                   help="dir with *vocab.json + *merges.txt (byte-level BPE; default: hash)")
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
                       help="hash (default) or bpe (--vocab-file, --merges-file)")
        p.add_argument("--vocab-size", type=int, default=4096)
        p.add_argument("--vocab-file", default=None)
        p.add_argument("--merges-file", default=None)
        p.add_argument("--pretrained", default=None,
                       help="HF torch T5ForConditionalGeneration state_dict")
        p.add_argument("--remat-policy", default="full", choices=["full", "attn_saved"],
                       help="layer checkpoints: replay all (full) or keep the attention "
                            "output (attn_saved)")

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

    # no overrides positional: the nargs='*' flags would swallow them;
    # per-run config overrides go through --override
    p = sub.add_parser("run-exp", help="run a task x seed matrix of CLI runs and summarize "
                                       "their results")
    p.add_argument("--matrix", default=None, help="json run-matrix spec")
    p.add_argument("--tasks", nargs="*", default=None,
                   help="built-in task names (deepdfa/combined/summarize/...)")
    p.add_argument("--seeds", nargs="*", type=int, default=[0])
    p.add_argument("--extra-arg", action="append", default=[],
                   help="extra CLI flag passed to every run (repeatable)")
    p.add_argument("--override", action="append", default=[],
                   help="dotted key=value config override for every run (repeatable)")
    p.add_argument("--tag", default="default")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_run_exp)

    p = sub.add_parser("coverage", help="abstract-dataflow coverage of each split's graphs")
    host_common(p)
    p.set_defaults(fn=cmd_coverage)

    p = sub.add_parser("ivdetect", help="dump per-line IVDetect features (subseq/ast/"
                                        "nametypes/data/control) for C files")
    p.add_argument("sources", nargs="+", help="C/C++ source files")
    p.add_argument("--out-dir", default=None)
    p.set_defaults(fn=cmd_ivdetect)

    p = sub.add_parser("cascade-calibrate",
                       help="fit the cascade's temperature and uncertainty band from a "
                            "labeled dev-set scores jsonl")
    p.add_argument("--scores", required=True, help="jsonl with per-row prob + label fields")
    p.add_argument("--prob-key", default="prob")
    p.add_argument("--label-key", default="label")
    p.add_argument("--target-escalation", type=float, default=0.3,
                   help="dev-set fraction the band should escalate")
    p.add_argument("--out", default=None, help="also write the result json here")
    p.set_defaults(fn=cmd_cascade_calibrate)

    p = sub.add_parser("codebleu", help="CodeBLEU of a hypothesis file against reference "
                                        "files (one example a line)")
    p.add_argument("--refs", nargs="+", required=True,
                   help="reference files (one example per line)")
    p.add_argument("--hyp", required=True, help="hypothesis file")
    from deepdfa_tpu_torch.eval.codebleu import LANG_DIALECT

    p.add_argument("--lang", default="c", choices=sorted(set(LANG_DIALECT) | {"python"}))
    p.add_argument("--params", default="0.25,0.25,0.25,0.25",
                   help="alpha,beta,gamma,theta component weights")
    p.set_defaults(fn=cmd_codebleu)

    p = sub.add_parser("localize", help="rank a combined run's lines by token attributions "
                                        "and score them against the labelled lines")
    p.add_argument("--arch", default="roberta", choices=["roberta", "t5"],
                   help="combined architecture the checkpoint was trained with (the "
                        "attention method is roberta-only)")
    p.add_argument("--no-graph", action="store_true")
    p.add_argument("--method", default="saliency",
                   choices=["attention", "saliency", "input_x_gradient", "lig", "deeplift",
                            "deeplift_shap", "gradient_shap"])
    p.add_argument("--checkpoint", default="best")
    p.add_argument("--split", default="test")
    p.add_argument("--encoder", default="tiny",
                   help="tiny | codebert-base (roberta) | codet5-base (t5)")
    p.add_argument("--tokenizer", default=None,
                   help="dir with *vocab.json + *merges.txt (byte-level BPE; default: hash)")
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--limit", type=int, default=None)
    # combined_setup's training-only knobs at their defaults
    p.set_defaults(sp_variant="ring", attn_impl="auto", remat_policy="full")
    common(p)
    p.set_defaults(fn=cmd_localize)

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

    def serve_common(p):
        p.add_argument("--family", default="deepdfa", choices=["deepdfa", "combined", "t5"])
        p.add_argument("--smoke", action="store_true",
                       help="a tiny run trained first, under the storage root (tests)")
        # no positional overrides: score's positionals are its sources
        p.add_argument("--config", default=None, help="json config file")
        p.add_argument("--override", action="append", default=[], dest="overrides",
                       help="dotted key=value config override (repeatable)")
        p.add_argument("--device", default=None,
                       help="cuda (default) or cpu (the plain PyTorch path)")

    p = sub.add_parser("score", help="score C source files/dirs against a run's checkpoint "
                                     "through the serving path")
    p.add_argument("sources", nargs="*", help="C source files or directories")
    p.add_argument("--out", default=None, help="scores jsonl path (default <run>/scores.jsonl)")
    serve_common(p)
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("scan", help="whole-repo incremental scan through the serving stack: "
                                    "findings JSONL + SARIF 2.1.0, content-keyed re-scans")
    p.add_argument("repo", nargs="?", default=None, help="repository root to scan")
    p.add_argument("--out", default=None,
                   help="findings jsonl path (default <run>/scan/findings.jsonl)")
    p.add_argument("--sarif", default=None,
                   help="SARIF 2.1.0 path (default <run>/scan/findings.sarif)")
    p.add_argument("--lines", action="store_true",
                   help="per-finding line attributions (scan.lines)")
    p.add_argument("--no-incremental", action="store_true",
                   help="ignore the scan manifest (still written): score every function cold")
    p.add_argument("--family", default="deepdfa", choices=["deepdfa"])
    p.add_argument("--smoke", action="store_true",
                   help="a tiny run, a synthetic repo, cold and incremental scans (tests)")
    # no positional overrides: the optional repo positional would take them
    p.add_argument("--config", default=None, help="json config file")
    p.add_argument("--override", action="append", default=[], dest="overrides",
                   help="dotted key=value config override (repeatable)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain PyTorch path)")
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("serve", help="HTTP /score /healthz /stats over the dynamic batcher")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471, help="0 picks a free port")
    serve_common(p)
    p.set_defaults(fn=cmd_serve)
    return parser


def main(argv: list[str] | None = None) -> None:
    from deepdfa_tpu_torch.train.resilience import EXIT_PREEMPTED, Preempted

    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except Preempted as e:
        # a clean preemption exit: the in-flight step finished, the state
        # and its resume manifest are on disk, and re-running the same
        # command resumes where this one stopped
        print(f"preempted: {e}")
        if e.manifest is not None:
            print(f"resume manifest: {e.manifest} (re-run to resume)")
        raise SystemExit(EXIT_PREEMPTED)


if __name__ == "__main__":
    main(sys.argv[1:])
