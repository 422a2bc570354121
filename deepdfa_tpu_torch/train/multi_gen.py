"""Multi-task seq2seq training (the reference's
`deepdfa_tpu/train/multi_gen.py`, CodeT5's `run_multi_gen.py`), host
Python over one `GenTrainer`:

- every step draws a task with probability proportional to |task|^0.7
  (`mixture_probs`) from `np.random.default_rng(seed)`, so a seed gives
  the reference's task order, and takes one batch of that task's stream,
  which restarts with the next epoch index when it runs out (`_cycled`);
- at every eval interval each live task computes dev perplexity (and
  BLEU/EM with `val_decode`) and saves its best-ppl / best-BLEU
  checkpoints; a task stops when both its counters exceed its patience
  (per family: summarize 2, translate 5, refine 5, concode 3, defect 2);
  more than 50 draws in a row of stopped tasks end the run, as does every
  evaluated task stopping;
- step s drops with `fold_seed(seed, s)`;
- the `train.debug_nans`/`train.enable_checks` sanitizers run the loop
  under core/sanitize.py's checks. As in the reference, the loop takes no
  resilient runtime and no obs instruments, and refuses them when
  configured (`core/config.py:refuse_unported_training`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core import sanitize
from deepdfa_tpu_torch.core.config import refuse_unported_training
from deepdfa_tpu_torch.data.gen_data import GenBatch
from deepdfa_tpu_torch.nn.dropout import fold_seed
from deepdfa_tpu_torch.train.gen_loop import GenTrainer, model_state
from deepdfa_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

#: per-family early-stop patience (run_multi_gen.py:253-266)
TASK_PATIENCE = {"summarize": 2, "translate": 5, "refine": 5, "concode": 3, "defect": 2}

#: consecutive draws of stopped tasks before the whole run ends (:285)
_STOP_DRAWS = 50


def task_target_length(name: str, default: int = 128) -> int:
    """Per-family decode length (run_multi_gen.py:52-67); task names are
    "<family>_<subtask>"."""
    family = name.split("_")[0]
    sub = name.split("_")[-1]
    return {
        "summarize": 128,
        "translate": 256,
        "refine": 120 if sub == "small" else 240,
        "concode": 150,
        "defect": 3,
    }.get(family, default)


@dataclasses.dataclass
class GenTask:
    """One task of the mixture: `train_batches(epoch)` yields a pass of
    host GenBatches, `size` (the example count) sets its weight."""

    name: str
    train_batches: Callable[[int], Iterable[GenBatch]]
    size: int
    val_batches: Callable[[], Iterable[GenBatch]] | None = None
    val_decode: tuple[np.ndarray, Sequence[Sequence[int]]] | None = None
    patience: int | None = None  # default: TASK_PATIENCE by the name's family

    def resolved_patience(self) -> int:
        if self.patience is not None:
            return self.patience
        return TASK_PATIENCE.get(self.name.split("_")[0], 2)


def mixture_probs(sizes: Sequence[int], alpha: float = 0.7) -> np.ndarray:
    """Normalise the sizes, raise to alpha, normalise again."""
    p = np.asarray(sizes, np.float64)
    p = p / p.sum()
    p = p**alpha
    return p / p.sum()


def _cycled(task: GenTask) -> Iterator[GenBatch]:
    epoch = 0
    while True:
        got = False
        for batch in task.train_batches(epoch):
            got = True
            yield batch
        if not got:
            raise ValueError(f"task {task.name!r} produced no batches")
        epoch += 1


@dataclasses.dataclass
class _TaskBook:
    """One task's early-stop bookkeeping."""

    best_ppl: float = float("inf")
    best_bleu_em: float = -1.0
    not_ppl_dec: int = 0
    not_bleu_inc: float = 0  # stays inf when BLEU is not evaluated
    stopped: bool = False
    stopped_at: int | None = None


def fit_multi(
    trainer: GenTrainer,
    state: TrainState,
    tasks: Sequence[GenTask],
    max_steps: int,
    eval_every: int | None = None,
    checkpoints: Callable[[str, str, str], object] | None = None,
    seed: int = 0,
    log_fn: Callable[[dict], None] | None = None,
) -> tuple[TrainState, dict[str, dict]]:
    """Train one model over the task mixture; (state, per-task summary).
    `checkpoints(task_name, monitor, mode)` makes a CheckpointManager,
    called once per task for its best-ppl (and best-BLEU) checkpoints;
    `eval_every` defaults to an eighth of the tasks' total size."""
    refuse_unported_training(trainer.cfg)
    if not tasks:
        raise ValueError("fit_multi needs at least one task")
    names = [t.name for t in tasks]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate task names: {names}")
    probs = mixture_probs([t.size for t in tasks])
    streams = {t.name: _cycled(t) for t in tasks}
    books = {t.name: _TaskBook() for t in tasks}
    for t in tasks:
        if t.val_decode is None:
            books[t.name].not_bleu_inc = float("inf")
    ppl_ckpt: dict[str, object] = {}
    bleu_ckpt: dict[str, object] = {}
    if eval_every is None:
        eval_every = max(1, sum(max(1, t.size) for t in tasks) // 8)

    rng = np.random.default_rng(seed)
    step = state.step
    t0 = time.perf_counter()
    losses: list = []
    skip_draws = 0
    tcfg = trainer.cfg.train
    with sanitize.nan_checks(state.model, tcfg.debug_nans), \
            sanitize.launch_checks(tcfg.enable_checks):
        while step < max_steps:
            task = tasks[int(rng.choice(len(tasks), p=probs))]
            book = books[task.name]
            if book.stopped:
                skip_draws += 1
                if skip_draws > _STOP_DRAWS:
                    logger.info("all tasks early-stopped at step %d", step)
                    break
                continue
            skip_draws = 0
            batch = next(streams[task.name]).to(trainer.device)
            losses.append(trainer.train_step(state, batch, fold_seed(seed, step)))
            step += 1
            if step % eval_every and step < max_steps:
                continue

            record: dict = {
                "step": step,
                "train_loss": float(np.mean(torch.stack(losses).cpu().numpy())),
                "window_seconds": time.perf_counter() - t0,
            }
            losses, t0 = [], time.perf_counter()
            for t in tasks:
                b = books[t.name]
                if b.stopped or t.val_batches is None:
                    continue
                ppl = trainer.eval_ppl(state, t.val_batches())
                record[f"{t.name}/val_ppl"] = ppl
                if ppl < b.best_ppl:
                    b.best_ppl, b.not_ppl_dec = ppl, 0
                    if checkpoints is not None:
                        if t.name not in ppl_ckpt:
                            ppl_ckpt[t.name] = checkpoints(t.name, "val_ppl", "min")
                        ppl_ckpt[t.name].save(f"step-{step:07d}", model_state(state.model),
                                              {"val_ppl": ppl}, step=step)
                else:
                    b.not_ppl_dec += 1
                if t.val_decode is not None:
                    src, refs = t.val_decode
                    scores = trainer.eval_bleu_em(state, src, refs)
                    record[f"{t.name}/val_bleu_em"] = scores["bleu_em"]
                    if scores["bleu_em"] > b.best_bleu_em:
                        b.best_bleu_em, b.not_bleu_inc = scores["bleu_em"], 0
                        if checkpoints is not None:
                            if t.name not in bleu_ckpt:
                                bleu_ckpt[t.name] = checkpoints(t.name + "-bleu", "val_bleu_em",
                                                                "max")
                            bleu_ckpt[t.name].save(f"step-{step:07d}", model_state(state.model),
                                                   {"val_bleu_em": scores["bleu_em"]}, step=step)
                    else:
                        b.not_bleu_inc += 1
                patience = t.resolved_patience()
                if patience and b.not_ppl_dec > patience and b.not_bleu_inc > patience:
                    b.stopped, b.stopped_at = True, step
                    logger.info("task %s early-stopped at step %d (ppl counter %d, bleu "
                                "counter %s)", t.name, step, b.not_ppl_dec, b.not_bleu_inc)
            logger.info("step %d: %s", step, record)
            if log_fn is not None:
                log_fn(record)
            evaluated = [t for t in tasks if t.val_batches is not None]
            if evaluated and all(books[t.name].stopped for t in evaluated):
                logger.info("every evaluated task early-stopped; ending run")
                break

    summary = {
        name: {
            "best_ppl": None if np.isinf(b.best_ppl) else b.best_ppl,
            "best_bleu_em": None if b.best_bleu_em < 0 else b.best_bleu_em,
            "stopped_at": b.stopped_at,
        }
        for name, b in books.items()
    }
    return state, summary
