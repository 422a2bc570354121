"""Training and evaluation of graph classifiers on one device (the
reference's `deepdfa_tpu/train/loop.py:GraphTrainer`).

- A train step is the masked loss SUM over the batch's valid slots
  divided by max(valid count, 1), its backward (on a CUDA device: the
  GGNN step kernel with its aggregate, then the backward kernels B3 and
  B4 in reverse, nn/ggnn_kernel.py), and one optimiser update.
- Evaluation accumulates an exact masked mean of the per-example loss
  in float64 on the host, and the classification metrics (under the
  dataflow_solution_* styles over every valid node's bits, the
  reference's masked [N, max_defs] arrays flattened).
- `fit` runs epochs through the prefetch pipeline (data/prefetch.py):
  `train.prefetch_batches` batches are packed and copied to the card by
  `train.prefetch_producers` background threads ahead of the step (a
  pure reordering in time: the losses are the inline loop's bits, which
  `prefetch_batches=0` runs), evaluates every `eval_every_epochs`,
  checkpoints on the reference's cadence and hands each record (with
  the pipeline's load, pack, place and wait seconds) to `log_fn`.
- The runtime hooks (the reference's `fit`, `:284-499`): with a
  `ResilientRunner` (`train.resilience.enabled`) each step is
  `train_step_guarded` (the on-device divergence guard,
  train/state.py), the runner reads its ok flag lagged, checkpoints
  every `step_checkpoint_every` steps, resumes (fast-forwarding the
  stream) and rolls back, and a heartbeat feeds its watchdog; the obs
  instruments (`obs.instruments`) wrap each step in a trace span, book
  the first step of each batch signature as a ledger site and time the
  rest with CUDA events; `train.debug_nans` and `train.enable_checks`
  run the fit under core/sanitize.py's checks. With all of them off the
  loop is the plain one.

Not in the port yet, and refused when configured: data parallelism or
any mesh beyond one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Iterable

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import Config, refuse_unported_training
from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.data.prefetch import DevicePlacer, PipelineStats, prefetch
from deepdfa_tpu_torch.graphs.batch import NUM_SUBKEY_FEATS, GraphBatch
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.losses import (
    bce_elements,
    check_label_style,
    labels_and_mask,
)
from deepdfa_tpu_torch.train.metrics import BinaryClassificationMetrics
from deepdfa_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)


def drop_known_feats(node_feats: torch.Tensor, generator: torch.Generator,
                     rate: float) -> torch.Tensor:
    """Feature-identity dropout: with probability `rate` per node, map
    every known vocab bucket (index >= 2) down to UNKNOWN (1), keeping
    the 0 pattern; structural columns past the four subkeys are never
    touched. The draws come from `generator` (on the features' device),
    so they differ from the reference's jax.random stream."""
    drop = torch.rand(node_feats.shape[0], generator=generator,
                      device=node_feats.device) < rate
    if node_feats.ndim == 1:
        return torch.where(drop, node_feats.clamp(max=1), node_feats)
    dropped = torch.where(drop[:, None], node_feats.clamp(max=1), node_feats)
    if node_feats.shape[1] > NUM_SUBKEY_FEATS:
        dropped = torch.cat([dropped[:, :NUM_SUBKEY_FEATS],
                             node_feats[:, NUM_SUBKEY_FEATS:]], dim=1)
    return dropped


class GraphTrainer:
    """Train/eval loop for models taking a GraphBatch and emitting
    logits, on one device (the card unless `device="cpu"`)."""

    def __init__(
        self,
        model: torch.nn.Module,
        cfg: Config,
        pos_weight: float | None = None,
        total_steps: int | None = None,
        device: str | torch.device | None = None,
    ):
        tcfg = cfg.train
        refuse_unported_training(cfg, runtime_hooks=True)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if pos_weight is None:
            pos_weight = tcfg.pos_weight if tcfg.pos_weight is not None else 1.0
        self.pos_weight = float(pos_weight)
        self.total_steps = total_steps
        self.label_style = check_label_style(getattr(model, "label_style", "graph"))
        self.feat_dropout = float(tcfg.feat_unknown_dropout)

    # -- construction -------------------------------------------------------

    def init_state(self, seed: int | None = None,
                   params: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh TrainState: the model's weights drawn from `seed`
        (train.seed by default), or loaded from `params` (a state dict,
        e.g. models/convert.py's from Flax parameters)."""
        if params is not None:
            self.model.load_state_dict(params, strict=True)
        else:
            # drawn on the CPU, so one seed gives the same weights on
            # every device
            seed = self.cfg.train.seed if seed is None else seed
            self.model.to("cpu").reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        return TrainState.create(self.model, self.cfg.train.optim, self.total_steps)

    def make_checkpoints(self, directory) -> CheckpointManager:
        """CheckpointManager wired to the configured monitor metric."""
        return CheckpointManager(
            directory, monitor=self.cfg.train.monitor,
            mode=self.cfg.train.monitor_mode,
            keep_last=self.cfg.train.checkpoint_keep_last,
        )

    # -- steps ---------------------------------------------------------------

    def _feat_dropout(self, batch: GraphBatch, step: int) -> GraphBatch:
        """Deterministic per step: the generator is seeded from
        (train.seed + 7919, step), so no RNG state lives in TrainState."""
        seed = int(np.random.SeedSequence([self.cfg.train.seed + 7919, step])
                   .generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return dataclasses.replace(
            batch, node_feats=drop_known_feats(batch.node_feats, gen, self.feat_dropout))

    def loss_sum(self, batch: GraphBatch):
        """(masked sum of per-example losses, valid count)."""
        logits = self.model(batch)
        labels, mask = labels_and_mask(batch, self.label_style)
        per = bce_elements(logits, labels, self.pos_weight)
        m = mask.to(per.dtype)
        return (per * m).sum(), m.sum()

    def forward_loss(self, state: TrainState, batch: GraphBatch) -> torch.Tensor:
        """The step's loss, sum / max(count, 1), with the graph for its
        backward (gradients of the sum over the same denominator)."""
        if self.feat_dropout > 0:
            batch = self._feat_dropout(batch, state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum, count = self.loss_sum(batch)
        return loss_sum / count.clamp(min=1.0)

    def train_step(self, state: TrainState, batch: GraphBatch) -> torch.Tensor:
        """One update on a batch already on the device; the loss,
        detached and left on the device."""
        self.model.train()
        loss = self.forward_loss(state, batch)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    def train_step_guarded(self, state: TrainState, batch: GraphBatch,
                           lr_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
        """`train_step` under the divergence guard: (loss, ok), both left
        on the device; a non-finite loss or gradient leaves the state as
        it was (TrainState.apply_gradients_guarded)."""
        self.model.train()
        loss = self.forward_loss(state, batch)
        loss.backward()
        ok = state.apply_gradients_guarded(loss, lr_scale)
        return loss.detach(), ok

    def step_signature(self, batch: GraphBatch) -> str:
        """The ledger's site of a training batch: G{graphs}xN{N}xE{E}."""
        return (f"G{batch.num_graphs}xN{batch.node_feats.shape[0]}"
                f"xE{batch.edge_src.shape[-1]}")

    @torch.inference_mode()
    def eval_step(self, batch: GraphBatch):
        """(probs, labels, mask, per-example loss) of a device batch."""
        self.model.eval()
        logits = self.model(batch)
        labels, mask = labels_and_mask(batch, self.label_style)
        per = bce_elements(logits, labels, self.pos_weight)
        return torch.sigmoid(logits), labels, mask, per

    # -- loops ---------------------------------------------------------------

    def evaluate(self, batches: Iterable[GraphBatch]
                 ) -> tuple[dict[str, float], BinaryClassificationMetrics]:
        m = BinaryClassificationMetrics()
        loss_sum = 0.0
        count = 0.0
        for batch in batches:
            probs, labels, mask, per = (
                x.cpu().numpy() for x in self.eval_step(batch.to(self.device))
            )
            m.update(probs, labels, mask)
            valid = np.asarray(mask, bool)
            loss_sum += float(np.asarray(per, np.float64)[valid].sum())
            count += float(valid.sum())
        metrics = m.compute()
        metrics["loss"] = loss_sum / count if count else float("nan")
        return metrics, m

    def fit(
        self,
        state: TrainState,
        train_batches: Callable[[int], Iterable[GraphBatch]],
        val_batches: Callable[[], Iterable[GraphBatch]] | None = None,
        checkpoints: CheckpointManager | None = None,
        max_epochs: int | None = None,
        log_fn: Callable[[dict], None] | None = None,
        source_stage: str = "pack",
        resilience=None,
    ) -> TrainState:
        from deepdfa_tpu_torch import obs
        from deepdfa_tpu_torch.core import sanitize
        from deepdfa_tpu_torch.train.resilience import ResumeCursor, finite_mean, skip_first

        tcfg = self.cfg.train
        max_epochs = max_epochs if max_epochs is not None else tcfg.max_epochs
        inst = obs.instruments(self.cfg, self.device)
        res = resilience
        guard = res is not None and res.guard_active
        start_epoch = skip_batches = 0
        cursor = res.maybe_resume(state) if res is not None else None
        if cursor is not None:
            start_epoch, skip_batches = cursor.epoch, cursor.batch_index
        placer = DevicePlacer(self.device)
        with contextlib.ExitStack() as hooks:
            if res is not None:
                hooks.enter_context(res)
            hooks.enter_context(sanitize.nan_checks(self.model, tcfg.debug_nans))
            hooks.enter_context(sanitize.launch_checks(tcfg.enable_checks))
            for epoch in range(start_epoch, max_epochs):
                t0 = time.perf_counter()
                losses = []
                stats = PipelineStats()
                if res is not None:
                    res.attach_stats(stats)
                source = train_batches(epoch)
                # a source may know which stage its pulls are (cli.BatchStream:
                # "load" on a warm cache epoch, "pack" on a cold one)
                stage = getattr(source, "source_stage", source_stage)
                batch_index = 0
                if epoch == start_epoch and skip_batches:
                    # the resume fast-forward, before the pipeline: the
                    # stream is a pure function of (epoch, seed, data)
                    source = skip_first(source, skip_batches, heartbeat=lambda: res.heartbeat(
                        "input", epoch=epoch, step=state.step))
                    batch_index = skip_batches
                stream = prefetch(source, tcfg.prefetch_batches, placer,
                                  producers=tcfg.prefetch_producers, stats=stats,
                                  source_stage=stage)
                try:
                    it = iter(stream)
                    while True:
                        if res is not None:
                            res.heartbeat("input", epoch=epoch, step=state.step)
                        try:
                            item = next(it)
                        except StopIteration:
                            break
                        batch = placer.receive(item)
                        if res is not None:
                            res.heartbeat("device", epoch=epoch, step=state.step)
                        ok = None
                        if guard:
                            loss, ok = inst.run_step(
                                state.step, "train_step", self.step_signature(batch),
                                lambda: self.train_step_guarded(state, batch, res.lr_scale()))
                        else:
                            loss = inst.run_step(state.step, "train_step",
                                                 self.step_signature(batch),
                                                 lambda: self.train_step(state, batch))
                        losses.append(loss)
                        batch_index += 1
                        if log_fn is not None and state.step % max(1, tcfg.log_every_steps) == 0:
                            log_fn({"step": state.step, "loss": float(losses[-1])})
                        # after the step's own logging: a preemption here
                        # raises, and the step it finished stays logged
                        if res is not None:
                            res.after_step(state, ok, ResumeCursor(epoch, batch_index,
                                                                   state.step))
                finally:
                    stream.close()  # joins the producers on any exit
                if losses:
                    values = torch.stack(losses).cpu().numpy()
                    # guarded runs: a skipped step's poisoned loss stays in the
                    # per-step log, not in the epoch's mean
                    train_loss = finite_mean(values) if guard else float(np.mean(values))
                else:
                    train_loss = float("nan")
                epoch_seconds = time.perf_counter() - t0
                record = {
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "epoch_seconds": epoch_seconds,
                    # host stage attribution: load/pack = the source, place =
                    # the host-to-device copy, wait = the step starved of input
                    "host_load_seconds": round(stats.load_seconds, 3),
                    "host_pack_seconds": round(stats.pack_seconds, 3),
                    "host_place_seconds": round(stats.place_seconds, 3),
                    "input_wait_seconds": round(stats.wait_seconds, 3),
                    "input_wait_fraction": round(stats.wait_fraction(epoch_seconds), 4),
                }
                if res is not None:
                    record.update(res.record())
                inst.observe_pipeline(stats)
                inst.finish_epoch(record)
                if val_batches is not None and (
                    (epoch + 1) % tcfg.eval_every_epochs == 0 or epoch == max_epochs - 1
                ):
                    if res is not None:
                        res.heartbeat("eval", epoch=epoch)
                    val_metrics, _ = self.evaluate(val_batches())
                    record.update({f"val_{k}": v for k, v in val_metrics.items()})
                if checkpoints is not None and (
                    any(k.startswith("val_") for k in record)
                    or (epoch + 1) % max(1, tcfg.checkpoint_every_epochs) == 0
                    or epoch == max_epochs - 1
                ):
                    if res is not None:
                        res.heartbeat("checkpoint", epoch=epoch)
                    checkpoints.save(
                        f"epoch-{epoch:04d}",
                        {"model": {k: v.detach().cpu() for k, v in self.model.state_dict().items()}},
                        {k: float(v) for k, v in record.items()
                         if k != "epoch" and isinstance(v, (int, float))},
                        step=state.step,
                    )
                logger.info("epoch %d: %s", epoch, record)
                if log_fn is not None:
                    log_fn(record)
            if res is not None:
                # drain lagged guard flags + leave a final resume point
                res.finish(state, ResumeCursor(max_epochs, 0, state.step))
        return state
