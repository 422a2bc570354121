"""Training and evaluation of graph classifiers on one device (the
reference's `deepdfa_tpu/train/loop.py:GraphTrainer`).

- A train step is the masked loss SUM over the batch's valid slots
  divided by max(valid count, 1), its backward (on a CUDA device: the
  GGNN step kernel with its aggregate, then the backward kernels B3 and
  B4 in reverse, nn/ggnn_kernel.py), and one optimiser update.
- Evaluation accumulates an exact masked mean of the per-example loss
  in float64 on the host, and the classification metrics.
- `fit` runs epochs of a plain host loop (each batch is packed on the
  host and copied to the device once), evaluates every
  `eval_every_epochs`, checkpoints on the reference's cadence and hands
  each record to `log_fn`.

Not in the port yet, and refused when configured: data parallelism or
any mesh beyond one card, `train.resilience.enabled` (the guarded step,
step checkpoints, resume), the obs instruments and the prefetch
pipeline.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Iterable

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import Config, one_card
from deepdfa_tpu_torch.core.device import resolve_device
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
        one_card(tcfg.mesh)
        if tcfg.resilience.enabled:
            raise NotImplementedError(
                "train.resilience.enabled: the resilient runtime (guarded "
                "step, step checkpoints, resume) comes with a later slice "
                "of the port (ROADMAP queue A)"
            )
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
    ) -> TrainState:
        tcfg = self.cfg.train
        max_epochs = max_epochs if max_epochs is not None else tcfg.max_epochs
        for epoch in range(max_epochs):
            t0 = time.perf_counter()
            losses = []
            pack_s = place_s = 0.0
            source = iter(train_batches(epoch))
            while True:
                t_pull = time.perf_counter()
                batch = next(source, None)
                if batch is None:
                    break
                t_place = time.perf_counter()
                batch = batch.to(self.device)
                pack_s += t_place - t_pull
                place_s += time.perf_counter() - t_place
                losses.append(self.train_step(state, batch))
                if log_fn is not None and state.step % max(1, tcfg.log_every_steps) == 0:
                    log_fn({"step": state.step, "loss": float(losses[-1])})
            train_loss = (float(np.mean(torch.stack(losses).cpu().numpy()))
                          if losses else float("nan"))
            record = {
                "epoch": epoch,
                "train_loss": train_loss,
                "epoch_seconds": time.perf_counter() - t0,
                "host_pack_seconds": round(pack_s, 3),
                "host_place_seconds": round(place_s, 3),
            }
            if val_batches is not None and (
                (epoch + 1) % tcfg.eval_every_epochs == 0 or epoch == max_epochs - 1
            ):
                val_metrics, _ = self.evaluate(val_batches())
                record.update({f"val_{k}": v for k, v in val_metrics.items()})
            if checkpoints is not None and (
                any(k.startswith("val_") for k in record)
                or (epoch + 1) % max(1, tcfg.checkpoint_every_epochs) == 0
                or epoch == max_epochs - 1
            ):
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
        return state
