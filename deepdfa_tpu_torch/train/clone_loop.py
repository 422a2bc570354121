"""Training of pairwise clone detection on one device (the reference's
`deepdfa_tpu/train/clone_loop.py:CloneTrainer`, CodeT5's `run_clone.py`):
two-class cross-entropy over code pairs, the sum over real rows divided
by max(their count, 1); per-epoch dev metrics (`train/metrics.py`); a
checkpoint each evaluated epoch, the best by dev F1; early stop when F1
has not risen for more than `patience` epochs. Step s drops with
`fold_seed(seed, s)`. On a CUDA device each code runs the seq2seq stack
with its flash kernels, the decoder's causal ones among them (`dec_mask`
= the source mask). The options `refuse_unported_training` names are
refused, as in the other trainers.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from deepdfa_tpu_torch.core.config import Config, refuse_unported_training
from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.data.gen_data import one_shard, to_tensor
from deepdfa_tpu_torch.models import t5_gen as gen
from deepdfa_tpu_torch.nn.dropout import fold_seed
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.gen_loop import model_state
from deepdfa_tpu_torch.train.metrics import BinaryClassificationMetrics
from deepdfa_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CloneBatch:
    pair_ids: Any  # [B, 2, T] int32
    labels: Any  # [B] int32
    row_mask: Any  # [B] bool

    def to(self, device: str | torch.device) -> "CloneBatch":
        dev = torch.device(device)
        return CloneBatch(to_tensor(self.pair_ids, dev), to_tensor(self.labels, dev),
                          to_tensor(self.row_mask, dev))


def collate_clone(pair_ids: np.ndarray, labels: Sequence[int], batch_rows: int,
                  pad_id: int = 0) -> CloneBatch:
    n = pair_ids.shape[0]
    if n > batch_rows:
        raise ValueError(f"{n} rows > batch_rows {batch_rows}")
    ids = np.full((batch_rows,) + pair_ids.shape[1:], pad_id, np.int32)
    lab = np.zeros((batch_rows,), np.int32)
    mask = np.zeros((batch_rows,), bool)
    ids[:n] = pair_ids
    lab[:n] = np.asarray(labels)
    mask[:n] = True
    return CloneBatch(pair_ids=ids, labels=lab, row_mask=mask)


def clone_batches_of(pair_ids: np.ndarray, labels: Sequence[int], num_shards: int,
                     rows_per_shard: int, pad_id: int = 0,
                     shuffle_seed: int | None = None) -> list[CloneBatch]:
    """One epoch of CloneBatches (the reference's order for a seed)."""
    one_shard(num_shards)
    n = pair_ids.shape[0]
    order = np.arange(n)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    labels = np.asarray(labels)
    return [collate_clone(pair_ids[order[i:i + rows_per_shard]],
                          labels[order[i:i + rows_per_shard]], rows_per_shard, pad_id)
            for i in range(0, n, rows_per_shard)]


class CloneTrainer:
    """Train/eval loop of a `CloneModel` (a `CloneConfig`) on one device."""

    def __init__(self, cfg: Config, clone_cfg: gen.CloneConfig, total_steps: int | None = None,
                 device: str | torch.device | None = None):
        refuse_unported_training(cfg)
        self.cfg = cfg
        self.clone_cfg = clone_cfg
        self.total_steps = total_steps
        self.device = resolve_device(device)

    def make_checkpoints(self, directory, monitor: str = "val_f1",
                         mode: str = "max") -> CheckpointManager:
        return CheckpointManager(directory, monitor=monitor, mode=mode)

    def init_state(self, seed: int | None = None,
                   params: dict[str, torch.Tensor] | None = None) -> TrainState:
        """Weights drawn on the CPU from `seed` (train.seed by default), or
        loaded from `params` (e.g. `from_jax_clone_params`)."""
        seed = self.cfg.train.seed if seed is None else seed
        model = gen.CloneModel(self.clone_cfg, generator=torch.Generator().manual_seed(seed))
        if params is not None:
            model.load_state_dict(params, strict=True)
        return TrainState.create(model.to(self.device), self.cfg.train.optim, self.total_steps)

    def _fresh(self, state: TrainState) -> TrainState:
        new = TrainState.create(state.model, self.cfg.train.optim, self.total_steps)
        new.step = state.step
        return new

    def load_params(self, state: TrainState, params: dict[str, torch.Tensor]) -> TrainState:
        state.model.load_state_dict(params, strict=True)
        return self._fresh(state)

    def load_seq2seq(self, state: TrainState, gen_params: dict[str, torch.Tensor]) -> TrainState:
        """Warm-start the encoder-decoder from a `T5Seq2Seq` state dict (a
        generation checkpoint); an LM head in it is dropped (the clone
        path never uses one); the optimiser starts afresh."""
        sd = {k: v for k, v in gen_params.items() if k != "decoder.lm_head"}
        state.model.seq2seq.load_state_dict(sd, strict=True)
        return self._fresh(state)

    # -- steps ---------------------------------------------------------------

    def forward_loss(self, state: TrainState, batch: CloneBatch, seed: int | None):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = gen.clone_forward(state.model, batch.pair_ids, dropout_key=seed)
        per = F.cross_entropy(logits.float(), batch.labels.long(), reduction="none")
        m = batch.row_mask.float()
        return (per * m).sum() / m.sum().clamp(min=1.0)

    def train_step(self, state: TrainState, batch: CloneBatch, seed: int | None) -> torch.Tensor:
        loss = self.forward_loss(state, batch, seed)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    @torch.inference_mode()
    def eval_step(self, state: TrainState, batch: CloneBatch):
        """(p(clone), labels, row mask, per-row loss) of a device batch."""
        state.model.eval()
        logits = gen.clone_forward(state.model, batch.pair_ids).float()
        per = F.cross_entropy(logits, batch.labels.long(), reduction="none")
        return torch.softmax(logits, dim=-1)[:, 1], batch.labels, batch.row_mask, per

    def evaluate(self, state: TrainState, batches: Iterable[CloneBatch]):
        m = BinaryClassificationMetrics()
        loss_sum = count = 0.0
        for batch in batches:
            probs, labels, mask, per = (
                x.cpu().numpy() for x in self.eval_step(state, batch.to(self.device)))
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
        train_batches: Callable[[int], Iterable[CloneBatch]],
        val_batches: Callable[[], Iterable[CloneBatch]] | None = None,
        checkpoints: CheckpointManager | None = None,
        max_epochs: int | None = None,
        patience: int | None = None,
        log_fn: Callable[[dict], None] | None = None,
        seed: int = 0,
    ) -> TrainState:
        tcfg = self.cfg.train
        max_epochs = max_epochs if max_epochs is not None else tcfg.max_epochs
        best_f1, not_inc = -1.0, 0
        for epoch in range(max_epochs):
            t0 = time.perf_counter()
            losses = [self.train_step(state, batch.to(self.device), fold_seed(seed, state.step))
                      for batch in train_batches(epoch)]
            record = {
                "epoch": epoch,
                "train_loss": (float(np.mean(torch.stack(losses).cpu().numpy()))
                               if losses else float("nan")),
                "epoch_seconds": time.perf_counter() - t0,
            }
            if val_batches is not None:
                metrics, _ = self.evaluate(state, val_batches())
                record.update({f"val_{k}": v for k, v in metrics.items()})
                f1 = metrics.get("f1", 0.0)
                if f1 > best_f1:
                    best_f1, not_inc = f1, 0
                else:
                    not_inc += 1
            if checkpoints is not None and (
                any(k.startswith("val_") for k in record)
                or (epoch + 1) % max(1, tcfg.checkpoint_every_epochs) == 0
                or epoch == max_epochs - 1
            ):
                checkpoints.save(f"epoch-{epoch:04d}", model_state(state.model),
                                 {k: float(v) for k, v in record.items()
                                  if isinstance(v, (int, float)) and k != "epoch"},
                                 step=state.step)
            logger.info("epoch %d: %s", epoch, record)
            if log_fn is not None:
                log_fn(record)
            if patience and not_inc > patience:
                logger.info("early stop: F1 stagnant for %d epochs", not_inc)
                break
        return state
