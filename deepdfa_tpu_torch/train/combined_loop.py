"""Training of the combined transformer + graph classifiers on one device
(the reference's `deepdfa_tpu/train/combined_loop.py:CombinedTrainer`):
the RoBERTa family (`CombinedConfig` -> `CombinedModel`, DeepDFA+LineVul)
and the T5 family (`DefectConfig` -> `DefectModel`, CodeT5+DeepDFA), as
the reference's `is_t5` switch picks `defect_forward` (`:123-128,
278-290`).

- A train step is the cross-entropy SUM over the batch's valid rows
  divided by max(valid count, 1), its backward and one optimiser update
  (AdamW with the reference's warmup/decay schedule and global-norm
  clip, `train/state.py`). On a CUDA device each encoder layer's
  attention is kernel 5 forward (with its probs dropout on the RoBERTa
  family, with the relative-position bias on the T5 family) and kernels
  6 and 7 backward, plus kernel 8 (dbias) on the T5 family, replayed
  under the layer checkpoint (`remat`); the graph branch runs the GGNN
  step kernel and its backward kernels.
- Dropout: step s draws its masks from the seed `fold_seed(seed, s)`
  (the reference folds the step into its root key): the encoder's and
  head's sites at the model config's rates, with any seed a different
  but equally distributed stream from the reference's.
- With the MoE adapter (`moe_experts > 0`) the loss sum takes the
  reference's load-balancing term, moe_aux_weight * aux * valid rows
  (`_loss_sum`, `:327-331`), so the per-row normalization leaves its
  weight constant across batch sizes.
- `freeze_graph` (the reference's `--freeze_graph`): the graph branch
  takes no gradient, no update and no weight decay (`train/transfer.py`).
- Evaluation accumulates the exact masked mean of the per-row loss in
  float64 on the host, and the classification metrics on p(class 1).
- `fit` runs epochs through the prefetch pipeline (data/prefetch.py,
  `train.prefetch_batches` ahead, 0 = inline, the same losses either
  way): each batch is collated on the host and copied to the device
  once by a producer thread, `train_step` runs, and the epoch record
  (loss, the pipeline's host seconds, real-token throughput, padding
  waste, the per-signature step counts) goes to `log_fn`; validation
  each epoch;
  checkpoints on the reference's cadence, the best by `train.monitor`.
  With `data.seq_buckets` set, `fit` first builds the kernels and runs
  one forward and backward per bucket signature on an all-padding batch
  (no update), outside every epoch's time: the counterpart of the
  reference's ahead-of-time `warmup` compile.

The runtime hooks, as `train/loop.py:GraphTrainer.fit` runs them (the
reference's `fit`, `:687`): with a `ResilientRunner` each step is
`train_step_guarded` (the on-device divergence guard), with the
runner's lagged ok read, step checkpoints, resume, rollback and
watchdog heartbeats; the obs instruments book the first step of each
batch signature "T{T}xR{rows}xG{graphs}" as a ledger site (counted in
the activations' type) and time the rest with CUDA events; the
sanitizers run the fit under core/sanitize.py's checks. A batch the
fault injector poisoned (`testing/faults.py:PoisonedTextBatch`: the
text batches have no float input to poison) has its loss multiplied by
NaN on the device.

Not in the port yet, and refused when configured: a mesh beyond one
card (an `ep` mesh among them: the reference's refusals of one without
MoE, or with an expert count it does not divide, come first, as
ValueError). `train.step_cache_entries` is read past.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Iterable

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import Config, refuse_unported_training
from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.data.prefetch import DevicePlacer, PipelineStats, prefetch
from deepdfa_tpu_torch.data.text import TextBatch, batch_token_counts, collate, rows_for_bucket
from deepdfa_tpu_torch.models.combined import CombinedConfig, CombinedModel
from deepdfa_tpu_torch.models.t5 import DefectConfig, DefectModel
from deepdfa_tpu_torch.nn import cuda_build
from deepdfa_tpu_torch.nn.dropout import fold_seed
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.losses import masked_softmax_cross_entropy, softmax_cross_entropy
from deepdfa_tpu_torch.train.metrics import BinaryClassificationMetrics
from deepdfa_tpu_torch.train.state import TrainState
from deepdfa_tpu_torch.train.transfer import freeze, load_graph_encoder

logger = logging.getLogger(__name__)


class CombinedTrainer:
    """Train/eval loop for `CombinedModel` (a `CombinedConfig`) or
    `DefectModel` (a `DefectConfig`) on one device (the card unless
    `device="cpu"`)."""

    def __init__(self, cfg: Config, model_cfg: CombinedConfig | DefectConfig,
                 total_steps: int | None = None, freeze_graph: bool = False,
                 device: str | torch.device | None = None):
        if not isinstance(model_cfg, (CombinedConfig, DefectConfig)):
            raise TypeError(f"{type(model_cfg).__name__}: the trainer takes a CombinedConfig "
                            "(RoBERTa family) or a DefectConfig (T5 family)")
        self.moe = bool(getattr(model_cfg, "moe_experts", 0))
        ep = cfg.train.mesh.ep
        if ep > 1 and not self.moe:
            raise ValueError("an ep>1 mesh needs an MoE block to shard (set model moe_experts)")
        if self.moe and model_cfg.moe_experts % ep:
            raise ValueError(f"{model_cfg.moe_experts} experts not divisible by ep={ep}")
        refuse_unported_training(cfg, runtime_hooks=True)
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.total_steps = total_steps
        self.freeze_graph = freeze_graph
        self.device = resolve_device(device)
        self.pad_id = model_cfg.encoder.pad_token_id
        #: per batch signature "T{T}xR{rows}xG{graphs}": train and eval
        #: steps, and the seconds of its warm-up batch
        self.signature_stats: dict[str, dict] = {}

    # -- construction -------------------------------------------------------

    def init_state(self, seed: int | None = None,
                   params: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh TrainState: the model's weights drawn on the CPU from
        `seed` (train.seed by default), so one seed gives the same
        weights on every device, or loaded from `params` (a state dict,
        e.g. models/convert.py's from the reference's parameters)."""
        seed = self.cfg.train.seed if seed is None else seed
        family = DefectModel if isinstance(self.model_cfg, DefectConfig) else CombinedModel
        model = family(self.model_cfg, generator=torch.Generator().manual_seed(seed))
        if params is not None:
            model.load_state_dict(params, strict=True)
        return self._state(model.to(self.device), step=0)

    def _state(self, model: CombinedModel | DefectModel, step: int) -> TrainState:
        if self.freeze_graph:
            freeze(model)
        state = TrainState.create(model, self.cfg.train.optim, self.total_steps,
                                  params=[p for p in model.parameters() if p.requires_grad])
        state.step = step
        return state

    def load_graph_encoder_params(self, state: TrainState, deepdfa_state) -> TrainState:
        """Splice a trained DeepDFA's encoder weights (a state dict) into
        the graph branch; the optimiser starts afresh, as the reference's
        `tx.init` does."""
        load_graph_encoder(state.model, deepdfa_state)
        return self._state(state.model, step=state.step)

    def load_encoder(self, state: TrainState, encoder_params) -> TrainState:
        """Load pretrained encoder weights (a `RobertaEncoder` or
        `T5Encoder` state dict, e.g. `params_from_hf_torch`'s) into the
        text branch; a pooler in them is dropped (the combined head never
        uses it) and the optimiser starts afresh, as the reference's
        `load_encoder` does."""
        sd = {k: v for k, v in encoder_params.items() if not k.startswith("pooler_")}
        state.model.encoder.load_state_dict(sd, strict=True)
        return self._state(state.model, step=state.step)

    def make_checkpoints(self, directory) -> CheckpointManager:
        return CheckpointManager(directory, monitor=self.cfg.train.monitor,
                                 mode=self.cfg.train.monitor_mode,
                                 keep_last=self.cfg.train.checkpoint_keep_last)

    # -- steps ---------------------------------------------------------------

    @staticmethod
    def signature(batch: TextBatch) -> str:
        T, rows = batch.input_ids.shape[-1], batch.input_ids.shape[-2]
        return f"T{int(T)}xR{int(rows)}xG{int(batch.graphs.num_graphs)}"

    def _stats(self, batch: TextBatch) -> dict:
        return self.signature_stats.setdefault(
            self.signature(batch),
            {"train_steps": 0, "eval_steps": 0, "warmup_seconds": 0.0})

    def forward_loss(self, state: TrainState, batch: TextBatch, seed: int | None) -> torch.Tensor:
        """The step's loss, sum / max(count, 1), with the graph for its
        backward; `seed` is the step's dropout seed (None: no dropout)."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if self.moe:
            logits, aux = state.model(batch.input_ids, batch.graphs, batch.has_graph,
                                      dropout_key=seed, with_aux=True)
        else:
            logits = state.model(batch.input_ids, batch.graphs, batch.has_graph,
                                 dropout_key=seed)
        loss_sum, count = masked_softmax_cross_entropy(logits, batch.labels, batch.row_mask)
        if self.moe:
            loss_sum = loss_sum + self.model_cfg.moe_aux_weight * aux * count
        loss = loss_sum / count.clamp(min=1.0)
        if getattr(batch, "poisoned", False):
            loss = loss * float("nan")
        return loss

    def train_step(self, state: TrainState, batch: TextBatch, seed: int | None) -> torch.Tensor:
        """One update on a batch already on the device; the loss,
        detached and left on the device."""
        loss = self.forward_loss(state, batch, seed)
        loss.backward()
        state.apply_gradients()
        self._stats(batch)["train_steps"] += 1
        return loss.detach()

    def train_step_guarded(self, state: TrainState, batch: TextBatch, seed: int | None,
                           lr_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
        """`train_step` under the divergence guard: (loss, ok), both left
        on the device; a non-finite loss or gradient leaves the state as
        it was (TrainState.apply_gradients_guarded)."""
        loss = self.forward_loss(state, batch, seed)
        loss.backward()
        ok = state.apply_gradients_guarded(loss, lr_scale)
        self._stats(batch)["train_steps"] += 1
        return loss.detach(), ok

    def aten_precision(self) -> str:
        """The type the aten products of a step run in (the ledger's MFU
        ceiling for them): the encoder's activations."""
        dtype = str(getattr(self.model_cfg.encoder, "dtype", "float32"))
        return "bf16" if "bfloat16" in dtype else "fp32"

    @torch.inference_mode()
    def eval_step(self, state: TrainState, batch: TextBatch):
        """(p(class 1), labels, row mask, per-row loss) of a device batch."""
        state.model.eval()
        logits = state.model(batch.input_ids, batch.graphs, batch.has_graph)
        per = softmax_cross_entropy(logits, batch.labels)
        self._stats(batch)["eval_steps"] += 1
        return torch.softmax(logits.float(), dim=-1)[:, 1], batch.labels, batch.row_mask, per

    def warmup(self, state: TrainState) -> dict:
        """Build the kernels and run one forward and backward per bucket
        of `data.seq_buckets` on an all-padding batch (rows from
        `rows_for_bucket`, the planner's formula; the data.batch
        budgets), with dropout on and no update. Returns {signature:
        seconds}."""
        dcfg = self.cfg.data
        if not dcfg.seq_buckets:
            return {}
        if self.device.type == "cuda":
            cuda_build.build()
        report = {}
        for T in dcfg.seq_buckets:
            rows = rows_for_bucket(T, dcfg.token_budget, 1)
            dummy = collate(np.zeros((0, int(T)), np.int32), [], [], {}, rows,
                            dcfg.batch.node_budget, dcfg.batch.edge_budget,
                            pad_id=self.pad_id).to(self.device)
            t0 = time.perf_counter()
            self.forward_loss(state, dummy, fold_seed(0, int(T))).backward()
            state.optimizer.zero_grad(set_to_none=True)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self._stats(dummy)["warmup_seconds"] += dt
            report[self.signature(dummy)] = dt
        return report

    # -- loops ---------------------------------------------------------------

    def evaluate(self, state: TrainState, batches: Iterable[TextBatch]
                 ) -> tuple[dict[str, float], BinaryClassificationMetrics]:
        m = BinaryClassificationMetrics()
        loss_sum = 0.0
        count = 0.0
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
        train_batches: Callable[[int], Iterable[TextBatch]],
        val_batches: Callable[[], Iterable[TextBatch]] | None = None,
        checkpoints: CheckpointManager | None = None,
        max_epochs: int | None = None,
        log_fn: Callable[[dict], None] | None = None,
        seed: int = 0,
        source_stage: str = "pack",
        resilience=None,
    ) -> TrainState:
        """Epochs over `train_batches(epoch)` (host TextBatches); step s
        drops with `fold_seed(seed, s)`."""
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
        warm = self.warmup(state)
        if warm and log_fn is not None:
            log_fn({"warmup_signatures": len(warm),
                    "warmup_seconds": round(sum(warm.values()), 3)})
        placer = DevicePlacer(self.device)
        precision = self.aten_precision()
        with contextlib.ExitStack() as hooks:
            if res is not None:
                hooks.enter_context(res)
            hooks.enter_context(sanitize.nan_checks(state.model, tcfg.debug_nans))
            hooks.enter_context(sanitize.launch_checks(tcfg.enable_checks))
            for epoch in range(start_epoch, max_epochs):
                t0 = time.perf_counter()
                losses = []
                stats = PipelineStats()
                if res is not None:
                    res.attach_stats(stats)

                def place(batch: TextBatch):
                    # token accounting on the host arrays, before the copy
                    stats.add_tokens(*batch_token_counts(batch.input_ids, batch.row_mask,
                                                         self.pad_id))
                    return placer(batch)

                source = train_batches(epoch)
                stage = getattr(source, "source_stage", source_stage)
                batch_index = 0
                if epoch == start_epoch and skip_batches:
                    source = skip_first(source, skip_batches, heartbeat=lambda: res.heartbeat(
                        "input", epoch=epoch, step=state.step))
                    batch_index = skip_batches
                stream = prefetch(source, tcfg.prefetch_batches, place,
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
                        step_seed = fold_seed(seed, state.step)
                        ok = None
                        if guard:
                            loss, ok = inst.run_step(
                                state.step, "train_step", self.signature(batch),
                                lambda: self.train_step_guarded(state, batch, step_seed,
                                                                res.lr_scale()),
                                precision)
                        else:
                            loss = inst.run_step(
                                state.step, "train_step", self.signature(batch),
                                lambda: self.train_step(state, batch, step_seed), precision)
                        losses.append(loss)
                        batch_index += 1
                        if log_fn is not None and state.step % max(1, tcfg.log_every_steps) == 0:
                            log_fn({"step": state.step, "loss": float(losses[-1])})
                        if res is not None:
                            res.after_step(state, ok, ResumeCursor(epoch, batch_index,
                                                                   state.step))
                finally:
                    stream.close()  # joins the producers on any exit
                if losses:
                    values = torch.stack(losses).cpu().numpy()
                    train_loss = finite_mean(values) if guard else float(np.mean(values))
                else:
                    train_loss = float("nan")
                epoch_seconds = time.perf_counter() - t0
                real, padded, rows = stats.real_tokens, stats.padded_tokens, stats.rows
                record = {
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "epoch_seconds": epoch_seconds,
                    "host_load_seconds": round(stats.load_seconds, 3),
                    "host_pack_seconds": round(stats.pack_seconds, 3),
                    "host_place_seconds": round(stats.place_seconds, 3),
                    "input_wait_seconds": round(stats.wait_seconds, 3),
                    "input_wait_fraction": round(stats.wait_fraction(epoch_seconds), 4),
                    "train_examples_per_sec": rows / epoch_seconds if epoch_seconds else None,
                    "train_tokens_per_sec": real / epoch_seconds if epoch_seconds else None,
                    "real_tokens": real,
                    "padded_tokens": padded,
                    "padding_waste": round(stats.padding_waste(), 4),
                    "step_signatures": {k: dict(v) for k, v in self.signature_stats.items()},
                }
                if res is not None:
                    record.update(res.record())
                inst.observe_pipeline(stats)
                inst.finish_epoch(record)
                if val_batches is not None:
                    if res is not None:
                        res.heartbeat("eval", epoch=epoch)
                    val_metrics, _ = self.evaluate(state, val_batches())
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
                        {"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}},
                        {k: float(v) for k, v in record.items()
                         if k != "epoch" and isinstance(v, (int, float))},
                        step=state.step,
                    )
                logger.info("epoch %d: %s", epoch, record)
                if log_fn is not None:
                    log_fn(record)
            if res is not None:
                res.finish(state, ResumeCursor(max_epochs, 0, state.step))
        return state
