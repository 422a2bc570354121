"""Training of the seq2seq generation tasks on one device (the reference's
`deepdfa_tpu/train/gen_loop.py:GenTrainer`, CodeT5's `run_gen.py`).

- A train step is the token-weighted cross-entropy: the CE sum over the
  target tokens that are not padding, in rows that are real, divided by
  max(that count, 1) (`:99-114`), its backward and one optimiser update
  (AdamW with the reference's warmup/decay schedule and global-norm
  clip, `train/state.py`). On a CUDA device each encoder layer's
  attention is kernel 5 with the bidirectional bias and kernels 6-8
  backward; each decoder layer's self-attention is the causal instances
  of kernels 5-8 with the unidirectional bias and its cross-attention
  the rectangular kernels 5-7; every layer is replayed under remat.
- Dropout: step s draws its masks from `fold_seed(seed, s)`, a different
  but equally distributed stream from the reference's keys; s is the host
  step (the data cursor's), which a guard-skipped step advances too.
- `eval_ppl` is exp of the token-weighted mean CE over a set of batches;
  `decode` runs `beam_search` over chunks of 16 sources (the last chunk
  padded with pad rows, as the reference pads it) and trims at EOS;
  `eval_bleu_em` scores the decoded token ids against the references
  with `corpus_bleu` and exact match, both in percent.
- `fit` runs epochs of a plain host loop, evaluates dev perplexity (and
  BLEU/EM with `val_decode`) each epoch, saves the best-ppl checkpoint to
  `checkpoints` and the best-BLEU+EM one to `bleu_checkpoints`, and stops
  early only when both the ppl counter and the BLEU counter exceed
  `patience` (`run_gen.py:398-405`; the BLEU counter is infinite without
  `val_decode`).

The runtime hooks, as the reference's `fit` runs them (`:265-441`): with
a `ResilientRunner` each step is `train_step_guarded` (the on-device
divergence guard, `TrainState.apply_gradients_guarded`, no host sync),
with the runner's lagged ok read, step checkpoints, resume (the stream
fast-forwarded past the consumed batches), rollback and watchdog
heartbeats (input, device, eval); the obs instruments book the first
step of each batch signature "S{source}xT{target}xR{rows}" as a ledger
site (its FLOPs counted through the flash kernels' work formulas,
obs/cost.py) and time the rest with CUDA events; the sanitizers
(`train.debug_nans`, `train.enable_checks`) run the fit under
core/sanitize.py's checks. A batch the fault injector poisoned
(`testing/faults.py:PoisonedGenBatch`: a generation batch has no float
input to poison) has its loss multiplied by NaN on the device.

Not in the port yet, and refused when configured: a mesh beyond one
card (`core/config.py:refuse_unported_training`).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import Config, refuse_unported_training
from deepdfa_tpu_torch.core.device import resolve_device
from deepdfa_tpu_torch.data.gen_data import GenBatch
from deepdfa_tpu_torch.eval.codebleu import corpus_bleu
from deepdfa_tpu_torch.models import t5_gen as gen
from deepdfa_tpu_torch.nn.dropout import fold_seed
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager
from deepdfa_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

#: sources per beam-search call of `decode` (the reference's batch_rows)
DECODE_ROWS = 16


def model_state(model: torch.nn.Module) -> dict:
    """What a checkpoint holds: the model's state dict on the CPU."""
    return {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


class GenTrainer:
    """Train/eval loop of a `T5Seq2Seq` (a `GenConfig`) on one device (the
    card unless `device="cpu"`). Evaluation takes a state or a model."""

    def __init__(self, cfg: Config, gen_cfg: gen.GenConfig, total_steps: int | None = None,
                 device: str | torch.device | None = None):
        refuse_unported_training(cfg, runtime_hooks=True)
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        self.total_steps = total_steps
        self.device = resolve_device(device)
        self.pad_id = gen_cfg.encoder.pad_token_id

    def make_checkpoints(self, directory, monitor: str = "val_ppl",
                         mode: str = "min") -> CheckpointManager:
        return CheckpointManager(directory, monitor=monitor, mode=mode,
                                 keep_last=self.cfg.train.checkpoint_keep_last)

    def init_state(self, seed: int | None = None,
                   params: dict[str, torch.Tensor] | None = None) -> TrainState:
        """A fresh TrainState: weights drawn on the CPU from `seed`
        (train.seed by default), so one seed gives the same weights on
        every device, or loaded from `params` (a state dict, e.g.
        `from_jax_gen_params` of the reference's parameters)."""
        seed = self.cfg.train.seed if seed is None else seed
        model = gen.T5Seq2Seq(self.gen_cfg, generator=torch.Generator().manual_seed(seed))
        if params is not None:
            model.load_state_dict(params, strict=True)
        return TrainState.create(model.to(self.device), self.cfg.train.optim, self.total_steps)

    def load_params(self, state: TrainState, params: dict[str, torch.Tensor]) -> TrainState:
        """`params` loaded into the model; the optimiser starts afresh and
        the step count stays, as the reference's `load_params` does. An
        untied `decoder.lm_head` in them (a Hugging Face checkpoint with
        tie_word_embeddings off) gets a model with its own head, and a
        tied state dict one without, as the reference's tree decides."""
        model = state.model
        untied = "decoder.lm_head" in params
        if untied != (model.decoder.lm_head is not None):
            model = gen.T5Seq2Seq(self.gen_cfg, untied_head=untied).to(self.device)
        model.load_state_dict(params, strict=True)
        new = TrainState.create(model, self.cfg.train.optim, self.total_steps)
        new.step = state.step
        return new

    # -- steps ---------------------------------------------------------------

    def token_loss(self, model: gen.T5Seq2Seq, batch: GenBatch,
                   seed: int | None) -> tuple[torch.Tensor, torch.Tensor]:
        """(CE sum over the valid target tokens, their count)."""
        logits = gen.seq2seq_logits(model, batch.source_ids, batch.target_ids, seed)
        mask = ((batch.target_ids != self.pad_id) & batch.row_mask[:, None]).float()
        return (gen.token_ce(logits, batch.target_ids) * mask).sum(), mask.sum()

    def forward_loss(self, state: TrainState, batch: GenBatch, seed: int | None) -> torch.Tensor:
        """The step's loss with the graph for its backward; `seed` is the
        step's dropout seed (None: no dropout)."""
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum, count = self.token_loss(state.model, batch, seed)
        loss = loss_sum / count.clamp(min=1.0)
        if getattr(batch, "poisoned", False):
            loss = loss * float("nan")
        return loss

    def train_step(self, state: TrainState, batch: GenBatch, seed: int | None) -> torch.Tensor:
        """One update on a batch already on the device; the loss,
        detached and left on the device."""
        loss = self.forward_loss(state, batch, seed)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    def train_step_guarded(self, state: TrainState, batch: GenBatch, seed: int | None,
                           lr_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
        """`train_step` under the divergence guard (the reference's
        `train_step_guarded`, `:152-158`): (loss, ok), both left on the
        device; a non-finite loss or gradient leaves the state as it was
        (TrainState.apply_gradients_guarded)."""
        loss = self.forward_loss(state, batch, seed)
        loss.backward()
        ok = state.apply_gradients_guarded(loss, lr_scale)
        return loss.detach(), ok

    @staticmethod
    def signature(batch: GenBatch) -> str:
        """The ledger site of a step: source and target lengths, rows."""
        rows, S = batch.source_ids.shape
        return f"S{int(S)}xT{int(batch.target_ids.shape[1])}xR{int(rows)}"

    def aten_precision(self) -> str:
        """The type the aten products of a step run in (the ledger's MFU
        ceiling for them): the model's activations."""
        return "bf16" if "bfloat16" in str(self.gen_cfg.encoder.dtype) else "fp32"

    @torch.inference_mode()
    def eval_step(self, state_or_model, batch: GenBatch) -> torch.Tensor:
        """[CE sum, token count] of a device batch."""
        model = getattr(state_or_model, "model", state_or_model)
        model.eval()
        return torch.stack(self.token_loss(model, batch, None))

    # -- evaluation ----------------------------------------------------------

    def eval_ppl(self, state_or_model, batches: Iterable[GenBatch]) -> float:
        """Token-weighted dev perplexity (`run_gen.py:eval_ppl_epoch`)."""
        s = c = 0.0
        for batch in batches:
            sc = self.eval_step(state_or_model, batch.to(self.device)).cpu().numpy()
            s += float(sc[0])
            c += float(sc[1])
        return float(np.exp(s / max(c, 1.0)))

    def decode(self, state_or_model, source_ids: np.ndarray, beam_size: int | None = None,
               max_length: int | None = None, batch_rows: int = DECODE_ROWS) -> list[list[int]]:
        """Beam-search decode of [n, S] source ids -> trimmed token lists."""
        model = getattr(state_or_model, "model", state_or_model)
        model.eval()
        ecfg = self.gen_cfg.encoder
        out: list[list[int]] = []
        for i in range(0, source_ids.shape[0], batch_rows):
            chunk = np.asarray(source_ids[i:i + batch_rows])
            pad_rows = batch_rows - chunk.shape[0]
            if pad_rows:
                chunk = np.concatenate(
                    [chunk, np.full((pad_rows, chunk.shape[1]), self.pad_id, chunk.dtype)])
            src = torch.from_numpy(chunk.astype(np.int64)).to(self.device)
            ids = gen.beam_search(model, src, beam_size=beam_size, max_length=max_length)
            out.extend(gen.trim_at_eos(ids[:batch_rows - pad_rows].cpu().numpy(),
                                       eos_id=ecfg.eos_token_id, pad_id=ecfg.pad_token_id))
        return out

    def eval_bleu_em(self, state_or_model, source_ids: np.ndarray,
                     target_token_lists: Sequence[Sequence[int]], beam_size: int | None = None,
                     return_preds: bool = False) -> dict:
        """Dev BLEU and exact match on token sequences, in percent
        (`run_gen.py:eval_bleu_epoch`)."""
        preds = self.decode(state_or_model, source_ids, beam_size=beam_size)
        refs = [list(map(int, t)) for t in target_token_lists]
        em = float(np.mean([p == r for p, r in zip(preds, refs)])) * 100.0
        bleu = corpus_bleu([[list(map(str, r))] for r in refs],
                           [list(map(str, p)) for p in preds]) * 100.0
        out = {"bleu": bleu, "em": em, "bleu_em": bleu + em}
        if return_preds:
            out["preds"] = preds
        return out

    # -- fit -----------------------------------------------------------------

    def fit(
        self,
        state: TrainState,
        train_batches: Callable[[int], Iterable[GenBatch]],
        val_batches: Callable[[], Iterable[GenBatch]] | None = None,
        val_decode: tuple[np.ndarray, Sequence[Sequence[int]]] | None = None,
        checkpoints: CheckpointManager | None = None,
        bleu_checkpoints: CheckpointManager | None = None,
        max_epochs: int | None = None,
        patience: int | None = None,
        log_fn: Callable[[dict], None] | None = None,
        seed: int = 0,
        resilience=None,
    ) -> TrainState:
        """Epochs over `train_batches(epoch)` (host GenBatches); step s
        drops with `fold_seed(seed, s)`. `val_decode` is (source ids,
        target token lists) for dev BLEU/EM. `resilience`: a
        `ResilientRunner` (train/resilience.py); a mid-epoch resume
        restores the exact state and fast-forwards the (seeded) stream,
        and the best-ppl/BLEU early-stop counters restart at the resumed
        epoch, as the reference's do."""
        from deepdfa_tpu_torch import obs
        from deepdfa_tpu_torch.core import sanitize
        from deepdfa_tpu_torch.train.resilience import ResumeCursor, finite_mean, skip_first

        tcfg = self.cfg.train
        max_epochs = max_epochs if max_epochs is not None else tcfg.max_epochs
        patience = patience or 0
        inst = obs.instruments(self.cfg, self.device)
        res = resilience
        guard = res is not None and res.guard_active
        start_epoch = skip_batches = 0
        cursor = res.maybe_resume(state) if res is not None else None
        if cursor is not None:
            start_epoch, skip_batches = cursor.epoch, cursor.batch_index
        precision = self.aten_precision()
        best_ppl, best_bleu_em = float("inf"), -1.0
        not_ppl_dec = 0
        not_bleu_inc = 0 if val_decode is not None else float("inf")
        with contextlib.ExitStack() as hooks:
            if res is not None:
                hooks.enter_context(res)
            hooks.enter_context(sanitize.nan_checks(state.model, tcfg.debug_nans))
            hooks.enter_context(sanitize.launch_checks(tcfg.enable_checks))
            for epoch in range(start_epoch, max_epochs):
                t0 = time.perf_counter()
                losses = []
                tokens = 0
                source = train_batches(epoch)
                batch_index = 0
                if epoch == start_epoch and skip_batches:
                    # deterministic fast-forward (the shuffle is seeded by
                    # epoch), a beat per skipped pull
                    source = skip_first(source, skip_batches, heartbeat=lambda: res.heartbeat(
                        "input", epoch=epoch, step=state.step))
                    batch_index = skip_batches
                it = iter(source)
                while True:
                    if res is not None:
                        res.heartbeat("input", epoch=epoch, step=state.step)
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    tokens += int(((np.asarray(batch.target_ids) != self.pad_id)
                                   & np.asarray(batch.row_mask)[:, None]).sum())
                    batch = batch.to(self.device)
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
                    if res is not None:
                        res.after_step(state, ok, ResumeCursor(epoch, batch_index, state.step))
                seconds = time.perf_counter() - t0
                if losses:
                    # guarded runs leave a skipped step's poisoned loss out
                    values = torch.stack(losses).cpu().numpy()
                    train_loss = finite_mean(values) if guard else float(np.mean(values))
                else:
                    train_loss = float("nan")
                record = {
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "epoch_seconds": seconds,
                    "train_target_tokens_per_sec": tokens / seconds if seconds else None,
                }
                if res is not None:
                    record.update(res.record())
                    # the epoch-end stages (perplexity, decoding, saves) run
                    # under the watchdog's grace threshold
                    res.heartbeat("eval", epoch=epoch)
                inst.finish_epoch(record)
                if val_batches is not None:
                    ppl = self.eval_ppl(state, val_batches())
                    record["val_ppl"] = ppl
                    if ppl < best_ppl:
                        best_ppl, not_ppl_dec = ppl, 0
                        if checkpoints is not None:
                            checkpoints.save(f"epoch-{epoch:04d}", model_state(state.model),
                                             {"val_ppl": ppl}, step=state.step)
                    else:
                        not_ppl_dec += 1
                elif checkpoints is not None and (
                    (epoch + 1) % max(1, tcfg.checkpoint_every_epochs) == 0
                    or epoch == max_epochs - 1
                ):
                    checkpoints.save(f"epoch-{epoch:04d}", model_state(state.model), {},
                                     step=state.step)
                if val_decode is not None:
                    src, refs = val_decode
                    bleu = self.eval_bleu_em(state, src, refs)
                    record.update({f"val_{k}": v for k, v in bleu.items()})
                    if bleu["bleu_em"] > best_bleu_em:
                        best_bleu_em, not_bleu_inc = bleu["bleu_em"], 0
                        if bleu_checkpoints is not None:
                            bleu_checkpoints.save(f"epoch-{epoch:04d}",
                                                  model_state(state.model),
                                                  {"val_bleu_em": bleu["bleu_em"]},
                                                  step=state.step)
                    else:
                        not_bleu_inc += 1
                logger.info("epoch %d: %s", epoch, record)
                if log_fn is not None:
                    log_fn(record)
                if patience and not_ppl_dec > patience and not_bleu_inc > patience:
                    logger.info("early stop: ppl counter %d, bleu counter %s > patience %d",
                                not_ppl_dec, not_bleu_inc, patience)
                    break
            if res is not None:
                res.finish(state, ResumeCursor(max_epochs, 0, state.step))
        return state
