"""Train state and optimiser construction (the reference's
`deepdfa_tpu/train/state.py`, in torch.optim terms).

- adamw -> torch.optim.AdamW (eps 1e-8): decoupled decay on every
  parameter, biases and embedding tables included, as `optax.adamw`
  with no mask does;
- adam -> torch.optim.Adam; sgd -> torch.optim.SGD (no momentum, as
  `optax.sgd`);
- warmup_frac > 0: optax's linear warmup 0 -> lr then linear decay
  lr -> 0 as a LambdaLR with the same boundaries, evaluated at the
  count of updates already applied (the first update uses lr * 0);
- grad_clip_norm > 0: `clip_grad_norm_` before each update (optax
  clips by the global norm too; torch adds 1e-6 to the norm).
"""

from __future__ import annotations

import dataclasses

import torch

from deepdfa_tpu_torch.core.config import OptimConfig


def lr_factor(cfg: OptimConfig, total_steps: int | None):
    """The schedule as a multiple of cfg.learning_rate, a function of
    the number of updates applied so far; None when it is constant."""
    if cfg.warmup_frac <= 0.0:
        return None
    if not total_steps:
        raise ValueError("warmup_frac requires total_steps")
    warmup = max(1, int(total_steps * cfg.warmup_frac))
    decay = max(1, total_steps - warmup)

    def factor(count: int) -> float:
        if count < warmup:
            return min(max(count / warmup, 0.0), 1.0)
        return 1.0 - min(max((count - warmup) / decay, 0.0), 1.0)

    return factor


def make_optimizer(cfg: OptimConfig, params, total_steps: int | None = None):
    """(optimizer, scheduler or None) for `params`."""
    params = list(params)
    if cfg.name == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(cfg.b1, cfg.b2),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    elif cfg.name == "adam":
        opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(cfg.b1, cfg.b2), eps=1e-8)
    elif cfg.name == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.learning_rate)
    else:
        raise ValueError(f"unknown optimizer {cfg.name}")
    factor = lr_factor(cfg, total_steps)
    sched = None if factor is None else torch.optim.lr_scheduler.LambdaLR(opt, factor)
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimiser, the schedule and the
    count of updates applied."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None
    grad_clip_norm: float = 0.0
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, cfg: OptimConfig,
               total_steps: int | None = None, params=None) -> "TrainState":
        """`params`: the parameters to update (all of the model's by
        default); the others get no update, no decay and no share of the
        clip's norm."""
        params = list(model.parameters() if params is None else params)
        opt, sched = make_optimizer(cfg, params, total_steps)
        return cls(model, opt, sched, cfg.grad_clip_norm)

    def apply_gradients(self) -> None:
        """One update from the gradients held in the parameters' .grad."""
        if self.grad_clip_norm > 0.0:
            params = [p for group in self.optimizer.param_groups for p in group["params"]]
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
