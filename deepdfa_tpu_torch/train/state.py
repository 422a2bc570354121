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

`TrainState.apply_gradients_guarded` is the resilient runtime's
divergence-guarded update (the reference's
`train/resilience.py:apply_guarded_update`): the loss's and the
gradients' global norm's finiteness is an `ok` flag ON THE DEVICE, and a
poisoned step leaves the parameters, the moments, the update counts and
with them the schedule's count exactly as they were, with no host sync.
`torch.optim` keeps its counts on the host and updates in place, so
the guarded update does the optimiser's arithmetic itself, on the state
`torch.optim` keeps (`optimizer.state[p]`: "step", "exp_avg",
"exp_avg_sq", one layout for both paths), with the counts as device
tensors and the schedule evaluated on the device from them; a bad step
turns every coefficient into the identity (grads zeroed, decay 1, step
size 0). `state_dict`/`load_state_dict` capture and restore all of it.
"""

from __future__ import annotations

import dataclasses

import torch

from deepdfa_tpu_torch.core.config import OptimConfig


def schedule_bounds(cfg: OptimConfig, total_steps: int | None) -> tuple[int, int] | None:
    """(warmup, decay) updates of the schedule; None when it is constant."""
    if cfg.warmup_frac <= 0.0:
        return None
    if not total_steps:
        raise ValueError("warmup_frac requires total_steps")
    warmup = max(1, int(total_steps * cfg.warmup_frac))
    return warmup, max(1, total_steps - warmup)


def lr_factor(cfg: OptimConfig, total_steps: int | None):
    """The schedule as a multiple of cfg.learning_rate, a function of
    the number of updates applied so far; None when it is constant."""
    bounds = schedule_bounds(cfg, total_steps)
    if bounds is None:
        return None
    warmup, decay = bounds

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
    #: the optimiser's name and the schedule's (warmup, decay) updates,
    #: for the guarded update
    optim_name: str = "adamw"
    schedule: tuple[int, int] | None = None

    @classmethod
    def create(cls, model: torch.nn.Module, cfg: OptimConfig,
               total_steps: int | None = None, params=None) -> "TrainState":
        """`params`: the parameters to update (all of the model's by
        default); the others get no update, no decay and no share of the
        clip's norm."""
        params = list(model.parameters() if params is None else params)
        opt, sched = make_optimizer(cfg, params, total_steps)
        return cls(model, opt, sched, cfg.grad_clip_norm, optim_name=cfg.name,
                   schedule=schedule_bounds(cfg, total_steps))

    def apply_gradients(self) -> None:
        """One update from the gradients held in the parameters' .grad."""
        if self.grad_clip_norm > 0.0:
            params = [p for group in self.optimizer.param_groups for p in group["params"]]
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1

    # -- the divergence-guarded update -----------------------------------------

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _device_state(self, p: torch.Tensor) -> dict:
        """optimizer.state[p] with its count on p's device (a restore
        leaves it on the CPU, where torch.optim keeps it)."""
        st = self.optimizer.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            if self.optim_name in ("adamw", "adam"):
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        elif st["step"].device != p.device:
            st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
        return st

    @torch.no_grad()
    def apply_gradients_guarded(self, loss: torch.Tensor, lr_scale: float = 1.0) -> torch.Tensor:
        """One update from the gradients held in the parameters' .grad,
        skipped ON THE DEVICE when the loss or the gradients' global norm
        is not finite; returns the 0-d bool `ok` flag, on the device. The
        host step count advances either way (it is the data cursor's);
        the optimiser's counts, and with them the schedule's, advance
        only with `ok`. `lr_scale` multiplies the update (decay included)
        as the reference's rollback cool-down does. No host sync."""
        params = [p for p in self._params() if p.grad is not None]
        self.step += 1
        if not params:
            return torch.isfinite(loss.detach())
        grads = [p.grad for p in params]
        total = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        ok = torch.isfinite(loss.detach()) & torch.isfinite(total)
        okf = ok.to(torch.float32)
        for g in grads:
            torch.where(ok, g, torch.zeros_like(g), out=g)
        if self.grad_clip_norm > 0.0:
            # clip_grad_norm_'s coefficient, from the norm of a good step
            coef = self.grad_clip_norm / (torch.where(ok, total, torch.zeros_like(total)) + 1e-6)
            torch._foreach_mul_(grads, torch.clamp(coef, max=1.0))
        states = [self._device_state(p) for p in params]
        count = states[0]["step"]
        for group in self.optimizer.param_groups:
            members = [i for i, p in enumerate(params)
                       if any(p is q for q in group["params"])]
            if members:
                self._guarded_group(group, [params[i] for i in members],
                                    [grads[i] for i in members], [states[i] for i in members],
                                    count, okf, lr_scale)
        # a list of addends: foreach add of one tensor reads it on the host
        steps = [st["step"] for st in states]
        torch._foreach_add_(steps, [okf] * len(steps))
        return ok

    def _guarded_group(self, group: dict, params, grads, states, count, okf,
                       lr_scale: float) -> None:
        base = group.get("initial_lr", group["lr"])
        lr = okf * (float(base) * float(lr_scale))
        if self.schedule is not None:
            warmup, decay = self.schedule
            factor = torch.where(count < warmup, (count / warmup).clamp(0.0, 1.0),
                                 1.0 - ((count - warmup) / decay).clamp(0.0, 1.0))
            lr = lr * factor
        if self.optim_name == "sgd":
            torch._foreach_add_(params, torch._foreach_mul(grads, -lr))
            return
        beta1, beta2 = group["betas"]
        c = torch.clamp(count + okf, min=1.0)
        bc1 = 1.0 - torch.pow(beta1, c)
        bc2 = 1.0 - torch.pow(beta2, c)
        if self.optim_name == "adamw" and group["weight_decay"]:
            torch._foreach_mul_(params, 1.0 - lr * group["weight_decay"])
        m = [st["exp_avg"] for st in states]
        v = [st["exp_avg_sq"] for st in states]
        # a bad step's grads are zero: m * 1 + 0 and v * 1 + 0 exactly
        torch._foreach_mul_(m, torch.where(okf > 0, beta1, 1.0))
        torch._foreach_add_(m, grads, alpha=1.0 - beta1)
        torch._foreach_mul_(v, torch.where(okf > 0, beta2, 1.0))
        torch._foreach_addcmul_(v, grads, grads, 1.0 - beta2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_div_(denom, bc2.sqrt())
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(m, denom)
        torch._foreach_mul_(upd, -lr / bc1)
        torch._foreach_add_(params, upd)

    # -- capture and restore (the resilient runtime's step checkpoints) --------

    def update_count(self) -> int:
        """Updates applied so far (the optimiser's count; a host sync
        when it lives on the device)."""
        for p in self._params():
            st = self.optimizer.state.get(p)
            if st and "step" in st:
                return int(st["step"])
        return 0

    def state_dict(self) -> dict:
        """Host copies of everything the next update reads: the model's
        weights, the optimiser's moments and counts, the schedule's count
        and the host step count."""

        def host(x):
            if isinstance(x, torch.Tensor):
                return x.detach().to("cpu", copy=True)
            if isinstance(x, dict):
                return {k: host(v) for k, v in x.items()}
            if isinstance(x, list):
                return [host(v) for v in x]
            return x

        count = self.update_count()
        return {"model": {k: v.detach().to("cpu", copy=True)
                          for k, v in self.model.state_dict().items()},
                "optimizer": host(self.optimizer.state_dict()),
                "schedule_count": count, "step": int(self.step)}

    def load_state_dict(self, d: dict) -> None:
        """Restore `state_dict`'s capture into this state in place."""
        self.model.load_state_dict(d["model"], strict=True)
        self.optimizer.load_state_dict(d["optimizer"])
        if self.scheduler is not None:
            count = int(d["schedule_count"])
            self.scheduler.last_epoch = count
            for group, base, fn in zip(self.optimizer.param_groups, self.scheduler.base_lrs,
                                       self.scheduler.lr_lambdas):
                group["lr"] = base * fn(count)
            self.scheduler._last_lr = [g["lr"] for g in self.optimizer.param_groups]
        self.step = int(d["step"])
