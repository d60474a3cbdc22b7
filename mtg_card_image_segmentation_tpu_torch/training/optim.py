"""Optimizer + LR-schedule factories (counterpart of the JAX package's
``training/optim.py``, which builds them with optax).

Schedules are plain ``step -> lr`` functions with optax's formulas: cosine
annealing to ``lr * min_lr_ratio`` over the run (optionally after a linear
warmup from 0), SGDR-style cosine restarts (first cycle ``num_epochs //
restart_div`` epochs, times ``restart_mult`` each restart), or a constant
(optionally after a linear warmup). A warmup is clamped to half the run.

The optimizer is AdamW (optax's defaults: b1 0.9, b2 0.999, eps 1e-8, the
decay applied to every parameter) or SGD with momentum after the weight
decay is added to the gradient, with an optional global-norm clip first. As
in optax, update *i* (counted from 0) uses the rate ``schedule(i)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional

import torch

from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1.0 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine_decay + alpha)

    return schedule


def join_schedules(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """optax.join_schedules: after each boundary the next schedule runs on
    the steps counted from that boundary."""

    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def create_schedule(cfg: OptimizerConfig, num_epochs: int, steps_per_epoch: int) -> Schedule:
    total_steps = max(1, num_epochs * steps_per_epoch)
    # clamp: a 5-epoch warmup on a 1-epoch run must still be valid
    warmup_steps = min(cfg.warmup_epochs * steps_per_epoch, total_steps // 2)
    base = cfg.learning_rate
    if cfg.schedule == "constant":
        if warmup_steps > 0:
            return linear_schedule(0.0, base, warmup_steps)
        return lambda count: base
    if cfg.schedule == "cosine":
        if warmup_steps > 0:
            # optax.warmup_cosine_decay_schedule(0, base, warmup, total, eta_min)
            eta_min = base * cfg.min_lr_ratio
            return join_schedules(
                [linear_schedule(0.0, base, warmup_steps),
                 cosine_decay_schedule(base, total_steps - warmup_steps,
                                       alpha=0.0 if base == 0.0 else eta_min / base)],
                [warmup_steps],
            )
        return cosine_decay_schedule(base, total_steps, alpha=cfg.min_lr_ratio)
    if cfg.schedule == "cosine_restarts":
        first_cycle = max(1, (num_epochs // cfg.restart_div) * steps_per_epoch)
        schedules, boundaries = [], []
        cycle, start = first_cycle, 0
        while start < total_steps:
            schedules.append(cosine_decay_schedule(base, cycle, alpha=0.0))
            start += cycle
            boundaries.append(start)
            cycle *= cfg.restart_mult
        return join_schedules(schedules, boundaries[:-1])
    raise ValueError(f"Unknown schedule {cfg.schedule!r}")


@dataclasses.dataclass(frozen=True)
class OptimizerDef:
    """What :func:`create_optimizer` describes; :meth:`build` makes the
    torch optimizer over a model's parameters, and :meth:`step` applies one
    update at the rate of the step count it is given."""

    name: str
    weight_decay: float
    momentum: float
    grad_clip_norm: Optional[float]
    schedule: Schedule

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        params = list(params)
        lr = self.schedule(0)
        if self.name == "adamw":
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=self.weight_decay)
        return torch.optim.SGD(params, lr=lr, momentum=self.momentum,
                               weight_decay=self.weight_decay)

    def step(self, opt: torch.optim.Optimizer, count: int) -> None:
        """One update with the gradients in ``.grad``, at ``schedule(count)``."""
        if self.grad_clip_norm is not None:
            clip_by_global_norm([p.grad for g in opt.param_groups for p in g["params"]
                                 if p.grad is not None], self.grad_clip_norm)
        lr = self.schedule(count)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm, in place and without a host read: every
    gradient becomes ``g / norm * max_norm`` where the global norm is at
    least ``max_norm``."""
    if not grads:
        return
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def create_optimizer(cfg: OptimizerConfig, num_epochs: int, steps_per_epoch: int,
                     lr_scale: float = 1.0) -> tuple[OptimizerDef, Schedule]:
    """Returns (optimizer definition, schedule). ``lr_scale`` scales the
    whole schedule (the pruning fine-tune's 0.1x)."""
    schedule = create_schedule(
        dataclasses.replace(cfg, learning_rate=cfg.learning_rate * lr_scale),
        num_epochs, steps_per_epoch,
    )
    if cfg.name not in ("adamw", "sgd"):
        raise ValueError(f"Unsupported optimizer {cfg.name!r}")
    return OptimizerDef(cfg.name, cfg.weight_decay, cfg.momentum, cfg.grad_clip_norm,
                        schedule), schedule
