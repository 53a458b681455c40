"""Optimizers, learning-rate schedules and gradient clipping on torch.optim,
with optax's arithmetic (port of pope_tpu/train/optim.py and the
clip_by_global_norm of pope_tpu/train/matcher_driver.py).

- adamw: torch.optim.AdamW, equal to optax.adamw to rounding; the decay
  reaches every parameter, as optax's mask=None does.
- adam: coupled L2 (optax.add_decayed_weights before optax.adam), which is
  torch.optim.Adam(weight_decay=...).
- The lr of update k (from k = 0) is schedule(k), as optax's count gives
  it: a MultiStepLR (milestones in epochs x steps_per_epoch), cosine or
  exponential base times a linear or constant warmup. With warmup_steps > 0
  and warmup_ratio 0 the first update's lr is 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adamw"  # 'adam' | 'adamw'
    lr: float = 8e-3  # the reference's canonical true_lr before batch scaling
    weight_decay: float = 0.1
    scheduler: str = "MultiStepLR"  # | 'CosineAnnealing' | 'ExponentialLR'
    mslr_milestones: Sequence[int] = (3, 6, 9, 12)  # in epochs
    mslr_gamma: float = 0.5
    cosa_tmax: int = 30
    elr_gamma: float = 0.999992
    warmup_steps: int = 4800
    warmup_ratio: float = 0.0
    warmup_type: str = "linear"  # | 'constant'
    steps_per_epoch: int = 1000  # converts epoch milestones to steps


def build_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """step -> lr, optax's schedules in closed form."""
    spe = cfg.steps_per_epoch
    if cfg.scheduler == "MultiStepLR":
        bounds = sorted(m * spe for m in cfg.mslr_milestones)
        base = lambda step: cfg.lr * cfg.mslr_gamma ** sum(step >= b for b in bounds)
    elif cfg.scheduler == "CosineAnnealing":
        T = float(cfg.cosa_tmax * spe)
        base = lambda step: cfg.lr * 0.5 * (1 + math.cos(math.pi * min(step, T) / T))
    elif cfg.scheduler == "ExponentialLR":
        base = lambda step: cfg.lr * cfg.elr_gamma ** step  # per-step gamma
    else:
        raise NotImplementedError(cfg.scheduler)
    if cfg.warmup_steps <= 0:
        return base

    def schedule(step):
        if cfg.warmup_type == "linear":
            ratio = cfg.warmup_ratio + (1.0 - cfg.warmup_ratio) * min(step / cfg.warmup_steps, 1.0)
        else:
            ratio = cfg.warmup_ratio if step < cfg.warmup_steps else 1.0
        return base(step) * ratio

    return schedule


class ScheduleLR(torch.optim.lr_scheduler.LRScheduler):
    """Sets every group's lr to schedule(k) before update k."""

    def __init__(self, optimizer, schedule: Callable[[int], float]):
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self):
        return [self.schedule(self.last_epoch) for _ in self.optimizer.param_groups]

    def state_dict(self):
        return {k: v for k, v in super().state_dict().items() if k != "schedule"}


def build_optimizer(params, cfg: OptimConfig = OptimConfig()):
    """(optimizer, scheduler) over `params`; call scheduler.step() after
    each optimizer.step()."""
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=cfg.lr, weight_decay=cfg.weight_decay)
    else:
        raise ValueError(cfg.optimizer)
    return opt, ScheduleLR(opt, build_schedule(cfg))


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float, tp_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: the gradients stay as they are
    when their global norm is below max_norm, else each becomes g / norm *
    max_norm (torch's clip_grad_norm_ divides by norm + 1e-6 instead).
    Returns the norm, without a host sync. tp_group: the parameters that
    parallel.shard_params_tp cut (`tp_sharded`) hold a shard each, and
    their squares are summed over the group; the others count once."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    sharded = [tp_group is not None and getattr(p, "tp_sharded", False) for p in params]
    zero = grads[0].new_zeros(())
    shards = torch.stack([g.square().sum() for g, sh in zip(grads, sharded) if sh] or [zero]).sum()
    whole = torch.stack([g.square().sum() for g, sh in zip(grads, sharded) if not sh] or [zero]).sum()
    if tp_group is not None:
        from pope_tpu_torch.parallel.collectives import all_reduce

        shards = all_reduce(shards, tp_group)
    norm = (whole + shards).sqrt()
    clipped = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clipped, g / norm * max_norm, g))
    return norm
