"""Training and eval steps of the pose regressors (port of
pope_tpu/models/regressor/train.py): AdamW at a constant lr with decoupled
weight decay (optax.adamw: every parameter is decayed, a frozen Vim's too),
loss = MSE(t) + mean geodesic(R); eval by the batched relative pose error.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from pope_tpu_torch.config import RegressorConfig
from pope_tpu_torch.geometry.pose import geodesic_distance, relative_pose_error, to_homo_pose
from pope_tpu_torch.models.regressor.model import Dropout
from pope_tpu_torch.train.optim import OptimConfig, build_optimizer


@dataclasses.dataclass
class RegressorTrainState:
    """The model, its optimizer and constant schedule, and the steps taken
    (utils/checkpoint.py saves and loads it)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_train_state(model: nn.Module, cfg: RegressorConfig = RegressorConfig()) -> RegressorTrainState:
    ocfg = OptimConfig(optimizer="adamw", lr=cfg.lr, weight_decay=cfg.weight_decay, scheduler="ExponentialLR",
                       elr_gamma=1.0, warmup_steps=0)
    optimizer, scheduler = build_optimizer(list(model.parameters()), ocfg)
    return RegressorTrainState(model, optimizer, scheduler)


def pose_loss(pred_t, pred_R, gt_t, gt_R):
    """MSE(t) + mean geodesic(R): (loss, (t_loss, r_loss))."""
    t_loss = ((pred_t - gt_t) ** 2).mean()
    r_loss = geodesic_distance(pred_R, gt_R, mode="mean")
    return t_loss + r_loss, (t_loss, r_loss)


def _predict(model, batch: Dict[str, torch.Tensor], dropout: Dropout = None):
    return model(batch["mkpts0"], batch["mkpts1"], batch.get("img0"), batch.get("img1"), dropout=dropout)


def train_step(state: RegressorTrainState, batch: Dict[str, torch.Tensor], dropout: Optional[Dropout]):
    """One step in place. batch: mkpts0, mkpts1, [img0, img1,] gt_t, gt_R;
    dropout: a torch.Generator for the MLP's masks (or the masks). Returns
    the metrics (loss, t_loss, r_loss) as detached 0-dim tensors."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    pred_t, pred_R = _predict(model, batch, dropout)
    loss, (t_loss, r_loss) = pose_loss(pred_t, pred_R, batch["gt_t"], batch["gt_R"])
    loss.backward()
    for p in model.parameters():
        if p.grad is None:  # torch's AdamW skips these; optax decays them with a zero gradient
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return {"loss": loss.detach(), "t_loss": t_loss.detach(), "r_loss": r_loss.detach()}


@torch.no_grad()
def eval_step(state: RegressorTrainState, batch: Dict[str, torch.Tensor]):
    """Predictions and per-sample angular errors (degrees) against the
    batch's (gt_R, gt_t)."""
    state.model.eval()
    pred_t, pred_R = _predict(state.model, batch)
    T = to_homo_pose(torch.cat([batch["gt_R"], batch["gt_t"][..., None]], dim=-1))
    t_err, r_err = relative_pose_error(T, pred_R, pred_t)
    return {"pred_t": pred_t, "pred_R": pred_R, "t_err": t_err, "R_err": r_err}
