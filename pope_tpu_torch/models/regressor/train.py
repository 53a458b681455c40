"""Training and eval steps of the pose regressors (port of
pope_tpu/models/regressor/train.py): AdamW at a constant lr with decoupled
weight decay (optax.adamw: every parameter is decayed, a frozen Vim's too),
loss = MSE(t) + mean geodesic(R); eval by the batched relative pose error.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

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


def train_step(state: RegressorTrainState, batch: Dict[str, torch.Tensor], dropout: Optional[Dropout],
               dp_group=None):
    """One step in place. batch: mkpts0, mkpts1, [img0, img1,] gt_t, gt_R;
    dropout: a torch.Generator for the MLP's masks (or the masks). Returns
    the metrics (loss, t_loss, r_loss) as detached 0-dim tensors. dp_group:
    make_sharded_train_step's; the batch is this rank's equal part, and the
    gradients and metrics are averaged over the group."""
    model = state.model
    model.train()
    state.optimizer.zero_grad(set_to_none=True)
    pred_t, pred_R = _predict(model, batch, dropout)
    loss, (t_loss, r_loss) = pose_loss(pred_t, pred_R, batch["gt_t"], batch["gt_R"])
    loss.backward()
    for p in model.parameters():
        if p.grad is None:  # torch's AdamW skips these; optax decays them with a zero gradient
            p.grad = torch.zeros_like(p)
    metrics = {"loss": loss.detach(), "t_loss": t_loss.detach(), "r_loss": r_loss.detach()}
    if dp_group is not None:
        from pope_tpu_torch.parallel.collectives import all_reduce, all_reduce_grads_, group_size

        all_reduce_grads_(model.parameters(), dp_group, average=True)
        metrics = {k: all_reduce(v, dp_group) / group_size(dp_group) for k, v in metrics.items()}
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


def make_sharded_train_step(mesh):
    """train_step over a (dp, tp) mesh (program 1 of the JAX package's
    multi-chip dry run): step(state, batch, dropout) with `batch` this
    rank's shard_batch(mesh, global_batch, sp_axis=1) (dp slice, token axis
    cut over tp, gathered back here since the model attends over every
    token), the model's large layers and their moments cut by
    parallel.shard_params_tp, and `dropout` the global batch's keep masks
    (each rank takes its rows) or None. It equals train_step on the global
    batch: the loss is a mean over samples, so the dp gradients and metrics
    are averaged."""
    from pope_tpu_torch.parallel.mesh import ShardedBatch, axis_size, shard_batch, unshard_sp

    group = mesh.get_group("dp") if axis_size(mesh, "dp") > 1 else None

    def step(state: RegressorTrainState, batch: ShardedBatch, dropout: Optional[Sequence[torch.Tensor]]):
        if isinstance(dropout, torch.Generator):
            raise ValueError("a sharded step takes the global batch's dropout masks, not a generator")
        full = unshard_sp(mesh, batch) if isinstance(batch, ShardedBatch) else batch
        masks = None if dropout is None else [shard_batch(mesh, m) for m in dropout]
        return train_step(state, full, masks, group)

    return step


@torch.no_grad()
def eval_step(state: RegressorTrainState, batch: Dict[str, torch.Tensor]):
    """Predictions and per-sample angular errors (degrees) against the
    batch's (gt_R, gt_t)."""
    state.model.eval()
    pred_t, pred_R = _predict(state.model, batch)
    T = to_homo_pose(torch.cat([batch["gt_R"], batch["gt_t"][..., None]], dim=-1))
    t_err, r_err = relative_pose_error(T, pred_R, pred_t)
    return {"pred_t": pred_t, "pred_R": pred_R, "t_err": t_err, "R_err": r_err}
