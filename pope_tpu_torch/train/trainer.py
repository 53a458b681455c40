"""The matcher's supervised training step (port of
pope_tpu/train/trainer.py): coarse supervision -> the matcher
in train mode with GT padding -> fine supervision at the ids the fine stage
used -> loss -> backward -> global-norm clip -> optimizer and schedule step.
`make_sharded_train_step` runs the same step over a (dp, tp) mesh: each dp
rank takes its slice of the global batch, with the global batch's
BatchNorm statistics and loss normalisers; the gradients are summed over
dp before the clip, and tp-sharded layers (parallel.shard_params_tp) clip
by the global norm of their shards."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from pope_tpu_torch.train.loss import LossConfig, matcher_loss
from pope_tpu_torch.train.optim import OptimConfig, build_optimizer, clip_by_global_norm_
from pope_tpu_torch.train.supervision import spvs_coarse, spvs_fine


@dataclasses.dataclass
class MatcherTrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer,
    the lr schedule, the clip norm (None: no clipping) and the count of
    steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_clip: Optional[float] = None
    step: int = 0


def init_matcher_train_state(matcher: nn.Module, ocfg: OptimConfig = OptimConfig(),
                             grad_clip: Optional[float] = None) -> MatcherTrainState:
    optimizer, scheduler = build_optimizer(list(matcher.parameters()), ocfg)
    return MatcherTrainState(matcher, optimizer, scheduler, grad_clip)


def train_loss(matcher: nn.Module, batch: Dict[str, torch.Tensor], loss_cfg: LossConfig = LossConfig(),
               group=None):
    """Supervision and the train-mode forward: (total loss, metrics). The GT
    coarse matches pad the fine stage's samples inside the forward: early in
    training the predictions are noise, and without them the fine loss has
    almost no signal. batch: image0 / image1 (B, H, W, 1), depth0 / depth1,
    T_0to1 / T_1to0 (B, 4, 4), K0 / K1, optional scale0 / scale1 and
    gt_pad_noise (B, L). group: a dp group whose global batch this one is
    a part of (the loss is this rank's part)."""
    cfg = matcher.config
    with torch.no_grad():
        spv = spvs_coarse(batch, cfg.coarse_stride)
    result = matcher(batch["image0"], batch["image1"], return_aux=True, gt_valid=spv["spv_valid"],
                     gt_j_of_i=spv["spv_j_of_i"], gt_pad_noise=batch.get("gt_pad_noise"))
    expec_f_gt = spvs_fine(spv, result.i_ids, result.j_ids, cfg.fine_stride, cfg.fine_window_size)
    return matcher_loss(result, spv, expec_f_gt, loss_cfg, group=group)


def apply_gradients(state: MatcherTrainState, tp_group=None) -> None:
    """Clip (optax's clip_by_global_norm arithmetic), step the optimizer and
    the schedule."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    if state.grad_clip is not None:
        clip_by_global_norm_(params, state.grad_clip, tp_group)
    state.optimizer.step()
    state.scheduler.step()


def matcher_train_step(state: MatcherTrainState, batch: Dict[str, torch.Tensor],
                       loss_cfg: LossConfig = LossConfig(), dp_group=None, tp_group=None) -> Dict[str, torch.Tensor]:
    """One supervised step in place; returns the metrics (loss, loss_coarse,
    loss_fine) as detached 0-dim tensors, without a host sync. On the card
    the backbone's backward stays outside cuDNN, as its forward
    (backbone.native_conv2d). dp_group / tp_group: make_sharded_train_step's
    groups (the loss is this rank's part, summed over dp with the
    gradients; the clip's norm sums the tp shards)."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    total, metrics = train_loss(state.model, batch, loss_cfg, group=dp_group)
    total.backward()
    if dp_group is not None:
        from pope_tpu_torch.parallel.collectives import all_reduce, all_reduce_grads_

        all_reduce_grads_([p for g in state.optimizer.param_groups for p in g["params"]], dp_group)
        metrics = {k: all_reduce(v.detach(), dp_group) for k, v in metrics.items()}
    apply_gradients(state, tp_group)
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def make_sharded_train_step(mesh, loss_cfg: LossConfig = LossConfig()):
    """The train step over a (dp, tp) mesh (parallel.make_mesh): step(state,
    batch) with `batch` this rank's dp slice of the global batch
    (parallel.shard_batch) and the model's large layers tp-sharded
    (parallel.shard_params_tp) when tp > 1. It equals matcher_train_step on
    the global batch: BatchNorm normalises over the global batch (and keeps
    its running statistics), each loss normaliser is global, the gradients
    are summed over dp before the global-norm clip, and the metrics are the
    global batch's."""
    from pope_tpu_torch.models.matcher.backbone import batch_statistics_over
    from pope_tpu_torch.parallel.collectives import sum_parts
    from pope_tpu_torch.parallel.mesh import axis_size

    dp = axis_size(mesh, "dp")
    dp_group = mesh.get_group("dp") if dp > 1 else None
    tp_group = mesh.get_group("tp") if axis_size(mesh, "tp") > 1 else None

    def step(state: MatcherTrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if dp_group is None:
            return matcher_train_step(state, batch, loss_cfg, None, tp_group)
        with batch_statistics_over(lambda t: sum_parts(t, dp_group), dp):
            return matcher_train_step(state, batch, loss_cfg, dp_group, tp_group)

    return step
