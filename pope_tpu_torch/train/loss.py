"""Matcher losses, static shapes (port of pope_tpu/train/loss.py): a dense
focal or cross-entropy loss on the coarse confidence matrix, and an l2 loss
(weighted by the inverse heatmap std, or plain) on the fine offsets; the
total is coarse_weight * coarse + fine_weight * fine.

`group` (a dp group): the batch is one rank's part of a global batch; each
normaliser (the positive and negative counts, the fine match count and the
fine std weights' mean) is the global one, summed across the group without
a gradient, so that the ranks' losses sum to the global batch's loss."""

from __future__ import annotations

import dataclasses

import torch


def _global_sum(x, group):
    """x summed over the group (no gradient); x itself without one."""
    if group is None:
        return x
    from pope_tpu_torch.parallel.collectives import all_reduce

    return all_reduce(x.detach(), group)


def _parts(group) -> int:
    """How many equal parts make the global batch: the group's size, 1
    without one."""
    if group is None:
        return 1
    from pope_tpu_torch.parallel.collectives import group_size

    return group_size(group)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    coarse_type: str = "focal"  # 'focal' | 'cross_entropy'
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    fine_type: str = "l2_with_std"  # 'l2_with_std' | 'l2'
    fine_correct_thr: float = 1.0
    coarse_weight: float = 1.0
    fine_weight: float = 1.0


def coarse_loss(conf, conf_gt, cfg: LossConfig = LossConfig(), weight=None, group=None):
    """Dense focal / CE loss on the (B, L, S) confidence matrix."""
    conf = torch.clamp(conf, 1e-6, 1 - 1e-6)
    pos = conf_gt > 0.5
    w = torch.ones_like(conf) if weight is None else weight
    posf = pos.float() * w
    negf = (~pos).float() * w
    n_pos = torch.clamp(_global_sum(posf.sum(), group), min=1.0)
    n_neg = torch.clamp(_global_sum(negf.sum(), group), min=1.0)
    if cfg.coarse_type == "cross_entropy":
        lp = -torch.log(conf) * posf
        ln = -torch.log(1 - conf) * negf
    else:
        a, g = cfg.focal_alpha, cfg.focal_gamma
        lp = -a * (1 - conf) ** g * torch.log(conf) * posf
        ln = -a * conf ** g * torch.log(1 - conf) * negf
    return cfg.pos_weight * lp.sum() / n_pos + cfg.neg_weight * ln.sum() / n_neg


def fine_loss(expec_f, expec_f_gt, match_valid, cfg: LossConfig = LossConfig(), group=None):
    """l2 (+ std) loss of (B, M, 3) predicted offsets and std against (B, M,
    2) GT offsets. Matches whose GT lies outside the window
    (|gt|_inf >= fine_correct_thr) and invalid slots weigh 0."""
    gt_ok = expec_f_gt.abs().amax(dim=-1) < cfg.fine_correct_thr
    w = (gt_ok & match_valid).float()
    offset_l2 = ((expec_f[..., :2] - expec_f_gt) ** 2).sum(-1)
    if cfg.fine_type == "l2_with_std":
        inverse_std = 1.0 / torch.clamp(expec_f[..., 2], min=1e-10)
        # detached, as the reference's weight is: with gradients through it
        # the model lowers the loss by raising std on hard matches instead of
        # improving their offsets
        std_mean = _global_sum((inverse_std * w).sum(), group) / (w.numel() * _parts(group))
        ws = (inverse_std / torch.clamp(std_mean, min=1e-10)).detach()
        offset_l2 = offset_l2 * torch.where(w > 0, ws, torch.zeros_like(ws))
    n = torch.clamp(_global_sum(w.sum(), group), min=1.0)
    return (offset_l2 * w).sum() / n


def matcher_loss(result, spv, expec_f_gt, cfg: LossConfig = LossConfig(), weight=None, group=None):
    """Total loss of a MatchResult (with its conf matrix) against the
    supervision: (total, {"loss", "loss_coarse", "loss_fine"}); with a dp
    group, this rank's part of each."""
    lc = coarse_loss(result.conf_matrix, spv["conf_matrix_gt"], cfg, weight, group)
    lf = fine_loss(result.expec_f, expec_f_gt, result.valid, cfg, group)
    total = cfg.coarse_weight * lc + cfg.fine_weight * lf
    return total, {"loss": total, "loss_coarse": lc, "loss_fine": lf}
