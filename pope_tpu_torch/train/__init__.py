"""Matcher (LoFTR-style) training (port of pope_tpu/train; one device or a
(dp, tp) mesh):
depth-warped coarse and fine supervision, focal / CE coarse and l2(+std)
fine losses, AdamW / Adam with optax's schedules and clipping, the train
step, and the multi-scene driver with validation and top-k checkpoints."""

from pope_tpu_torch.train.supervision import warp_kpts, spvs_coarse, spvs_fine
from pope_tpu_torch.train.loss import coarse_loss, fine_loss, matcher_loss
from pope_tpu_torch.train.optim import build_optimizer
from pope_tpu_torch.train.trainer import make_sharded_train_step, matcher_train_step
from pope_tpu_torch.train.matcher_driver import (
    TopKCheckpointer,
    TrainMatcherConfig,
    train_matcher,
    validate,
)
