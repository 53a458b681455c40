"""Pose-regression extension ("MoCoPE"; port of pope_tpu/models/regressor):
direct relative-pose regressors trained on the pipeline's match dumps, with
optional ConvNeXtV2 or frozen Vision Mamba image branches, and the
DINOv2-feature poser."""

from pope_tpu_torch.models.regressor.convnextv2 import ConvNeXtV2
from pope_tpu_torch.models.regressor.dinov2_poser import DINOv2Poser, posenet_loss, poser_rotation
from pope_tpu_torch.models.regressor.embedding import nerf_embedding
from pope_tpu_torch.models.regressor.model import MkptsRegModel
from pope_tpu_torch.models.regressor.train import (
    RegressorTrainState,
    create_train_state,
    eval_step,
    pose_loss,
    train_step,
)
from pope_tpu_torch.models.regressor.vim import VimConfig, VisionMamba, selective_scan
