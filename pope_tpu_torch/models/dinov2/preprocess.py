"""DINOv2 preprocessing and retrieval scoring (port of
pope_tpu/models/dinov2/preprocess.py): Resize(256) -> CenterCrop(196) ->
ImageNet normalisation, and the cls-token cosine vote."""

from __future__ import annotations

import torch

from pope_tpu_torch.ops.resize import resize_bilinear_antialias

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(img):
    """(..., 3) RGB in [0, 1] -> ImageNet-normalised."""
    mean = img.new_tensor(IMAGENET_MEAN)
    std = img.new_tensor(IMAGENET_STD)
    return (img - mean) / std


def preprocess_image(images, center_crop: bool = False):
    """(B, H, W, 3) RGB in [0, 255] -> (B, h, w, 3) normalised f32.

    center_crop=True: antialiased bilinear resize to 256x256, then the
    central 196x196 (rows and columns 30:226); False: resize to 224x224."""
    img = images.float() / 255.0
    if center_crop:
        img = resize_bilinear_antialias(img, (256, 256))[:, 30:226, 30:226]
    else:
        img = resize_bilinear_antialias(img, (224, 224))
    return normalize(img)


def cls_token_cosine(ref_cls, crop_cls, eps: float = 1e-8):
    """Cosine similarity of cls tokens (..., C), broadcast."""
    ref = ref_cls / torch.clamp(torch.linalg.norm(ref_cls, dim=-1, keepdim=True), min=eps)
    crop = crop_cls / torch.clamp(torch.linalg.norm(crop_cls, dim=-1, keepdim=True), min=eps)
    return (ref * crop).sum(-1)
