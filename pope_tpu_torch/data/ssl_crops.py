"""DINOv2 SSL data pipeline: multi-crop augmentation, block masking, collate
(a copy of pope_tpu/data/ssl_crops.py, numpy and cv2 only: the port imports
nothing of the JAX package, and its batches are the JAX package's byte for
byte).

Behavioral spec: dinov2/dinov2/data/augmentations.py (DataAugmentationDINO —
2 global crops @ [0.32, 1.0] scale with flip/jitter/gray/blur/solarize, n
local crops @ [0.05, 0.32]), dinov2/dinov2/data/masking.py (BEiT-style block
MaskingGenerator: grow random-aspect rectangles until the target count),
dinov2/dinov2/data/collate.py (stack crops crop-major, draw per-sample mask
ratios from a linspace over [mask_ratio_min, mask_ratio_max] for a
`mask_sample_probability` fraction of the batch, shuffle).

Host-side numpy/cv2 by design: augmentation runs in the loader threads while
the card computes the previous step; the
device sees fixed-shape f32 crop stacks + a dense (2B, N) bool mask — no
dynamic `mask_indices_list` (the dense iBOT loss in train/ssl.py replaces
the reference's dynamic-length gather).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _rand_resized_crop(rng, img, out_size: int, scale) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (log-uniform aspect in
    [3/4, 4/3], uniform area in `scale`), bicubic resize."""
    import cv2

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(3 / 4), math.log(4 / 3))
        ar = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * ar)))
        ch = int(round(math.sqrt(target_area / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = rng.integers(0, w - cw + 1)
            y0 = rng.integers(0, h - ch + 1)
            crop = img[y0 : y0 + ch, x0 : x0 + cw]
            return cv2.resize(crop, (out_size, out_size), interpolation=cv2.INTER_CUBIC)
    # fallback: center crop
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return cv2.resize(img[y0 : y0 + s, x0 : x0 + s], (out_size, out_size),
                      interpolation=cv2.INTER_CUBIC)


def _color_jitter(rng, img):
    """brightness/contrast/saturation 0.4, hue 0.1, applied w.p. 0.8, then
    grayscale w.p. 0.2 (augmentations.py:52-61). img f32 in [0,1]."""
    if rng.uniform() < 0.8:
        b = rng.uniform(0.6, 1.4)
        c = rng.uniform(0.6, 1.4)
        s = rng.uniform(0.6, 1.4)
        img = np.clip(img * b, 0, 1)
        mean = img.mean()
        img = np.clip((img - mean) * c + mean, 0, 1)
        gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
        img = np.clip(gray[..., None] + (img - gray[..., None]) * s, 0, 1)
        # cheap hue: channel-rotation blend (full HSV round-trip not worth
        # the loader cpu; hue jitter is the least influential term)
        h_amt = rng.uniform(-0.1, 0.1)
        img = np.clip(img + h_amt * (np.roll(img, 1, axis=-1) - img), 0, 1)
    if rng.uniform() < 0.2:
        gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
        img = np.repeat(gray[..., None], 3, axis=-1)
    return img


def _gaussian_blur(rng, img, p: float):
    import cv2

    if rng.uniform() >= p:
        return img
    sigma = rng.uniform(0.1, 2.0)
    return cv2.GaussianBlur(img, (9, 9), sigma)


def _solarize(rng, img, p: float):
    if rng.uniform() >= p:
        return img
    return np.where(img >= 0.5, 1.0 - img, img)


@dataclasses.dataclass(frozen=True)
class MultiCropConfig:
    global_crop_size: int = 224
    local_crop_size: int = 98
    n_local_crops: int = 8
    global_crops_scale: tuple = (0.32, 1.0)
    local_crops_scale: tuple = (0.05, 0.32)


class DataAugmentationDINO:
    """image (H, W, 3) uint8/f32 -> {'global_crops': [2 x (S,S,3) f32],
    'local_crops': [n x (s,s,3) f32]}, ImageNet-normalized."""

    def __init__(self, cfg: MultiCropConfig = MultiCropConfig(), seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def _finish(self, img):
        return (img - IMAGENET_MEAN) / IMAGENET_STD

    def __call__(self, image: np.ndarray) -> Dict[str, List[np.ndarray]]:
        rng = self.rng
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        cfg = self.cfg

        def base(size, scale):
            c = _rand_resized_crop(rng, img, size, scale)
            if rng.uniform() < 0.5:
                c = c[:, ::-1]  # horizontal flip
            return np.ascontiguousarray(c)

        # global crop 1: always blurred; global crop 2: blur p=0.1 then
        # solarize p=0.2 (augmentations.py:63-84)
        g1 = _gaussian_blur(rng, _color_jitter(rng, base(cfg.global_crop_size, cfg.global_crops_scale)), 1.0)
        g2 = _color_jitter(rng, base(cfg.global_crop_size, cfg.global_crops_scale))
        g2 = _solarize(rng, _gaussian_blur(rng, g2, 0.1), 0.2)
        locals_ = [
            _gaussian_blur(rng, _color_jitter(rng, base(cfg.local_crop_size, cfg.local_crops_scale)), 0.5)
            for _ in range(cfg.n_local_crops)
        ]
        return {
            "global_crops": [self._finish(g1), self._finish(g2)],
            "local_crops": [self._finish(c) for c in locals_],
        }


class MaskingGenerator:
    """BEiT block masking (masking.py:12-87): accumulate random-aspect
    rectangles (area in [min_num_patches, remaining]) until `num_masking_
    patches` cells are set."""

    def __init__(self, input_size: int, min_num_patches: int = 4,
                 max_num_patches: Optional[int] = None, min_aspect: float = 0.3,
                 seed: int = 0):
        self.h = self.w = input_size
        self.min_num_patches = min_num_patches
        self.max_num_patches = max_num_patches
        self.log_aspect = (math.log(min_aspect), math.log(1 / min_aspect))
        self.rng = np.random.default_rng(seed)

    def _grow(self, mask, max_mask_patches: int) -> int:
        rng = self.rng
        lo = min(self.min_num_patches, max_mask_patches)
        hi = max(self.min_num_patches, max_mask_patches)
        for _ in range(10):
            target_area = rng.uniform(lo, hi)
            ar = math.exp(rng.uniform(*self.log_aspect))
            bh = int(round(math.sqrt(target_area * ar)))
            bw = int(round(math.sqrt(target_area / ar)))
            if bw < self.w and bh < self.h:
                top = rng.integers(0, self.h - bh + 1)
                left = rng.integers(0, self.w - bw + 1)
                region = mask[top : top + bh, left : left + bw]
                delta = bh * bw - int(region.sum())
                if 0 < delta <= max_mask_patches:
                    region[:] = True
                    return delta
        return 0

    def __call__(self, num_masking_patches: int = 0) -> np.ndarray:
        mask = np.zeros((self.h, self.w), bool)
        count = 0
        while count < num_masking_patches:
            cap = num_masking_patches - count
            if self.max_num_patches is not None:
                cap = min(cap, self.max_num_patches)
            delta = self._grow(mask, cap)
            if delta == 0:
                break
            count += delta
        return mask


def collate_multicrop(samples: List[Dict[str, List[np.ndarray]]],
                      mask_generator: MaskingGenerator,
                      mask_ratio: tuple = (0.1, 0.5),
                      mask_probability: float = 0.5,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """collate.py semantics with dense masks: crops stack crop-major
    (crop0 of every sample, then crop1 ...), a `mask_probability` fraction
    of the 2B global crops get a block mask whose ratio is drawn from
    consecutive linspace bins over `mask_ratio`, mask order shuffled."""
    rng = np.random.default_rng(seed)
    n_global = len(samples[0]["global_crops"])
    n_local = len(samples[0]["local_crops"])
    global_crops = np.stack(
        [s["global_crops"][i] for i in range(n_global) for s in samples]
    ).astype(np.float32)
    if n_local:
        local_crops = np.stack(
            [s["local_crops"][i] for i in range(n_local) for s in samples]
        ).astype(np.float32)
    else:
        local_crops = np.zeros((0,), np.float32)

    B = global_crops.shape[0]
    N = mask_generator.h * mask_generator.w
    n_masked_samples = int(B * mask_probability)
    probs = np.linspace(*mask_ratio, n_masked_samples + 1)
    masks = []
    for i in range(n_masked_samples):
        ratio = rng.uniform(probs[i], probs[i + 1])
        masks.append(mask_generator(int(N * ratio)).reshape(-1))
    masks.extend(np.zeros(N, bool) for _ in range(B - n_masked_samples))
    rng.shuffle(masks)
    return {
        "global_crops": global_crops,
        "local_crops": local_crops,
        "masks": np.stack(masks),
    }
