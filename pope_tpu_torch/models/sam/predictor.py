"""SamPredictor: encode an image once, then prompt it repeatedly (port of
pope_tpu/models/sam/predictor.py).

`set_image` resizes the frame on the host (cv2, INTER_LINEAR, as the JAX
class does), uploads it once and keeps the embedding on the device; the
encoder runs through the port's attention kernels on the square
(img_size, img_size) frame, or on the patch-aligned rect frame with
`rect_encode`. `predict` / `predict_batched` decode prompts in original image
coordinates against that embedding and return numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pope_tpu_torch.models.sam.sam import apply_coords, postprocess_masks, rect_frame, resize_longest_side
from pope_tpu_torch.utils.device import resolve_device


class SamPredictor:
    def __init__(self, sam, rect_encode: bool = False, device=None):
        """rect_encode: pad a non-square image only to patch multiples (fewer
        encoder tokens; off by default, which keeps the square frame).
        device=None runs on CUDA and raises without a GPU; the module is
        moved to the device."""
        self.device = resolve_device(device)
        self.sam = sam.to(self.device).eval()
        self.rect_encode = rect_encode
        self.reset_image()

    def reset_image(self):
        self.features: Optional[torch.Tensor] = None
        self.original_hw: Optional[Tuple[int, int]] = None
        self.input_hw: Optional[Tuple[int, int]] = None

    @property
    def is_image_set(self) -> bool:
        return self.features is not None

    def _check_image_set(self):
        if not self.is_image_set:
            raise RuntimeError("call set_image first")

    @torch.no_grad()
    def set_image(self, image_rgb: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 RGB -> the cached (1, gh, gw, C) embedding."""
        import cv2

        self.original_hw = tuple(image_rgb.shape[:2])
        enc = self.sam.config.encoder
        self.input_hw = resize_longest_side(*self.original_hw, enc.img_size)
        resized = cv2.resize(image_rgb, (self.input_hw[1], self.input_hw[0]), interpolation=cv2.INTER_LINEAR)
        frame = rect_frame(self.input_hw, enc.patch_size) if self.rect_encode else (enc.img_size, enc.img_size)
        image = torch.from_numpy(np.ascontiguousarray(resized)).to(self.device)
        self.features = self.sam.encode_image(self.sam.preprocess(image[None], self.input_hw, frame))
        return self.features

    @torch.no_grad()
    def _decode(self, coords: np.ndarray, labels: np.ndarray, multimask_output: bool, return_logits: bool):
        """(B, N, 2) original-frame coords and (B, N) labels -> numpy (masks
        (B, K, H, W), iou (B, K), low-res logits (B, K, 4gh, 4gw))."""
        pts = apply_coords(coords, self.original_hw, self.sam.config.encoder.img_size).to(self.device)
        lbl = torch.from_numpy(labels).to(self.device)
        low_res, iou = self.sam.decode(self.features, pts, lbl, multimask_output=multimask_output)
        low_res = low_res.float()
        masks = postprocess_masks(low_res, self.input_hw, self.original_hw)
        if not return_logits:
            masks = masks > 0.0
        return masks.cpu().numpy(), iou.float().cpu().numpy(), low_res.cpu().numpy()

    def predict(
        self,
        point_coords: Optional[np.ndarray] = None,
        point_labels: Optional[np.ndarray] = None,
        box: Optional[np.ndarray] = None,
        multimask_output: bool = True,
        return_logits: bool = False,
    ):
        """Prompt with points (N, 2) with labels (N,) and/or a box (4,) in
        ORIGINAL image coords; returns (masks (K, H, W), iou (K,), low_res
        (K, 4gh, 4gw)), K = 3 with multimask_output else 1. A box embeds as
        its two corners with labels 2/3; a point-only prompt gets a pad slot
        (label -1)."""
        self._check_image_set()
        pts, lbls = [], []
        if point_coords is not None:
            pts.append(np.asarray(point_coords, np.float32))
            lbls.append(np.asarray(point_labels, np.int64))
        if box is not None:
            pts.append(np.asarray(box, np.float32).reshape(2, 2))
            lbls.append(np.asarray([2, 3], np.int64))
        if point_coords is not None and box is None:
            pts.append(np.zeros((1, 2), np.float32))
            lbls.append(np.asarray([-1], np.int64))
        masks, iou, low_res = self._decode(
            np.concatenate(pts, 0)[None], np.concatenate(lbls, 0)[None], multimask_output, return_logits
        )
        return masks[0], iou[0], low_res[0]

    def predict_batched(
        self,
        point_coords: Optional[np.ndarray] = None,
        point_labels: Optional[np.ndarray] = None,
        boxes: Optional[np.ndarray] = None,
        multimask_output: bool = True,
        return_logits: bool = False,
    ):
        """A batch of prompt sets against the cached embedding in one decode:
        boxes (B, 4) and/or per-set points (B, N, 2) with labels (B, N), in
        ORIGINAL image coords. Returns (masks (B, K, H, W), iou (B, K),
        low_res (B, K, 4gh, 4gw)). Point-only batches get one pad slot."""
        self._check_image_set()
        parts, lparts = [], []
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels is required when point_coords is given")
            pc = np.asarray(point_coords, np.float32)
            if pc.ndim != 3:
                raise ValueError(f"predict_batched expects (B, N, 2) points, got {pc.shape}")
            parts.append(pc)
            lparts.append(np.asarray(point_labels, np.int64).reshape(pc.shape[:2]))
        if boxes is not None:
            b = np.asarray(boxes, np.float32).reshape(-1, 2, 2)
            parts.append(b)
            lparts.append(np.broadcast_to(np.asarray([2, 3], np.int64), (len(b), 2)))
        if not parts:
            raise ValueError("need points and/or boxes")
        if len(parts) == 2 and len(parts[0]) != len(parts[1]):
            raise ValueError("point and box batch sizes differ")
        if boxes is None:
            B = len(parts[0])
            parts.append(np.zeros((B, 1, 2), np.float32))
            lparts.append(np.full((B, 1), -1, np.int64))
        return self._decode(np.concatenate(parts, 1), np.concatenate(lparts, 1), multimask_output, return_logits)
