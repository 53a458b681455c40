"""Automatic mask generation, the eval path (port of
pope_tpu/models/sam/amg.py: `_generate_impl`, `_amg_boxes`,
`generate_boxes_batch`, `postprocess_small_regions_device`).

Grid prompts -> chunked multimask decode -> IoU and stability filters ->
mask -> box -> NMS -> top-`mask_capacity` cut -> small-region cleanup, with
fixed-capacity outputs. The JAX package's `vmap` over images is a batch
dimension here (the decode loops over images, because each image's prompts
share its embedding); its `lax.map` over prompt chunks is a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pope_tpu_torch.config import AMGConfig
from pope_tpu_torch.models.sam.sam import MASK_THRESHOLD, rect_frame, resize_longest_side
from pope_tpu_torch.ops.components import clean_mask
from pope_tpu_torch.ops.masks import batched_mask_to_box, build_point_grid, calculate_stability_score
from pope_tpu_torch.ops.nms import nms
from pope_tpu_torch.ops.resize import resize_bilinear_antialias
from pope_tpu_torch.utils.device import resolve_device


class AMGResult(NamedTuple):
    masks_low_res: torch.Tensor  # (B, C, h, w) logits over the encode frame
    boxes: torch.Tensor  # (B, C, 4) XYXY in original image coords
    iou_preds: torch.Tensor  # (B, C)
    stability: torch.Tensor  # (B, C)
    areas: torch.Tensor  # (B, C) pixel area at original resolution (approx)
    valid: torch.Tensor  # (B, C) bool
    n_dropped: torch.Tensor  # (B,) NMS survivors cut by mask_capacity
    point_idx: torch.Tensor  # (B, C) prompt index of each candidate


class AutomaticMaskGenerator:
    """AMG over a Sam module.

        amg = AutomaticMaskGenerator(sam, amg_cfg)          # on the card
        boxes_xywh, valid, n_dropped = amg.generate_boxes_batch(frames)

    device=None runs on CUDA and raises without a GPU; pass device="cpu" to
    run on the CPU. The module is moved to the device."""

    def __init__(self, sam, cfg: AMGConfig = AMGConfig(), device=None):
        self.device = resolve_device(device)
        self.sam = sam.to(self.device).eval()
        self.cfg = cfg
        self.sam_cfg = sam.config
        self._grid01 = torch.as_tensor(
            build_point_grid(cfg.points_per_side), dtype=torch.float32, device=self.device
        )

    def _frame_hw(self, in_h: int, in_w: int):
        """Encode frame for a resized content extent: the patch-aligned rect
        (cfg.rect_encode) or the square."""
        enc = self.sam_cfg.encoder
        if self.cfg.rect_encode:
            return rect_frame((in_h, in_w), enc.patch_size)
        return enc.img_size, enc.img_size

    def _encode(self, images, in_h: int, in_w: int):
        """(B, H, W, 3) RGB uint8 -> (B, gh, gw, C) embeddings."""
        imgs = images.float()
        if tuple(images.shape[1:3]) != (in_h, in_w):
            imgs = resize_bilinear_antialias(imgs, (in_h, in_w))
        pre = self.sam.preprocess(imgs, (in_h, in_w), self._frame_hw(in_h, in_w))
        return self.sam.encode_image(pre)

    def _generate_impl(self, embeddings, input_h: int, input_w: int,
                       orig_h: int, orig_w: int, subsample: int = 1) -> AMGResult:
        cfg = self.cfg
        dev = embeddings.device
        n_points = cfg.points_per_side ** 2
        pts_orig = self._grid01 * torch.tensor([orig_w, orig_h], dtype=torch.float32, device=dev)
        scale = torch.tensor([input_w / orig_w, input_h / orig_h], dtype=torch.float32, device=dev)
        pts = (pts_orig * scale)[:, None, :]
        pts = torch.cat([pts, torch.zeros_like(pts)], dim=1)  # pad slot
        labels = torch.tensor([1, -1], dtype=torch.int64, device=dev).expand(n_points, 2)

        chunk = cfg.points_per_chunk if 0 < cfg.points_per_chunk < n_points else n_points
        masks, iou = [], []
        for b in range(embeddings.shape[0]):
            outs = [
                self.sam.decode(
                    embeddings[b : b + 1], pts[i : i + chunk], labels[i : i + chunk],
                    multimask_output=True, subsample=subsample,
                )
                for i in range(0, n_points, chunk)
            ]
            masks.append(torch.cat([m for m, _ in outs]))
            iou.append(torch.cat([s for _, s in outs]))
        B = len(masks)
        masks = torch.stack(masks).flatten(1, 2)  # (B, C, h, w), prompt-major x 3
        iou = torch.stack(iou).flatten(1, 2)  # (B, C)
        C = masks.shape[1]

        keep = iou > cfg.pred_iou_thresh
        stability = calculate_stability_score(masks, MASK_THRESHOLD, cfg.stability_score_offset)
        keep &= stability >= cfg.stability_score_thresh

        binmask = masks > MASK_THRESHOLD
        boxes_low = batched_mask_to_box(binmask)
        px_per_cell = self.sam_cfg.encoder.patch_size * subsample // 4
        frame_px = (masks.shape[-2] * px_per_cell, masks.shape[-1] * px_per_cell)
        to_input, lim, inv_scale, area_scale = _low_res_frame_maps(
            masks.shape[-2:], (orig_h, orig_w), (input_h, input_w), frame_px, dev
        )
        boxes = torch.minimum(torch.clamp(boxes_low * to_input, min=0.0), lim) * inv_scale

        area_low = binmask.sum(dim=(-2, -1)).float()
        areas = area_low / area_scale
        keep &= area_low > 0

        keep_nms = nms(boxes, iou, cfg.box_nms_thresh, valid=keep)

        # top-capacity by IoU among survivors; ties keep the lower index, as
        # jax.lax.top_k does
        score = torch.where(keep_nms, iou, torch.full_like(iou, float("-inf")))
        cap = min(cfg.mask_capacity, C)
        top_score, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
        top_score, top_idx = top_score[:, :cap], top_idx[:, :cap]
        take = lambda x: torch.take_along_dim(x, top_idx.reshape(B, cap, *[1] * (x.ndim - 2)), dim=1)
        return AMGResult(
            masks_low_res=take(masks),
            boxes=take(boxes),
            iou_preds=take(iou),
            stability=take(stability),
            areas=take(areas),
            valid=torch.isfinite(top_score),
            n_dropped=torch.clamp(keep_nms.sum(dim=-1) - cap, min=0),
            point_idx=top_idx // 3,
        )

    @torch.no_grad()
    def generate_boxes_batch(self, images_rgb):
        """Eval-path AMG: (B, H, W, 3) uint8 frames (numpy, a list of frames,
        or a tensor) -> ((B, C, 4) xywh boxes, (B, C) valid, (B,) n_dropped)
        on the device: encode, decode, filters, NMS and the small-region
        cleanup."""
        if isinstance(images_rgb, (list, tuple)):
            images_rgb = np.stack([np.asarray(im, np.uint8) for im in images_rgb])
        images = torch.as_tensor(images_rgb, device=self.device)
        orig_h, orig_w = images.shape[1:3]
        in_h, in_w = resize_longest_side(orig_h, orig_w, self.sam_cfg.encoder.img_size)
        embs = self._encode(images, in_h, in_w)
        res = self._generate_impl(
            embs, in_h, in_w, orig_h, orig_w, subsample=self.cfg.eval_decode_subsample
        )
        if self.cfg.min_mask_region_area > 0:
            boxes, valid = postprocess_small_regions_device(
                res.masks_low_res > MASK_THRESHOLD, res.valid, self.cfg.min_mask_region_area,
                (orig_h, orig_w), self.cfg.box_nms_thresh, k=self.cfg.cc_max_components,
                orig_boxes=res.boxes, input_hw=(in_h, in_w),
                frame_px_hw=self._frame_hw(in_h, in_w),
            )
        else:
            boxes, valid = res.boxes, res.valid
        xywh = torch.cat([boxes[..., :2], boxes[..., 2:] - boxes[..., :2]], dim=-1)
        return xywh, valid, res.n_dropped


def _low_res_frame_maps(low_hw, orig_hw, input_hw, frame_px_hw, device):
    """Coordinate and area maps for a low-res mask grid that covers
    `frame_px_hw` input-frame pixels, of which `input_hw` hold the image
    (`orig_hw` original pixels). Returns (xyxy low -> input scale, xyxy
    input-frame content clamp, xyxy input -> orig scale, orig-area -> low-area
    factor). The low -> orig map goes through the input frame."""
    low_h, low_w = low_hw
    oh, ow = orig_hw
    in_h, in_w = input_hw
    fh, fw = frame_px_hw
    vec = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)
    to_input = vec(fw / low_w, fh / low_h, fw / low_w, fh / low_h)
    lim = vec(in_w, in_h, in_w, in_h)
    inv = vec(ow / in_w, oh / in_h, ow / in_w, oh / in_h)
    area_scale = (low_h * in_h / (fh * oh)) * (low_w * in_w / (fw * ow))
    return to_input, lim, inv, float(area_scale)


def postprocess_small_regions_device(
    binmasks, valid, min_area: int, orig_hw, box_nms_thresh: float = 0.35,
    k: int = 64, orig_boxes: Optional[torch.Tensor] = None, input_hw=None, frame_px_hw=None,
):
    """Hole-fill and small-island removal of (..., C, h, w) bool masks, box
    recompute for changed masks, and NMS preferring untouched masks. min_area
    is in original-image pixels. Returns ((..., C, 4) xyxy boxes in original
    coords, (..., C) valid)."""
    low_hw = binmasks.shape[-2:]
    input_hw = orig_hw if input_hw is None else input_hw
    frame_px_hw = input_hw if frame_px_hw is None else frame_px_hw
    to_input, lim, inv, area_scale = _low_res_frame_maps(
        low_hw, orig_hw, input_hw, frame_px_hw, binmasks.device
    )
    min_area_low = max(int(round(min_area * area_scale)), 1)
    # invalid candidates are blanked; their boxes and flags are never used
    masks = binmasks & valid[..., None, None]
    out_masks, changed = clean_mask(masks, min_area_low, k=k)
    boxes = torch.minimum(torch.clamp(batched_mask_to_box(out_masks) * to_input, min=0.0), lim) * inv
    if orig_boxes is not None:
        # only masks the cleanup changed get the recomputed box
        boxes = torch.where(changed[..., None], boxes, orig_boxes)
    scores = torch.where(changed, 0.0, 1.0)
    keep = nms(boxes, scores, box_nms_thresh, valid=valid)
    return boxes, keep & valid
