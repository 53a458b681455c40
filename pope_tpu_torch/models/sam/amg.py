"""Automatic mask generation (port of pope_tpu/models/sam/amg.py).

Two paths over one device program (grid prompts -> chunked multimask decode
-> IoU and stability filters -> mask -> box -> NMS -> top-`mask_capacity`
cut, with fixed-capacity outputs):
- the eval path, `generate_boxes_batch`: the stride-4 subsampled decode and
  the small-region cleanup on the device; boxes and validity stay there;
- the records path, `generate` / `generate_batch` / `generate_records`: the
  full-resolution decode, one download per batch, the small-region cleanup
  of each image on the host (the native library, one thread per image), and
  the reference's mask records with RLE; with `crop_n_layers > 0` the
  reference's multi-crop sweep on the host over per-crop device programs.
The JAX package's `vmap` over images is a batch dimension here (the decode
loops over images, because each image's prompts share its embedding); its
`lax.map` over prompt chunks is a Python loop. Its bit-packed mask download
exists for its TPU link and has no counterpart: bool masks are downloaded.
"""

from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np
import torch

from pope_tpu_torch import native
from pope_tpu_torch.config import AMGConfig
from pope_tpu_torch.models.sam.sam import MASK_THRESHOLD, postprocess_masks, rect_frame, resize_longest_side
from pope_tpu_torch.ops.components import clean_mask
from pope_tpu_torch.ops.masks import (
    batched_mask_to_box,
    build_all_layer_point_grids,
    build_point_grid,
    calculate_stability_score,
    generate_crop_boxes,
    is_box_near_crop_edge_np,
)
from pope_tpu_torch.ops.nms import nms
from pope_tpu_torch.ops.resize import resize_bilinear_antialias
from pope_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class AMGResult(NamedTuple):
    """Candidates of a batch, (B, C, ...) tensors on the device, or of one
    image, (C, ...) host numpy arrays on the records path."""

    masks_low_res: torch.Tensor  # (B, C, h, w) logits over the encode frame
    boxes: torch.Tensor  # (B, C, 4) XYXY in original image coords
    iou_preds: torch.Tensor  # (B, C)
    stability: torch.Tensor  # (B, C)
    areas: torch.Tensor  # (B, C) pixel area at original resolution (approx)
    valid: torch.Tensor  # (B, C) bool
    n_dropped: torch.Tensor  # (B,) NMS survivors cut by mask_capacity
    point_idx: torch.Tensor  # (B, C) prompt index of each candidate

    @property
    def boxes_xywh(self):
        """boxes as XYWH, a tensor or a numpy array as boxes is."""
        b = self.boxes
        xp = torch if torch.is_tensor(b) else np
        return xp.stack([b[..., 0], b[..., 1], b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1)


class AutomaticMaskGenerator:
    """AMG over a Sam module.

        amg = AutomaticMaskGenerator(sam, amg_cfg)          # on the card
        boxes_xywh, valid, n_dropped = amg.generate_boxes_batch(frames)
        result = amg.generate(image_rgb)                    # host arrays
        records = amg.generate_records(image_rgb)           # mask records

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
        self._layer_gens = {}  # the multi-crop sweep's sub-generator of each crop layer

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

    # ---- the records path ----

    def _amg_full(self, images):
        """The device side of generate_batch on (B, H, W, 3) uint8 frames:
        encode, full-resolution decode, filters, NMS and the capacity cut.
        Returns the (B, C, ...) result and the resized content extent."""
        images = torch.as_tensor(images, device=self.device)
        orig_h, orig_w = images.shape[1:3]
        in_h, in_w = resize_longest_side(orig_h, orig_w, self.sam_cfg.encoder.img_size)
        embs = self._encode(images, in_h, in_w)
        return self._generate_impl(embs, in_h, in_w, orig_h, orig_w), (in_h, in_w)

    @torch.no_grad()
    def generate_from_embeddings(self, embeddings, orig_hw, input_hw) -> AMGResult:
        """AMG of one image from its (1, gh, gw, C) embedding, no cleanup:
        the device result without the batch dimension."""
        emb = torch.as_tensor(embeddings, device=self.device)
        if emb.ndim != 4 or emb.shape[0] != 1:
            raise ValueError(f"expected one image's (1, gh, gw, C) embedding, got {tuple(emb.shape)}")
        res = self._generate_impl(emb, int(input_hw[0]), int(input_hw[1]), int(orig_hw[0]), int(orig_hw[1]))
        return AMGResult(*(x[0] for x in res))

    def generate(self, image_rgb) -> AMGResult:
        """The records path on one (H, W, 3) RGB uint8 frame, mask logits
        kept (mask records and demos upsample them)."""
        return self.generate_batch([image_rgb], keep_logits=True)[0]

    @torch.no_grad()
    def generate_batch(self, images_rgb, keep_logits: bool = False) -> list:
        """The records path over same-shape frames (a list of (H, W, 3) RGB
        uint8 frames or a (B, H, W, 3) array or tensor): one device program,
        one download, then each image's small-region cleanup on the host,
        in threads. Returns one host AMGResult of (C, ...) numpy arrays per
        image.

        keep_logits=False downloads the binarized masks only: masks_low_res
        then holds +-1 pseudo-logits. keep_logits=True downloads the f32
        logits, so that records and demos upsample the true boundaries."""
        if isinstance(images_rgb, (list, tuple)):
            images_rgb = np.stack([np.asarray(im, np.uint8) for im in images_rgb])
        orig_hw = tuple(images_rgb.shape[1:3])
        res, in_hw = self._amg_full(images_rgb)
        host = download_result(res, keep_logits)
        frame_hw = self._frame_hw(*in_hw)
        min_area = self.cfg.min_mask_region_area

        def finish(i):
            masks = host.masks_low_res[i]
            binm = masks > MASK_THRESHOLD if keep_logits else masks
            r = AMGResult(
                masks_low_res=masks if keep_logits else np.where(binm, 1.0, -1.0).astype(np.float32),
                boxes=host.boxes[i], iou_preds=host.iou_preds[i], stability=host.stability[i],
                areas=host.areas[i], valid=host.valid[i], n_dropped=host.n_dropped[i],
                point_idx=host.point_idx[i],
            )
            if min_area > 0:
                r = postprocess_small_regions_host(
                    r, min_area, orig_hw, self.cfg.box_nms_thresh, binmasks=binm,
                    input_hw=in_hw, frame_px_hw=frame_hw,
                )
            return r

        n = len(host.valid)
        if n > 1 and min_area > 0:
            # the native cleanup releases the GIL: one thread per image
            with ThreadPoolExecutor(max_workers=min(n, 8)) as pool:
                return list(pool.map(finish, range(n)))
        return [finish(i) for i in range(n)]

    def generate_records(self, image_rgb) -> list:
        """The reference's mask records of one (H, W, 3) RGB uint8 frame: the
        single-crop path when cfg.crop_n_layers is 0 (POPE's configuration),
        else the multi-crop sweep. A capacity overflow is logged."""
        image = np.asarray(image_rgb, np.uint8)
        if self.cfg.crop_n_layers > 0:
            return self._generate_multicrop_records(image)
        res = self.generate(image)
        n_dropped = int(res.n_dropped)
        if n_dropped > 0:
            logger.warning("%d masks over mask_capacity were dropped (raise AMGConfig.mask_capacity)", n_dropped)
        in_hw = resize_longest_side(*image.shape[:2], self.sam_cfg.encoder.img_size)
        return amg_records(res, image.shape[:2], in_hw, point_grid01=self._grid01, device=self.device)

    def _layer_generator(self, layer: int) -> "AutomaticMaskGenerator":
        """The multi-crop sweep's generator of one crop layer, built once: its
        layer's grid, every candidate kept (capacity pps^2 * 3), NMS and the
        small-region cleanup left to the sweep."""
        if layer not in self._layer_gens:
            cfg = self.cfg
            # the >= 1 clamp of build_all_layer_point_grids, so that this grid
            # and grids[layer] (point provenance) have the same size
            pps = max(int(cfg.points_per_side / (cfg.crop_n_points_downscale_factor**layer)), 1)
            sub_cfg = dataclasses.replace(
                cfg, points_per_side=pps, box_nms_thresh=1.5, min_mask_region_area=0,
                mask_capacity=pps * pps * 3, crop_n_layers=0,
            )
            self._layer_gens[layer] = AutomaticMaskGenerator(self.sam, sub_cfg, device=self.device)
        return self._layer_gens[layer]

    @torch.no_grad()
    def _generate_multicrop_records(self, image: np.ndarray) -> list:
        """crop_n_layers > 0, the reference's sweep: per crop, grid prompts ->
        filters -> crop-edge filter -> NMS -> uncrop at full resolution; then
        NMS across crops preferring smaller crops, and the full-resolution
        small-region cleanup with a re-NMS preferring untouched masks."""
        cfg = self.cfg
        oh, ow = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes((oh, ow), cfg.crop_n_layers, cfg.crop_overlap_ratio)
        grids = build_all_layer_point_grids(cfg.points_per_side, cfg.crop_n_layers,
                                            cfg.crop_n_points_downscale_factor)
        masks_all, boxes_all, iou_all, stab_all, pts_all, cbox_all = [], [], [], [], [], []
        for crop_box, layer in zip(crop_boxes, layer_idxs):
            x0, y0, x1, y1 = crop_box
            sub = np.ascontiguousarray(image[y0:y1, x0:x1])
            ch, cw = sub.shape[:2]
            # true logits: the reference thresholds after upsampling to the crop
            res = self._layer_generator(layer).generate_batch([sub], keep_logits=True)[0]
            boxes, iou = res.boxes, res.iou_preds  # crop coords
            valid = res.valid & ~is_box_near_crop_edge_np(boxes, crop_box, [0, 0, ow, oh])
            keep = _nms_host(boxes, iou, cfg.box_nms_thresh, valid)
            if not keep.any():
                continue
            idx = np.nonzero(keep)[0]
            in_hw = resize_longest_side(ch, cw, self.sam_cfg.encoder.img_size)
            logits = torch.from_numpy(res.masks_low_res[idx]).to(self.device)
            up = (postprocess_masks(logits[None], in_hw, (ch, cw))[0] > MASK_THRESHOLD).cpu().numpy()
            full = np.zeros((len(idx), oh, ow), bool)
            full[:, y0:y1, x0:x1] = up
            masks_all.append(full)
            boxes_all.append(boxes[idx] + np.asarray([x0, y0, x0, y0], np.float32))
            iou_all.append(iou[idx])
            stab_all.append(res.stability[idx])
            pt = grids[layer][res.point_idx[idx]] * np.asarray([cw, ch], np.float32)
            pts_all.append(pt + np.asarray([x0, y0], np.float32))
            cbox_all.append(np.tile(np.asarray(crop_box, np.float32), (len(idx), 1)))
        if not masks_all:
            return []
        masks, boxes, iou, stab, pts, cboxes = (
            np.concatenate(a) for a in (masks_all, boxes_all, iou_all, stab_all, pts_all, cbox_all)
        )

        if len(crop_boxes) > 1:
            # prefer masks from smaller crops
            areas = (cboxes[:, 2] - cboxes[:, 0]) * (cboxes[:, 3] - cboxes[:, 1])
            keep = _nms_host(boxes, (1.0 / np.maximum(areas, 1.0)).astype(np.float32),
                             cfg.crop_nms_thresh, np.ones(len(boxes), bool))
            masks, boxes, iou, stab, pts, cboxes = (a[keep] for a in (masks, boxes, iou, stab, pts, cboxes))

        if cfg.min_mask_region_area > 0:
            changed = np.zeros(len(masks), bool)
            for i in range(len(masks)):
                m, ch1 = native.remove_small_regions(masks[i], cfg.min_mask_region_area, "holes")
                m, ch2 = native.remove_small_regions(m, cfg.min_mask_region_area, "islands")
                masks[i] = m
                changed[i] = ch1 or ch2
            boxes = _mask_to_box_np(masks)
            keep = _nms_host(boxes, np.where(changed, 0.0, 1.0).astype(np.float32),
                             max(cfg.box_nms_thresh, cfg.crop_nms_thresh), masks.any((-2, -1)))
            masks, boxes, iou, stab, pts, cboxes = (a[keep] for a in (masks, boxes, iou, stab, pts, cboxes))

        records = []
        for i in range(len(masks)):
            x0, y0, x1, y1 = boxes[i]
            cx0, cy0, cx1, cy1 = cboxes[i]
            records.append({
                "segmentation": masks[i],
                "rle": native.rle_encode(masks[i]),
                "area": int(masks[i].sum()),
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "predicted_iou": float(iou[i]),
                "stability_score": float(stab[i]),
                "point_coords": [[float(pts[i, 0]), float(pts[i, 1])]],
                "crop_box": [float(cx0), float(cy0), float(cx1 - cx0), float(cy1 - cy0)],
            })
        return records


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


def download_result(res: AMGResult, keep_logits: bool) -> AMGResult:
    """A (B, C, ...) device result as host numpy arrays; masks_low_res holds
    the f32 logits with keep_logits, else the bool binarization."""
    masks = res.masks_low_res.float() if keep_logits else res.masks_low_res > MASK_THRESHOLD
    return AMGResult(
        masks_low_res=masks.cpu().numpy(),
        boxes=res.boxes.cpu().numpy(),
        iou_preds=res.iou_preds.float().cpu().numpy(),
        stability=res.stability.cpu().numpy(),
        areas=res.areas.cpu().numpy(),
        valid=res.valid.cpu().numpy(),
        n_dropped=res.n_dropped.cpu().numpy(),
        point_idx=res.point_idx.cpu().numpy(),
    )


def _mask_to_box_np(masks: np.ndarray) -> np.ndarray:
    """batched_mask_to_box of host masks: (C, H, W) bool -> (C, 4) f32."""
    return batched_mask_to_box(torch.from_numpy(np.ascontiguousarray(masks))).numpy()


def _nms_host(boxes: np.ndarray, scores: np.ndarray, thresh: float, valid: np.ndarray) -> np.ndarray:
    """Greedy NMS on the host (the native library) in which invalid
    candidates suppress nothing, as ops.nms.nms(valid=...)."""
    keep = np.zeros(len(boxes), bool)
    idx = np.nonzero(valid)[0]
    if len(idx):
        keep[idx] = native.nms_cpu(boxes[idx], scores[idx], thresh)
    return keep


def postprocess_small_regions_host(
    result: AMGResult, min_area: int, orig_hw, box_nms_thresh: float = 0.35,
    binmasks: Optional[np.ndarray] = None, input_hw=None, frame_px_hw=None,
) -> AMGResult:
    """The small-region cleanup of one image's host result: fill holes and
    drop islands below min_area (original-image pixels, rescaled to the
    low-res grid) with the native library, recompute every box, and re-run
    NMS preferring untouched masks. binmasks: the (C, h, w) binarization of
    masks_low_res, if already at hand; input_hw / frame_px_hw as
    postprocess_small_regions_device takes them."""
    masks = np.asarray(result.masks_low_res) > MASK_THRESHOLD if binmasks is None else np.asarray(binmasks, bool)
    valid = np.asarray(result.valid)
    input_hw = orig_hw if input_hw is None else input_hw
    frame_px_hw = input_hw if frame_px_hw is None else frame_px_hw
    to_input, lim, inv, scale = _low_res_frame_maps(masks.shape[-2:], orig_hw, input_hw, frame_px_hw, "cpu")
    to_input, lim, inv = (a.numpy() for a in (to_input, lim, inv))
    min_area_low = max(int(round(min_area * scale)), 1)

    changed = np.zeros(len(masks), bool)
    out_masks = masks.copy()
    for i in np.nonzero(valid)[0]:
        m, ch1 = native.remove_small_regions(masks[i], min_area_low, "holes")
        m, ch2 = native.remove_small_regions(m, min_area_low, "islands")
        out_masks[i] = m
        changed[i] = ch1 or ch2

    boxes = (np.clip(_mask_to_box_np(out_masks) * to_input, 0.0, lim) * inv).astype(np.float32)
    keep = _nms_host(boxes, np.where(changed, 0.0, 1.0).astype(np.float32), box_nms_thresh, valid)
    # changed masks become +-1 logits
    logits = np.where(changed[:, None, None], np.where(out_masks, 1.0, -1.0),
                      np.asarray(result.masks_low_res)).astype(np.float32)
    return AMGResult(
        masks_low_res=logits,
        boxes=boxes,
        iou_preds=np.asarray(result.iou_preds),
        stability=np.asarray(result.stability),
        areas=(out_masks.sum((-2, -1)) / scale).astype(np.float32),
        valid=keep & valid,
        n_dropped=result.n_dropped,
        point_idx=result.point_idx,
    )


def amg_records(result: AMGResult, orig_hw, input_hw, point_grid01=None, device=None) -> list:
    """One image's host result as the reference's mask records, one dict per
    valid candidate: "segmentation" ((H, W) bool at the original size),
    "rle" (uncompressed, column-major), "area", "bbox" (XYWH),
    "predicted_iou", "stability_score", "crop_box" (the whole image) and,
    given the [0, 1] prompt grid, "point_coords". The masks are upsampled on
    `device` (default CUDA; raises without a GPU unless device="cpu")."""
    dev = resolve_device(device)
    ok = np.asarray(result.valid)
    idx = np.nonzero(ok)[0]
    logits = torch.as_tensor(np.asarray(result.masks_low_res, np.float32)[idx], device=dev)
    with torch.no_grad():
        masks_full = (postprocess_masks(logits[None], input_hw, orig_hw)[0] > MASK_THRESHOLD).cpu().numpy()
    boxes = np.asarray(result.boxes)
    ious = np.asarray(result.iou_preds)
    stab = np.asarray(result.stability)
    pts = None
    if result.point_idx is not None and point_grid01 is not None:
        grid = point_grid01.cpu().numpy() if torch.is_tensor(point_grid01) else np.asarray(point_grid01)
        pts = grid[np.asarray(result.point_idx)] * np.asarray([orig_hw[1], orig_hw[0]], np.float32)[None]
    records = []
    for seg, i in zip(masks_full, idx):
        x0, y0, x1, y1 = boxes[i]
        rec = {
            "segmentation": seg,
            "rle": native.rle_encode(seg),
            "area": int(seg.sum()),
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "predicted_iou": float(ious[i]),
            "stability_score": float(stab[i]),
            "crop_box": [0.0, 0.0, float(orig_hw[1]), float(orig_hw[0])],
        }
        if pts is not None:
            rec["point_coords"] = [[float(pts[i, 0]), float(pts[i, 1])]]
        records.append(rec)
    return records
