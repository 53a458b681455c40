"""The demo entry points (port of pope_tpu/pipeline/demos.py), after the
reference's visual_dinov2.py (patch-PCA heatmap -> headmap.jpg),
visual_sam.py (AMG masks rendered -> LINEMOD_mask.png) and visual_3dbbox.py
(one pair through the pipeline, the 3-D box and axes drawn ->
query_result.png, 3D_BBox.png). The models run on `models.device`; images
are read and written on the host with cv2.
"""

from __future__ import annotations

import numpy as np
import torch

from pope_tpu_torch.data.image_io import read_rgb


def _write(path: str, image_bgr: np.ndarray) -> None:
    import cv2

    if not cv2.imwrite(path, image_bgr):
        raise OSError(f"cannot write image {path}")


@torch.no_grad()
def demo_dinov2_heatmap(models, image_path: str, out_path: str = "headmap.jpg", size: int = 448):
    """visual_dinov2.py: the image resized to size x size, DINOv2's patch
    tokens, their first principal component as a JET heatmap at the input
    size (written to out_path unless it is empty). Returns the heatmap."""
    import cv2

    from pope_tpu_torch.models.dinov2.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from pope_tpu_torch.utils.draw import pca_heatmap

    img = cv2.resize(read_rgb(image_path), (size, size)).astype(np.float32) / 255.0
    x = ((img - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)).astype(np.float32)
    out = models.dinov2(torch.from_numpy(x)[None].to(models.device))
    patch = models.config.dinov2.patch_size
    g = size // patch
    return pca_heatmap(out["x_norm_patchtokens"][0].float().cpu().numpy(), (g, g), out_path, patch)


@torch.no_grad()
def demo_sam_masks(models, image_path: str, out_path: str = "LINEMOD_mask.png"):
    """visual_sam.py: the records path's masks of one image, upsampled to its
    size and overlaid in random colours. Returns the BGR render."""
    import cv2

    from pope_tpu_torch.models.sam.sam import postprocess_masks, resize_longest_side
    from pope_tpu_torch.utils.draw import render_masks

    img = read_rgb(image_path)
    res = models.amg.generate(img)
    in_hw = resize_longest_side(img.shape[0], img.shape[1], models.amg.sam_cfg.encoder.img_size)
    logits = torch.from_numpy(res.masks_low_res[res.valid]).to(models.device)
    masks = (postprocess_masks(logits[None], in_hw, img.shape[:2])[0] > 0).cpu().numpy()
    out = render_masks(cv2.cvtColor(img, cv2.COLOR_RGB2BGR), masks)
    _write(out_path, out)
    return out


@torch.no_grad()
def demo_3dbbox(
    models,
    prompt_path: str,
    target_path: str,
    K0,
    K1,
    prompt_pose,
    box3d_corners,
    target_pose=None,
    out_query: str = "query_result.png",
    out_bbox: str = "3D_BBox.png",
    noise=None,
):
    """visual_3dbbox.py: one (prompt, target) pair through the pipeline (the
    records-path AMG of the target, retrieval, matching, the solver), then
    the 3-D box drawn with the predicted relative rotation composed onto the
    prompt pose and the target's ground-truth translation kept (the demo has
    no metric scale for t); 3D_BBox.png is that drawing, query_result.png
    the resized prompt beside the winning crop.

    noise: the solver's Gumbel noise (n_rounds, n_hyps, match_capacity), or
    None for a generator seeded with 0 on the models' device (the JAX demo
    draws from PRNGKey(0), whose bits torch cannot repeat).
    Returns (the box drawing, the query image, the PairResult)."""
    import cv2

    from pope_tpu_torch.geometry.affine import get_image_crop_resize
    from pope_tpu_torch.geometry.pose import project_points
    from pope_tpu_torch.models.dinov2.preprocess import preprocess_image
    from pope_tpu_torch.pipeline.runner import get_executor
    from pope_tpu_torch.utils.draw import draw_axis, draw_bbox_3d

    dev = models.device
    img0, img1 = read_rgb(prompt_path), read_rgb(target_path)
    img0_t = torch.from_numpy(img0).to(dev)
    img1_01 = torch.from_numpy(img1).to(dev).float() / 255.0
    ref_cls = models.dinov2(preprocess_image(img0_t[None], center_crop=True))["x_norm_clstoken"][0]
    amg_res = models.amg.generate(img1)
    if noise is None:
        noise = torch.Generator(device=dev).manual_seed(0)
    result = get_executor(models, 256).estimate_pair(
        img0_t.float() / 255.0, img1_01, torch.as_tensor(K0, dtype=torch.float32),
        torch.as_tensor(K1, dtype=torch.float32), amg_res, ref_cls, noise,
    )

    R_rel = result.R.cpu().numpy()
    prompt_pose = np.asarray(prompt_pose)
    t_src = np.asarray(target_pose) if target_pose is not None else prompt_pose
    R_obj = R_rel @ prompt_pose[:3, :3]
    t_obj = t_src[:3, 3]
    RT = np.hstack([R_obj, t_obj[:, None]]).astype(np.float32)
    corners2d, _ = project_points(box3d_corners, RT, K1)
    vis = draw_bbox_3d(cv2.cvtColor(img1, cv2.COLOR_RGB2BGR), corners2d.numpy())
    vis = draw_axis(vis, R_obj, t_obj, K1)
    _write(out_bbox, vis)

    crop, _ = get_image_crop_resize(img1_01[None], result.pre_bbox.float()[None, None], (256, 256))
    crop = (np.clip(crop[0, 0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    que = cv2.resize(cv2.cvtColor(img0, cv2.COLOR_RGB2BGR), (256, 256))
    stack = np.hstack([que, cv2.cvtColor(crop, cv2.COLOR_RGB2BGR)])
    _write(out_query, stack)
    return vis, stack, result
