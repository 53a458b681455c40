"""Novel-view rendering over LINEMOD-layout sequences (port of
pope_tpu/nvs/driver.py).

Reads color/{i}.png, poses_ba/{i}.txt and intrin_ba/{i}.txt for the source
ids, takes the depth range from the poses' z-translation ([0.6 min, 1.5
max]), fits the scene's NeRF, renders each target id and writes
`{label}_gt_pose_{idx}.jpg` (the render) beside `{label}_gt_{idx}.jpg` (the
ground truth), reporting PSNR and SSIM, and LPIPS when its parameters are
given.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from pope_tpu_torch.nvs.nerf import NerfConfig, init_nerf, make_rays, render_image, train_nerf
from pope_tpu_torch.utils.device import resolve_device
from pope_tpu_torch.utils.image_metrics import psnr, ssim
from pope_tpu_torch.utils.logging import get_logger

logger = get_logger("pope_tpu_torch.nvs")


def _load_view(root: str, idx: int):
    import cv2

    rgb = cv2.imread(os.path.join(root, "color", f"{idx}.png"), cv2.IMREAD_COLOR)
    if rgb is None:
        raise FileNotFoundError(f"{root}/color/{idx}.png")
    rgb = rgb[..., ::-1].astype(np.float32) / 255.0
    pose = np.loadtxt(os.path.join(root, "poses_ba", f"{idx}.txt"))
    K = np.loadtxt(os.path.join(root, "intrin_ba", f"{idx}.txt"))
    return rgb, pose, K


def _downscaled(rgb, K, downscale: int):
    import cv2

    if downscale <= 1:
        return rgb, K
    h, w = rgb.shape[0] // downscale, rgb.shape[1] // downscale
    K = K.copy()
    K[:2] /= downscale
    return cv2.resize(rgb, (w, h), interpolation=cv2.INTER_AREA), K


def render_novel_views(seq_root: str, source_ids: Sequence[int], target_ids: Optional[Sequence[int]] = None,
                       out_dir: str = ".", label: Optional[str] = None, cfg: NerfConfig = NerfConfig(),
                       train_steps: int = 2000, downscale: int = 1, seed: int = 0, lpips_params=None,
                       device=None):
    """Fit the sequence's source views on `device` (default CUDA), render the
    targets, write the jpg pairs. Returns [(idx, psnr, ssim), ...], with an
    LPIPS column when `lpips_params` (utils/lpips.py's tree) is given. The
    field is initialised from `seed` and its ray batches drawn from a
    generator on `device` seeded with seed + 1."""
    import cv2

    dev = resolve_device(device)
    label = label or os.path.basename(os.path.dirname(seq_root.rstrip("/")))
    views = [_load_view(seq_root, i) for i in source_ids]
    zs = np.array([p[2][3] for _, p, _ in views])
    near, far = float(zs.min() * 0.6), float(zs.max() * 1.5)

    all_o, all_d, all_rgb = [], [], []
    for rgb, pose, K in views:
        rgb, K = _downscaled(rgb, K, downscale)
        o, d = make_rays(K, pose, rgb.shape[:2])
        all_o.append(o.reshape(-1, 3))
        all_d.append(d.reshape(-1, 3))
        all_rgb.append(rgb.reshape(-1, 3))
    rays_o = torch.from_numpy(np.concatenate(all_o)).to(dev)
    rays_d = torch.from_numpy(np.concatenate(all_d)).to(dev)
    rgbs = torch.from_numpy(np.concatenate(all_rgb).astype(np.float32)).to(dev)
    logger.info("fitting %s: %d source views, %d rays, depth range [%.3f, %.3f]", label, len(views),
                rays_o.shape[0], near, far)

    model, state = init_nerf(cfg, seed, dev)
    train_nerf(model, state, rays_o, rays_d, rgbs, near, far, train_steps,
               generator=torch.Generator(device=dev).manual_seed(seed + 1), log_every=max(train_steps // 10, 1))

    if lpips_params is not None:
        from pope_tpu_torch.utils.lpips import lpips_distance, params_to

        lpips_params = params_to(lpips_params, dev)
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for idx in target_ids if target_ids is not None else source_ids:
        rgb, pose, K = _load_view(seq_root, idx)
        rgb, K = _downscaled(rgb, K, downscale)
        render = render_image(model, K, pose, rgb.shape[:2], near, far)
        p, s = psnr(render, rgb), ssim(render, rgb)
        if lpips_params is not None:
            lp = float(lpips_distance(lpips_params, render[None], rgb[None])[0])
            results.append((idx, p, s, lp))
            logger.info("view %d: psnr=%.2f ssim=%.3f lpips=%.4f", idx, p, s, lp)
        else:
            results.append((idx, p, s))
            logger.info("view %d: psnr=%.2f ssim=%.3f", idx, p, s)
        cv2.imwrite(os.path.join(out_dir, f"{label}_gt_pose_{idx}.jpg"), (render[..., ::-1] * 255).astype(np.uint8))
        cv2.imwrite(os.path.join(out_dir, f"{label}_gt_{idx}.jpg"), (rgb[..., ::-1] * 255).astype(np.uint8))
    return results


def render_main(args):
    """CLI entry (`cli render-novel-view`)."""
    source_ids = [int(s) for s in args.source_ids.split(",")]
    target_ids = [int(s) for s in args.target_ids.split(",")] if args.target_ids else None
    lpips_params = None
    if args.lpips_alexnet or args.lpips_lins:
        if not (args.lpips_alexnet and args.lpips_lins):
            raise SystemExit("--lpips-alexnet and --lpips-lins must be given together")
        from pope_tpu_torch.utils.lpips import lpips_from_torch_files

        lpips_params = lpips_from_torch_files(args.lpips_alexnet, args.lpips_lins)
    return render_novel_views(args.seq_root, source_ids, target_ids, out_dir=args.out_dir, label=args.label,
                              train_steps=args.train_steps, downscale=args.downscale, seed=args.seed,
                              lpips_params=lpips_params, device=args.device)
