"""Extraction: run the pipeline and dump each pair's artifacts for regressor
training (port of pope_tpu/eval/extract.py). Instead of solving the pose it
writes {pre_bbox, mkpts0, mkpts1, pre_K, img0 (the prompt frame), img1 (the
winning target crop)} under <out>/<label>/<kind>/<pair>.{txt,png}; pairs
with fewer than 5 matches are skipped. Stage 1 runs the records-path AMG
(kernels 1 and 2), stage 2 the retrieve -> match step (kernel 3).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pope_tpu_torch.eval.manifest import DATASETS, iter_pairs, load_manifest
from pope_tpu_torch.geometry.affine import get_image_crop_resize
from pope_tpu_torch.pipeline import runner

SUBDIRS = ("pre_bbox", "mkpts0", "mkpts1", "pre_K", "img0", "img1")


@torch.no_grad()
def extract_pair(models, paths, spec, out_dir: str, noise=None) -> bool:
    """Run the pipeline for one pair and write its dump; True when the pair
    had at least 5 matches and was written. noise: the solver's Gumbel
    noise (n_rounds, n_hyps, M), by default the pair's own
    (runner.pair_noise)."""
    import cv2

    dev = models.device
    img0 = cv2.cvtColor(cv2.imread(paths.image0), cv2.COLOR_BGR2RGB)
    img1 = cv2.cvtColor(cv2.imread(paths.image1), cv2.COLOR_BGR2RGB)
    K1 = np.loadtxt(paths.k1, delimiter=" ").astype(np.float32)
    K0 = np.loadtxt(paths.k0, delimiter=" ").astype(np.float32)
    if noise is None:
        cfg = models.config
        noise = runner.pair_noise([paths], cfg.matcher.match_coarse.match_capacity, cfg.ransac_rounds, dev)[0]

    executor = runner.get_executor(models, spec.crop_size)
    img0_u8, img1_u8 = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (img0, img1))
    ref_cls = executor.prompt_cls_raw(img0_u8[None])[0]
    amg_res = models.amg.generate_batch(img1[None], keep_logits=True)[0]
    result = executor.estimate_pair(img0_u8, img1_u8, torch.from_numpy(K0), torch.from_numpy(K1), amg_res, ref_cls,
                                    noise)

    ok = result.match_valid.cpu().numpy()
    mkpts0 = result.mkpts0.cpu().numpy()[ok]
    mkpts1 = result.mkpts1.cpu().numpy()[ok]
    if len(mkpts0) < 5:
        return False

    # the winner's crop, regenerated from the frame
    crop1, _ = get_image_crop_resize(img1_u8[None].float(), result.pre_bbox[None, None],
                                     (spec.crop_size, spec.crop_size))
    write_dump(out_dir, paths.pair_name, result.pre_bbox.cpu().numpy(), mkpts0, mkpts1, result.pre_K.cpu().numpy(),
               img0, crop1[0, 0].cpu().numpy().astype(np.uint8))
    return True


def write_dump(out_dir: str, pair_name: str, pre_bbox, mkpts0, mkpts1, pre_K, img0_rgb, img1_rgb) -> None:
    """One pair's dump: <out_dir>/<label>/<kind>/<pair>.txt for pre_bbox,
    mkpts0, mkpts1, pre_K and .png for the (H, W, 3) uint8 RGB images img0
    (the prompt frame) and img1 (the target crop); label is the pair name's
    first part, pair its last."""
    import cv2

    label, points_name = pair_name.split("/")[0], pair_name.split("/")[-1]
    base = Path(out_dir) / label
    for sub in SUBDIRS:
        (base / sub).mkdir(parents=True, exist_ok=True)
    for sub, a in (("pre_bbox", pre_bbox), ("mkpts0", mkpts0), ("mkpts1", mkpts1), ("pre_K", pre_K)):
        np.savetxt(base / sub / f"{points_name}.txt", np.asarray(a))
    for sub, img in (("img0", img0_rgb), ("img1", img1_rgb)):
        cv2.imwrite(str(base / sub / f"{points_name}.png"), cv2.cvtColor(np.asarray(img, np.uint8), cv2.COLOR_RGB2BGR))


def extract_dataset(args):
    """The CLI body: extraction over a dataset manifest."""
    from pope_tpu_torch import pipeline

    models = pipeline.load_models(sam_checkpoint=args.sam_checkpoint, sam_type=args.sam_type,
                                  dinov2_checkpoint=args.dinov2_checkpoint,
                                  matcher_checkpoint=args.matcher_checkpoint, device=args.device)
    spec = DATASETS[args.dataset]
    manifest = load_manifest(args.pairs_dir, spec)
    n = written = 0
    for paths in iter_pairs(args.data_root, spec, manifest):
        if args.max_pairs is not None and n >= args.max_pairs:
            break
        written += int(extract_pair(models, paths, spec, args.out_dir))
        n += 1
    print(f"extracted {written}/{n} pairs -> {args.out_dir}")
