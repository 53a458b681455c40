"""Regressor dataset: extraction dumps + ground truth for training and eval
(port of pope_tpu/models/regressor/data.py: the same files, skips, seeded
`random.Random` draws in the same order, crops resized to 224 by cv2 and
scaled by 1/255, supervision 'relative_r-gt_t')."""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from pope_tpu_torch.eval.manifest import DATASETS, iter_pairs, load_manifest


def load_pose_dataset(dataset: str, data_root: str, pairs_dir: str, points_dir: str, img_size: int = 224,
                      max_pairs: Optional[int] = None, load_images: bool = True) -> List[Dict]:
    """Every pair of the manifest with a readable, non-empty dump under
    points_dir/<label>/{mkpts0,mkpts1,pre_bbox,pre_K[,img0,img1]}."""
    import cv2

    spec = DATASETS[dataset]
    manifest = load_manifest(pairs_dir, spec)
    data = []
    for paths in iter_pairs(data_root, spec, manifest):
        if max_pairs is not None and len(data) >= max_pairs:
            break
        label = paths.pair_name.split("/")[0]
        points_name = paths.pair_name.split("/")[-1]
        base = Path(points_dir) / label
        try:
            mkpts0 = np.loadtxt(base / "mkpts0" / f"{points_name}.txt")
            mkpts1 = np.loadtxt(base / "mkpts1" / f"{points_name}.txt")
            pre_bbox = np.loadtxt(base / "pre_bbox" / f"{points_name}.txt")
            pre_K = np.loadtxt(base / "pre_K" / f"{points_name}.txt")
        except (OSError, ValueError):
            continue  # a pair without a dump
        if mkpts0.ndim != 2 or mkpts0.shape[0] == 0 or mkpts0.shape != mkpts1.shape:
            continue
        pose0 = np.loadtxt(paths.pose0)
        pose1 = np.loadtxt(paths.pose1)
        if pose0.shape[0] == 3:
            pose0 = np.vstack([pose0, [0, 0, 0, 1]])
        if pose1.shape[0] == 3:
            pose1 = np.vstack([pose1, [0, 0, 0, 1]])
        item = {
            "K0": np.loadtxt(paths.k0, delimiter=" "), "K1": np.loadtxt(paths.k1, delimiter=" "),
            "pose0": pose0, "pose1": pose1, "pre_bbox": pre_bbox, "pre_K": pre_K,
            "mkpts0": mkpts0.astype(np.float32), "mkpts1": mkpts1.astype(np.float32),
            "pair_name": paths.pair_name, "name": label,
        }
        if load_images:
            img0 = cv2.imread(str(base / "img0" / f"{points_name}.png"))
            img1 = cv2.imread(str(base / "img1" / f"{points_name}.png"))
            if img0 is None or img1 is None:
                continue
            item["img0"] = cv2.resize(img0, (img_size, img_size)).astype(np.float32) / 255.0
            item["img1"] = cv2.resize(img1, (img_size, img_size)).astype(np.float32) / 255.0
        data.append(item)
    return data


def sample_mkpts(mkpts: np.ndarray, num_sample: int, rng: random.Random) -> np.ndarray:
    """Subsample or zero-pad to num_sample rows."""
    n = mkpts.shape[0]
    if n > num_sample:
        return mkpts[rng.sample(range(n), num_sample)]
    return np.concatenate([mkpts, np.zeros((num_sample - n, 2), np.float32)], axis=0)


def make_batches(data: List[Dict], num_sample: int, batch_size: int, seed: int = 20231223, shuffle: bool = True,
                 with_images: bool = False):
    """Numpy batches with 'relative_r-gt_t' supervision: gt_R the relative
    rotation pose1 inv(pose0), gt_t the target's translation."""
    rng = random.Random(seed)
    order = list(range(len(data)))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        items = [data[i] for i in order[start : start + batch_size]]
        batch = {
            "mkpts0": np.stack([sample_mkpts(it["mkpts0"], num_sample, rng) for it in items]),
            "mkpts1": np.stack([sample_mkpts(it["mkpts1"], num_sample, rng) for it in items]),
            "gt_R": np.stack([(it["pose1"] @ np.linalg.inv(it["pose0"]))[:3, :3] for it in items]).astype(np.float32),
            "gt_t": np.stack([it["pose1"][:3, 3] for it in items]).astype(np.float32),
        }
        if with_images:
            batch["img0"] = np.stack([it["img0"] for it in items])
            batch["img1"] = np.stack([it["img1"] for it in items])
        yield batch


def train_val_split(data: List[Dict], seed: int = 20231223, val_frac: float = 0.2):
    """A seeded 80/20 random split."""
    rng = random.Random(seed)
    order = list(range(len(data)))
    rng.shuffle(order)
    val_idx = set(order[: int(len(order) * val_frac)])
    return ([d for i, d in enumerate(data) if i not in val_idx], [d for i, d in enumerate(data) if i in val_idx])
