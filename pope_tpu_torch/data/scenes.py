"""Multi-scene training data: scene datasets, concatenation, per-rank splits
and scene-balanced sampling (a copy of the matcher-training part of
pope_tpu/data/scenes.py, which the port does not import: the same numpy
draws, so the same index order).

Reference behavior: src/datasets/scannet.py (npz-index pair dataset with
poses/intrinsics), src/datasets/megadepth.py (per-scene npz with depth),
src/lightning/data.py MultiSceneDataModule (concat + per-rank scene split),
src/utils/dataloader.py:6-23 get_local_split, src/datasets/sampler.py:5-77
RandomConcatSampler (n_samples_per_subset per scene, with/without
replacement, optional shuffle + repeat).
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence

import numpy as np

from pope_tpu_torch.data.readers import (
    read_megadepth_depth,
    read_megadepth_gray,
    read_scannet_depth,
    read_scannet_gray,
    read_scannet_intrinsic,
    read_scannet_pose,
)


def get_local_split(items: Sequence, world_size: int, rank: int, seed: int = 66):
    """Split `items` into `world_size` near-even chunks; pad by seeded
    resampling so every rank gets the same count (dataloader.py:6-23)."""
    n = len(items)
    per = math.ceil(n / world_size)
    rng = random.Random(seed)
    padded = list(items) + [rng.choice(items) for _ in range(per * world_size - n)]
    return padded[rank * per : (rank + 1) * per]


class ScanNetPairDataset:
    """Pairs from an npz index: arrays 'name' (N, 4: scene, seq, im0, im1)
    and optional 'score'. Loads grayscale frames, depths, world2cam poses."""

    def __init__(self, root: str, npz_path: str, intrinsic_path: str, min_overlap_score: float = 0.0):
        data = np.load(npz_path)
        names = data["name"]
        if "score" in data and min_overlap_score > 0:
            names = names[data["score"] > min_overlap_score]
        self.names = names
        self.root = root
        self.intrinsics = dict(np.load(intrinsic_path)) if intrinsic_path else None

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        import os.path as osp

        scene, seq, i0, i1 = self.names[idx]
        scene_name = f"scene{int(scene):04d}_{int(seq):02d}"
        d = osp.join(self.root, scene_name)
        out = {
            "image0": read_scannet_gray(osp.join(d, "color", f"{i0}.jpg")),
            "image1": read_scannet_gray(osp.join(d, "color", f"{i1}.jpg")),
            "depth0": read_scannet_depth(osp.join(d, "depth", f"{i0}.png")),
            "depth1": read_scannet_depth(osp.join(d, "depth", f"{i1}.png")),
            "T0": read_scannet_pose(osp.join(d, "pose", f"{i0}.txt")),
            "T1": read_scannet_pose(osp.join(d, "pose", f"{i1}.txt")),
            "pair_name": f"{scene_name}/{i0}_{i1}",
        }
        if self.intrinsics is not None:
            out["K"] = self.intrinsics[scene_name].reshape(3, 3)
        out["T_0to1"] = (out["T1"] @ np.linalg.inv(out["T0"])).astype(np.float32)
        out["T_1to0"] = np.linalg.inv(out["T_0to1"]).astype(np.float32)
        return out


class ConcatDataset:
    def __init__(self, datasets: List):
        self.datasets = datasets
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[ds][idx - int(self.offsets[ds])]


class RandomConcatSampler:
    """Scene-balanced index sampler over a ConcatDataset (sampler.py:5-77):
    draw n_samples_per_subset indices per sub-dataset each epoch, with or
    without replacement, optional whole-epoch shuffle and sample repetition.
    """

    def __init__(
        self,
        concat: ConcatDataset,
        n_samples_per_subset: int,
        subset_replacement: bool = True,
        shuffle: bool = True,
        repeat: int = 1,
        seed: Optional[int] = 66,
    ):
        self.concat = concat
        self.n = n_samples_per_subset
        self.replacement = subset_replacement
        self.shuffle = shuffle
        self.repeat = max(1, repeat)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.concat.datasets) * self.n * self.repeat

    def __iter__(self):
        chunks = []
        for d_idx, d in enumerate(self.concat.datasets):
            lo = int(self.concat.offsets[d_idx])
            hi = int(self.concat.offsets[d_idx + 1])
            if self.replacement:
                idx = self.rng.integers(lo, hi, size=self.n)
            else:
                pool = self.rng.permutation(np.arange(lo, hi))
                idx = pool[: self.n]
                if len(idx) < self.n:  # pad by resampling (sampler.py:51-56)
                    pad = self.rng.integers(lo, hi, size=self.n - len(idx))
                    idx = np.concatenate([idx, pad])
            chunks.append(idx)
        indices = np.concatenate(chunks)
        if self.shuffle:
            indices = self.rng.permutation(indices)
        if self.repeat > 1:
            reps = [indices]
            for _ in range(self.repeat - 1):
                reps.append(self.rng.permutation(indices) if self.shuffle else indices)
            indices = np.concatenate(reps)
        return iter(indices.tolist())


class MegaDepthPairDataset:
    """Pairs from one MegaDepth scene npz (src/datasets/megadepth.py:11-127):
    `pair_infos` [(idx0, idx1), overlap_score, central_matches] filtered by
    min_overlap_score, `image_paths`/`depth_paths`/`intrinsics`/`poses`
    indexed per frame; images resized to `img_resize` longest side, rounded
    to a `df` divisor, optionally padded square with a validity mask;
    depths zero-padded to `depth_max_size` (reference: 2000).

    Output keys match ScanNetPairDataset plus scale0/scale1 (pixel scale of
    the ORIGINAL intrinsics vs the resized image — spvs_coarse consumes them)
    and coarse-scale masks when img_padding is set.
    """

    def __init__(self, root_dir: str, npz_path: str, mode: str = "train",
                 min_overlap_score: float = 0.4, img_resize: Optional[int] = None,
                 df: Optional[int] = None, img_padding: bool = False,
                 depth_padding: bool = True, depth_max_size: int = 2000,
                 coarse_scale: int = 8):
        self.root = root_dir
        self.mode = mode
        self.scene_id = npz_path.split("/")[-1].split(".")[0]
        if mode == "test" and min_overlap_score > 0:
            min_overlap_score = 0  # megadepth.py:44-46
        info = np.load(npz_path, allow_pickle=True)
        self.pair_infos = [p for p in info["pair_infos"] if p[1] > min_overlap_score]
        self.image_paths = info["image_paths"]
        self.depth_paths = info["depth_paths"]
        self.intrinsics = info["intrinsics"]
        self.poses = info["poses"]
        if mode == "train":
            assert img_resize is not None and img_padding and depth_padding, (
                "training requires fixed shapes (megadepth.py:54)"
            )
        self.img_resize = img_resize
        self.df = df
        self.img_padding = img_padding
        self.depth_max_size = depth_max_size if depth_padding else None
        self.coarse_scale = coarse_scale

    def __len__(self):
        return len(self.pair_infos)

    def _frame(self, idx):
        import os.path as osp

        img, mask, scale = read_megadepth_gray(
            osp.join(self.root, self.image_paths[idx]),
            self.img_resize, self.df, self.img_padding,
        )
        if self.mode in ("train", "val"):
            depth = read_megadepth_depth(
                osp.join(self.root, self.depth_paths[idx]), pad_to=self.depth_max_size
            )
        else:
            depth = np.zeros((0,), np.float32)  # megadepth.py:88-90
        K = np.asarray(self.intrinsics[idx], np.float32).reshape(3, 3)
        T = np.asarray(self.poses[idx], np.float64)
        return img, mask, scale, depth, K, T

    def __getitem__(self, idx):
        (i0, i1), overlap, _ = self.pair_infos[idx]
        img0, mask0, scale0, depth0, K0, T0 = self._frame(i0)
        img1, mask1, scale1, depth1, K1, T1 = self._frame(i1)
        T_0to1 = (T1 @ np.linalg.inv(T0)).astype(np.float32)[:4, :4]
        out = {
            "image0": img0, "image1": img1,
            "depth0": depth0, "depth1": depth1,
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "K0": K0, "K1": K1,
            "scale0": scale0, "scale1": scale1,
            "scene_id": self.scene_id, "pair_id": idx,
            "pair_name": f"{self.scene_id}/{i0}_{i1}",
        }
        if mask0 is not None:
            # nearest-subsampled coarse masks (megadepth.py:119-125)
            s = self.coarse_scale
            out["mask0"] = mask0[::s, ::s]
            out["mask1"] = mask1[::s, ::s]
        return out
