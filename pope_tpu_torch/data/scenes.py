"""Multi-scene training data: scene datasets, concatenation, per-rank splits
and scene-balanced sampling, and the object-centric pair datasets (CO3D,
Objaverse renders) with mask2bbox (a copy of pope_tpu/data/scenes.py,
which the port does not import: the same numpy and `random` draws, so the
same index order and pairs).

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


def mask2bbox(mask: np.ndarray) -> np.ndarray:
    """xywh bbox of a binary mask; zeros when empty (co3d.py:23-31)."""
    if np.sum(mask) == 0:
        return np.asarray([0, 0, 0, 0], np.float32)
    ys, xs = np.nonzero(mask)
    return np.asarray(
        [xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min()], np.int32
    )


class Co3DResizeDataset:
    """A resized-CO3D sequence database (src/datasets/co3d.py:33-67):
    `<root>/<category>/<sequence>/info.pkl` holds (Ks, poses, img_ids,
    ratios); frames live in images/<id>.jpg with masks/<id>.png. Also acts
    as a pair dataset: __getitem__(i) pairs consecutive frames (the
    reference only exposes the per-frame database; the pair view makes the
    sequence usable by the LoFTR trainer directly)."""

    def __init__(self, seq_root: str):
        import os.path as osp
        import pickle

        self.root = seq_root
        with open(osp.join(seq_root, "info.pkl"), "rb") as f:
            self.Ks, self.poses, self.img_ids, self.ratios = pickle.load(f)

    # -- database surface (co3d.py:50-67) --
    def get_image(self, img_id):
        import cv2
        import os.path as osp

        im = cv2.imread(osp.join(self.root, "images", f"{img_id}.jpg"))
        return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)

    def get_mask(self, img_id):
        import cv2
        import os.path as osp

        return cv2.imread(
            osp.join(self.root, "masks", f"{img_id}.png"), cv2.IMREAD_GRAYSCALE
        ) > 0

    def get_K(self, img_id):
        return np.asarray(self.Ks[img_id], np.float32).copy()

    def get_pose(self, img_id):
        return np.asarray(self.poses[img_id], np.float32).copy()

    def get_img_ids(self):
        return self.img_ids

    def get_bbox(self, img_id):
        return mask2bbox(self.get_mask(img_id))

    # -- pair-dataset surface --
    def __len__(self):
        return max(len(self.img_ids) - 1, 0)

    def __getitem__(self, idx):
        i0, i1 = self.img_ids[idx], self.img_ids[idx + 1]
        g0 = self.get_image(i0).astype(np.float32).mean(-1) / 255.0
        g1 = self.get_image(i1).astype(np.float32).mean(-1) / 255.0
        P0 = np.vstack([self.get_pose(i0), [0, 0, 0, 1]]) if self.get_pose(i0).shape[0] == 3 else self.get_pose(i0)
        P1 = np.vstack([self.get_pose(i1), [0, 0, 0, 1]]) if self.get_pose(i1).shape[0] == 3 else self.get_pose(i1)
        T_0to1 = (P1 @ np.linalg.inv(P0)).astype(np.float32)
        return {
            "image0": g0[None], "image1": g1[None],
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "K0": self.get_K(i0), "K1": self.get_K(i1),
            "bbox0": self.get_bbox(i0), "bbox1": self.get_bbox(i1),
            "pair_name": f"{i0}_{i1}",
        }


class ObjaverseV2PairDataset:
    """In-memory rendered-views pair dataset (src/datasets/objaversev2.py:
    38-146): a pickled dict {class: {view_id: {'image', 'pose'}}}; each
    __getitem__ draws a random 2-view pair of one class, converts frames to
    grayscale, and returns the relative pose — both as the 4x4 matrix (our
    trainer's convention) and as the reference's (t, quaternion) 7-vector
    output (`rel_tq`, objaversev2.py:118-124)."""

    INTRINSIC = np.array([[1120.0, 0, 256], [0, 840, 256], [0, 0, 1]], np.float32)

    def __init__(self, root_dir: str, npz_path: str, mode: str = "train", seed: int = 0):
        import os.path as osp

        self.data = np.load(osp.join(root_dir, npz_path), allow_pickle=True).item()
        self.values = list(self.data.values())
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.values)

    @staticmethod
    def _to_44(pose):
        pose = np.asarray(pose, np.float64)
        return np.vstack([pose, [0, 0, 0, 1]]) if pose.shape[0] == 3 else pose

    @staticmethod
    def _quat_from_R(R):
        """(x, y, z, w) quaternion, scipy convention (objaversev2.py:122)."""
        import torch

        from pope_tpu_torch.geometry.pose import matrix_to_quat

        w, x, y, z = matrix_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()
        return np.array([x, y, z, w], np.float32)

    @staticmethod
    def _gray(img):
        img = np.asarray(img)
        if img.ndim == 3:
            img = img.astype(np.float32).mean(-1)
        return img[None].astype(np.float32) / 255.0

    def __getitem__(self, idx):
        views = self.values[idx]
        item0, item1 = self.rng.sample(list(views.values()), 2)
        T_0to1 = (
            self._to_44(item1["pose"]) @ np.linalg.inv(self._to_44(item0["pose"]))
        ).astype(np.float32)
        rel_tq = np.concatenate(
            [T_0to1[:3, 3], self._quat_from_R(T_0to1[:3, :3])]
        ).astype(np.float32)
        return {
            "image0": self._gray(item0["image"]),
            "image1": self._gray(item1["image"]),
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "rel_tq": rel_tq,
            "K0": self.INTRINSIC, "K1": self.INTRINSIC,
            "pair_id": idx,
        }


class RenderedViewsPairDataset:
    """Object-centric rendered-views pair sampler (the Objaverse-style
    trainer data source).

    Reference behavior: src/datasets/objaverse.py:26-119 — a class list file
    names per-object directories of `n_views` rendered frames
    ('000.png'..'010.png') with matching '000.npy' pose files; __getitem__
    rejection-samples a view pair until its relative-rotation magnitude
    falls under a rotation bin drawn from {30,30,30,60,60,90} degrees
    (:93-95), and returns grayscale frames + the relative pose + the fixed
    render intrinsics (:47).
    """

    INTRINSIC = np.array([[1120.0, 0, 256], [0, 840, 256], [0, 0, 1]], np.float32)
    ANGULAR_BINS = (30, 30, 30, 60, 60, 90)

    def __init__(self, root_dir: str, class_file: str, n_views: int = 11, seed: int = 0, max_tries: int = 64):
        import os.path as osp

        self.root = root_dir
        self.classes = [c for c in np.loadtxt(class_file, dtype=str).reshape(-1)]
        self.n_views = n_views
        self.rng = random.Random(seed)
        self.max_tries = max_tries

    def __len__(self):
        return len(self.classes)

    def __getitem__(self, idx):
        import os.path as osp

        import torch

        from pope_tpu_torch.data.readers import read_scannet_grayv2
        from pope_tpu_torch.geometry.pose import rotation_angle_deg

        d = osp.join(self.root, str(self.classes[idx]))
        for _ in range(self.max_tries):
            i0, i1 = self.rng.sample(range(self.n_views), 2)
            p0 = osp.join(d, f"{i0:03d}.png")
            p1 = osp.join(d, f"{i1:03d}.png")
            if not (osp.exists(p0) and osp.exists(p1)):
                continue
            pose0 = np.load(osp.join(d, f"{i0:03d}.npy"))
            pose1 = np.load(osp.join(d, f"{i1:03d}.npy"))
            if pose0.shape[0] == 3:
                pose0 = np.vstack([pose0, [0, 0, 0, 1]])
            if pose1.shape[0] == 3:
                pose1 = np.vstack([pose1, [0, 0, 0, 1]])
            T_0to1 = pose1 @ np.linalg.inv(pose0)
            r_err = float(rotation_angle_deg(torch.eye(3), torch.as_tensor(T_0to1[:3, :3], dtype=torch.float32)))
            bin_deg = self.rng.choice(self.ANGULAR_BINS)
            if r_err <= bin_deg:
                return {
                    "image0": read_scannet_grayv2(p0),
                    "image1": read_scannet_grayv2(p1),
                    "T_0to1": T_0to1.astype(np.float32),
                    "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
                    "K0": self.INTRINSIC,
                    "K1": self.INTRINSIC,
                    "pair_name": f"{self.classes[idx]}/{i0:03d}_{i1:03d}",
                }
        raise RuntimeError(f"no pair within rotation bins for {d}")
