"""Pair manifests and per-dataset path conventions (a copy of
pope_tpu/eval/manifest.py, which the port does not import).

Reference behavior: data/pairs/{LINEMOD,Onepose,OneposePlusPlus,YCB-VIDEO}-
test.json — a list per object of {"0".."5": [ "ref.png-tgt.png", ...]}
rotation bins — and the driver path rules:

- LINEMOD (eval_linemod_json.py:49-62): prompt from `color/`, target from
  `color_full/`; K0 from `intrin_ba/*.txt`, K1 from `intrin/*.txt`; poses
  from `poses_ba/`; names split on the first '-'.
- OnePose / OnePose++ (eval_onepose_json.py:49-62): both frames from
  `color/` with `intrin_ba` + `poses_ba`; split on '-'.
- YCB-Video (eval_ycb_json.py:30-45): like LINEMOD but frame names contain
  '-', so the split is on 'png-'; only every 2nd pair is evaluated (:35).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, NamedTuple


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    manifest: str  # file name under data/pairs/
    root: str  # dataset root relative to data dir
    target_dir_sub: str  # replacement for 'color' when loading the target
    k0_sub: str  # 'color' -> this for the prompt intrinsics
    k1_from: str  # directory name replaced for target intrinsics
    k1_sub: str
    pose_from0: str
    pose_sub0: str
    pose_from1: str
    pose_sub1: str
    split_on: str  # '-' or 'png-'
    stride: int = 1  # YCBV evaluates every 2nd pair
    crop_size: int = 256  # OnePose uses 512 (eval_onepose_json.py:88)


DATASETS = {
    "linemod": DatasetSpec(
        name="linemod", manifest="LINEMOD-test.json", root="LM_dataset",
        target_dir_sub="color_full", k0_sub="intrin_ba", k1_from="color_full",
        k1_sub="intrin", pose_from0="color", pose_sub0="poses_ba",
        pose_from1="color_full", pose_sub1="poses_ba", split_on="-",
    ),
    "onepose": DatasetSpec(
        name="onepose", manifest="Onepose-test.json", root="onepose",
        target_dir_sub="color", k0_sub="intrin_ba", k1_from="color",
        k1_sub="intrin_ba", pose_from0="color", pose_sub0="poses_ba",
        pose_from1="color", pose_sub1="poses_ba", split_on="-", crop_size=512,
    ),
    "onepose_plusplus": DatasetSpec(
        name="onepose_plusplus", manifest="OneposePlusPlus-test.json",
        root="onepose_plusplus", target_dir_sub="color", k0_sub="intrin_ba",
        k1_from="color", k1_sub="intrin_ba", pose_from0="color",
        pose_sub0="poses_ba", pose_from1="color", pose_sub1="poses_ba",
        split_on="-", crop_size=512,
    ),
    "ycbv": DatasetSpec(
        name="ycbv", manifest="YCB-VIDEO-test.json", root="ycbv",
        target_dir_sub="color_full", k0_sub="intrin_ba", k1_from="color_full",
        k1_sub="intrin", pose_from0="color", pose_sub0="poses_ba",
        pose_from1="color_full", pose_sub1="poses_ba", split_on="png-",
        stride=2,
    ),
}

LINEMOD_ID2NAME = {
    1: "ape", 2: "benchvise", 4: "camera", 5: "can", 6: "cat", 8: "driller",
    9: "duck", 10: "eggbox", 11: "glue", 12: "holepuncher", 13: "iron",
    14: "lamp", 15: "phone",
}


class PairPaths(NamedTuple):
    object_label: str
    rotation_bin: str
    pair_name: str
    image0: str
    image1: str
    k0: str
    k1: str
    pose0: str
    pose1: str
    box3d: str  # box3d_corners.txt next to the object root


def load_manifest(pairs_dir: str, spec: DatasetSpec) -> List[dict]:
    with open(os.path.join(pairs_dir, spec.manifest)) as f:
        return json.load(f)


def iter_pairs(data_root: str, spec: DatasetSpec, manifest: List[dict]) -> Iterator[PairPaths]:
    """Yield resolved file paths per evaluated pair, mirroring the driver's
    name surgery (eval_linemod_json.py:51-62)."""
    root_dir = os.path.join(data_root, spec.root)
    for test_dict in manifest:
        sample = test_dict["0"][0]
        label = sample.split("/")[0]
        dir_name = os.path.dirname(sample)
        full_dir = os.path.join(root_dir, dir_name)
        for bin_key, pairs in test_dict.items():
            for pair_name in pairs[:: spec.stride]:
                base = os.path.basename(pair_name)
                if spec.split_on == "png-":
                    idx0 = base.split("png-")[0] + "png"
                    idx1 = base.split("png-")[1]
                else:
                    idx0, idx1 = base.split("-")[0], base.split("-")[1]
                image0 = os.path.join(full_dir, idx0)
                image1 = os.path.join(full_dir.replace("color", spec.target_dir_sub), idx1)
                yield PairPaths(
                    object_label=label,
                    rotation_bin=bin_key,
                    pair_name=pair_name,
                    image0=image0,
                    image1=image1,
                    k0=image0.replace("color", spec.k0_sub).replace("png", "txt"),
                    k1=image1.replace(spec.k1_from, spec.k1_sub).replace("png", "txt"),
                    pose0=image0.replace(spec.pose_from0, spec.pose_sub0).replace("png", "txt"),
                    pose1=image1.replace(spec.pose_from1, spec.pose_sub1).replace("png", "txt"),
                    box3d=os.path.join(root_dir, label, "box3d_corners.txt"),
                )
