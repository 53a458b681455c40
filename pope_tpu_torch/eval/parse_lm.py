"""CDPN-format LINEMOD -> OnePose-layout converter.

Reference behavior: parse_lm_real_data.py — reads real_{train,test}/<obj>
'*-color.png' frames with per-frame pose/box txts and the models_info.txt
metric metadata; writes the OnePose directory layout
(<onepose_id>-lm<k>-others/lm<k>-{1,2,3}/{color,color_full,intrin,intrin_ba,
poses_ba}) with bbox-compact-cropped 256x256 prompt frames + updated
intrinsics, plus box3d_corners.txt / diameter.txt / model_eval.ply at the
object root. Optional detector noise and YOLO-box modes mirror
:190-230; scripts/parse_linemod_objs.sh's per-object loop is `convert_all`.

Port of pope_tpu/eval/parse_lm.py: the host code is a copy (cv2 imported
where used); the two-stage crop runs the port's affine geometry on
`device` (default CUDA; "cpu" for the CPU).
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
from glob import glob
from pathlib import Path

import numpy as np

from pope_tpu_torch.eval.manifest import LINEMOD_ID2NAME

LM_K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]])


def parse_models_info_txt(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split(" ")
            obj_id = parts.pop(0)
            out[obj_id] = {parts[i]: float(parts[i + 1]) for i in range(0, len(parts) - 1, 2)}
    return out


def _crop_256(image, box, device=None):
    """Two-stage crop+resize identical to the reference (:231-244), on
    `device`: the box's own size first, then 256x256."""
    import torch

    from pope_tpu_torch.geometry.affine import get_image_crop_resize, get_K_crop_resize
    from pope_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    x0, y0, x1, y1 = box
    box_t = torch.as_tensor(box, dtype=torch.float32, device=dev)
    K_crop, _ = get_K_crop_resize(box_t, torch.as_tensor(LM_K, dtype=torch.float32, device=dev), (y1 - y0, x1 - x0))
    img = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=dev)
    crop, _ = get_image_crop_resize(img[None], box_t[None, None], (int(y1 - y0), int(x1 - x0)))
    box_new = torch.tensor([0, 0, x1 - x0, y1 - y0], dtype=torch.float32, device=dev)
    K_crop, _ = get_K_crop_resize(box_new, K_crop, (256, 256))
    crop, _ = get_image_crop_resize(crop[:, 0], box_new[None, None], (256, 256))
    return crop[0, 0].cpu().numpy().astype(np.uint8), K_crop.cpu().numpy()


def convert_object(
    data_base_dir: str,
    obj_id: int,
    output_data_dir: str,
    split: str = "train",
    assign_onepose_id: str = "0801",
    compact_percent: float = 0.3,
    add_detector_noise: bool = False,
    rng=None,
    device=None,
):
    import cv2

    obj_name = LINEMOD_ID2NAME[obj_id]
    image_seq_dir = osp.join(
        data_base_dir, "real_train" if split == "train" else "real_test", obj_name
    )
    models_info = parse_models_info_txt(osp.join(data_base_dir, "models", "models_info.txt"))

    obj_full_name = f"{assign_onepose_id}-lm{obj_id}-others"
    seq_name = f"lm{obj_id}-{'1' if split == 'train' else ('3' if add_detector_noise else '2')}"
    seq_dir = osp.join(output_data_dir, obj_full_name, seq_name)
    if osp.exists(seq_dir):
        shutil.rmtree(seq_dir)
    subdirs = {}
    for sub in ("color", "color_full", "intrin_ba", "intrin", "poses_ba"):
        subdirs[sub] = osp.join(seq_dir, sub)
        Path(subdirs[sub]).mkdir(parents=True, exist_ok=True)

    if split == "train":
        info = models_info[str(obj_id)]
        scale = np.array([info["size_x"], info["size_y"], info["size_z"]]) / 1000.0
        sx, sy, sz = scale
        corners = np.array(
            [
                [-sx, -sy, -sz], [-sx, -sy, sz], [-sx, sy, sz], [-sx, sy, -sz],
                [sx, -sy, -sz], [sx, -sy, sz], [sx, sy, sz], [sx, sy, -sz],
            ]
        ) * 0.5
        np.savetxt(osp.join(output_data_dir, obj_full_name, "box3d_corners.txt"), corners)
        np.savetxt(
            osp.join(output_data_dir, obj_full_name, "diameter.txt"),
            np.array([info["diameter"] / 1000.0]),
        )
        model_ply = osp.join(data_base_dir, "models", obj_name, obj_name + ".ply")
        if osp.exists(model_ply):
            shutil.copyfile(model_ply, osp.join(output_data_dir, obj_full_name, "model_eval.ply"))

    rng = rng or np.random.default_rng(0)
    for global_id, image_path in enumerate(sorted(glob(osp.join(image_seq_dir, "*-color.png")))):
        dataset_img_id = osp.splitext(osp.basename(image_path))[0].split("-")[0]
        pose = np.loadtxt(osp.join(image_seq_dir, f"{dataset_img_id}-pose.txt"))
        original = cv2.imread(image_path)
        x0, y0, w, h = np.loadtxt(osp.join(image_seq_dir, f"{dataset_img_id}-box.txt")).astype(int).tolist()
        x1, y1 = x0 + w, y0 + h
        x0 -= int(w * compact_percent)
        y0 -= int(h * compact_percent)
        x1 += int(w * compact_percent)
        y1 += int(h * compact_percent)
        if add_detector_noise:
            off = rng.uniform(-compact_percent, compact_percent)
            x0 += int(w * off)
            y0 += int(h * off)
            x1 += int(w * off)
            y1 += int(h * off)
        crop, K_crop = _crop_256(original, np.array([x0, y0, x1, y1]), device)
        cv2.imwrite(osp.join(subdirs["color"], f"{global_id}.png"), crop)
        cv2.imwrite(osp.join(subdirs["color_full"], f"{global_id}.png"), original)
        np.savetxt(osp.join(subdirs["intrin_ba"], f"{global_id}.txt"), K_crop)
        np.savetxt(osp.join(subdirs["intrin"], f"{global_id}.txt"), LM_K)
        np.savetxt(osp.join(subdirs["poses_ba"], f"{global_id}.txt"), pose)
    return seq_dir


def convert_all(data_base_dir: str, output_data_dir: str, splits=("train", "val"), device=None):
    """scripts/parse_linemod_objs.sh: loop all object ids and splits."""
    for obj_id in LINEMOD_ID2NAME:
        for split in splits:
            convert_object(data_base_dir, obj_id, output_data_dir, split=split, device=device)
