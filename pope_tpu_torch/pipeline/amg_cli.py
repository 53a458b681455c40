"""Batch automatic-mask-generation tool (port of pope_tpu/pipeline/amg_cli.py:
the reference's standalone AMG CLI, segment_anything/scripts/amg.py:1-240,
as the `amg` subcommand).

Runs AMG over a single image or a directory of images and writes, per image,
either a folder of binary-mask PNGs + a metadata.csv (scripts/amg.py:152-175
`write_masks_to_folder`) or one JSON of COCO-style compressed RLEs
(`--convert-to-rle`; the reference needs pycocotools for this —
`coco_encode_rle` below implements the same rleToString varint so the output
is pycocotools-compatible without the dependency).

Deltas vs the reference, by design: the single-crop path (POPE's
crop_n_layers=0) caps the mask set at AMGConfig.mask_capacity (an overflow
is logged, never silent); crop_n_layers > 0 runs the reference's crop sweep.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np


def coco_encode_rle(rle: Dict[str, Any]) -> Dict[str, Any]:
    """Uncompressed RLE ({'size': [h, w], 'counts': [int, ...]}) -> COCO
    compressed form (pycocotools `rleToString`: counts delta-coded from the
    second-previous entry, signed LEB128-style 5-bit varint, chars offset by
    48). Matches `pycocotools.mask.encode` output byte-for-byte."""
    counts = list(rle["counts"])
    chars = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return {"size": list(rle["size"]), "counts": "".join(chars)}


def coco_decode_rle(ann: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of coco_encode_rle (pycocotools `rleFrString`): COCO compressed
    counts -> the uncompressed {'size', 'counts'} form."""
    s, counts, i = ann["counts"], [], 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and c & 0x10:
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return {"size": list(ann["size"]), "counts": counts}


_METADATA_HEADER = (
    "id,area,bbox_x0,bbox_y0,bbox_w,bbox_h,point_input_x,point_input_y,"
    "predicted_iou,stability_score,crop_box_x0,crop_box_y0,crop_box_w,crop_box_h"
)


def write_masks_to_folder(records: List[Dict[str, Any]], path: str) -> None:
    """One 0/255 PNG per mask + metadata.csv, the exact column layout of
    scripts/amg.py:152-175."""
    import cv2

    rows = [_METADATA_HEADER]
    for i, rec in enumerate(records):
        mask = np.asarray(rec["segmentation"], np.uint8) * 255
        cv2.imwrite(os.path.join(path, f"{i}.png"), mask)
        px, py = rec.get("point_coords", [[-1.0, -1.0]])[0]
        rows.append(
            ",".join(
                str(v)
                for v in (
                    i, rec["area"], *rec["bbox"], px, py,
                    rec["predicted_iou"], rec["stability_score"], *rec["crop_box"],
                )
            )
        )
    with open(os.path.join(path, "metadata.csv"), "w") as f:
        f.write("\n".join(rows))


def run_amg(models, input_path: str, output_dir: str, convert_to_rle: bool = False) -> List[str]:
    """scripts/amg.py `main`: iterate the input image(s), generate masks,
    write per-image outputs. Returns the list of processed image paths."""
    import cv2

    if not os.path.isdir(input_path):
        targets = [input_path]
    else:
        targets = sorted(
            os.path.join(input_path, f)
            for f in os.listdir(input_path)
            if not os.path.isdir(os.path.join(input_path, f))
        )
    os.makedirs(output_dir, exist_ok=True)

    done = []
    for t in targets:
        image = cv2.imread(t)
        if image is None:
            print(f"Could not load '{t}' as an image, skipping...")
            continue
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        # one records path for both the fused single-crop pipeline and the
        # crop_n_layers sweep; capacity-overflow telemetry is logged inside
        records = models.amg.generate_records(image)
        base = os.path.splitext(os.path.basename(t))[0]
        save_base = os.path.join(output_dir, base)
        if convert_to_rle:
            anns = []
            for rec in records:
                ann = {k: v for k, v in rec.items() if k not in ("segmentation", "rle")}
                ann["segmentation"] = coco_encode_rle(rec["rle"])
                anns.append(ann)
            with open(save_base + ".json", "w") as f:
                json.dump(anns, f)
        else:
            os.makedirs(save_base, exist_ok=False)
            write_masks_to_folder(records, save_base)
        done.append(t)
    return done
