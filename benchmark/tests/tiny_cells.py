"""A cell at a size the CPU holds, added the way a later PR adds one: a
configuration file, a traffic file, a limits file and BENCHMARK.json
entries, in a folder of its own beside copies of the drivers and metric
readers. The program runs on the CPU (its kernels' plain versions)."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark.cells import HERE, load_json, pipeline_config

TINY = HERE / "tests" / "tiny.json"
CELL, MIX, TWIN = "tiny-segment", "tiny-segment-batch", "segment-vitl-b16"
# open filters, so that the tiny model's candidates reach NMS, the cut and
# the cleanup, and a fault planted there shows
SEGMENT = {"frames": 4, "batch_size": 2, "warmup_batches": 1, "sample_batches": [1, 2], "sample_images": 4,
           "overrides": {"amg.pred_iou_thresh": "-inf", "amg.stability_score_thresh": 0.0}}
# limits of the tiny cell, between the readings of the program and the
# control at this size (the cells' own limits are set at theirs)
LIMITS = {"sam_iou_gap": 0.1, "sam_mask_gap": 0.6, "stage_mismatch": 0}


def make_root(tmp: Path) -> tuple:
    """(root, spec): a benchmark folder with the tiny cell and a
    BENCHMARK.json that adds it to the repository's."""
    root = Path(tmp) / "bench"
    for d in ("drivers", "metrics"):
        shutil.copytree(HERE / d, root / d)
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir(parents=True)
    shutil.copy(TINY, root / "configs" / "tiny.json")
    spec = copy.deepcopy(load_json(HERE.parent / "BENCHMARK.json"))
    traffic = {**load_json(HERE / "traffic" / "segment-batch.json"), **SEGMENT}
    (root / "traffic" / f"{MIX}.json").write_text(json.dumps(traffic))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec["workloads"].append({"name": CELL, "config": "tiny", "traffic": MIX, "chips": 1, "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if TWIN in m.get("workloads", []):
            m["workloads"].append(CELL)
    return root, spec


def tiny_encoder():
    """The tiny configuration's SAM encoder (load_models builds the
    encoder of its sam_type; a test maps that type to this one)."""
    from pope_tpu_torch import config

    return pipeline_config(config, load_json(TINY), {}).sam.encoder
