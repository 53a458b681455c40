"""Model loading (port of pope_tpu/pipeline/api.py::load_models, SAM only).

Without a checkpoint SAM gets seeded random weights, made on the device from
a `torch.Generator`. A released `sam_vit_*.pth` loads through the copied
reference converter and the weights bridge.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from pope_tpu_torch.config import PipelineConfig, SamEncoderConfig
from pope_tpu_torch.models.sam import AutomaticMaskGenerator, Sam, convert_torch_sam_state
from pope_tpu_torch.models.sam.decoder import UpConvT
from pope_tpu_torch.models.sam.encoder import LayerNorm2d
from pope_tpu_torch.utils.bf16_storage import cast_sam_storage
from pope_tpu_torch.utils.device import resolve_device
from pope_tpu_torch.weights import sam_state_from_jax

SAM_CHECKPOINTS = {
    "b": ("weights/sam_vit_b_01ec64.pth", SamEncoderConfig.vit_b),
    "l": ("weights/sam_vit_l_0b3195.pth", SamEncoderConfig.vit_l),
    "h": ("weights/sam_vit_h_4b8939.pth", SamEncoderConfig.vit_h),
}


@dataclasses.dataclass
class PopeModels:
    """The loaded model bundle. dinov2 and the matcher come with the next
    slice of the port."""

    sam: Sam
    amg: AutomaticMaskGenerator
    config: PipelineConfig
    device: torch.device


def _load_torch_state(path: str):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}


@torch.no_grad()
def init_sam_weights(sam: Sam, generator: torch.Generator) -> None:
    """Seeded random init in place: lecun-normal Dense/conv kernels, zero
    biases, unit LayerNorms, unit-normal embeddings. The rel-pos tables and
    the abs pos embed get small non-zero values (the JAX init zeroes them),
    so the attention kernels' bias paths see real data."""
    g = generator
    for mod in sam.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, UpConvT):
            mod.kernel.normal_(0.0, 1.0 / math.sqrt(4 * mod.kernel.shape[2]), generator=g)
            mod.bias.zero_()
        else:
            for name, p in mod.named_parameters(recurse=False):
                small = name.startswith("rel_pos") or name == "pos_embed"
                p.normal_(0.0, 0.02 if small else 1.0, generator=g)


def load_models(
    config: PipelineConfig = PipelineConfig(),
    sam_checkpoint: Optional[str] = None,
    sam_type: str = "h",
    seed: int = 0,
    components: tuple = ("sam",),
    device=None,
) -> PopeModels:
    """Build SAM on `device` (default CUDA; raises without a GPU unless
    device="cpu") and its automatic mask generator."""
    later = [c for c in components if c in ("dinov2", "matcher")]
    if later:
        raise NotImplementedError(
            f"{later}: DINOv2 and the matcher are ported in the next slice "
            "(ROADMAP.md Queue 1, items 5-8)"
        )
    if "sam" not in components:
        raise ValueError(f"unknown components {components}")
    dev = resolve_device(device)
    sam_cfg = dataclasses.replace(config.sam, encoder=SAM_CHECKPOINTS[sam_type][1]())
    with torch.device(dev):
        sam = Sam(sam_cfg)
    if sam_checkpoint:
        tree = convert_torch_sam_state(_load_torch_state(sam_checkpoint), depth=sam_cfg.encoder.depth)
        sam.load_state_dict(sam_state_from_jax(tree), strict=True)
    else:
        init_sam_weights(sam, torch.Generator(device=dev).manual_seed(seed))
    cast_sam_storage(sam, sam_cfg.encoder)
    amg = AutomaticMaskGenerator(sam, config.amg, device=dev)
    return PopeModels(sam=sam, amg=amg, config=config, device=dev)
