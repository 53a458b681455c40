"""The reference's SAM (or the control's) from a configuration file and the
benchmark's seeded weights. It imports nothing of the program."""

from __future__ import annotations

import dataclasses

import torch

from benchmark import weights
from benchmark.cells import pipeline_config
from benchmark.reference.popref import config as ref_config
from benchmark.reference.popref.models.sam.sam import Sam

# the encoder parameters the port keeps in float32 under bf16 storage; every
# other encoder parameter is stored as bf16
KEEP_F32 = ("norm1", "norm2", "neck_ln1", "neck_ln2")


@dataclasses.dataclass
class Models:
    """The reference's SAM, its configuration and device."""

    sam: Sam
    config: object
    device: torch.device


def plans(config_file: dict, traffic: dict) -> dict:
    """The weight plan of each tower the reference has, from its modules on
    the meta device."""
    cfg = pipeline_config(ref_config, config_file, traffic)
    with torch.device("meta"):
        return {"sam": weights.init_plan(Sam(cfg.sam))}


@torch.no_grad()
def build(config_file: dict, traffic: dict, seed: int, device, stored_bf16: bool) -> Models:
    """The reference in float32 with the benchmark's weights for `seed`.
    stored_bf16: round the SAM encoder's weights to bf16 where the port
    stores them so (its configuration computes the encoder in bf16)."""
    cfg = pipeline_config(ref_config, config_file, traffic, dtype="float32")
    with torch.device(device):
        sam = Sam(cfg.sam)
    weights.load_into(sam, weights.make_state(weights.init_plan(sam), seed, "sam", device))
    if stored_bf16:
        for name, p in sam.image_encoder.named_parameters():
            if not set(name.split(".")) & set(KEEP_F32):
                p.copy_(p.to(torch.bfloat16).float())
    return Models(sam=sam.eval(), config=cfg, device=torch.device(device))
