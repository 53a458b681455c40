"""Model loading (port of pope_tpu/pipeline/api.py::load_models): SAM,
DINOv2 and the matcher.

Without a checkpoint each tower gets seeded random weights, made on the
device from a `torch.Generator` (seeds `seed`, `seed + 1`, `seed + 2`, as the
JAX package keys them). A released checkpoint (`sam_vit_*.pth`,
`dinov2_vits14_pretrain.pth`, the matcher's `.ckpt`) is checked against its
key/shape manifest, then loads through the copied reference converter and
the weights bridge.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from pope_tpu_torch.config import MatcherConfig, PipelineConfig, SamEncoderConfig
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer, convert_torch_dinov2_state
from pope_tpu_torch.models.dinov2.model import LayerScale
from pope_tpu_torch.models.matcher import Matcher, convert_torch_matcher_state
from pope_tpu_torch.models.sam import AutomaticMaskGenerator, Sam, convert_torch_sam_state
from pope_tpu_torch.models.sam.decoder import UpConvT
from pope_tpu_torch.models.sam.encoder import LayerNorm2d
from pope_tpu_torch.utils.bf16_storage import cast_sam_storage
from pope_tpu_torch.utils.checkpoint import load_torch_state_dict
from pope_tpu_torch.utils.device import resolve_device
from pope_tpu_torch.utils.state_manifest import check_state_dict
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax, sam_state_from_jax

SAM_CHECKPOINTS = {
    "b": ("weights/sam_vit_b_01ec64.pth", SamEncoderConfig.vit_b),
    "l": ("weights/sam_vit_l_0b3195.pth", SamEncoderConfig.vit_l),
    "h": ("weights/sam_vit_h_4b8939.pth", SamEncoderConfig.vit_h),
}


@dataclasses.dataclass
class PopeModels:
    """The loaded model bundle; towers left out of `components` are None."""

    sam: Optional[Sam]
    amg: Optional[AutomaticMaskGenerator]
    dinov2: Optional[DinoVisionTransformer]
    matcher: Optional[Matcher]
    config: PipelineConfig
    device: torch.device


def _init_dense_and_norm(mod: nn.Module, g: torch.Generator) -> bool:
    """Lecun-normal Dense / conv kernels with zero biases, unit LayerNorms;
    False for any other module."""
    if isinstance(mod, (nn.Linear, nn.Conv2d)):
        mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight[0].numel()), generator=g)
        if mod.bias is not None:
            mod.bias.zero_()
    elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
        mod.weight.fill_(1.0)
        mod.bias.zero_()
    else:
        return False
    return True


@torch.no_grad()
def init_sam_weights(sam: Sam, generator: torch.Generator) -> None:
    """Seeded random init in place: lecun-normal Dense/conv kernels, zero
    biases, unit LayerNorms, unit-normal embeddings. The rel-pos tables and
    the abs pos embed get small non-zero values (the JAX init zeroes them),
    so the attention kernels' bias paths see real data."""
    g = generator
    for mod in sam.modules():
        if _init_dense_and_norm(mod, g):
            continue
        if isinstance(mod, UpConvT):
            mod.kernel.normal_(0.0, 1.0 / math.sqrt(4 * mod.kernel.shape[2]), generator=g)
            mod.bias.zero_()
        else:
            for name, p in mod.named_parameters(recurse=False):
                small = name.startswith("rel_pos") or name == "pos_embed"
                p.normal_(0.0, 0.02 if small else 1.0, generator=g)


@torch.no_grad()
def init_dinov2_weights(model: DinoVisionTransformer, generator: torch.Generator) -> None:
    """Seeded random init in place: lecun-normal Dense / conv kernels, zero
    biases, unit LayerNorms, 0.02-normal cls token and pos embed, zero mask
    token. LayerScale gamma is drawn from U(0.1, 1), not the 1e-5 of a fresh
    DINOv2: at 1e-5 the blocks barely touch the residual stream, and the
    attention kernel's work would not show in the output."""
    g = generator
    for mod in model.modules():
        if not _init_dense_and_norm(mod, g) and isinstance(mod, LayerScale):
            mod.gamma.uniform_(0.1, 1.0, generator=g)
    model.cls_token.normal_(0.0, 0.02, generator=g)
    model.pos_embed.normal_(0.0, 0.02, generator=g)
    model.mask_token.zero_()


@torch.no_grad()
def init_matcher_weights(model: Matcher, generator: torch.Generator) -> None:
    """Seeded random init in place: lecun-normal Dense / conv kernels, zero
    biases, unit LayerNorms; BatchNorms keep their init (unit scale, zero
    bias, statistics mean 0 and var 1, as flax's)."""
    for mod in model.modules():
        _init_dense_and_norm(mod, generator)


def load_models(
    config: PipelineConfig = PipelineConfig(),
    sam_checkpoint: Optional[str] = None,
    sam_type: str = "h",
    dinov2_checkpoint: Optional[str] = None,
    matcher_checkpoint: Optional[str] = None,
    seed: int = 0,
    components: tuple = ("sam", "dinov2", "matcher"),
    device=None,
    validate_checkpoints: bool = True,
) -> PopeModels:
    """Build SAM and its automatic mask generator, DINOv2 and the matcher on
    `device` (default CUDA; raises without a GPU unless device="cpu"),
    loading the reference checkpoints when given.

    validate_checkpoints: check each checkpoint's key/shape inventory against
    the released file's manifest before converting it
    (utils/state_manifest.py), so that a mismatched file raises
    StateDictMismatch instead of loading garbage. It applies where the config
    is the released variant's; pass False for custom-architecture files."""
    unknown = set(components) - {"sam", "dinov2", "matcher"}
    if unknown:
        raise ValueError(f"unknown components {sorted(unknown)}")
    dev = resolve_device(device)
    sam = amg = dinov2 = matcher = None
    if "sam" in components:
        sam_cfg = dataclasses.replace(config.sam, encoder=SAM_CHECKPOINTS[sam_type][1]())
        with torch.device(dev):
            sam = Sam(sam_cfg)
        if sam_checkpoint:
            sd = load_torch_state_dict(sam_checkpoint)
            if validate_checkpoints:
                check_state_dict(sd, f"sam_vit_{sam_type}")
            tree = convert_torch_sam_state(sd, depth=sam_cfg.encoder.depth)
            sam.load_state_dict(sam_state_from_jax(tree), strict=True)
        else:
            init_sam_weights(sam, torch.Generator(device=dev).manual_seed(seed))
        cast_sam_storage(sam, sam_cfg.encoder)
        amg = AutomaticMaskGenerator(sam, config.amg, device=dev)
    if "dinov2" in components:
        with torch.device(dev):
            dinov2 = DinoVisionTransformer(config.dinov2).eval()
        if dinov2_checkpoint:
            sd = load_torch_state_dict(dinov2_checkpoint)
            # only the released flat-key vits14 layout is checked; SSL-style
            # student/teacher- or backbone.-wrapped files go straight to the
            # converter's key normalisation
            flat = not any(k in sd and isinstance(sd[k], dict) for k in ("student", "teacher")) and not any(
                k.startswith(("backbone.", "module.")) for k in sd
            )
            if validate_checkpoints and flat and config.dinov2.depth == 12 and config.dinov2.embed_dim == 384:
                check_state_dict(sd, "dinov2_vits14", extra_optional=("mask_token",))
            tree = convert_torch_dinov2_state(sd, depth=config.dinov2.depth)
            dinov2.load_state_dict(dinov2_state_from_jax(tree), strict=True)
        else:
            init_dinov2_weights(dinov2, torch.Generator(device=dev).manual_seed(seed + 1))
    if "matcher" in components:
        with torch.device(dev):
            matcher = Matcher(config.matcher).eval()
        if matcher_checkpoint:
            sd = load_torch_state_dict(matcher_checkpoint)
            if validate_checkpoints and config.matcher == MatcherConfig():
                check_state_dict(sd, "matcher")
            variables = convert_torch_matcher_state(sd)
            matcher.load_state_dict(matcher_state_from_jax(variables), strict=True)
        else:
            init_matcher_weights(matcher, torch.Generator(device=dev).manual_seed(seed + 2))
    return PopeModels(sam=sam, amg=amg, dinov2=dinov2, matcher=matcher, config=config, device=dev)
