"""Novel-view synthesis: a per-scene NeRF and the LINEMOD-sequence driver
(port of pope_tpu/nvs)."""

from pope_tpu_torch.nvs.nerf import (
    NerfConfig,
    NerfMLP,
    NerfState,
    init_nerf,
    make_rays,
    render_image,
    render_rays,
    train_nerf,
)
from pope_tpu_torch.nvs.driver import render_novel_views

__all__ = [
    "NerfConfig",
    "NerfMLP",
    "NerfState",
    "init_nerf",
    "make_rays",
    "render_rays",
    "render_image",
    "train_nerf",
    "render_novel_views",
]
