"""DINOv2 vision transformer (port of pope_tpu/models/dinov2/model.py).

Patch embed (14x14 conv) + cls token + bicubic-resampled pos embed ->
pre-norm blocks with LayerScale -> final LayerNorm; returns
x_norm_clstoken / x_norm_patchtokens. The cast points are the JAX package's:
LayerNorms in f32, Dense layers in the config dtype, the LayerScale product
promotes the residual stream to f32.

Attention runs through the bias-free streaming kernel
(ops/flash_attention.py::flash_attention) on strided q/k/v views of the qkv
Dense output, with no copy. The JAX package computes it as einsum + f32
softmax with the logits and the softmax weights rounded to the compute
dtype; the kernel keeps logits and softmax statistics in f32.

For self-supervised training (train/ssl.py) the model also takes iBOT's
block masks (the mask token replaces the masked patch embeddings before the
pos embed), per-sample stochastic depth (DropPath, with per-block rates
uniform or rising linearly to `drop_path_rate`) and the fused SwiGLU FFN
(`ffn_layer="swiglufused"`, vit_giant2's). Randomness comes from an
explicit torch.Generator or from keep masks passed in: torch cannot draw
the JAX package's threefry bits.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.config import DinoV2Config
from pope_tpu_torch.models.sam.encoder import conv_nhwc, dense, layer_norm_f32
from pope_tpu_torch.ops.flash_attention import flash_attention
from pope_tpu_torch.ops.resize import resize_bicubic_antialias


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        nh = self.num_heads
        qkv = dense(self.qkv, x, self.dtype).view(B, N, 3, nh, C // nh)
        out = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return dense(self.proj, out, self.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch: a Bernoulli(1 - rate)
    keep mask over the batch axis, the kept samples scaled by 1 / (1 - rate).
    Identity at rate 0 and outside training. The mask is `keep` when given
    ((B,) bool), else drawn on `generator`'s device as uniform < 1 - rate."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, train: bool = False, generator=None, keep=None):
        if self.rate == 0.0 or not train:
            return x
        p = 1.0 - self.rate
        if keep is None:
            if generator is None:
                raise ValueError("DropPath in training needs a torch.Generator or keep masks")
            keep = torch.rand(x.shape[0], generator=generator, device=generator.device) < p
        mask = keep.to(device=x.device, dtype=x.dtype).view(-1, *([1] * (x.ndim - 1)))
        return x * mask / p


class SwiGLUFFNFused(nn.Module):
    """SwiGLU FFN with the fused hidden size round8(2/3 * mlp_hidden): one
    w12 product split into gate and value, silu(x1) * x2, then w3."""

    def __init__(self, dim: int, mlp_hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        hidden = (int(mlp_hidden * 2 / 3) + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = dense(self.w12, x, self.dtype).chunk(2, dim=-1)
        return dense(self.w3, F.silu(x1) * x2, self.dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, init_values: float,
                 dtype: torch.dtype, gelu: str = "erf", drop_path: float = 0.0, ffn_layer: str = "mlp"):
        super().__init__()
        self.dtype = dtype
        self.gelu = gelu
        self.ffn_layer = ffn_layer
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        if ffn_layer == "swiglufused":
            self.mlp = SwiGLUFFNFused(dim, hidden, dtype)
        elif ffn_layer == "mlp":
            self.mlp_fc1 = nn.Linear(dim, hidden)
            self.mlp_fc2 = nn.Linear(hidden, dim)
        else:
            raise ValueError(f"unknown ffn_layer {ffn_layer!r}")
        self.ls2 = LayerScale(dim, init_values)
        self.drop_path = DropPath(drop_path)

    def _ffn(self, h):
        if self.ffn_layer == "swiglufused":
            return self.mlp(h)
        h = dense(self.mlp_fc1, h, self.dtype)
        h = F.gelu(h, approximate="tanh" if self.gelu == "tanh" else "none")
        return dense(self.mlp_fc2, h, self.dtype)

    def forward(self, x, train: bool = False, generator=None, keep=(None, None)):
        """`keep`: the two residual branches' DropPath masks, drawn on
        `generator` where None."""
        h = self.ls1(self.attn(layer_norm_f32(self.norm1, x)))
        x = x + self.drop_path(h, train, generator, keep[0])
        h = self.ls2(self._ffn(layer_norm_f32(self.norm2, x)))
        return x + self.drop_path(h, train, generator, keep[1])


def interpolate_pos_embed(pos_embed, grid_hw):
    """The (1, 1 + side^2, C) pos embed on a (h, w) patch grid: the patch part
    resampled as jax.image.resize(..., "bicubic") does (Keys a = -0.5,
    antialiased when it shrinks)."""
    h, w = grid_hw
    side = int((pos_embed.shape[1] - 1) ** 0.5)
    cls_pe = pos_embed[:, :1]
    patch_pe = pos_embed[:, 1:].reshape(1, side, side, -1)
    if (h, w) != (side, side):
        patch_pe = resize_bicubic_antialias(patch_pe.float(), (h, w))
    return torch.cat([cls_pe, patch_pe.reshape(1, h * w, -1)], dim=1)


def drop_path_rates(cfg: DinoV2Config) -> list:
    """Per-block stochastic-depth rates: uniform, or rising linearly from 0
    to drop_path_rate."""
    if cfg.drop_path_uniform:
        return [cfg.drop_path_rate] * cfg.depth
    return [cfg.drop_path_rate * i / max(cfg.depth - 1, 1) for i in range(cfg.depth)]


class DinoVisionTransformer(nn.Module):
    """(B, H, W, 3) normalised NHWC images -> {"x_norm_clstoken": (B, C),
    "x_norm_patchtokens": (B, N, C)} in f32."""

    def __init__(self, config: DinoV2Config = DinoV2Config()):
        super().__init__()
        cfg = config
        if cfg.num_register_tokens:
            raise NotImplementedError(
                f"{cfg.num_register_tokens} register tokens: neither package implements them"
            )
        self.config = cfg
        self.dtype = getattr(torch, cfg.dtype)
        p, C = cfg.patch_size, cfg.embed_dim
        self.patch_embed = nn.Conv2d(3, C, p, stride=p)
        self.mask_token = nn.Parameter(torch.zeros(1, C))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + (cfg.img_size // p) ** 2, C))
        self.block_names = []
        for i, rate in enumerate(drop_path_rates(cfg)):
            name = f"block_{i}"
            self.add_module(name, Block(C, cfg.num_heads, cfg.mlp_ratio, cfg.init_values,
                                        self.dtype, cfg.gelu, rate, cfg.ffn_layer))
            self.block_names.append(name)
        self.norm = nn.LayerNorm(C, eps=1e-6)

    def draw_drop_keep(self, batch_sizes, generator: torch.Generator, device) -> list:
        """The DropPath keep masks of one train-mode forward per batch size in
        `batch_sizes`, drawn on `generator` in the order those forwards would
        draw them one by one (forward by forward, block by block, the
        attention branch first, nothing at rate 0), so each forward's
        `drop_keep`: [[(keep_attn, keep_ffn) or (None, None) per block] per
        batch size]. All reach `device` in one copy, from pinned memory: a
        copy per mask would stall the card's stream once per branch."""
        rates = [getattr(self, name).drop_path.rate for name in self.block_names]
        draws = [torch.rand(B, generator=generator, device=generator.device) < 1.0 - r
                 for B in batch_sizes for r in rates if r > 0 for _ in range(2)]
        if draws:
            flat = torch.cat(draws)
            if flat.is_cpu and torch.device(device).type == "cuda":
                flat = flat.pin_memory()
            parts = iter(flat.to(device, non_blocking=True).split([d.numel() for d in draws]))
        return [[(next(parts), next(parts)) if r > 0 else (None, None) for r in rates] for _ in batch_sizes]

    def forward(self, x, masks=None, train: bool = False, generator=None, drop_keep=None):
        """`masks` (B, gh*gw) bool: the masked patch embeddings become the mask
        token before the pos embed (iBOT's student input). `train=True` turns
        on stochastic depth: each block's two keep masks come from
        `drop_keep[i]` (a pair of (B,) bool tensors) or are drawn on
        `generator` (draw_drop_keep)."""
        B, H, W, _ = x.shape
        if train and drop_keep is None and generator is not None:
            drop_keep = self.draw_drop_keep([B], generator, x.device)[0]
        p, C = self.config.patch_size, self.config.embed_dim
        x = conv_nhwc(self.patch_embed, x, self.dtype).reshape(B, (H // p) * (W // p), C)
        if masks is not None:
            x = torch.where(masks[..., None], self.mask_token.to(x.dtype)[None], x)
        x = torch.cat([self.cls_token.expand(B, 1, C).to(x.dtype), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, (H // p, W // p)).to(x.dtype)
        for i, name in enumerate(self.block_names):
            keep = drop_keep[i] if drop_keep is not None else (None, None)
            x = getattr(self, name)(x, train, generator, keep)
        x = layer_norm_f32(self.norm, x)
        return {"x_norm_clstoken": x[:, 0], "x_norm_patchtokens": x[:, 1:]}


def vit_small(**kw) -> DinoVisionTransformer:
    return DinoVisionTransformer(DinoV2Config(embed_dim=384, depth=12, num_heads=6, **kw))


def vit_base(**kw) -> DinoVisionTransformer:
    return DinoVisionTransformer(DinoV2Config(embed_dim=768, depth=12, num_heads=12, **kw))


def vit_large(**kw) -> DinoVisionTransformer:
    return DinoVisionTransformer(DinoV2Config(embed_dim=1024, depth=24, num_heads=16, **kw))


def vit_giant2(**kw) -> DinoVisionTransformer:
    """embed 1536, 40 blocks, 24 heads (d = 64), the SwiGLU-fused FFN."""
    kw.setdefault("ffn_layer", "swiglufused")
    return DinoVisionTransformer(DinoV2Config(embed_dim=1536, depth=40, num_heads=24, **kw))
