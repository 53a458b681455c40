"""ConvNeXtV2 image backbone, atto..huge zoo (port of
pope_tpu/models/regressor/convnextv2.py): 7x7 depthwise conv -> LayerNorm ->
4x pointwise MLP with GRN -> residual; a 4-stage stem / downsample layout;
global average pool + LayerNorm + an optional linear head. NHWC in and
through the blocks, as the JAX package; the convs run on NCHW views.
Channels-last LayerNorms at eps 1e-6, exact GELU."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

ZOO = {
    "test": ((1, 1, 2, 1), (16, 32, 64, 128)),  # a tiny config for tests
    "atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "femto": ((2, 2, 6, 2), (48, 96, 192, 384)),
    "pico": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "nano": ((2, 2, 8, 2), (80, 160, 320, 640)),
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "huge": ((3, 3, 27, 3), (352, 704, 1408, 2816)),
}


def conv_nhwc(conv: nn.Conv2d, x):
    """An NCHW conv on an NHWC tensor, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GRN(nn.Module):
    """Global Response Normalization over the spatial dims of NHWC input."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        gx = torch.sqrt((x * x).sum(dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        h = self.norm(conv_nhwc(self.dwconv, x))
        h = self.grn(F.gelu(self.pwconv1(h)))
        return x + self.pwconv2(h)


class ConvNeXtV2(nn.Module):
    """4-stage ConvNeXtV2 on (B, H, W, 3) normalized images: pooled features
    (num_classes=0) or logits."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3), dims: Sequence[int] = (192, 384, 768, 1536),
                 num_classes: int = 1000):
        super().__init__()
        self.depths, self.dims, self.num_classes = tuple(depths), tuple(dims), num_classes
        self.stem_conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=1e-6)
        for i in range(1, 4):
            self.add_module(f"down{i}_norm", nn.LayerNorm(dims[i - 1], eps=1e-6))
            self.add_module(f"down{i}_conv", nn.Conv2d(dims[i - 1], dims[i], 2, stride=2))
        for i, depth in enumerate(depths):
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", ConvNeXtV2Block(dims[i]))
        self.head_norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes) if num_classes else None

    @classmethod
    def from_name(cls, variant: str, **kw):
        depths, dims = ZOO[variant]
        return cls(depths=depths, dims=dims, **kw)

    def forward(self, x):
        for i in range(4):
            if i == 0:
                x = self.stem_norm(conv_nhwc(self.stem_conv, x))
            else:
                x = conv_nhwc(getattr(self, f"down{i}_conv"), getattr(self, f"down{i}_norm")(x))
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i}_block{j}")(x)
        x = self.head_norm(x.mean(dim=(1, 2)))
        return self.head(x) if self.head is not None else x
