"""SAM prompt encoder (port of pope_tpu/models/sam/prompt.py).

Label convention: 1 = foreground point, 0 = background point, -1 = padding
slot, 2/3 = box corners. Point coords are shifted by +0.5 to pixel centres.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.popref.models.sam.encoder import conv_nhwc


def random_position_embedding(gaussian_matrix, coords01):
    """Fourier-feature PE of [0, 1]^2 coords: (..., 2) -> (..., 2*feats)."""
    coords = 2.0 * coords01 - 1.0
    proj = (2.0 * math.pi) * (coords @ gaussian_matrix)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def dense_grid_pe(gaussian_matrix, hw: Tuple[int, int], norm_hw: Optional[Tuple[int, int]] = None):
    """(H, W, C) dense PE over the pixel-centre grid. norm_hw (default hw)
    sets the normalisation grid: a rect (gh, gw) grid normalised by the square
    grid is the exact top-left slice of the square dense PE."""
    h, w = hw
    nh, nw = hw if norm_hw is None else norm_hw
    dev = gaussian_matrix.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / nh
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / nw
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # (h, w, 2)
    return random_position_embedding(gaussian_matrix, grid)


class PromptEncoder(nn.Module):
    """Returns (sparse (B, N, C), dense (1 or B, h, w, C)).

    points: (B, N, 2) pixel coords with labels (B, N); masks: optional
    (B, 4h, 4w, 1) low-res masks."""

    def __init__(self, embed_dim: int = 256, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024), mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_gaussian = nn.Parameter(torch.zeros(2, embed_dim // 2))
        # 0: negative point, 1: positive point, 2/3: box corners
        self.point_embeddings = nn.Parameter(torch.zeros(4, embed_dim))
        self.not_a_point = nn.Parameter(torch.zeros(embed_dim))
        self.no_mask = nn.Parameter(torch.zeros(embed_dim))
        self.mask_conv1 = nn.Conv2d(1, mask_in_chans // 4, 2, stride=2)
        self.mask_ln1 = nn.LayerNorm(mask_in_chans // 4, eps=1e-6)
        self.mask_conv2 = nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2)
        self.mask_ln2 = nn.LayerNorm(mask_in_chans, eps=1e-6)
        self.mask_conv3 = nn.Conv2d(mask_in_chans, embed_dim, 1)

    def get_dense_pe(self, hw: Optional[Tuple[int, int]] = None):
        """(h, w, C); a rect `hw` sub-grid slices the square PE exactly."""
        return dense_grid_pe(
            self.pe_gaussian, hw or self.image_embedding_size, self.image_embedding_size
        )

    def forward(self, points, labels, masks=None, embed_hw: Optional[Tuple[int, int]] = None):
        H, W = self.input_image_size
        scale = torch.tensor([W, H], dtype=torch.float32, device=points.device)
        pe = random_position_embedding(self.pe_gaussian, (points + 0.5) / scale)
        labels = labels[..., None]
        emb = torch.where(labels == -1, self.not_a_point, pe)
        for i in range(4):
            emb = emb + torch.where(labels == i, self.point_embeddings[i], 0.0)

        h, w = embed_hw or self.image_embedding_size
        if masks is not None:
            m = conv_nhwc(self.mask_conv1, masks, torch.float32)
            m = F.gelu(F.layer_norm(m, m.shape[-1:], self.mask_ln1.weight, self.mask_ln1.bias, 1e-6))
            m = conv_nhwc(self.mask_conv2, m, torch.float32)
            m = F.gelu(F.layer_norm(m, m.shape[-1:], self.mask_ln2.weight, self.mask_ln2.bias, 1e-6))
            dense = conv_nhwc(self.mask_conv3, m, torch.float32)
        else:
            # size-1 batch: every prompt shares the no-mask embedding, which
            # lets the decoder run block 0's image-side projections once
            dense = self.no_mask.expand(1, h, w, self.embed_dim)
        return emb, dense
