"""Sinusoidal 2-D position encoding and the LoFTR transformer stages (port
of pope_tpu/models/matcher/transformer.py)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.models.sam.encoder import dense, layer_norm_f32
from pope_tpu_torch.ops.attention import full_attention, linear_attention


def sine_position_encoding(h: int, w: int, d_model: int, temp_bug_fix: bool = False, device=None):
    """(h, w, d_model) f32 encoding: channels [0::4] sin(x f), [1::4] cos(x f),
    [2::4] sin(y f), [3::4] cos(y f), 1-indexed positions. temp_bug_fix=False
    keeps the reference's precedence bug in the frequency
    (exp(k * (-log(1e4) / d // 2))), which the released weights bake in."""
    n_freq = d_model // 4
    k = torch.arange(0, d_model // 2, 2, dtype=torch.float32, device=device)
    if temp_bug_fix:
        div_term = torch.exp(k * (-math.log(10000.0) / (d_model // 2)))
    else:
        div_term = torch.exp(k * (-math.log(10000.0) / d_model // 2))
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None, None]
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :, None]
    f = div_term[None, None, :]
    pe = torch.zeros(h, w, d_model, dtype=torch.float32, device=device)
    pe[:, :, 0::4] = torch.sin(x * f).expand(h, w, n_freq)
    pe[:, :, 1::4] = torch.cos(x * f).expand(h, w, n_freq)
    pe[:, :, 2::4] = torch.sin(y * f).expand(h, w, n_freq)
    pe[:, :, 3::4] = torch.cos(y * f).expand(h, w, n_freq)
    return pe


class LoFTREncoderLayer(nn.Module):
    """out = x + LN2(MLP(cat[x, LN1(merge(attn(q, k, v)))])); LayerNorms in
    f32 with flax's eps 1e-6, Dense layers bias-free in the stage dtype."""

    def __init__(self, d_model: int, nhead: int, attention: str = "linear", dtype=torch.float32):
        super().__init__()
        self.nhead = nhead
        self.attention = attention
        self.dtype = dtype
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.mlp1 = nn.Linear(2 * d_model, 2 * d_model, bias=False)
        self.mlp2 = nn.Linear(2 * d_model, d_model, bias=False)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x, source, x_mask=None, source_mask=None):
        B, L, C = x.shape
        S = source.shape[1]
        nh, dt = self.nhead, self.dtype
        q = dense(self.q_proj, x, dt).view(B, L, nh, C // nh)
        k = dense(self.k_proj, source, dt).view(B, S, nh, C // nh)
        v = dense(self.v_proj, source, dt).view(B, S, nh, C // nh)
        attn = linear_attention if self.attention == "linear" else full_attention
        msg = attn(q, k, v, q_mask=x_mask, kv_mask=source_mask)
        msg = layer_norm_f32(self.norm1, dense(self.merge, msg.reshape(B, L, C), dt))
        msg = F.relu(dense(self.mlp1, torch.cat([x, msg], dim=-1), dt))
        msg = layer_norm_f32(self.norm2, dense(self.mlp2, msg, dt))
        return x + msg


class LocalFeatureTransformer(nn.Module):
    """Interleaved self/cross attention over two token sets."""

    def __init__(self, d_model: int, nhead: int, layer_names=("self", "cross"),
                 attention: str = "linear", dtype=torch.float32):
        super().__init__()
        for name in layer_names:
            if name not in ("self", "cross"):
                raise KeyError(name)
        self.layer_names = tuple(layer_names)
        for i in range(len(self.layer_names)):
            self.add_module(f"layer_{i}", LoFTREncoderLayer(d_model, nhead, attention, dtype))

    def forward(self, feat0, feat1, mask0=None, mask1=None):
        for i, name in enumerate(self.layer_names):
            layer = getattr(self, f"layer_{i}")
            if name == "self":
                feat0 = layer(feat0, feat0, mask0, mask0)
                feat1 = layer(feat1, feat1, mask1, mask1)
            else:
                feat0 = layer(feat0, feat1, mask0, mask1)
                feat1 = layer(feat1, feat0, mask1, mask0)
        return feat0, feat1
