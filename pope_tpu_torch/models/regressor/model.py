"""Relative-pose regressor over matcher keypoints and/or image crops (port of
pope_tpu/models/regressor/model.py): NeRF-embedded (mkpts0, mkpts1) -> token
attention blocks -> mean-pooled summary; an image branch (ConvNeXtV2, or a
frozen Vision Mamba); their fusion (post-norm cross-attention blocks, or an
encoder-decoder transformer pair); a leaky-ReLU MLP with dropout 0.1 in
training; translation (3) and rotation (matrix 9 / quat 4 / 6d 6) heads.

The attention is flax's MultiHeadDotProductAttention: query / key / value /
out projections with biases, the query scaled by head_dim^-1/2, softmax,
no dropout; it runs outside any kernel (plain products and softmax), as in
the JAX package. The mean pool runs over the zero-padded tokens too, as
there.

`dtype` is the compute dtype, as flax's `dtype=` in the JAX package: the
denses (the attention's projections among them), convs and the Vim run in
it, the LayerNorms and both heads in f32; the parameters stay f32.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.config import RegressorConfig
from pope_tpu_torch.geometry.pose import o6d_to_matrix, quat_to_matrix
from pope_tpu_torch.models.regressor.convnextv2 import ConvNeXtV2
from pope_tpu_torch.models.regressor.embedding import nerf_embedding
from pope_tpu_torch.models.sam.encoder import dense, layer_norm_f32
from pope_tpu_torch.models.regressor.vim import VimConfig, VisionMamba

MLP_WIDTHS = (512, 256, 128, 64)
DROPOUT = 0.1
VIM_SIZES = {"tiny": (192, 24), "small": (384, 24), "test": (32, 2)}  # (embed_dim, depth)

# one keep mask per MLP layer, a Generator to draw them, or None (no dropout)
Dropout = Union[None, torch.Generator, Sequence[torch.Tensor]]


class MultiHeadAttention(nn.Module):
    """flax nn.MultiHeadDotProductAttention(num_heads, qkv_features=d)."""

    def __init__(self, d_in: int, d_qkv: int, nhead: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nhead, self.dtype = nhead, dtype
        self.query = nn.Linear(d_in, d_qkv)
        self.key = nn.Linear(d_in, d_qkv)
        self.value = nn.Linear(d_in, d_qkv)
        self.out = nn.Linear(d_qkv, d_in)

    def forward(self, q_in, kv_in):
        B, Lq, _ = q_in.shape
        Lk = kv_in.shape[1]
        heads = lambda t, L: t.view(B, L, self.nhead, -1)
        dt = self.dtype
        q = heads(dense(self.query, q_in, dt), Lq)
        q = q / q.shape[-1] ** 0.5
        k, v = heads(dense(self.key, kv_in, dt), Lk), heads(dense(self.value, kv_in, dt), Lk)
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return dense(self.out, torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, Lq, -1), dt)


class CrossAttnBlock(nn.Module):
    """Post-norm block: tgt attends to src, residual + LayerNorm, ReLU FFN,
    residual + LayerNorm."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn = MultiHeadAttention(d_model, d_model, nhead, dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.ffn1 = nn.Linear(d_model, d_ffn)
        self.ffn2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, src, tgt):
        dt = self.dtype
        tgt = layer_norm_f32(self.norm1, tgt + self.attn(tgt, src))
        return layer_norm_f32(self.norm2, tgt + dense(self.ffn2, F.relu(dense(self.ffn1, tgt, dt)), dt))


class TransformerFusion(nn.Module):
    """Encoder-decoder fusion (model0604's nn.Transformer pair): src is
    encoded into memory; tgt self-attends, cross-attends to it, FFN; each
    sublayer post-norm."""

    def __init__(self, d_model: int, nhead: int, layers: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        d = d_model
        for i in range(layers):
            self.add_module(f"enc{i}_attn", MultiHeadAttention(d, d, nhead, dtype))
            for n in ("n1", "n2"):
                self.add_module(f"enc{i}_{n}", nn.LayerNorm(d, eps=1e-6))
            self.add_module(f"enc{i}_ffn1", nn.Linear(d, 2 * d))
            self.add_module(f"enc{i}_ffn2", nn.Linear(2 * d, d))
        for i in range(layers):
            self.add_module(f"dec{i}_self", MultiHeadAttention(d, d, nhead, dtype))
            self.add_module(f"dec{i}_cross", MultiHeadAttention(d, d, nhead, dtype))
            for n in ("n1", "n2", "n3"):
                self.add_module(f"dec{i}_{n}", nn.LayerNorm(d, eps=1e-6))
            self.add_module(f"dec{i}_ffn1", nn.Linear(d, 2 * d))
            self.add_module(f"dec{i}_ffn2", nn.Linear(2 * d, d))

    def _ffn(self, x, name):
        dt = self.dtype
        return dense(getattr(self, f"{name}_ffn2"), F.relu(dense(getattr(self, f"{name}_ffn1"), x, dt)), dt)

    def forward(self, src, tgt):
        m = lambda name: getattr(self, name)
        ln = lambda name, x: layer_norm_f32(m(name), x)
        mem = src
        for i in range(self.layers):
            mem = ln(f"enc{i}_n1", mem + m(f"enc{i}_attn")(mem, mem))
            mem = ln(f"enc{i}_n2", mem + self._ffn(mem, f"enc{i}"))
        out = tgt
        for i in range(self.layers):
            out = ln(f"dec{i}_n1", out + m(f"dec{i}_self")(out, out))
            out = ln(f"dec{i}_n2", out + m(f"dec{i}_cross")(out, mem))
            out = ln(f"dec{i}_n3", out + self._ffn(out, f"dec{i}"))
        return out


def dropout_masks(batch: int, generator: torch.Generator, device=None):
    """Keep masks (B, width) of the MLP's four dropout layers, P(keep) 0.9."""
    return [torch.rand(batch, w, generator=generator, device=device) < 1.0 - DROPOUT for w in MLP_WIDTHS]


class MkptsRegModel(nn.Module):
    """Pose regressor; modes 'mkpts' | 'imgs' | 'mkpts+imgs' | 'mkpts+vim' |
    'vim' (the '+vim' modes are MoCoPE: a frozen VisionMamba image branch);
    config.fusion 'cross_attn' or 'transformer' fuses two branches.

    mkpts0, mkpts1: (B, N, 2) matched keypoints, zero-padded to N;
    img0, img1: (B, H, W, 3) crops for the image branch, or None;
    dropout: None (eval), a torch.Generator that draws the MLP's keep masks,
    or the four (B, width) keep masks themselves;
    dtype: the compute dtype, "float32" or "bfloat16".
    Returns (pred_t (B, 3), pred_R (B, 3, 3)), f32."""

    def __init__(self, config: RegressorConfig = RegressorConfig(), cnn_name: str = "large",
                 dtype: str = "float32"):
        super().__init__()
        cfg = self.config = config
        self.dtype = dt = getattr(torch, dtype)
        mode, d = cfg.net_mode, cfg.d_model
        self.use_mkpts = "mkpts" in mode
        self.use_vim = "vim" in mode
        self.use_imgs = "imgs" in mode or self.use_vim
        if self.use_mkpts:
            self.mkpts_in = nn.Linear(4 * (2 * cfg.n_freqs + 1), d)
            self.mkpts_attn0 = CrossAttnBlock(d, cfg.nhead, 2 * d, dt)
            self.mkpts_attn1 = CrossAttnBlock(d, cfg.nhead, 2 * d, dt)
        if self.use_vim:
            dim, depth = VIM_SIZES[cfg.vim_size]
            self.vim = VisionMamba(VimConfig(embed_dim=dim, depth=depth, num_classes=0, dtype=dtype))
            self.img_in = nn.Linear(dim, d)
        elif self.use_imgs:
            self.cnn = ConvNeXtV2.from_name(cnn_name, num_classes=0, dtype=dt)
            self.img_in = nn.Linear(self.cnn.dims[-1], d)
        if self.use_mkpts and self.use_imgs:
            if cfg.fusion == "transformer":
                self.fuse_mkpts_q = TransformerFusion(d, cfg.nhead, cfg.fusion_layers, dt)
                self.fuse_img_q = TransformerFusion(d, cfg.nhead, cfg.fusion_layers, dt)
            else:
                self.fuse_mkpts_q = CrossAttnBlock(d, cfg.nhead, 2 * d, dt)
                self.fuse_img_q = CrossAttnBlock(d, cfg.nhead, 2 * d, dt)
            width = 2 * d
        else:
            width = d
        for i, w in enumerate(MLP_WIDTHS):
            self.add_module(f"mlp{i}", nn.Linear(width, w))
            width = w
        self.translation_head = nn.Linear(width, 3)
        self.rotation_head = nn.Linear(width, {"matrix": 9, "quat": 4, "6d": 6}[cfg.rotation_mode])

    def image_features(self, img0, img1):
        """The image branch's (B, 2, d) tokens; a frozen Vim runs without
        gradients (its parameters get none)."""
        if self.use_vim:
            with torch.set_grad_enabled(torch.is_grad_enabled() and not self.config.freeze_vim):
                f0, f1 = self.vim(img0), self.vim(img1)
        else:
            f0, f1 = self.cnn(img0), self.cnn(img1)
        return dense(self.img_in, torch.stack([f0, f1], dim=1), self.dtype)

    def forward(self, mkpts0, mkpts1, img0=None, img1=None, dropout: Dropout = None):
        cfg = self.config
        tokens = []
        if self.use_mkpts:
            x = dense(self.mkpts_in, nerf_embedding(torch.cat([mkpts0, mkpts1], dim=-1), cfg.n_freqs), self.dtype)
            x = self.mkpts_attn0(x, x)
            x = self.mkpts_attn1(x, x)
            tokens.append(x.mean(dim=1, keepdim=True))  # (B, 1, d), padded tokens included
        if self.use_imgs:
            tokens.append(self.image_features(img0, img1))
        if len(tokens) == 2:
            tm, ti = tokens
            q_m, q_i = self.fuse_mkpts_q(ti, tm), self.fuse_img_q(tm, ti)
            h = torch.cat([q_m.mean(1), q_i.mean(1)], dim=-1)
        else:
            h = tokens[0].mean(dim=1)
        if isinstance(dropout, torch.Generator):
            dropout = dropout_masks(h.shape[0], dropout, h.device)
        for i in range(len(MLP_WIDTHS)):
            h = F.leaky_relu(dense(getattr(self, f"mlp{i}"), h, self.dtype), 0.01)
            if dropout is not None:
                h = torch.where(dropout[i], h / (1.0 - DROPOUT), torch.zeros_like(h))
        pred_t = dense(self.translation_head, h, torch.float32)
        raw = dense(self.rotation_head, h, torch.float32)
        if cfg.rotation_mode == "matrix":
            pred_R = raw.reshape(-1, 3, 3)
        elif cfg.rotation_mode == "quat":
            pred_R = quat_to_matrix(raw)
        else:
            pred_R = o6d_to_matrix(raw)
        return pred_t, pred_R
