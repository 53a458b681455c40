"""SAM image encoder: ViTDet-style ViT with 14x14 window attention, global
layers, and decomposed relative position bias (NHWC, as the JAX package).

Port of pope_tpu/models/sam/encoder.py. The cast points are the JAX
package's: LayerNorms run in f32, the normed activations are cast to the
compute dtype before the window partition, the output is f32. Windowed
layers call the windowed-attention kernel on the un-reshaped qkv output;
global layers call the streaming rel-pos kernel on strided q/k/v views. The
rel-table einsums stay outside both kernels, as in the JAX package.

`quantize='int8'` builds the block's four dense layers as w8a8 `QuantDense`
(ops/quant.py; experimental, as in pope_tpu: no accuracy gate). They
quantize what the float layers would cast: qkv and proj the compute-dtype
activations, mlp_lin1 the f32 LayerNorm output (not cast first), mlp_lin2
the gelu output; the weights from their f32 master copy. `use_rel_pos=False`
registers no rel tables, and both windowed and global layers run the
bias-free attention kernel (ops/flash_attention.py::flash_attention, what
pope_tpu's `jax.nn.dot_product_attention` computes) on views of qkv.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.config import SamEncoderConfig
from pope_tpu_torch.ops.flash_attention import flash_attention, flash_attention_relpos
from pope_tpu_torch.ops.quant import QuantDense, dense_w8a8, make_dense, quantize_weight_cols
from pope_tpu_torch.ops.window_attention import windowed_attention_relpos


class _Unsharded:
    """The tensor-parallel wiring of a layer that has none: identity.
    parallel.shard_params_tp gives each layer it cuts a `tp_shard` with the
    same two methods."""

    @staticmethod
    def enter(x, dim: int = 1):
        return x

    @staticmethod
    def gather(y, dim: int):
        return y


def tp_shard(layer: nn.Module):
    """How a helper that reads `layer`'s weight itself feeds it (`enter`)
    and assembles its output (`gather`)."""
    return getattr(layer, "tp_shard", _Unsharded)


def dense(layer: nn.Linear, x, dtype):
    """flax nn.Dense(dtype=dtype): inputs, kernel and bias cast to dtype (a
    tp-sharded layer's output gathered over tp). A QuantDense quantizes x as
    it comes and its weight from the stored copy, and returns dtype."""
    tp = tp_shard(layer)
    if isinstance(layer, QuantDense):
        w8, w_scale = quantize_weight_cols(layer.weight)
        return tp.gather(dense_w8a8(tp.enter(x, -1), w8, w_scale, layer.bias, dtype), -1)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return tp.gather(F.linear(tp.enter(x, -1).to(dtype), layer.weight.to(dtype), bias), -1)


def layer_norm_f32(layer: nn.LayerNorm, x):
    """flax nn.LayerNorm(dtype=float32): computed and returned in f32."""
    return F.layer_norm(
        x.float(), layer.normalized_shape, layer.weight.float(), layer.bias.float(), layer.eps
    )


def conv_nhwc(layer: nn.Conv2d, x, dtype):
    """flax nn.Conv(dtype=dtype) on an NHWC tensor (a tp-sharded layer's
    output gathered over tp)."""
    tp = tp_shard(layer)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    y = F.conv2d(
        tp.enter(x.permute(0, 3, 1, 2)).to(dtype), layer.weight.to(dtype), bias,
        stride=layer.stride, padding=layer.padding, groups=layer.groups,
    )
    return tp.gather(y, 1).permute(0, 2, 3, 1)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm with biased variance; in NHWC a LayerNorm over the
    trailing axis, computed in f32 and returned in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        u = xf.mean(dim=-1, keepdim=True)
        s = ((xf - u) ** 2).mean(dim=-1, keepdim=True)
        xf = (xf - u) / torch.sqrt(s + self.eps)
        return (self.weight.float() * xf + self.bias.float()).to(x.dtype)


def _rel_pos_table(rel_pos, size: int):
    """(size, size, d) table of rel_pos rows at relative coords. The table's
    centre entry is zero displacement, so a sub-grid (size <= T, the
    rect-encode grid) slices the exact entries the square frame would use."""
    center = (rel_pos.shape[0] - 1) // 2
    ar = torch.arange(size, device=rel_pos.device)
    return rel_pos[ar[:, None] - ar[None, :] + center]


def _rel_tables(q, rel_pos_h, rel_pos_w, hw, dtype):
    """q-projected bias tables: q (B, H*W, nh, d) -> ((B, nh, N, H), (B, nh, N, W))."""
    B, N, nh, d = q.shape
    H, W = hw
    r_q = q.reshape(B, H, W, nh, d)
    Rh = _rel_pos_table(rel_pos_h, H).to(dtype)
    Rw = _rel_pos_table(rel_pos_w, W).to(dtype)
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", r_q, Rh).reshape(B, nh, N, H).contiguous()
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", r_q, Rw).reshape(B, nh, N, W).contiguous()
    return rel_h, rel_w


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 grid: int, dtype: torch.dtype, gelu: str = "erf", use_rel_pos: bool = True,
                 quantize: str = "none"):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size  # 0 = global
        self.dtype = dtype
        self.gelu = gelu
        self.use_rel_pos = use_rel_pos
        Dense = make_dense(quantize)
        d = dim // num_heads
        side = window_size if window_size > 0 else grid
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = Dense(dim, 3 * dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, d))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, d))
        self.proj = Dense(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp_lin1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp_lin2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x):
        B, H, W, C = x.shape
        nh = self.num_heads
        d = C // nh
        dt = self.dtype
        shortcut = x
        h = layer_norm_f32(self.norm1, x).to(dt)

        ws = self.window_size
        if ws > 0:
            pad_h = (ws - H % ws) % ws
            pad_w = (ws - W % ws) % ws
            Hp, Wp = H + pad_h, W + pad_w
            hp = F.pad(h, (0, 0, 0, pad_w, 0, pad_h))
            hp = hp.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
            tokens = hp.reshape(-1, ws * ws, C)
            qkv = dense(self.qkv, tokens, dt)  # (BW, ws*ws, 3C)
            if self.use_rel_pos:
                q = qkv[..., :C].unflatten(-1, (nh, d))
                rel_h, rel_w = _rel_tables(q, self.rel_pos_h, self.rel_pos_w, (ws, ws), dt)
                attn = windowed_attention_relpos(qkv, rel_h, rel_w, nh, d, ws, ws)
            else:
                qkv = qkv.view(*tokens.shape[:2], 3, nh, d)
                attn = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
            attn = dense(self.proj, attn, dt)
            attn = attn.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
            attn_sp = attn.reshape(B, Hp, Wp, C)[:, :H, :W]
        else:
            qkv = dense(self.qkv, h.reshape(B, H * W, C), dt).view(B, H * W, 3, nh, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if self.use_rel_pos:
                rel_h, rel_w = _rel_tables(q, self.rel_pos_h, self.rel_pos_w, (H, W), dt)
                attn = flash_attention_relpos(q, k, v, rel_h, rel_w, H, W)
            else:
                attn = flash_attention(q, k, v)
            attn_sp = dense(self.proj, attn, dt).reshape(B, H, W, C)

        x = shortcut + attn_sp
        h = layer_norm_f32(self.norm2, x)
        h = dense(self.mlp_lin1, h, dt)
        h = F.gelu(h, approximate="tanh" if self.gelu == "tanh" else "none")
        h = dense(self.mlp_lin2, h, dt)
        return x + h


class ImageEncoderViT(nn.Module):
    """(B, fh, fw, 3) preprocessed frames -> (B, fh/16, fw/16, out_chans) f32.

    Rect frames (fh, fw multiples of the patch size, <= img_size) encode a
    rect token grid; the abs pos embed and the global rel-pos tables are
    sliced, not interpolated."""

    def __init__(self, config: SamEncoderConfig = SamEncoderConfig()):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = getattr(torch, cfg.dtype)
        grid = cfg.img_size // cfg.patch_size
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, cfg.embed_dim))
        self.block_names = []
        for i in range(cfg.depth):
            name = f"block_{i}"
            self.add_module(name, EncoderBlock(
                cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio,
                0 if i in cfg.global_attn_indexes else cfg.window_size,
                grid, self.dtype, cfg.gelu, cfg.use_rel_pos, cfg.quantize,
            ))
            self.block_names.append(name)
        self.neck_conv1 = nn.Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False)
        self.neck_ln1 = LayerNorm2d(cfg.out_chans)
        self.neck_conv2 = nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False)
        self.neck_ln2 = LayerNorm2d(cfg.out_chans)

    def forward(self, x):
        dt = self.dtype
        x = conv_nhwc(self.patch_embed, x, dt)
        gh, gw = x.shape[1:3]
        x = x + self.pos_embed[:, :gh, :gw].to(dt)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.neck_ln1(conv_nhwc(self.neck_conv1, x, dt))
        x = self.neck_ln2(conv_nhwc(self.neck_conv2, x, dt))
        return x.float()
