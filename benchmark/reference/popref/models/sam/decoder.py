"""SAM two-way transformer + mask decoder (port of
pope_tpu/models/sam/decoder.py): Dense layers in the decoder dtype,
LayerNorms and softmax in f32."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.popref.models.sam.encoder import LayerNorm2d, dense, layer_norm_f32


class DownsampledAttention(nn.Module):
    """q/k/v projections into an internal (possibly downsampled) dim.

    q: (Bq, Nq, C), k/v: (Bk, Nk, C) with Bq and Bk equal or one of them 1.
    A size-1 side is not expanded to the full batch: its projection runs once
    and the einsums broadcast (the AMG decode's shared image side). The
    output batch is max(Bq, Bk)."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        internal = embedding_dim // downsample_rate
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def forward(self, q, k, v):
        nh, dt = self.num_heads, self.dtype
        internal = self.q_proj.out_features
        d = internal // nh
        Bq, Nq, _ = q.shape
        Bk, Nk = k.shape[:2]
        if Bq != Bk and 1 not in (Bq, Bk):
            raise ValueError(f"batch mismatch: q {Bq} vs k/v {Bk} (one must be 1)")
        qp = dense(self.q_proj, q, dt).reshape(Bq, Nq, nh, d)
        kp = dense(self.k_proj, k, dt).reshape(Bk, Nk, nh, d)
        vp = dense(self.v_proj, v, dt).reshape(Bk, Nk, nh, d)
        scale = d ** -0.5
        if Bq == Bk:
            logits = torch.einsum("bqhd,bkhd->bhqk", qp * scale, kp)
        elif Bk == 1:
            logits = torch.einsum("bqhd,khd->bhqk", qp * scale, kp[0])
        else:
            logits = torch.einsum("qhd,bkhd->bhqk", qp[0] * scale, kp)
        attn = torch.softmax(logits.float(), dim=-1).to(qp.dtype)
        if vp.shape[0] == attn.shape[0]:
            out = torch.einsum("bhqk,bkhd->bqhd", attn, vp)
        else:
            out = torch.einsum("bhqk,khd->bqhd", attn, vp[0])
        out = out.reshape(attn.shape[0], Nq, internal)
        return dense(self.out_proj, out, dt)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, skip_first_layer_pe: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dim = embedding_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.dtype = dtype
        self.self_attn = DownsampledAttention(dim, num_heads, 1, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_t2i = DownsampledAttention(dim, num_heads, attention_downsample_rate, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_lin1 = nn.Linear(dim, mlp_dim)
        self.mlp_lin2 = nn.Linear(mlp_dim, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn_i2t = DownsampledAttention(dim, num_heads, attention_downsample_rate, dtype)
        self.norm4 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = layer_norm_f32(self.norm1, queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = layer_norm_f32(self.norm2, queries + self.cross_attn_t2i(q, k, keys))

        h = F.relu(dense(self.mlp_lin1, queries, self.dtype))
        h = dense(self.mlp_lin2, h, self.dtype)
        queries = layer_norm_f32(self.norm3, queries + h)

        q = queries + query_pe
        k = keys + key_pe
        keys = layer_norm_f32(self.norm4, keys + self.cross_attn_i2t(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer_{i}", TwoWayAttentionBlock(
                embedding_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0), dtype=dtype,
            ))
        self.final_attn_t2i = DownsampledAttention(embedding_dim, num_heads, 2, dtype)
        self.norm_final = nn.LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding/image_pe: (Bk, h, w, C); point_embedding: (B, N, C).
        Bk == 1 is the shared-image path. Returns (tokens (B, N, C), image
        state (max(B, Bk), hw, C))."""
        Bk, h, w, C = image_embedding.shape
        keys = image_embedding.reshape(Bk, h * w, C)
        key_pe = image_pe.reshape(-1, h * w, C)[:1]
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layer_{i}")(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = layer_norm_f32(self.norm_final, queries + self.final_attn_t2i(q, k, keys))
        return queries, keys


class UpConvT(nn.Module):
    """2x2-stride-2 transposed conv with an exact-subsample mode.

    The parameter keeps the JAX package's layout, `kernel` (2, 2, in, out),
    and its tap order: output pixel (2i+a, 2j+b) = x[i, j] @ kernel[1-a, 1-b]
    + bias (lax.conv_transpose with transpose_kernel=False). subsample=True
    returns only subpixel (0, 0), the stride-2 subsample of the full output,
    as a per-pixel matmul with kernel[1, 1]."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(2, 2, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, subsample: bool = False):
        dt = self.dtype
        x, kernel, bias = x.to(dt), self.kernel.to(dt), self.bias.to(dt)
        if subsample:
            return torch.einsum("bhwc,cf->bhwf", x, kernel[1, 1]) + bias
        # torch's taps: out(2i+a, 2j+b) = x[i, j] @ weight[:, :, a, b]
        weight = kernel.flip(0, 1).permute(2, 3, 0, 1)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, stride=2)
        return y.permute(0, 2, 3, 1) + bias


class HyperMLP(nn.Module):
    """3-layer relu MLP."""

    def __init__(self, in_dim: int, hidden: int, out: int, layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = layers
        dims = [in_dim] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"lin{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.layers - 1):
            x = F.relu(dense(getattr(self, f"lin{i}"), x, self.dtype))
        return dense(getattr(self, f"lin{self.layers - 1}"), x, self.dtype)


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 depth: int = 2, num_heads: int = 8, mlp_dim: int = 2048,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, C))
        self.mask_tokens = nn.Parameter(torch.zeros(self.num_mask_tokens, C))
        self.transformer = TwoWayTransformer(depth, C, num_heads, mlp_dim, dtype)
        self.up_conv1 = UpConvT(C, C // 4, dtype)
        self.up_ln = LayerNorm2d(C // 4)
        self.up_conv2 = UpConvT(C // 4, C // 8, dtype)
        for i in range(self.num_mask_tokens):
            self.add_module(f"hyper_{i}", HyperMLP(C, C, C // 8, dtype=dtype))
        self.iou_head = HyperMLP(C, iou_head_hidden_dim, self.num_mask_tokens, iou_head_depth, dtype)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool = True, subsample: int = 1, return_all_tokens: bool = False):
        """image_embeddings: (1 or B, h, w, C); image_pe: (h, w, C);
        sparse_prompt: (B, N, C); dense_prompt: (1 or B, h, w, C).
        Returns (masks (B, K, 4h, 4w), iou_pred (B, K)), K = 3 with
        multimask_output else 1; subsample=4 gives the exact stride-4
        subsample of the masks, (B, K, h, w). return_all_tokens=True returns
        all 4 mask tokens unsliced (the prompt head's surface, whose
        single-mask selection needs token 0 and the multimask slots)."""
        if subsample not in (1, 4):
            raise ValueError(f"subsample must be 1 or 4, got {subsample}")
        C = self.iou_token.shape[-1]
        B = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse_prompt], dim=1)
        src = image_embeddings + dense_prompt
        h, w = src.shape[1:3]

        hs, keys = self.transformer(src, image_pe[None], tokens)
        iou_out = hs[:, 0]
        mask_out = hs[:, 1 : 1 + self.num_mask_tokens]

        sub = subsample == 4
        src2 = keys.reshape(B, h, w, C)
        up = F.gelu(self.up_ln(self.up_conv1(src2, subsample=sub)))
        up = F.gelu(self.up_conv2(up, subsample=sub))

        hyper = torch.stack(
            [getattr(self, f"hyper_{i}")(mask_out[:, i]) for i in range(self.num_mask_tokens)],
            dim=1,
        )  # (B, K, C/8)
        masks = torch.einsum("bkc,bhwc->bkhw", hyper, up)
        iou_pred = self.iou_head(iou_out)
        if return_all_tokens:
            return masks, iou_pred
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]
