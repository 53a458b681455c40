"""Model FLOPs (2 x multiply-adds) of SAM's encode and AMG decode of a
640x480 frame, from the configuration: a frozen copy of the SAM terms of
`pope_tpu_torch/bench.py::flop_budget` (term for term), with the decode's
subsample as a parameter so that the records path's full-resolution decode
(subsample 1) is counted."""

from __future__ import annotations

H, W = 480, 640


def vit_flops(n_tokens, depth, embed, mlp_ratio=4.0, window=0, n_windows=0, n_global=0):
    """A ViT forward: qkv / proj / MLP products and the attention einsums;
    windowed layers attend within `n_windows` windows of window^2 tokens,
    `n_global` layers over all tokens."""
    C = embed
    flops = float(depth) * 2 * n_tokens * C * C * (3 + 1 + 2 * mlp_ratio)
    if window:
        flops += (depth - n_global) * 4 * n_windows * (window * window) ** 2 * C
        flops += n_global * 4 * n_tokens * n_tokens * C
    else:
        flops += depth * 4 * n_tokens * n_tokens * C
    return flops


def token_grid(cfg) -> tuple:
    """The SAM encoder's token grid of a 640x480 frame (rect encode: the
    patch-aligned 1024x768 frame)."""
    enc = cfg.sam.encoder
    if not cfg.amg.rect_encode:
        g = enc.img_size // enc.patch_size
        return g, g
    scale = enc.img_size / max(H, W)
    h, w = int(H * scale + 0.5), int(W * scale + 0.5)
    up = lambda v: -(-v // enc.patch_size)
    return up(h), up(w)


def sam_flops(cfg, subsample: int) -> dict:
    """SAM's encode and the AMG decode of one frame: every grid prompt's
    two-way transformer on the image side (7 units a prompt, 3 once an
    image) and its upscaling, of which a subsampled decode runs
    1 / subsample^2."""
    enc = cfg.sam.encoder
    gh, gw = token_grid(cfg)
    n_tok = gh * gw
    ws = enc.window_size
    n_windows = (-(-gh // ws)) * (-(-gw // ws))
    encode = vit_flops(n_tok, enc.depth, enc.embed_dim, enc.mlp_ratio,
                       window=ws, n_windows=n_windows, n_global=len(enc.global_attn_indexes))
    D = cfg.sam.prompt_embed_dim
    n_prompts = cfg.amg.points_per_side ** 2
    unit = 2 * n_tok * D * (D // 2)
    upscale = 2 * (4 * n_tok) * D * (D // 4) * 4 + 2 * (16 * n_tok) * (D // 4) * (D // 8) * 4
    upscale /= float(subsample) ** 2
    decode = n_prompts * (7 * unit + upscale) + 3 * unit
    return {"sam_encode": encode, "amg_decode": decode}


def image_flops(cfg) -> dict:
    """One frame of the records path: SAM's encode and the full-resolution
    decode (subsample 1), no retrieval and no matcher."""
    out = sam_flops(cfg, 1)
    out["total"] = sum(out.values())
    return out
