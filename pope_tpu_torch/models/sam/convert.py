"""Released SAM checkpoint layout (sam_vit_{b,l,h}_*.pth, build_sam.py:53-107)
-> the JAX package's parameter tree, as numpy arrays.

A copy of pope_tpu/models/sam/convert.py (the port imports nothing of the
JAX package); `weights.sam_state_from_jax` takes the tree on to the port's
modules."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _conv(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _convT(w):
    # torch ConvTranspose2d: (in, out, kh, kw) -> flax: (kh, kw, in, out)
    return np.transpose(np.asarray(w), (2, 3, 0, 1))


def _lin(w):
    return np.transpose(np.asarray(w), (1, 0))


def _set(tree: Dict, path: str, value):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


def _ln(params, dst, sd, src):
    _set(params, f"{dst}/scale", sd[f"{src}.weight"])
    _set(params, f"{dst}/bias", sd[f"{src}.bias"])


def _dense(params, dst, sd, src):
    _set(params, f"{dst}/kernel", _lin(sd[f"{src}.weight"]))
    if f"{src}.bias" in sd:
        _set(params, f"{dst}/bias", sd[f"{src}.bias"])


def _attn4(params, dst, sd, src):
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(params, f"{dst}/{n}", sd, f"{src}.{n}")


def convert_torch_sam_state(state_dict: Mapping[str, np.ndarray], depth: int):
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    p: Dict = {}

    # ---- image encoder ----
    enc = "image_encoder"
    _set(p, f"{enc}/patch_embed/kernel", _conv(sd["image_encoder.patch_embed.proj.weight"]))
    _set(p, f"{enc}/patch_embed/bias", sd["image_encoder.patch_embed.proj.bias"])
    _set(p, f"{enc}/pos_embed", sd["image_encoder.pos_embed"])  # already (1,H,W,C)
    for i in range(depth):
        s = f"image_encoder.blocks.{i}"
        d = f"{enc}/block_{i}"
        _ln(p, f"{d}/norm1", sd, f"{s}.norm1")
        _ln(p, f"{d}/norm2", sd, f"{s}.norm2")
        _dense(p, f"{d}/qkv", sd, f"{s}.attn.qkv")
        _dense(p, f"{d}/proj", sd, f"{s}.attn.proj")
        if f"{s}.attn.rel_pos_h" in sd:
            _set(p, f"{d}/rel_pos_h", sd[f"{s}.attn.rel_pos_h"])
            _set(p, f"{d}/rel_pos_w", sd[f"{s}.attn.rel_pos_w"])
        _dense(p, f"{d}/mlp_lin1", sd, f"{s}.mlp.lin1")
        _dense(p, f"{d}/mlp_lin2", sd, f"{s}.mlp.lin2")
    _set(p, f"{enc}/neck_conv1/kernel", _conv(sd["image_encoder.neck.0.weight"]))
    _set(p, f"{enc}/neck_ln1/weight", sd["image_encoder.neck.1.weight"])
    _set(p, f"{enc}/neck_ln1/bias", sd["image_encoder.neck.1.bias"])
    _set(p, f"{enc}/neck_conv2/kernel", _conv(sd["image_encoder.neck.2.weight"]))
    _set(p, f"{enc}/neck_ln2/weight", sd["image_encoder.neck.3.weight"])
    _set(p, f"{enc}/neck_ln2/bias", sd["image_encoder.neck.3.bias"])

    # ---- prompt encoder ----
    pe = "prompt_encoder"
    _set(p, f"{pe}/pe_gaussian", sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"])
    pts = np.concatenate(
        [sd[f"prompt_encoder.point_embeddings.{i}.weight"] for i in range(4)], axis=0
    )
    _set(p, f"{pe}/point_embeddings", pts)
    _set(p, f"{pe}/not_a_point", sd["prompt_encoder.not_a_point_embed.weight"][0])
    _set(p, f"{pe}/no_mask", sd["prompt_encoder.no_mask_embed.weight"][0])
    _set(p, f"{pe}/mask_conv1/kernel", _conv(sd["prompt_encoder.mask_downscaling.0.weight"]))
    _set(p, f"{pe}/mask_conv1/bias", sd["prompt_encoder.mask_downscaling.0.bias"])
    _ln(p, f"{pe}/mask_ln1", sd, "prompt_encoder.mask_downscaling.1")
    _set(p, f"{pe}/mask_conv2/kernel", _conv(sd["prompt_encoder.mask_downscaling.3.weight"]))
    _set(p, f"{pe}/mask_conv2/bias", sd["prompt_encoder.mask_downscaling.3.bias"])
    _ln(p, f"{pe}/mask_ln2", sd, "prompt_encoder.mask_downscaling.4")
    _set(p, f"{pe}/mask_conv3/kernel", _conv(sd["prompt_encoder.mask_downscaling.6.weight"]))
    _set(p, f"{pe}/mask_conv3/bias", sd["prompt_encoder.mask_downscaling.6.bias"])

    # ---- mask decoder ----
    md = "mask_decoder"
    _set(p, f"{md}/iou_token", sd["mask_decoder.iou_token.weight"])
    _set(p, f"{md}/mask_tokens", sd["mask_decoder.mask_tokens.weight"])
    tr = f"{md}/transformer"
    for i in range(2):
        s = f"mask_decoder.transformer.layers.{i}"
        d = f"{tr}/layer_{i}"
        _attn4(p, f"{d}/self_attn", sd, f"{s}.self_attn")
        _attn4(p, f"{d}/cross_attn_t2i", sd, f"{s}.cross_attn_token_to_image")
        _attn4(p, f"{d}/cross_attn_i2t", sd, f"{s}.cross_attn_image_to_token")
        for j in (1, 2, 3, 4):
            _ln(p, f"{d}/norm{j}", sd, f"{s}.norm{j}")
        _dense(p, f"{d}/mlp_lin1", sd, f"{s}.mlp.lin1")
        _dense(p, f"{d}/mlp_lin2", sd, f"{s}.mlp.lin2")
    _attn4(p, f"{tr}/final_attn_t2i", sd, "mask_decoder.transformer.final_attn_token_to_image")
    _ln(p, f"{tr}/norm_final", sd, "mask_decoder.transformer.norm_final_attn")
    _set(p, f"{md}/up_conv1/kernel", _convT(sd["mask_decoder.output_upscaling.0.weight"]))
    _set(p, f"{md}/up_conv1/bias", sd["mask_decoder.output_upscaling.0.bias"])
    _set(p, f"{md}/up_ln/weight", sd["mask_decoder.output_upscaling.1.weight"])
    _set(p, f"{md}/up_ln/bias", sd["mask_decoder.output_upscaling.1.bias"])
    _set(p, f"{md}/up_conv2/kernel", _convT(sd["mask_decoder.output_upscaling.3.weight"]))
    _set(p, f"{md}/up_conv2/bias", sd["mask_decoder.output_upscaling.3.bias"])
    for i in range(4):
        for j in range(3):
            _dense(p, f"{md}/hyper_{i}/lin{j}", sd, f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}")
    for j in range(3):
        _dense(p, f"{md}/iou_head/lin{j}", sd, f"mask_decoder.iou_prediction_head.layers.{j}")

    return {"params": p}
