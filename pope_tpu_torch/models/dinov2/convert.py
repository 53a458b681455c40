"""PyTorch -> flax weight conversion for DINOv2 ViTs.

Accepts the released `dinov2_vits14.pth`-style state dict (optionally under a
'student'/'teacher' checkpoint key with 'backbone.' prefixes, the layout
load_pretrained_weights handles at dinov2/utils/utils.py:21).

A verbatim copy of pope_tpu/models/dinov2/convert.py (numpy only): the port
imports nothing of the JAX package. weights.py carries its output into the
port's modules.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _lin(w):
    return np.transpose(np.asarray(w), (1, 0))


def _set(tree: Dict, path: str, value):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


def normalize_dinov2_keys(sd: Mapping[str, np.ndarray], checkpoint_key: str = "student"):
    """Unwrap {'student': {...}} / 'backbone.' / 'blocks.0.' chunked-prefix
    layouts to flat vit keys."""
    if checkpoint_key in sd and isinstance(sd[checkpoint_key], Mapping):
        sd = sd[checkpoint_key]
    out = {}
    for k, v in sd.items():
        k = k.replace("module.", "").replace("backbone.", "")
        # chunked blocks: blocks.0.blocks.0.x -> blocks.0.x
        parts = k.split(".")
        if len(parts) > 3 and parts[0] == "blocks" and parts[2] == "blocks":
            k = ".".join(["blocks", parts[3]] + parts[4:])
        out[k] = np.asarray(v)
    return out


def convert_torch_dinov2_state(state_dict: Mapping[str, np.ndarray], depth: int = 12):
    sd = normalize_dinov2_keys(state_dict)
    params: Dict = {}
    _set(params, "cls_token", sd["cls_token"])
    _set(params, "pos_embed", sd["pos_embed"])
    if "mask_token" in sd:  # absent from some stripped eval checkpoints
        _set(params, "mask_token", sd["mask_token"])
    else:
        _set(params, "mask_token", np.zeros_like(sd["cls_token"][0]))
    # patch embed conv: OIHW -> HWIO
    _set(params, "patch_embed/kernel", np.transpose(sd["patch_embed.proj.weight"], (2, 3, 1, 0)))
    _set(params, "patch_embed/bias", sd["patch_embed.proj.bias"])
    for i in range(depth):
        b = f"blocks.{i}"
        d = f"block_{i}"
        _set(params, f"{d}/norm1/scale", sd[f"{b}.norm1.weight"])
        _set(params, f"{d}/norm1/bias", sd[f"{b}.norm1.bias"])
        _set(params, f"{d}/attn/qkv/kernel", _lin(sd[f"{b}.attn.qkv.weight"]))
        _set(params, f"{d}/attn/qkv/bias", sd[f"{b}.attn.qkv.bias"])
        _set(params, f"{d}/attn/proj/kernel", _lin(sd[f"{b}.attn.proj.weight"]))
        _set(params, f"{d}/attn/proj/bias", sd[f"{b}.attn.proj.bias"])
        _set(params, f"{d}/ls1/gamma", sd[f"{b}.ls1.gamma"])
        _set(params, f"{d}/ls2/gamma", sd[f"{b}.ls2.gamma"])
        _set(params, f"{d}/norm2/scale", sd[f"{b}.norm2.weight"])
        _set(params, f"{d}/norm2/bias", sd[f"{b}.norm2.bias"])
        if f"{b}.mlp.w12.weight" in sd:  # SwiGLU-fused blocks (vit_giant2)
            _set(params, f"{d}/mlp/w12/kernel", _lin(sd[f"{b}.mlp.w12.weight"]))
            _set(params, f"{d}/mlp/w12/bias", sd[f"{b}.mlp.w12.bias"])
            _set(params, f"{d}/mlp/w3/kernel", _lin(sd[f"{b}.mlp.w3.weight"]))
            _set(params, f"{d}/mlp/w3/bias", sd[f"{b}.mlp.w3.bias"])
        else:
            _set(params, f"{d}/mlp_fc1/kernel", _lin(sd[f"{b}.mlp.fc1.weight"]))
            _set(params, f"{d}/mlp_fc1/bias", sd[f"{b}.mlp.fc1.bias"])
            _set(params, f"{d}/mlp_fc2/kernel", _lin(sd[f"{b}.mlp.fc2.weight"]))
            _set(params, f"{d}/mlp_fc2/bias", sd[f"{b}.mlp.fc2.bias"])
    _set(params, "norm/scale", sd["norm.weight"])
    _set(params, "norm/bias", sd["norm.bias"])
    return {"params": params}
