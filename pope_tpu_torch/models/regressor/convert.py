"""PyTorch -> flax weight converters for the regressor image towers.

The reference freezes *pretrained* towers:
- ConvNeXtV2 from an FCMAE checkpoint, remapped key-by-key
  (pose/model0429_mkpts.py:46-155: drop decoder/mask_token/proj/pred keys,
  strip the 'encoder.' prefix, reshape Minkowski sparse-conv 'kernel'
  tensors into dense conv weights, collapse '.ln.'/'.linear.' path segments,
  flatten biases, reshape GRN affines);
- Vision Mamba from vim_tiny/vim_small checkpoints
  (pose/model0606.py:86-144; param layout = mamba_ssm's Mamba with
  bimamba_type='v2': in_proj/conv1d/x_proj/dt_proj/A_log/D (+ *_b twins)
  and a shared out_proj, pose/vim/models_mamba.py:66-175).

Layout rules (same as the matcher/SAM converters): conv OIHW -> HWIO,
conv1d (out, in/groups, k) -> (k, in/groups, out), linear (out, in) ->
(in, out).

A verbatim copy of pope_tpu/models/regressor/convert.py (numpy only): the
port imports nothing of the JAX package. weights.regressor_state_from_jax
carries its output into the port's ConvNeXtV2 and VisionMamba.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np


def _lin(w):
    return np.transpose(np.asarray(w), (1, 0))


def _conv(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _set(tree: Dict, path: str, value):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


# ---------------------------------------------------------------------------
# FCMAE checkpoint -> standard ConvNeXtV2 torch keys
# ---------------------------------------------------------------------------


def remap_fcmae_keys(checkpoint: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Numpy port of ConvNeXtV2.remap_checkpoint_keys
    (pose/model0429_mkpts.py:71-104): FCMAE sparse-encoder layout -> the
    standard dense ConvNeXtV2 state-dict layout."""
    ckpt = {k: np.asarray(v) for k, v in checkpoint.items()}
    # drop decoder-side keys (model0429_mkpts.py:58-64)
    ckpt = {
        k: v for k, v in ckpt.items()
        if not ("decoder" in k or "mask_token" in k or "proj" in k or "pred" in k)
    }
    new_ckpt: Dict[str, np.ndarray] = {}
    for k, v in ckpt.items():
        if k.startswith("encoder"):
            k = ".".join(k.split(".")[1:])
        if k.endswith("kernel"):
            k = ".".join(k.split(".")[:-1])
            new_k = k + ".weight"
            if v.ndim == 3:  # standard conv: (k*k, in, out) -> OIHW
                kv, in_dim, out_dim = v.shape
                ks = int(math.sqrt(kv))
                new_ckpt[new_k] = np.swapaxes(
                    v.transpose(2, 1, 0).reshape(out_dim, in_dim, ks, ks), 3, 2
                )
            elif v.ndim == 2:  # depthwise conv: (k*k, dim) -> (dim, 1, k, k)
                kv, dim = v.shape
                ks = int(math.sqrt(kv))
                new_ckpt[new_k] = np.swapaxes(
                    v.transpose(1, 0).reshape(dim, 1, ks, ks), 3, 2
                )
            continue
        elif "ln" in k or "linear" in k:
            parts = k.split(".")
            parts.pop(-2)
            new_k = ".".join(parts)
        else:
            new_k = k
        new_ckpt[new_k] = v
    for k, v in new_ckpt.items():
        if k.endswith("bias") and v.ndim != 1:
            new_ckpt[k] = v.reshape(-1)
        elif "grn" in k:
            new_ckpt[k] = v[None, None] if v.ndim == 2 else v
    return new_ckpt


# ---------------------------------------------------------------------------
# standard ConvNeXtV2 torch state dict -> flax
# ---------------------------------------------------------------------------


def convert_torch_convnextv2_state(
    state_dict: Mapping[str, np.ndarray], depths=(3, 3, 27, 3),
    from_fcmae: bool = False,
):
    """Reference torch ConvNeXtV2 (pose/convnextv2/convnextv2.py:47-139:
    downsample_layers.{0..3} + stages.{i}.{j} + norm + head) -> flax
    variables for :class:`pope_tpu.models.regressor.convnextv2.ConvNeXtV2`.

    from_fcmae=True first applies :func:`remap_fcmae_keys` (the reference's
    pretrained-checkpoint path, model0429_mkpts.py:46-70)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    if from_fcmae:
        sd = remap_fcmae_keys(sd)
    params: Dict = {}
    # stem: downsample_layers.0 = [conv4x4, LN]
    _set(params, "stem_conv/kernel", _conv(sd["downsample_layers.0.0.weight"]))
    _set(params, "stem_conv/bias", sd["downsample_layers.0.0.bias"])
    _set(params, "stem_norm/scale", sd["downsample_layers.0.1.weight"])
    _set(params, "stem_norm/bias", sd["downsample_layers.0.1.bias"])
    for i in (1, 2, 3):  # downsample_layers.i = [LN, conv2x2]
        _set(params, f"down{i}_norm/scale", sd[f"downsample_layers.{i}.0.weight"])
        _set(params, f"down{i}_norm/bias", sd[f"downsample_layers.{i}.0.bias"])
        _set(params, f"down{i}_conv/kernel", _conv(sd[f"downsample_layers.{i}.1.weight"]))
        _set(params, f"down{i}_conv/bias", sd[f"downsample_layers.{i}.1.bias"])
    for i, depth in enumerate(depths):
        for j in range(depth):
            src = f"stages.{i}.{j}"
            dst = f"stage{i}_block{j}"
            # depthwise conv (C, 1, 7, 7) -> HWIO (7, 7, 1, C)
            _set(params, f"{dst}/dwconv/kernel", _conv(sd[f"{src}.dwconv.weight"]))
            _set(params, f"{dst}/dwconv/bias", sd[f"{src}.dwconv.bias"])
            _set(params, f"{dst}/norm/scale", sd[f"{src}.norm.weight"])
            _set(params, f"{dst}/norm/bias", sd[f"{src}.norm.bias"])
            _set(params, f"{dst}/pwconv1/kernel", _lin(sd[f"{src}.pwconv1.weight"]))
            _set(params, f"{dst}/pwconv1/bias", sd[f"{src}.pwconv1.bias"])
            _set(params, f"{dst}/grn/gamma", sd[f"{src}.grn.gamma"].reshape(-1))
            _set(params, f"{dst}/grn/beta", sd[f"{src}.grn.beta"].reshape(-1))
            _set(params, f"{dst}/pwconv2/kernel", _lin(sd[f"{src}.pwconv2.weight"]))
            _set(params, f"{dst}/pwconv2/bias", sd[f"{src}.pwconv2.bias"])
    _set(params, "head_norm/scale", sd["norm.weight"])
    _set(params, "head_norm/bias", sd["norm.bias"])
    if "head.weight" in sd:
        _set(params, "head/kernel", _lin(sd["head.weight"]))
        _set(params, "head/bias", sd["head.bias"])
    return {"params": params}


# ---------------------------------------------------------------------------
# Vim (mamba_ssm bimamba layout) -> flax
# ---------------------------------------------------------------------------


def convert_torch_vim_state(state_dict: Mapping[str, np.ndarray], depth: int = 24):
    """Vim checkpoint (pose/vim/models_mamba.py VisionMamba: patch_embed +
    cls_token + pos_embed + layers.{i}.{norm,mixer} + norm_f + head, with
    mamba_ssm bimamba-v2 mixer params) -> flax variables for
    :class:`pope_tpu.models.regressor.vim.VisionMamba`."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params: Dict = {}
    _set(params, "patch_embed/kernel", _conv(sd["patch_embed.proj.weight"]))
    _set(params, "patch_embed/bias", sd["patch_embed.proj.bias"])
    _set(params, "cls_token", sd["cls_token"])
    _set(params, "pos_embed", sd["pos_embed"])
    for i in range(depth):
        src = f"layers.{i}"
        dst = f"block_{i}"
        _set(params, f"{dst}/norm/weight", sd[f"{src}.norm.weight"])
        m_src, m_dst = f"{src}.mixer", f"{dst}/mixer"
        _set(params, f"{m_dst}/in_proj/kernel", _lin(sd[f"{m_src}.in_proj.weight"]))
        _set(params, f"{m_dst}/out_proj/kernel", _lin(sd[f"{m_src}.out_proj.weight"]))
        for suffix, t_suffix, a_key, d_key in (
            ("", "", "A_log", "D"),
            ("_b", "_b", "A_b_log", "D_b"),
        ):
            a_full = f"{m_src}.{a_key}"
            if a_full not in sd:
                continue  # unidirectional checkpoint
            # conv1d (d_inner, 1, k) -> flax Conv kernel (k, 1, d_inner)
            _set(params, f"{m_dst}/conv1d{suffix}/kernel",
                 np.transpose(sd[f"{m_src}.conv1d{t_suffix}.weight"], (2, 1, 0)))
            _set(params, f"{m_dst}/conv1d{suffix}/bias", sd[f"{m_src}.conv1d{t_suffix}.bias"])
            _set(params, f"{m_dst}/x_proj{suffix}/kernel", _lin(sd[f"{m_src}.x_proj{t_suffix}.weight"]))
            _set(params, f"{m_dst}/dt_proj{suffix}/kernel", _lin(sd[f"{m_src}.dt_proj{t_suffix}.weight"]))
            _set(params, f"{m_dst}/dt_proj{suffix}/bias", sd[f"{m_src}.dt_proj{t_suffix}.bias"])
            _set(params, f"{m_dst}/A_log{suffix}", sd[a_full])
            _set(params, f"{m_dst}/D{suffix}", sd[f"{m_src}.{d_key}"])
    _set(params, "norm_f/weight", sd["norm_f.weight"])
    if "head.weight" in sd:
        _set(params, "head/kernel", _lin(sd["head.weight"]))
        _set(params, "head/bias", sd["head.bias"])
    return {"params": params}
