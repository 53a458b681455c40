"""Weights bridge: the JAX package's parameter trees (SAM, DINOv2, the
matcher, the pose regressors, SSL and NeRF training states, LPIPS) -> the
port's state_dicts.

The port's modules carry the JAX package's parameter names, so a flax path
`image_encoder/block_3/qkv/kernel` becomes the key
`image_encoder.block_3.qkv.weight`. Layouts change to PyTorch's:
- Dense kernels (in, out) -> Linear weights (out, in);
- conv kernels HWIO -> Conv2d weights OIHW;
- flax LayerNorm and BatchNorm `scale` -> `weight`;
- flax BatchNorm statistics (the `batch_stats` collection, `mean` / `var`)
  -> the buffers `running_mean` / `running_var`;
- everything else (biases, DINOv2's LayerScale `gamma`, cls / mask tokens,
  pos embeds, the scalar `bin_score`) keeps its name and shape;
- `UpConvT` kernels (2, 2, in, out) stay as they are: the port's UpConvT
  keeps the JAX tap order (models/sam/decoder.py).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _leaf(path, value) -> tuple:
    *mod, name = path
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel" and a.ndim == 2:
        return ".".join(mod + ["weight"]), a.T
    if name == "kernel" and not mod[-1].startswith("up_conv"):
        return ".".join(mod + ["weight"]), a.transpose(3, 2, 0, 1)
    if name == "scale":
        return ".".join(mod + ["weight"]), a
    return ".".join(path), a


_STATS = {"mean": "running_mean", "var": "running_var"}


def _walk(node, path, leaf, out: Dict[str, torch.Tensor]) -> None:
    for key, val in node.items():
        if isinstance(val, Mapping):
            _walk(val, path + (key,), leaf, out)
        else:
            name, a = leaf(path + (key,), val)
            out[name] = torch.from_numpy(np.array(a, order="C"))  # keeps 0-dim leaves 0-dim


def _stat_leaf(path, value) -> tuple:
    *mod, name = path
    return ".".join(mod + [_STATS[name]]), np.asarray(value, dtype=np.float32)


def params_state_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": tree[, "batch_stats": tree]} or a bare params tree, leaves
    as numpy arrays -> a state_dict of f32 tensors for the port's module of
    the same architecture."""
    out: Dict[str, torch.Tensor] = {}
    _walk(variables.get("params", variables), (), _leaf, out)
    _walk(variables.get("batch_stats", {}), (), _stat_leaf, out)
    return out


def sam_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX SAM tree -> a state_dict for `pope_tpu_torch.models.sam.Sam`."""
    return params_state_from_jax(params)


def dinov2_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX DINOv2 tree -> a state_dict for
    `pope_tpu_torch.models.dinov2.DinoVisionTransformer` (LayerScale
    `gamma`, cls / mask tokens and the pos embed keep their shapes)."""
    return params_state_from_jax(params)


def matcher_state_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX matcher's {"params", "batch_stats"} -> a state_dict for
    `pope_tpu_torch.models.matcher.Matcher`: BatchNorm statistics become
    `running_mean` / `running_var`, a sinkhorn `bin_score` stays a scalar."""
    return params_state_from_jax(variables)


def _regressor_leaf(path, value) -> tuple:
    """_leaf, plus the regressor's 3-dim kernels: flax MultiHeadDotProductAttention's
    query / key / value kernels (d, nh, hd) and biases (nh, hd), its out
    kernel (nh, hd, d), and conv1d kernels (k, in / groups, out)."""
    *mod, name = path
    a = np.asarray(value, dtype=np.float32)
    if mod and mod[-1] in ("query", "key", "value"):
        if name == "kernel" and a.ndim == 3:
            return ".".join(mod + ["weight"]), a.reshape(a.shape[0], -1).T
        if name == "bias" and a.ndim == 2:
            return ".".join(path), a.reshape(-1)
    if mod and mod[-1] == "out" and name == "kernel" and a.ndim == 3:
        return ".".join(mod + ["weight"]), a.reshape(-1, a.shape[-1]).T
    if name == "kernel" and a.ndim == 3:
        return ".".join(mod + ["weight"]), a.transpose(2, 1, 0)
    return _leaf(path, value)


def regressor_state_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX regressor tree -> a state_dict of the port's module of the same
    architecture: `MkptsRegModel` (attention projections reshaped to
    Linear layers), `DINOv2Poser`, and the `VisionMamba` / `ConvNeXtV2`
    trees of models/regressor/convert.py's convert_torch_*_state (conv1d
    kernels to Conv1d weights)."""
    out: Dict[str, torch.Tensor] = {}
    _walk(variables.get("params", variables), (), _regressor_leaf, out)
    return out


def ssl_state_from_jax(state) -> dict:
    """A JAX SSLState (numpy leaves) -> the payload of the port's
    `SSLState.load_state_dict`: the student's and the teacher's state_dicts
    (`backbone.*` with SwiGLU's `mlp.w12` / `mlp.w3` and the mask token,
    `dino_head.mlp_i.*`, `last_v` (bottleneck, out) and `last_g` as they
    are), the Adam moments under the student's parameter names in the same
    layouts, the centers and the step."""
    return {
        "step": int(np.asarray(state.step)),
        "student": params_state_from_jax(state.student),
        "teacher": params_state_from_jax(state.teacher),
        "mu": params_state_from_jax(state.mu),
        "nu": params_state_from_jax(state.nu),
        "dino_center": torch.from_numpy(np.asarray(state.dino_center, np.float32).copy()),
        "ibot_center": torch.from_numpy(np.asarray(state.ibot_center, np.float32).copy()),
    }


def nerf_state_from_jax(state) -> dict:
    """A JAX NerfState (numpy leaves; its opt_state optax.adam's) ->
    {"model": NerfMLP state_dict, "mu", "nu": moments by parameter name,
    "step": Adam's update count}, for `NerfMLP.load_state_dict` and
    `NerfState(step, mu, nu)`."""
    adam = state.opt_state[0]
    return {
        "model": params_state_from_jax(state.params),
        "mu": params_state_from_jax(adam.mu),
        "nu": params_state_from_jax(adam.nu),
        "step": int(np.asarray(adam.count)),
    }


def lpips_params_from_jax(params: Mapping) -> dict:
    """The JAX LPIPS tree ({"features": {conv_i: {"kernel" HWIO, "bias"}},
    "lins": {lin_i: (C,)}}) -> the port's (OIHW conv weights)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    return {
        "features": {name: {"weight": t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)), "bias": t(p["bias"])}
                     for name, p in params["features"].items()},
        "lins": {k: t(v) for k, v in params["lins"].items()},
    }
