"""Weights bridge: the JAX package's SAM parameter tree -> the port's
state_dict.

The port's modules carry the JAX package's parameter names, so a flax path
`image_encoder/block_3/qkv/kernel` becomes the key
`image_encoder.block_3.qkv.weight`. Layouts change to PyTorch's:
- Dense kernels (in, out) -> Linear weights (out, in);
- conv kernels HWIO -> Conv2d weights OIHW;
- flax LayerNorm `scale` -> `weight`;
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


def sam_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": tree} or the tree itself, leaves as numpy arrays -> a
    state_dict of f32 tensors for `pope_tpu_torch.models.sam.Sam`."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
            else:
                name, a = _leaf(path + (key,), val)
                out[name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(tree, ())
    return out
