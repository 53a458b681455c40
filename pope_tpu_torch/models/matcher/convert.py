"""PyTorch -> flax weight conversion for the matcher.

Accepts the reference checkpoint layout (LoFTR indoor ckpt: keys optionally
prefixed 'matcher.', see matcher.py:81-85 / pope_model_api.py:177-180) as a
{name: np.ndarray} dict and produces flax {'params', 'batch_stats'}
collections for :class:`pope_tpu.models.matcher.Matcher`.

Layout rules: conv OIHW -> HWIO, linear (out,in) -> (in,out),
BN weight/bias -> scale/bias + running stats -> batch_stats.

A verbatim copy of pope_tpu/models/matcher/convert.py (numpy only): the port
imports nothing of the JAX package. weights.py carries its output into the
port's modules.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _conv(w):
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _lin(w):
    return np.transpose(np.asarray(w), (1, 0))


def _set(tree: Dict, path: str, value):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = np.asarray(value)


def strip_prefix(sd: Mapping[str, np.ndarray], prefix: str = "matcher.") -> Dict[str, np.ndarray]:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}


def _convbn(params, stats, dst, sd, conv_key, bn_key):
    _set(params, f"{dst}/conv/kernel", _conv(sd[f"{conv_key}.weight"]))
    _set(params, f"{dst}/bn/scale", sd[f"{bn_key}.weight"])
    _set(params, f"{dst}/bn/bias", sd[f"{bn_key}.bias"])
    _set(stats, f"{dst}/bn/mean", sd[f"{bn_key}.running_mean"])
    _set(stats, f"{dst}/bn/var", sd[f"{bn_key}.running_var"])


def _encoder_layer(params, dst, sd, src):
    for name in ("q_proj", "k_proj", "v_proj", "merge"):
        _set(params, f"{dst}/{name}/kernel", _lin(sd[f"{src}.{name}.weight"]))
    _set(params, f"{dst}/mlp1/kernel", _lin(sd[f"{src}.mlp.0.weight"]))
    _set(params, f"{dst}/mlp2/kernel", _lin(sd[f"{src}.mlp.2.weight"]))
    for i in (1, 2):
        _set(params, f"{dst}/norm{i}/scale", sd[f"{src}.norm{i}.weight"])
        _set(params, f"{dst}/norm{i}/bias", sd[f"{src}.norm{i}.bias"])


def convert_torch_matcher_state(state_dict: Mapping[str, np.ndarray]):
    """Convert a reference matcher state dict to flax variables."""
    sd = strip_prefix({k: np.asarray(v) for k, v in state_dict.items()})
    params: Dict = {}
    stats: Dict = {}

    bb = "backbone"
    _set(params, f"{bb}/stem_conv/kernel", _conv(sd["backbone.conv1.weight"]))
    _set(params, f"{bb}/stem_bn/scale", sd["backbone.bn1.weight"])
    _set(params, f"{bb}/stem_bn/bias", sd["backbone.bn1.bias"])
    _set(stats, f"{bb}/stem_bn/mean", sd["backbone.bn1.running_mean"])
    _set(stats, f"{bb}/stem_bn/var", sd["backbone.bn1.running_var"])

    for layer in (1, 2, 3):
        for blk in (0, 1):
            src = f"backbone.layer{layer}.{blk}"
            dst = f"{bb}/layer{layer}_{blk}"
            _convbn(params, stats, f"{dst}/cb1", sd, f"{src}.conv1", f"{src}.bn1")
            _convbn(params, stats, f"{dst}/cb2", sd, f"{src}.conv2", f"{src}.bn2")
            if f"{src}.downsample.0.weight" in sd:
                _convbn(params, stats, f"{dst}/down", sd, f"{src}.downsample.0", f"{src}.downsample.1")

    _set(params, f"{bb}/l3_out/kernel", _conv(sd["backbone.layer3_outconv.weight"]))
    _set(params, f"{bb}/l2_lat/kernel", _conv(sd["backbone.layer2_outconv.weight"]))
    _convbn(params, stats, f"{bb}/l2_out/cb", sd, "backbone.layer2_outconv2.0", "backbone.layer2_outconv2.1")
    _set(params, f"{bb}/l2_out/conv_out/kernel", _conv(sd["backbone.layer2_outconv2.3.weight"]))
    _set(params, f"{bb}/l1_lat/kernel", _conv(sd["backbone.layer1_outconv.weight"]))
    _convbn(params, stats, f"{bb}/l1_out/cb", sd, "backbone.layer1_outconv2.0", "backbone.layer1_outconv2.1")
    _set(params, f"{bb}/l1_out/conv_out/kernel", _conv(sd["backbone.layer1_outconv2.3.weight"]))

    n_coarse = len([k for k in sd if k.startswith("loftr_coarse.layers.") and k.endswith(".q_proj.weight")])
    for i in range(n_coarse):
        _encoder_layer(params, f"loftr_coarse/layer_{i}", sd, f"loftr_coarse.layers.{i}")
    n_fine = len([k for k in sd if k.startswith("loftr_fine.layers.") and k.endswith(".q_proj.weight")])
    for i in range(n_fine):
        _encoder_layer(params, f"loftr_fine/layer_{i}", sd, f"loftr_fine.layers.{i}")

    if "fine_preprocess.down_proj.weight" in sd:
        _set(params, "fine_down_proj/kernel", _lin(sd["fine_preprocess.down_proj.weight"]))
        _set(params, "fine_down_proj/bias", sd["fine_preprocess.down_proj.bias"])
        _set(params, "fine_merge_feat/kernel", _lin(sd["fine_preprocess.merge_feat.weight"]))
        _set(params, "fine_merge_feat/bias", sd["fine_preprocess.merge_feat.bias"])

    return {"params": params, "batch_stats": stats}
