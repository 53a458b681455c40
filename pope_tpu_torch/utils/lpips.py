"""LPIPS perceptual distance (Zhang et al., CVPR 2018), port of
pope_tpu/utils/lpips.py.

AlexNet's five conv stages tapped after each ReLU, each tap unit-normalized
over channels, the squared difference weighted by the calibrated
non-negative 1x1 "lin" heads, meaned over space and summed over the taps.
Inputs are NHWC RGB in [0, 1]; the [-1, 1] mapping and the per-channel
shift / scale are applied inside (the released implementation's
`normalize=True`).

The released weights are not in the repository. They load through
converters that pin the exact key and shape inventory of the two files
(torchvision's `alexnet-*.pth`, the lpips package's `weights/v0.1/alex.pth`)
and fail loudly, naming every deviation. The port keeps the conv kernels in
PyTorch's OIHW layout: {"features": {conv_i: {"weight", "bias"}}, "lins":
{lin_i: (C,)}}.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the ScalingLayer constants of the lpips package, for [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision AlexNet `features`: LPIPS taps each ReLU's output; MaxPool(3, 2)
# sits before conv2 and conv3 only.
# name -> (in_ch, out_ch, kernel, stride, pad, pool_before)
_STAGES = (
    ("conv1", 3, 64, 11, 4, 2, False),
    ("conv2", 64, 192, 5, 1, 2, True),
    ("conv3", 192, 384, 3, 1, 1, True),
    ("conv4", 384, 256, 3, 1, 1, False),
    ("conv5", 256, 256, 3, 1, 1, False),
)
_TAP_CHANNELS = (64, 192, 384, 256, 256)
_FEATURE_INDEX = (0, 3, 6, 8, 10)  # each stage's index in AlexNet's `features`

ALEXNET_MANIFEST: Dict[str, Tuple[int, ...]] = {}
for _i, (_name, _cin, _cout, _k, _s, _p, _pool) in zip(_FEATURE_INDEX, _STAGES):
    ALEXNET_MANIFEST[f"features.{_i}.weight"] = (_cout, _cin, _k, _k)
    ALEXNET_MANIFEST[f"features.{_i}.bias"] = (_cout,)
# torchvision's whole AlexNet file also holds the classifier head, which
# LPIPS ignores
_ALEXNET_OPTIONAL_PREFIX = "classifier."

LPIPS_LINS_MANIFEST: Dict[str, Tuple[int, ...]] = {
    f"lin{i}.model.1.weight": (1, c, 1, 1) for i, c in enumerate(_TAP_CHANNELS)
}


class LpipsStateMismatch(RuntimeError):
    pass


def _check(sd: Mapping, manifest: Mapping, label: str, optional_prefix: str = "") -> None:
    problems = []
    for k, shape in manifest.items():
        if k not in sd:
            problems.append(f"missing key: {k}")
        elif tuple(sd[k].shape) != tuple(shape):
            problems.append(f"shape mismatch: {k} {tuple(sd[k].shape)} != {tuple(shape)}")
    for k in sd:
        if k not in manifest and not (optional_prefix and k.startswith(optional_prefix)):
            problems.append(f"unknown key: {k}")
    if problems:
        raise LpipsStateMismatch(f"{label}: {len(problems)} problem(s):\n  " + "\n  ".join(problems[:12]))


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float32))


def convert_alexnet_features(sd: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """torchvision AlexNet state dict -> {conv_i: {"weight" OIHW, "bias"}}."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    _check(sd, ALEXNET_MANIFEST, "alexnet features", _ALEXNET_OPTIONAL_PREFIX)
    return {name: {"weight": _f32(sd[f"features.{i}.weight"]), "bias": _f32(sd[f"features.{i}.bias"])}
            for i, (name, *_rest) in zip(_FEATURE_INDEX, _STAGES)}


def convert_lpips_lins(sd: Mapping) -> Dict[str, torch.Tensor]:
    """The lpips package's `alex.pth` (lin heads only) -> per-tap weight
    vectors."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    _check(sd, LPIPS_LINS_MANIFEST, "lpips lin heads")
    return {f"lin{i}": _f32(sd[f"lin{i}.model.1.weight"].reshape(-1)) for i in range(len(_TAP_CHANNELS))}


def init_random_params(seed: int = 0) -> Dict:
    """Random parameters with the released shapes, for tests and shape
    checks only (LPIPS means nothing without the calibrated weights). Drawn
    from numpy's generator seeded with `seed` in the JAX package's order and
    layout, so both packages' trees hold the same numbers."""
    rng = np.random.default_rng(seed)
    feats = {}
    for name, cin, cout, k, _s, _p, _pool in _STAGES:
        kernel = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)  # HWIO
        bias = rng.normal(0, 0.05, (cout,)).astype(np.float32)
        feats[name] = {"weight": _f32(kernel.transpose(3, 2, 0, 1)), "bias": _f32(bias)}
    lins = {f"lin{i}": _f32(np.abs(rng.normal(0, 0.1, (c,)))) for i, c in enumerate(_TAP_CHANNELS)}
    return {"features": feats, "lins": lins}


def params_to(params: Mapping, device) -> Dict:
    """The parameter tree with every tensor on `device`."""
    return {"features": {n: {k: v.to(device) for k, v in p.items()} for n, p in params["features"].items()},
            "lins": {k: v.to(device) for k, v in params["lins"].items()}}


def _taps(features: Mapping, x):
    outs = []
    for name, _cin, _cout, _k, stride, pad, pool_before in _STAGES:
        if pool_before:
            x = F.max_pool2d(x, 3, 2)  # floor division of the output size, no padding
        p = features[name]
        x = torch.relu(F.conv2d(x, p["weight"], p["bias"], stride=stride, padding=pad))
        outs.append(x)
    return outs


def _unit_normalize(x, eps: float = 1e-10):
    # x / (||x||_channel + eps): eps outside the square root, as released
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips_distance(params: Mapping, img0, img1) -> torch.Tensor:
    """LPIPS(img0, img1) for NHWC RGB batches in [0, 1] -> (B,) distances,
    on the parameters' device."""
    dev = params["lins"]["lin0"].device
    shift = torch.tensor(_SHIFT, device=dev).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=dev).view(1, 3, 1, 1)

    def pre(img):
        x = torch.as_tensor(np.asarray(img, np.float32) if not torch.is_tensor(img) else img)
        x = x.to(dev, torch.float32).permute(0, 3, 1, 2) * 2.0 - 1.0
        return (x - shift) / scale

    total = 0.0
    for i, (f0, f1) in enumerate(zip(_taps(params["features"], pre(img0)), _taps(params["features"], pre(img1)))):
        d = (_unit_normalize(f0) - _unit_normalize(f1)) ** 2
        w = params["lins"][f"lin{i}"]
        # the 1x1 non-negative conv is a channel dot product; then the mean over space
        total = total + torch.einsum("bchw,c->bhw", d, w).mean(dim=(1, 2))
    return total


def lpips_from_torch_files(alexnet_path: str, lins_path: str) -> Dict:
    """Load and validate the two released files into a parameter tree (on
    the CPU; `params_to` moves it).

    alexnet_path: torchvision `alexnet-owt-*.pth` (the ImageNet backbone).
    lins_path:    the lpips package's `weights/v0.1/alex.pth` (calibrated heads).
    """
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lins = torch.load(lins_path, map_location="cpu", weights_only=True)
    return {
        "features": convert_alexnet_features({k: v.numpy() for k, v in alex.items()}),
        "lins": convert_lpips_lins({k: v.numpy() for k, v in lins.items()}),
    }
