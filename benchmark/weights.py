"""Seeded weights, made by the benchmark on the device and handed alike to
the program and to the reference.

Each tower's parameters are one normal draw from a `torch.Generator` on the
device, cut into the tower's leaves in `named_parameters` order and scaled
as the port's seeded init scales them (`pipeline/api.py`): lecun-normal
dense and conv kernels, zero biases, unit LayerNorms, small rel-pos tables
and position embeddings, LayerScale gammas in U(0.1, 1). The plan is read
from the reference's modules (built on the meta device), which have the
port's parameter names and shapes; BatchNorm statistics keep their init
(mean 0, variance 1) on both sides.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

TOWER_SEED = {"sam": 0, "dinov2": 1, "matcher": 2}


def init_plan(model: nn.Module) -> list:
    """[(name, shape, kind, scale)] for every parameter of `model`, kind one
    of "normal", "zeros", "ones", "uniform" (U(0.1, 1))."""
    plan = []
    for mod_name, mod in model.named_modules():
        kind_of = _rule(mod)
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            plan.append((name, tuple(p.shape), *kind_of(p_name, p)))
    return plan


def _rule(mod: nn.Module):
    cls = type(mod).__name__
    if cls in ("Linear", "Conv2d"):
        return lambda n, p: ("normal", 1.0 / math.sqrt(p[0].numel())) if n == "weight" else ("zeros", 0.0)
    if cls in ("LayerNorm", "LayerNorm2d", "BatchNorm"):
        return lambda n, p: ("ones", 1.0) if n == "weight" else ("zeros", 0.0)
    if cls == "UpConvT":
        return lambda n, p: ("normal", 1.0 / math.sqrt(4 * p.shape[2])) if n == "kernel" else ("zeros", 0.0)
    if cls == "LayerScale":
        return lambda n, p: ("uniform", 0.0)
    if cls == "DinoVisionTransformer":
        return lambda n, p: ("zeros", 0.0) if n == "mask_token" else ("normal", 0.02)
    return lambda n, p: ("normal", 0.02 if n.startswith("rel_pos") or n == "pos_embed" else 1.0)


@torch.no_grad()
def make_state(plan: list, seed: int, tower: str, device) -> dict:
    """{name: float32 tensor} of one tower from (seed, tower): one draw on
    `device`, cut and scaled per the plan."""
    total = sum(math.prod(shape) for _, shape, _, _ in plan)
    g = torch.Generator(device=device).manual_seed(_tower_seed(seed, tower))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    state, off = {}, 0
    for name, shape, kind, scale in plan:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "normal":
            t.mul_(scale)
        elif kind == "zeros":
            t.zero_()
        elif kind == "ones":
            t.fill_(1.0)
        else:  # U(0.1, 1) through the normal CDF
            t.copy_(0.1 + 0.9 * torch.special.ndtr(t))
        state[name] = t
    return state


def _tower_seed(seed: int, tower: str) -> int:
    """A 63-bit generator seed from the run's seed (any size) and the tower."""
    return (int(seed) * 3 + TOWER_SEED[tower]) % (2 ** 63 - 1)


@torch.no_grad()
def load_into(module: nn.Module, state: dict) -> None:
    """Copy `state` into `module`'s parameters (each keeps its own dtype:
    the port's bf16 storage rounds as its own cast does); every parameter
    must be covered and nothing else given."""
    params = dict(module.named_parameters())
    missing, extra = set(params) - set(state), set(state) - set(params)
    if missing or extra:
        raise KeyError(f"weights do not fit {type(module).__name__}: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(extra)[:5]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: {tuple(p.shape)} != {tuple(state[name].shape)}")
        p.copy_(state[name])
