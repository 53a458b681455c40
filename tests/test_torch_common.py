"""Shared inputs of the port's parity tests (pope_tpu vs pope_tpu_torch): a
tiny SAM config, JAX parameters made from a seed, and the same weights
carried into the port through the weights bridge. No tests here."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pope_tpu.config import SamConfig, SamEncoderConfig
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu_torch.models.sam import Sam
from pope_tpu_torch.weights import sam_state_from_jax

# the shape of tests/test_sam_parity.py's TEST_CFG, with 5x5 windows so a
# 12x16 rect grid pads to 15x20
TINY_SAM = SamConfig(
    encoder=SamEncoderConfig(
        img_size=256, patch_size=16, embed_dim=64, depth=4, num_heads=2,
        window_size=5, global_attn_indexes=(1, 3), out_chans=64, dtype="float32",
        gelu="erf",
    ),
    prompt_embed_dim=64,
    image_embedding_size=16,
    decoder_num_heads=2,
    decoder_mlp_dim=256,
    iou_head_hidden_dim=64,
    decoder_dtype="float32",
)


def tiny_cfg(shipped: bool) -> SamConfig:
    """f32 + erf (the exact config), or the shipped bf16 + tanh config."""
    if not shipped:
        return TINY_SAM
    return dataclasses.replace(
        TINY_SAM,
        encoder=dataclasses.replace(TINY_SAM.encoder, dtype="bfloat16", gelu="tanh"),
        decoder_dtype="bfloat16",
    )


def jax_params(cfg: SamConfig, seed: int = 0) -> dict:
    """{"params": numpy tree} with the tree of JaxSam(cfg).init, filled from a
    numpy seed: lecun-scaled kernels, non-zero biases, LayerNorm scales near
    1, and non-zero rel-pos tables and abs pos embed (the JAX init zeroes
    those, which would leave the attention bias paths untested)."""
    S = cfg.encoder.img_size
    shapes = jax.eval_shape(
        lambda: JaxSam(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((S, S, 3)), (S, S),
            jnp.zeros((1, 2, 2)), jnp.zeros((1, 2), jnp.int32),
        )
    )["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "bias":
            a = rng.normal(0, 0.1, shape)
        elif name in ("scale", "weight"):
            a = 1.0 + rng.normal(0, 0.1, shape)
        elif name.startswith("rel_pos") or name == "pos_embed":
            a = rng.normal(0, 0.2, shape)
        else:
            a = rng.normal(0, 1, shape)
        return a.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return {"params": _to_dict(params)}


def _to_dict(tree):
    return {k: _to_dict(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


def structure_decoder(params: dict) -> dict:
    """The decoder surgery of tests/test_amg_oracle.py, on the JAX tree:
    identity upscaling, one-hot hypernetworks and a -0.5 bias, so a mask
    logit is GELU(one embedding channel) - 0.5 with O(0.3) structure instead
    of the untrained decoder's sign noise around zero."""
    md = params["params"]["mask_decoder"]
    for name in ("up_conv1", "up_conv2"):
        k = np.zeros_like(md[name]["kernel"])
        for j in range(min(k.shape[2], k.shape[3])):
            k[:, :, j, j] = 1.0
        md[name]["kernel"] = k
        md[name]["bias"] = np.zeros_like(md[name]["bias"])
    md["up_conv2"]["bias"][:] = -0.5
    md["up_ln"]["weight"][:] = 1.0
    md["up_ln"]["bias"][:] = 0.0
    i = 0
    while f"hyper_{i}" in md:
        lin = md[f"hyper_{i}"]["lin2"]
        lin["kernel"][:] = 0.0
        lin["bias"][:] = 0.0
        lin["bias"][(7 * i) % lin["bias"].shape[0]] = 1.0
        i += 1
    return params


def port_sam(cfg: SamConfig, params: dict) -> Sam:
    """The port's Sam on the CPU with the JAX weights. The JAX init creates
    no parameters for the prompt encoder's mask-input convs (flax makes them
    on first use, and nothing calls them), so exactly those stay unloaded."""
    sam = Sam(cfg)
    missing, unexpected = sam.load_state_dict(sam_state_from_jax(params), strict=False)
    assert not unexpected, unexpected
    assert all(k.startswith("prompt_encoder.mask_") for k in missing), missing
    return sam.eval()


def to_jax(params: dict) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, params)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def seeded_variables(module, *init_args, seed: int = 0, fill=None) -> dict:
    """The variable tree of a flax `module.init(key, *init_args)` filled from
    a numpy seed: lecun-scaled kernels, N(0, 0.1) biases, scales near 1,
    N(0, 1) for everything else; `fill(name, shape, rng)` may return an array
    to override a leaf by name. Returned as nested dicts of numpy arrays."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *init_args))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        a = fill(name, shape, rng) if fill is not None else None
        if a is None and name == "kernel":
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif a is None and name == "bias":
            a = rng.normal(0, 0.1, shape)
        elif a is None and name == "scale":
            a = 1.0 + rng.normal(0, 0.1, shape)
        elif a is None:
            a = rng.normal(0, 1, shape)
        return np.asarray(a, np.float32)

    return _to_dict(jax.tree_util.tree_map_with_path(leaf, shapes))


def port_config(cfg):
    """A pope_tpu config dataclass -> the port's class of the same name with
    the same field values (nested configs included)."""
    import pope_tpu_torch.config as tcfg

    fields = {
        f.name: port_config(v) if dataclasses.is_dataclass(v) else v
        for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]
    }
    return getattr(tcfg, type(cfg).__name__)(**fields)
