"""The port's SAM image encoder against pope_tpu's ImageEncoderViT on the
same weights and inputs: square and rect token grids, in the exact f32 + erf
config and the shipped bf16 + tanh config. Off the TPU the JAX encoder takes
its einsum attention path; the port takes its kernels' plain versions."""

import jax
import numpy as np
import pytest
import torch

from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu_torch.utils.bf16_storage import cast_sam_storage
from tests.test_torch_common import f32, jax_params, port_sam, tiny_cfg, to_jax

# f32: reassociation only. bf16: the JAX einsum path rounds the logits and
# the bias to bf16 before the softmax where the port keeps them f32, and bf16
# activations carry ~3 significant digits through 4 blocks; the neck
# LayerNorm output is O(1), so a few bf16 ulps at magnitude 4 bound the max,
# and the mean error must stay within two bf16 ulps of values in [1, 2).
TOL = {False: (2e-5, 2e-6), True: (0.1, 0.015)}  # (max abs, mean abs)


@pytest.fixture(scope="module", params=[False, True], ids=["f32_erf", "bf16_tanh"])
def encoders(request):
    shipped = request.param
    cfg = tiny_cfg(shipped)
    params = jax_params(cfg, seed=0)
    return shipped, JaxSam(cfg), to_jax(params), port_sam(cfg, params)


@pytest.mark.parametrize("hw", [(256, 256), (192, 256)], ids=["square", "rect"])
def test_encoder_matches_jax(encoders, hw):
    shipped, jsam, jvars, sam = encoders
    x = np.random.default_rng(1).uniform(-2, 2, (2, *hw, 3)).astype(np.float32)
    ref = f32(jax.jit(lambda v, x: jsam.apply(v, x, method=jsam.encode_image))(jvars, x))
    with torch.no_grad():
        out = sam.encode_image(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, hw[0] // 16, hw[1] // 16, 64)
    err = np.abs(f32(out) - ref)
    tol_max, tol_mean = TOL[shipped]
    assert err.max() < tol_max and err.mean() < tol_mean, (err.max(), err.mean())


def test_bf16_storage_is_bit_identical():
    """Storing the bf16-consumed encoder weights in bf16 changes no output
    bit; the f32-consumed LayerNorms stay f32."""
    cfg = tiny_cfg(True)
    params = jax_params(cfg, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-2, 2, (1, 192, 256, 3)).astype(np.float32))
    sam = port_sam(cfg, params)
    with torch.no_grad():
        ref = sam.encode_image(x)
        cast_sam_storage(sam, cfg.encoder)
        out = sam.encode_image(x)
    enc = sam.image_encoder
    assert enc.block_0.qkv.weight.dtype == torch.bfloat16
    assert enc.pos_embed.dtype == torch.bfloat16
    assert enc.block_0.norm1.weight.dtype == torch.float32
    assert enc.neck_ln2.weight.dtype == torch.float32
    assert torch.equal(out, ref)
