"""The port's SAM image encoder against pope_tpu's at SAM ViT-H's layer size:
embed 1280, 16 heads of 80, 14x14 windows, out_chans 256, the 1024-px
frame's 64x64 pos embed and rel-pos tables, cut to 2 blocks (block 1
global), on the rect 48x64 token grid of a 768x1024 frame (a 640x480 image
resized). So pope_tpu's rel-pos center slicing
(pope_tpu/models/sam/encoder.py:49-62) and the pos embed's top-left corner
run at their real sizes: 127 rows of the global table sliced to 95 and 127,
the windowed layers' 27 rows whole over 20 padded windows. The exact f32 +
erf config and the shipped bf16 + tanh one, each about 8 s on the CPU."""

import jax
import numpy as np
import pytest
import torch

from pope_tpu.config import SamConfig, SamEncoderConfig
from pope_tpu.models.sam import Sam as JaxSam
from tests.test_torch_common import f32, jax_params, port_sam, to_jax
from tests.test_torch_encoder import TOL


@pytest.mark.parametrize("shipped", [False, True], ids=["f32_erf", "bf16_tanh"])
def test_encoder_at_vit_h_layer_size_matches_jax(shipped):
    enc = SamEncoderConfig(
        img_size=1024, patch_size=16, embed_dim=1280, depth=2, num_heads=16, window_size=14,
        global_attn_indexes=(1,), out_chans=256,
        dtype="bfloat16" if shipped else "float32", gelu="tanh" if shipped else "erf",
    )
    cfg = SamConfig(encoder=enc, decoder_dtype="bfloat16" if shipped else "float32")
    params = jax_params(cfg, seed=0)
    jsam = JaxSam(cfg)
    x = np.random.default_rng(1).uniform(-2, 2, (1, 768, 1024, 3)).astype(np.float32)
    ref = f32(jax.jit(lambda v, x: jsam.apply(v, x, method=jsam.encode_image))(to_jax(params), x))
    with torch.no_grad():
        out = port_sam(cfg, params).encode_image(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (1, 48, 64, 256)
    err = np.abs(f32(out) - ref)
    tol_max, tol_mean = TOL[shipped]
    assert err.max() < tol_max and err.mean() < tol_mean, (err.max(), err.mean())
