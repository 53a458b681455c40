"""The port on the card: the CUDA kernels against their plain versions, and a
small SAM on the card against the same module on the CPU. Needs an NVIDIA
GPU (marked `cuda`; skipped without one). Imports neither JAX nor pope_tpu,
so it also runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import copy

import numpy as np
import pytest
import torch

from pope_tpu_torch.config import SamConfig, SamEncoderConfig
from pope_tpu_torch.models.sam import Sam
from pope_tpu_torch.ops.flash_attention import flash_attention_relpos, flash_attention_relpos_plain
from pope_tpu_torch.ops.window_attention import (
    windowed_attention_relpos,
    windowed_attention_relpos_plain,
)
from pope_tpu_torch.pipeline.api import init_sam_weights
from pope_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda

# f32: the same math in another summation order (max abs error; outputs are
# softmax averages of v ~ N(0, 1), max |out| about 1 at these shapes). bf16,
# scaled to the output: the max error within a few bf16 ulps of the largest
# output (the windowed kernel rounds its softmax weights before normalising,
# the plain version after), the rms error within 1% of the rms output
TOL_F32 = 2e-5
TOL_BF16_MAX_REL, TOL_BF16_RMS_REL = 2.5e-2, 1e-2


def assert_matches_plain(out, ref):
    diff = out.float() - ref.float()
    if out.dtype == torch.float32:
        assert diff.abs().max().item() < TOL_F32
        return
    ref = ref.float()
    assert diff.abs().max().item() <= TOL_BF16_MAX_REL * ref.abs().max().item()
    assert diff.square().mean().sqrt().item() <= TOL_BF16_RMS_REL * ref.square().mean().sqrt().item()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")  # also turns TF32 off, as the entry points do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "BW,nh,d,hk,wk", [(3, 4, 80, 14, 14), (2, 2, 80, 12, 16), (2, 3, 32, 5, 7)]
)
def test_kernels_match_plain(card, dtype, BW, nh, d, hk, wk):
    g = torch.Generator(device=card).manual_seed(0)
    N = hk * wk
    qkv = torch.randn(BW, N, 3 * nh * d, device=card, generator=g).to(dtype)
    rel_h = (0.5 * torch.randn(BW, nh, N, hk, device=card, generator=g)).to(dtype)
    rel_w = (0.5 * torch.randn(BW, nh, N, wk, device=card, generator=g)).to(dtype)
    n_win, n_flash = windowed_attention_relpos.launches, flash_attention_relpos.launches
    out = windowed_attention_relpos(qkv, rel_h, rel_w, nh, d, hk, wk)
    assert_matches_plain(out, windowed_attention_relpos_plain(qkv, rel_h, rel_w, nh, d, hk, wk))
    q, k, v = qkv.view(BW, N, 3, nh, d).unbind(2)
    out = flash_attention_relpos(q, k, v, rel_h, rel_w, hk, wk)
    assert_matches_plain(out, flash_attention_relpos_plain(q, k, v, rel_h, rel_w, hk, wk))
    assert windowed_attention_relpos.launches == n_win + 1
    assert flash_attention_relpos.launches == n_flash + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    before = windowed_attention_relpos.launches
    qkv = torch.zeros(2, 16, 3 * 2 * 8, device=card, dtype=torch.float16)
    rel = torch.zeros(2, 2, 16, 4, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        windowed_attention_relpos(qkv, rel, rel, 2, 8, 4, 4)
    # the bf16 tensor-core body takes the head dims it is instantiated for
    with pytest.raises(ValueError, match="head dim must be one of"):
        windowed_attention_relpos(qkv.bfloat16(), rel.bfloat16(), rel.bfloat16(), 2, 8, 4, 4)
    assert windowed_attention_relpos.launches == before


def test_small_sam_on_card_matches_cpu(card):
    cfg = SamConfig(
        encoder=SamEncoderConfig(
            img_size=128, embed_dim=64, depth=2, num_heads=2, window_size=5,
            global_attn_indexes=(1,), out_chans=32, dtype="float32", gelu="erf",
        ),
        prompt_embed_dim=32, image_embedding_size=8, decoder_num_heads=2,
        decoder_mlp_dim=64, iou_head_hidden_dim=32, decoder_dtype="float32",
    )
    cpu = Sam(cfg)
    init_sam_weights(cpu, torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(card)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-2, 2, (2, 96, 128, 3)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(0, 128, (8, 2, 2)).astype(np.float32))
    labels = torch.tensor([[1, -1]]).expand(8, 2)
    with torch.no_grad():
        emb = cpu.encode_image(x)
        torch.testing.assert_close(gpu.encode_image(x.to(card)).cpu(), emb, atol=1e-4, rtol=0)
        for sub in (1, 4):
            masks, iou = cpu.decode(emb[:1], pts, labels, subsample=sub)
            m, i = gpu.decode(emb[:1].to(card), pts.to(card), labels.to(card), subsample=sub)
            torch.testing.assert_close(m.cpu(), masks, atol=1e-4, rtol=0)
            torch.testing.assert_close(i.cpu(), iou, atol=1e-4, rtol=0)
