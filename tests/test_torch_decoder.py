"""The port's SAM prompt encoder, mask decoder and Sam.decode against
pope_tpu's on the same weights and inputs, in the f32 config and the
shipped bf16 decoder config, at full resolution and at the eval path's
exact stride-4 subsample."""

import jax
import numpy as np
import pytest
import torch

from pope_tpu.models.sam import Sam as JaxSam
from tests.test_torch_common import f32, jax_params, port_sam, tiny_cfg, to_jax

# (max abs) on O(1) outputs. f32: reassociation (seen: 1.5e-6). bf16: Dense
# layers, attention and the upscaling run in bf16 (8 bits of mantissa) on
# both sides, rounded at different places (seen: 0.027, about 3 bf16 ulps at
# magnitude 1-2).
TOL = {False: 2e-5, True: 0.06}


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def models(request):
    shipped = request.param
    cfg = tiny_cfg(shipped)
    params = jax_params(cfg, seed=4)
    return shipped, JaxSam(cfg), to_jax(params), port_sam(cfg, params)


def _prompts(seed, P):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 256, (P, 2, 2)).astype(np.float32)
    labels = rng.choice([-1, 0, 1, 2, 3], (P, 2)).astype(np.int32)
    labels[:, 0] = 1
    return pts, labels


def _emb(seed, hw):
    return np.random.default_rng(seed).normal(0, 1, (1, *hw, 64)).astype(np.float32)


def test_prompt_encoder_matches_jax(models):
    _, jsam, jvars, sam = models
    pts, labels = _prompts(0, 6)
    hw = (12, 16)
    sparse_j, dense_j = jsam.apply(
        jvars, pts, labels, method=lambda m, p, l: m.prompt_encoder(p, l, embed_hw=hw)
    )
    pe_j = jsam.apply(jvars, method=lambda m: m.prompt_encoder.get_dense_pe(hw))
    with torch.no_grad():
        sparse, dense = sam.prompt_encoder(torch.from_numpy(pts), torch.from_numpy(labels), embed_hw=hw)
        pe = sam.prompt_encoder.get_dense_pe(hw)
    assert dense.shape == (1, 12, 16, 64)  # the shared no-mask embedding keeps batch 1
    np.testing.assert_allclose(f32(sparse), f32(sparse_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(f32(dense), f32(dense_j), atol=0, rtol=0)
    np.testing.assert_allclose(f32(pe), f32(pe_j), atol=2e-5, rtol=0)
    # a rect grid's dense PE is the top-left slice of the square one
    with torch.no_grad():
        square = sam.prompt_encoder.get_dense_pe()
    torch.testing.assert_close(pe, square[:12, :16])


@pytest.mark.parametrize("subsample", [1, 4])
def test_mask_decoder_matches_jax(models, subsample):
    shipped, jsam, jvars, sam = models
    pts, labels = _prompts(1, 5)
    hw = (12, 16)
    emb = _emb(2, hw)

    def run_j(m, e, p, l):
        sparse, dense = m.prompt_encoder(p, l, embed_hw=hw)
        return m.mask_decoder(
            e, m.prompt_encoder.get_dense_pe(hw), sparse, dense,
            multimask_output=True, subsample=subsample,
        )

    masks_j, iou_j = jax.jit(lambda v, e, p, l: jsam.apply(v, e, p, l, method=run_j))(
        jvars, emb, pts, labels
    )
    with torch.no_grad():
        sparse, dense = sam.prompt_encoder(torch.from_numpy(pts), torch.from_numpy(labels), embed_hw=hw)
        masks, iou = sam.mask_decoder(
            torch.from_numpy(emb), sam.prompt_encoder.get_dense_pe(hw), sparse, dense,
            multimask_output=True, subsample=subsample,
        )
    side = 4 if subsample == 1 else 1
    assert masks.shape == (5, 3, 12 * side, 16 * side) and iou.shape == (5, 3)
    assert masks.dtype == (torch.bfloat16 if shipped else torch.float32)
    assert np.abs(f32(masks) - f32(masks_j)).max() < TOL[shipped]
    assert np.abs(f32(iou) - f32(iou_j)).max() < TOL[shipped]


def test_subsample_is_exact_stride4_of_full_res():
    """UpConvT's tap order: the subsampled decode equals every 4th pixel of
    the full-resolution decode (in f32: bf16 rounds the two paths apart)."""
    cfg = tiny_cfg(False)
    sam = port_sam(cfg, jax_params(cfg, seed=8))
    pts, labels = (torch.from_numpy(a) for a in _prompts(3, 4))
    emb = torch.from_numpy(_emb(5, (12, 16)))
    with torch.no_grad():
        full, _ = sam.decode(emb, pts, labels, subsample=1)
        sub, _ = sam.decode(emb, pts, labels, subsample=4)
    torch.testing.assert_close(sub, full[..., ::4, ::4], atol=1e-5, rtol=0)


@pytest.mark.parametrize("multimask", [True, False])
def test_sam_decode_matches_jax(models, multimask):
    shipped, jsam, jvars, sam = models
    pts, labels = _prompts(6, 3)
    emb = _emb(7, (16, 16))
    masks_j, iou_j = jax.jit(
        lambda v, e, p, l: jsam.apply(v, e, p, l, multimask_output=multimask, method=jsam.decode)
    )(jvars, emb, pts, labels)
    with torch.no_grad():
        masks, iou = sam.decode(
            torch.from_numpy(emb), torch.from_numpy(pts), torch.from_numpy(labels),
            multimask_output=multimask,
        )
    assert masks.shape == (3, 3 if multimask else 1, 64, 64)
    assert np.abs(f32(masks) - f32(masks_j)).max() < TOL[shipped]
    assert np.abs(f32(iou) - f32(iou_j)).max() < TOL[shipped]
