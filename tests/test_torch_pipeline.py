"""The port's stage 2 (pope_tpu_torch/pipeline/pose_pipeline.py:
retrieve -> match -> select -> solve over a batch of pairs) against
pope_tpu's fused `PipelineExecutor.build_batched(fold_prompt=True)` on the
same tiny seeded models, inputs and solver noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.config import BackboneConfig, CoarseMatchConfig, DinoV2Config, LoFTRStageConfig, MatcherConfig
from pope_tpu.config import PipelineConfig
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.pipeline.api import PopeModels as JaxModels
from pope_tpu.pipeline.pose_pipeline import PipelineExecutor as JaxExecutor
from pope_tpu.pipeline.pose_pipeline import retrieve_top_k as jax_retrieve
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.pipeline import PipelineExecutor, PopeModels
from pope_tpu_torch.pipeline.pose_pipeline import retrieve_top_k
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax
from tests.test_torch_common import port_config, seeded_variables, to_jax
from tests.test_torch_solver import jax_noise

B, C, SIDE, CROP = 2, 8, 96, 64
DINO = DinoV2Config(embed_dim=64, depth=2, num_heads=2)
MATCHER = MatcherConfig(
    backbone=BackboneConfig(initial_dim=32, block_dims=(32, 48, 64)),
    coarse=LoFTRStageConfig(d_model=64, d_ffn=64, nhead=4, layer_names=("self", "cross") * 2),
    fine=LoFTRStageConfig(d_model=32, d_ffn=32, nhead=4, layer_names=("self", "cross")),
    match_coarse=CoarseMatchConfig(match_capacity=128, thr=0.0, border_rm=0),
)
CFG = PipelineConfig(matcher=MATCHER, dinov2=DINO)


def _gamma(name, shape, rng):
    return rng.uniform(0.5, 1.5, shape) if name == "gamma" else None


def _bn(name, shape, rng):
    return {"mean": rng.normal(0, 0.2, shape), "var": rng.uniform(0.5, 2.0, shape)}.get(name)


@pytest.fixture(scope="module")
def models():
    z = jnp.zeros((1, 64, 64, 1))
    d_vars = seeded_variables(JaxDino(DINO), jnp.zeros((1, 196, 196, 3)), seed=0, fill=_gamma)
    m_vars = seeded_variables(JaxMatcher(MATCHER), z, z, seed=1, fill=_bn)
    jax_models = JaxModels(
        sam=None, sam_variables=None, dinov2=JaxDino(DINO), dinov2_variables=to_jax(d_vars),
        matcher=JaxMatcher(MATCHER), matcher_variables=to_jax(m_vars), amg=None, config=CFG,
    )
    dino = DinoVisionTransformer(port_config(DINO))
    dino.load_state_dict(dinov2_state_from_jax(d_vars), strict=True)
    matcher = Matcher(port_config(MATCHER))
    matcher.load_state_dict(matcher_state_from_jax(m_vars), strict=True)
    port = PopeModels(sam=None, amg=None, dinov2=dino.eval(), matcher=matcher.eval(),
                      config=port_config(CFG), device=torch.device("cpu"))
    return jax_models, port


def _inputs(seed):
    """Prompt frames, target frames that hold a shifted, brightened copy of
    the prompt's content, K, and AMG-like candidate boxes (one invalid)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIDE + 40, 0:SIDE + 40].astype(np.float32)
    img0, img1 = [], []
    for _ in range(B):
        scene = np.zeros(yy.shape + (3,), np.float32)
        for _ in range(30):
            cy, cx, s = rng.uniform(0, SIDE + 40, 2).tolist() + [rng.uniform(3, 10)]
            scene += rng.uniform(-80, 80, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))[..., None]
        scene = np.clip(scene - scene.min(), 0, 255)
        dy, dx = rng.integers(0, 30, 2)
        img0.append(scene[:SIDE, :SIDE])
        img1.append(np.clip(scene[dy:dy + SIDE, dx:dx + SIDE] * 1.1, 0, 255))
    img0, img1 = (np.stack(x).astype(np.uint8) for x in (img0, img1))
    K = np.broadcast_to(np.array([[100.0, 0, 48], [0, 100, 48], [0, 0, 1]], np.float32), (B, 3, 3)).copy()
    xy = rng.uniform(0, 40, (B, C, 2))
    wh = rng.uniform(20, 55, (B, C, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    valid = np.ones((B, C), bool)
    valid[1, 2] = False
    return img0, img1, K, boxes, valid


def test_retrieval_f32(models):
    """Every candidate of both pairs in one DINOv2 forward, the prompt folded
    in: the same top-k and cosine scores as the per-pair JAX function."""
    jax_models, port = models
    img0, img1, K, boxes, valid = _inputs(0)
    from pope_tpu.models.dinov2.preprocess import preprocess_image as jax_pre
    from pope_tpu_torch.models.dinov2 import preprocess_image

    ref_img = preprocess_image(torch.from_numpy(img0).float(), center_crop=True)
    with torch.no_grad():
        top_idx, scores, crops, crop_Ks, xyxy = retrieve_top_k(
            port, torch.from_numpy(img1).float() / 255.0, torch.from_numpy(boxes), torch.from_numpy(valid),
            torch.from_numpy(K), top_k=3, crop_size=CROP, ref_img=ref_img,
        )
    for b in range(B):
        ref = jax_retrieve(
            jax_models, jnp.asarray(img1[b], jnp.float32) / 255.0, jnp.asarray(boxes[b]), jnp.asarray(valid[b]),
            jnp.asarray(K[b]), None, top_k=3, crop_size=CROP,
            ref_img=jax_pre(jnp.asarray(img0[b], jnp.float32), center_crop=True)[0],
        )
        np.testing.assert_array_equal(top_idx[b].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(scores[b].numpy(), np.asarray(ref[1]), atol=1e-5)
        np.testing.assert_allclose(crops[b].numpy(), np.asarray(ref[2]), atol=1e-5)
        np.testing.assert_allclose(crop_Ks[b].numpy(), np.asarray(ref[3]), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(xyxy[b].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_batched_fold_prompt(models, seed):
    """The packed (B, 29) records and (B, M, 6) matches of one batched call:
    ok, pre_bbox, n_strong and the drop counts exactly, the match set
    exactly, match coordinates within 1e-3 px, R and t within 2e-3 (the
    solver's own sensitivity to last-bit differences, test_torch_solver.py)."""
    jax_models, port = models
    img0, img1, K, boxes, valid = _inputs(seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    small_ref, matches_ref = JaxExecutor(jax_models, crop_size=CROP).build_batched(B, fold_prompt=True)(
        *map(jnp.asarray, (img0, img1, K, K, boxes, valid)), None, keys, packed=True
    )
    small_ref, matches_ref = np.asarray(small_ref), np.asarray(matches_ref)
    noise = torch.from_numpy(np.stack([jax_noise(k, MATCHER.match_coarse.match_capacity) for k in keys]))
    small, matches = PipelineExecutor(port, crop_size=CROP).batched()(
        *map(torch.from_numpy, (img0, img1, K, K, boxes, valid)), None, noise, packed=True
    )
    small, matches = small.numpy(), matches.numpy()
    assert small.shape == (B, 29) and matches.shape == (B, 128, 6)
    exact = [12, 13, 14, 15, 16, 26, 27, 28]  # ok, pre_bbox, n_strong, drop counts
    np.testing.assert_array_equal(small[:, exact], small_ref[:, exact])
    # pre_K: entries near 1e2, off-diagonal zeros within f32 noise of the affine solve
    np.testing.assert_allclose(small[:, 17:26], small_ref[:, 17:26], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(matches[..., 5], matches_ref[..., 5])  # match validity
    np.testing.assert_allclose(matches[..., :4], matches_ref[..., :4], atol=1e-3)
    np.testing.assert_allclose(matches[..., 4], matches_ref[..., 4], atol=1e-5)
    assert (small[:, 12] == 1).any()  # some pair solved
    ok = small[:, 12] == 1
    np.testing.assert_allclose(small[ok, :12], small_ref[ok, :12], atol=2e-3)  # R, t


def test_unfolded_and_single_pair_paths(models):
    """fold_prompt=False fed prompt_cls_raw's tokens gives the folded
    results; estimate_pair gives row 0 of the batch."""
    _, port = models
    img0, img1, K, boxes, valid = (torch.from_numpy(a) for a in _inputs(2))
    ex = PipelineExecutor(port, crop_size=CROP)
    noise = torch.from_numpy(np.stack([jax_noise(jax.random.PRNGKey(i), 128) for i in range(B)]))
    folded = ex.batched()(img0, img1, K, K, boxes, valid, None, noise)
    unfolded = ex.build_batched()(img0, img1, K, K, boxes, valid, ex.prompt_cls_raw(img0), noise)
    for a, b in zip(folded, unfolded):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    amg = type("AMG", (), {"boxes_xywh": boxes[0], "valid": valid[0]})
    single = ex.estimate_pair(img0[0], img1[0], K[0], K[0], amg, ex.prompt_cls_raw(img0[:1])[0], noise[0])
    # a batch of one rounds differently from a batch of two: R and t within
    # the solver's sensitivity (2e-3, as above), the rest within 1e-5
    for name, a, b in zip(single._fields, single, folded):
        torch.testing.assert_close(a, b[0], atol=2e-3 if name in ("R", "t") else 1e-5, rtol=0)
