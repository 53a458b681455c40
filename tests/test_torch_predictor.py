"""The port's SamPredictor and SamPromptHead against pope_tpu's SamPredictor
and exported prompt head (`export_sam_prompt_head` run through
`load_exported(...).call`), on the same weights, image and prompts: a tiny
SAM with the structured decoder of tests/test_amg_oracle.py (mask logits
with O(0.3) structure), a 96x128 image, the square frame and rect_encode, in
the exact f32 + erf config and the shipped bf16 + tanh config."""

import numpy as np
import pytest
import torch

from pope_tpu.export import export_sam_prompt_head as jax_export_prompt_head
from pope_tpu.export import load_exported
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu.models.sam.predictor import SamPredictor as JaxPredictor
from pope_tpu_torch.export import sam_prompt_head
from pope_tpu_torch.models.sam.predictor import SamPredictor
from pope_tpu_torch.models.sam.sam import apply_boxes, apply_coords
from tests.test_torch_common import f32, jax_params, port_sam, structure_decoder, tiny_cfg, to_jax

H, W = 96, 128
# low-res logits and iou scores (max abs, mean abs): the encoder test's
# tolerances (tests/test_torch_encoder.py), which also hold after the
# decoder. f32: reassociation. bf16: bf16 activations, rounded at other places
# on the two sides. Binary masks at the original size agree on at least
# MIN_AGREE of the pixels (a logit within rounding of 0 may flip).
TOL = {False: (2e-5, 2e-6), True: (0.1, 0.015)}
MIN_AGREE = 0.99
MIN_IOU = 0.9  # of the foregrounds: boundary pixels at a logit near 0 may flip


def image(seed=0):
    """Blobs under rectangles: structure for the encoder to see."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.full((H, W, 3), 100.0, np.float32)
    for _ in range(20):
        cy, cx, s = rng.uniform(0, H), rng.uniform(0, W), rng.uniform(4, 12)
        img += rng.uniform(-70, 70, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))[..., None]
    for _ in range(3):
        y0, x0 = rng.integers(0, H - 40), rng.integers(0, W - 50)
        img[y0 : y0 + 35, x0 : x0 + 45] += rng.uniform(-60, 60, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def with_mask_convs(params, seed=1):
    """The JAX init makes no parameters for the prompt encoder's mask-input
    convs (nothing it runs calls them): seed them in the JAX tree, so that
    the weights bridge carries them to the port too."""
    rng = np.random.default_rng(seed)
    pe = params["params"]["prompt_encoder"]
    E = pe["no_mask"].shape[0]
    c1, c2 = 4, 16  # mask_in_chans // 4, mask_in_chans

    def conv(kh, cin, cout):
        return {"kernel": (rng.normal(0, 1, (kh, kh, cin, cout)) / np.sqrt(kh * kh * cin)).astype(np.float32),
                "bias": rng.normal(0, 0.1, cout).astype(np.float32)}

    def ln(c):
        return {"scale": (1 + rng.normal(0, 0.1, c)).astype(np.float32), "bias": rng.normal(0, 0.1, c).astype(np.float32)}

    pe.update(mask_conv1=conv(2, 1, c1), mask_ln1=ln(c1), mask_conv2=conv(2, c1, c2), mask_ln2=ln(c2),
              mask_conv3=conv(1, c2, E))
    return params


@pytest.fixture(scope="module", params=[False, True], ids=["f32_erf", "bf16_tanh"])
def sams(request):
    shipped = request.param
    cfg = tiny_cfg(shipped)
    params = with_mask_convs(structure_decoder(jax_params(cfg, seed=3)))
    return shipped, JaxSam(cfg), to_jax(params), port_sam(cfg, params)


@pytest.fixture(scope="module", params=[False, True], ids=["square", "rect"])
def predictors(request, sams):
    shipped, jsam, jvars, sam = sams
    img = image()
    jp, tp = JaxPredictor(jsam, jvars, rect_encode=request.param), SamPredictor(sam, rect_encode=request.param,
                                                                                  device="cpu")
    jp.set_image(img)
    tp.set_image(img)
    return shipped, jp, tp


def assert_close_outputs(shipped, port, ref):
    masks, iou, low = port
    masks_j, iou_j, low_j = (np.asarray(a, np.float32) for a in ref)
    tol_max, tol_mean = TOL[shipped]
    assert low.shape == low_j.shape and iou.shape == iou_j.shape and masks.shape == masks_j.shape
    for got, want in ((low, low_j), (iou, iou_j)):
        err = np.abs(got - want)
        assert err.max() < tol_max and err.mean() < tol_mean, (err.max(), err.mean())
    assert masks.dtype == bool and masks.shape[-2:] == (H, W)
    masks_j = masks_j > 0
    assert (masks == masks_j).mean() >= MIN_AGREE
    # the structured decoder leaves some mask tokens empty; the foregrounds
    # of the others agree too
    union = (masks | masks_j).sum()
    if union:
        assert (masks & masks_j).sum() / union >= MIN_IOU, (masks & masks_j).sum() / union


def test_embedding_matches_jax(predictors):
    shipped, jp, tp = predictors
    assert tp.is_image_set and tp.input_hw == jp.input_hw and tp.original_hw == jp.original_hw
    assert tp.features.device.type == "cpu" and tp.features.shape == jp.features.shape
    err = np.abs(f32(tp.features) - f32(jp.features))
    tol_max, tol_mean = TOL[shipped]
    assert err.max() < tol_max and err.mean() < tol_mean, (err.max(), err.mean())


PROMPTS = {
    "points": dict(point_coords=np.array([[40.0, 30.0], [90.0, 60.0]]), point_labels=np.array([1, 0])),
    "box": dict(box=np.array([20.0, 15.0, 100.0, 80.0])),
    "points_and_box": dict(point_coords=np.array([[60.0, 45.0]]), point_labels=np.array([1]),
                           box=np.array([20.0, 15.0, 100.0, 80.0])),
}


@pytest.mark.parametrize("prompt,multimask", [("points", True), ("box", False), ("points_and_box", True)])
def test_predict_matches_jax(predictors, prompt, multimask):
    shipped, jp, tp = predictors
    kw = dict(PROMPTS[prompt], multimask_output=multimask)
    port, ref = tp.predict(**kw), jp.predict(**kw)
    assert port[0].shape == (3 if multimask else 1, H, W)
    assert port[0].any()  # some mask has a foreground to compare
    assert_close_outputs(shipped, port, ref)


def test_predict_batched_matches_jax(predictors):
    shipped, jp, tp = predictors
    rng = np.random.default_rng(5)
    boxes = np.concatenate([rng.uniform(0, 50, (4, 2)), rng.uniform(60, 96, (4, 2))], 1)
    pts = rng.uniform(0, 96, (4, 2, 2))
    lbl = np.array([[1, 0]] * 4)
    kw = dict(point_coords=pts, point_labels=lbl, boxes=boxes)
    port, ref = tp.predict_batched(**kw), jp.predict_batched(**kw)
    assert port[0].shape == (4, 3, H, W)
    assert_close_outputs(shipped, port, ref)
    # row 0 of a batch is the single prompt's decode
    one = tp.predict(box=boxes[0])
    np.testing.assert_allclose(tp.predict_batched(boxes=boxes)[2][0], one[2], atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tp.predict_batched(point_coords=pts)


def test_reset_and_coords():
    sam = port_sam(tiny_cfg(False), jax_params(tiny_cfg(False), seed=3))
    tp = SamPredictor(sam, device="cpu")
    assert not tp.is_image_set
    tp.set_image(image())
    tp.reset_image()
    assert not tp.is_image_set and tp.features is None
    from pope_tpu.models.sam.sam import apply_boxes as jax_apply_boxes
    from pope_tpu.models.sam.sam import apply_coords as jax_apply_coords

    pts = np.random.default_rng(0).uniform(0, 128, (3, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(apply_coords(pts, (H, W), 256).numpy(), np.asarray(jax_apply_coords(pts, (H, W), 256)))
    boxes = pts.reshape(3, 10)[:, :8].reshape(3, 2, 4)
    np.testing.assert_array_equal(apply_boxes(boxes, (H, W), 256).numpy(), np.asarray(jax_apply_boxes(boxes, (H, W), 256)))


def test_sam_forward_is_preprocess_encode_decode():
    """Sam.forward against the JAX Sam.__call__ on the square frame (f32)."""
    import cv2
    import jax

    cfg = tiny_cfg(False)
    params = jax_params(cfg, seed=3)
    jsam, sam = JaxSam(cfg), port_sam(cfg, params)
    img = cv2.resize(image(), (256, 192), interpolation=cv2.INTER_LINEAR)
    pts = np.array([[[50.0, 40.0], [0.0, 0.0]]], np.float32)
    lbl = np.array([[1, -1]], np.int32)
    ref = jax.jit(lambda v, x, p, l: jsam.apply(v, x, (192, 256), p, l))(to_jax(params), img, pts, lbl)
    with torch.no_grad():
        out = sam(torch.from_numpy(img)[None], (192, 256), torch.from_numpy(pts), torch.from_numpy(lbl))
    for got, want in zip(out, ref):
        assert got.shape == want.shape
        assert np.abs(f32(got) - f32(want)).max() < TOL[False][0]


# --- the prompt head -------------------------------------------------------------------

ORIG_HW = (96, 128)
# the head's outputs against the JAX export: f32 reassociation, or in bf16
# the decoder tolerance of tests/test_torch_decoder.py (0.06 max abs on O(1)
# logits); binary upscaled masks agree on MIN_AGREE of the pixels
HEAD_TOL = {False: 2e-5, True: 0.06}


@pytest.fixture(scope="module")
def heads(sams):
    shipped, jsam, jvars, sam = sams
    jax_heads = {single: load_exported(jax_export_prompt_head(jsam, jvars, ORIG_HW, num_points=2,
                                                              return_single_mask=single)).call
                 for single in (False, True)}
    port_heads = {single: sam_prompt_head(sam, ORIG_HW, num_points=2, return_single_mask=single)
                  for single in (False, True)}
    rng = np.random.default_rng(7)
    E = sam.config.image_embedding_size
    args = dict(
        emb=rng.normal(0, 1, (1, E, E, 64)).astype(np.float32),
        pts=np.array([[[70.0, 50.0], [0.0, 0.0]]], np.float32),
        lbl=np.array([[1, -1]], np.int32),
        mask=rng.normal(0, 2, (1, 4 * E, 4 * E, 1)).astype(np.float32),
    )
    return shipped, jax_heads, port_heads, args


def run_heads(heads, single, has_mask, click_count=None, mask=True):
    shipped, jax_heads, port_heads, a = heads
    m = a["mask"] if mask else np.zeros_like(a["mask"])
    extra = () if click_count is None else (np.array([click_count], np.float32),)
    jargs = (a["emb"], a["pts"], a["lbl"], m, np.array([has_mask], np.float32), *extra)
    ref = jax_heads[single](*jargs)
    with torch.no_grad():
        out = port_heads[single](*(torch.from_numpy(np.asarray(x)) for x in jargs))
    return shipped, out, ref


def assert_head_close(shipped, out, ref, K):
    up, scores, low = out
    up_j, scores_j, low_j = (f32(x) for x in ref)
    assert up.shape == (1, K, *ORIG_HW) and scores.shape == (1, K) and low.shape == low_j.shape
    assert up.dtype == scores.dtype == low.dtype == torch.float32
    tol = HEAD_TOL[shipped]
    assert np.abs(f32(low) - low_j).max() < tol
    assert np.abs(f32(scores) - scores_j).max() < tol
    assert ((f32(up) > 0) == (up_j > 0)).mean() >= MIN_AGREE


@pytest.mark.parametrize("case", ["no_mask", "mask_on", "mask_off"])
def test_prompt_head_matches_jax(heads, case):
    """All four mask tokens; the mask input enters only with has_mask_input
    1 (0 is the no-mask path on any mask)."""
    shipped, out, ref = run_heads(heads, False, float(case == "mask_on"), mask=case != "no_mask")
    assert_head_close(shipped, out, ref, 4)
    if case == "mask_off":
        _, no_mask, _ = run_heads(heads, False, 0.0, mask=False)
        torch.testing.assert_close(out[2], no_mask[2], atol=0, rtol=0)


@pytest.mark.parametrize("click_count", [2.0, 3.0])
def test_single_mask_head_matches_jax(heads, click_count):
    """A click and its pad point (2) take the best multimask token; 3 points
    take token 0."""
    shipped, out, ref = run_heads(heads, True, 0.0, click_count=click_count, mask=False)
    assert_head_close(shipped, out, ref, 1)
    _, all_tokens, _ = run_heads(heads, False, 0.0, mask=False)
    scores = all_tokens[1][0]
    best = 1 + int(torch.argmax(scores[1:])) if click_count == 2.0 else 0
    torch.testing.assert_close(out[2][0, 0], all_tokens[2][0, best], atol=0, rtol=0)


def test_prompt_head_takes_its_capacity(heads):
    _, _, port_heads, a = heads
    pts = torch.zeros(1, 3, 2)
    with pytest.raises(ValueError, match="2 prompt slots"):
        port_heads[False](torch.from_numpy(a["emb"]), pts, torch.full((1, 3), -1), torch.from_numpy(a["mask"]),
                          torch.zeros(1))
