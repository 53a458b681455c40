"""The port's tools on the records path against pope_tpu's on the same tiny
models and inputs: the `amg` tool (coco_encode_rle, run_amg in both output
modes), the three demos (demo_sam_masks, demo_dinov2_heatmap at its 448x448
input, a 32x32 patch grid, demo_3dbbox with JAX's solver noise passed in),
project_points, DINOv2's pos embed at the demo's grid, estimate_pair fed a
records-path result, and the `amg` / `demo-sam` / `demo-dinov2` /
`demo-3dbbox` commands, which run on CUDA unless `--device cpu` is given.

The tiny SAM has the structured decoder of tests/test_amg_oracle.py; DINOv2
and the matcher are tests/test_torch_pipeline.py's. f32 throughout, so the
records agree exactly (tests/test_torch_amg_records.py); images written by
the two packages are compared pixel by pixel within the stated limits."""

import csv
import dataclasses
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu_torch.pipeline as pipeline
from pope_tpu.config import AMGConfig as JaxAMGConfig
from pope_tpu.config import PipelineConfig as JaxPipelineConfig
from pope_tpu.geometry.pose import project_points as jax_project_points
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.dinov2.model import _interpolate_pos_embed as jax_interpolate_pos_embed
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.models.sam import AutomaticMaskGenerator as JaxAMG
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu.pipeline import amg_cli as jax_amg_cli
from pope_tpu.pipeline import demos as jax_demos
from pope_tpu.pipeline.api import PopeModels as JaxModels
from pope_tpu_torch.cli import main
from pope_tpu_torch.geometry.pose import project_points
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.models.dinov2.model import interpolate_pos_embed
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.sam import AutomaticMaskGenerator
from pope_tpu_torch.pipeline import PopeModels, amg_cli, demos
from pope_tpu_torch.pipeline.runner import get_executor
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax
from tests.test_torch_common import jax_params, port_config, port_sam, seeded_variables, structure_decoder
from tests.test_torch_common import tiny_cfg, to_jax
from tests.test_torch_pipeline import DINO, MATCHER, _bn, _gamma
from tests.test_torch_solver import jax_noise

H, W = 96, 128
AMG_KW = dict(points_per_side=8, pred_iou_thresh=-0.25, stability_score_thresh=0.0)
BOX_TOL = 1e-3  # boxes and bboxes: low-res cell edges times f32 scale factors
SCORE_TOL = 1e-4  # predicted IoU and stability in f32
# rendered demo images: the masks agree to MIN_IOU (tests/test_torch_amg_records.py)
# and the drawn lines and crops to a rounding step, so a few pixels may differ
MAX_DIFF_PIXELS = 0.002
TOL_POSE = 2e-3  # R and t of one pair (tests/test_torch_pipeline.py)
TOL_TOKENS = 1e-4  # DINOv2 patch tokens in f32, O(1)
K = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]])


def _scene(rng, h=H, w=W):
    """Gaussian blobs (texture for the matcher) under coloured rectangles
    (regions for the AMG)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 90.0, np.float32)
    for _ in range(40):
        cy, cx, s = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 9)
        img += rng.uniform(-70, 70, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))[..., None]
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 50)
        img[y0 : y0 + rng.integers(20, 40), x0 : x0 + rng.integers(25, 50)] += rng.uniform(-60, 60, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A directory of two frames and a file that is no image; a prompt and a
    target frame of one scene with their poses."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("images")
    frames = root / "frames"
    frames.mkdir()
    for name in ("a.png", "b.png"):
        cv2.imwrite(str(frames / name), _scene(rng))
    (frames / "notes.txt").write_text("not an image")
    scene = _scene(rng, H + 24, W + 24)
    cv2.imwrite(str(root / "prompt.png"), scene[:H, :W])
    cv2.imwrite(str(root / "target.png"), np.clip(scene[12 : 12 + H, 9 : 9 + W] * 1.1, 0, 255).astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def models():
    """The same seeded tiny models in both packages."""
    sam_cfg = tiny_cfg(False)
    sam_params = structure_decoder(jax_params(sam_cfg, seed=0))
    d_vars = seeded_variables(JaxDino(DINO), jnp.zeros((1, 196, 196, 3)), seed=0, fill=_gamma)
    z = jnp.zeros((1, 64, 64, 1))
    m_vars = seeded_variables(JaxMatcher(MATCHER), z, z, seed=1, fill=_bn)
    cfg = JaxPipelineConfig(matcher=MATCHER, dinov2=DINO, sam=sam_cfg, amg=JaxAMGConfig(**AMG_KW),
                            ransac_thresh_px=4.0)
    jax_models = JaxModels(
        sam=JaxSam(sam_cfg), sam_variables=to_jax(sam_params), dinov2=JaxDino(DINO),
        dinov2_variables=to_jax(d_vars), matcher=JaxMatcher(MATCHER), matcher_variables=to_jax(m_vars),
        amg=JaxAMG(JaxSam(sam_cfg), to_jax(sam_params), cfg.amg, sam_cfg), config=cfg,
    )
    pcfg = port_config(cfg)
    dino = DinoVisionTransformer(pcfg.dinov2)
    dino.load_state_dict(dinov2_state_from_jax(d_vars), strict=True)
    matcher = Matcher(pcfg.matcher)
    matcher.load_state_dict(matcher_state_from_jax(m_vars), strict=True)
    sam = port_sam(sam_cfg, sam_params)
    port = PopeModels(sam=sam, amg=AutomaticMaskGenerator(sam, pcfg.amg, device="cpu"), dinov2=dino.eval(),
                      matcher=matcher.eval(), config=pcfg, device=torch.device("cpu"))
    return jax_models, port


def _png_masks(folder):
    return {f: cv2.imread(os.path.join(folder, f), cv2.IMREAD_UNCHANGED)
            for f in sorted(os.listdir(folder)) if f.endswith(".png")}


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _diff_share(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype
    return float((a != b).any(-1).mean() if a.ndim == 3 else (a != b).mean())


def test_coco_encode_rle_matches_jax():
    """pycocotools' rleToString on varied runs: long, alternating, a leading
    empty run, deltas of both signs."""
    rng = np.random.default_rng(3)
    for counts in ([0, 5, 3], [7], [1, 1, 1, 1, 1], [100000, 3, 47, 900, 2, 1], [0, 40, 2, 33, 31],
                   rng.integers(0, 5000, 50).tolist()):
        rle = {"size": [7, int(sum(counts) // 7 + 1)], "counts": counts}
        assert amg_cli.coco_encode_rle(rle) == jax_amg_cli.coco_encode_rle(rle)
        assert amg_cli.coco_decode_rle(amg_cli.coco_encode_rle(rle)) == rle


@pytest.mark.parametrize("convert_to_rle", [False, True], ids=["png_folder", "coco_json"])
def test_run_amg_matches_jax(models, images, tmp_path, convert_to_rle):
    """run_amg of both packages on one directory: the same files, the same
    masks, the metadata within tolerance."""
    jax_models, port = models
    ref_dir, out_dir = tmp_path / "jax", tmp_path / "port"
    ref_done = jax_amg_cli.run_amg(jax_models, str(images / "frames"), str(ref_dir), convert_to_rle=convert_to_rle)
    done = amg_cli.run_amg(port, str(images / "frames"), str(out_dir), convert_to_rle=convert_to_rle)
    assert done == ref_done and len(done) == 2
    assert sorted(os.listdir(out_dir)) == sorted(os.listdir(ref_dir)) == (
        ["a.json", "b.json"] if convert_to_rle else ["a", "b"])
    for name in ("a", "b"):
        if convert_to_rle:
            with open(out_dir / f"{name}.json") as f, open(ref_dir / f"{name}.json") as g:
                anns, ref_anns = json.load(f), json.load(g)
            assert len(anns) == len(ref_anns) > 0
            for a, r in zip(anns, ref_anns):
                assert a.keys() == r.keys() and a["segmentation"] == r["segmentation"]
                assert a["area"] == r["area"] and a["crop_box"] == r["crop_box"]
                np.testing.assert_allclose(a["bbox"], r["bbox"], atol=BOX_TOL, rtol=0)
                np.testing.assert_allclose(a["predicted_iou"], r["predicted_iou"], atol=SCORE_TOL, rtol=0)
            continue
        pngs, ref_pngs = _png_masks(out_dir / name), _png_masks(ref_dir / name)
        assert pngs.keys() == ref_pngs.keys() and len(pngs) > 0
        for f in pngs:
            assert np.array_equal(pngs[f], ref_pngs[f]), f
        rows, ref_rows = _csv_rows(out_dir / name / "metadata.csv"), _csv_rows(ref_dir / name / "metadata.csv")
        assert rows[0] == ref_rows[0] and len(rows) == len(ref_rows) == len(pngs) + 1
        for row, ref_row in zip(rows[1:], ref_rows[1:]):
            assert row[:2] == ref_row[:2] and row[10:] == ref_row[10:]  # id, area, crop box
            np.testing.assert_allclose(np.float64(row[2:8]), np.float64(ref_row[2:8]), atol=BOX_TOL, rtol=0)
            np.testing.assert_allclose(np.float64(row[8:10]), np.float64(ref_row[8:10]), atol=SCORE_TOL, rtol=0)


def test_demo_sam_masks_matches_jax(models, images, tmp_path):
    jax_models, port = models
    ref = jax_demos.demo_sam_masks(jax_models, str(images / "target.png"), str(tmp_path / "jax.png"))
    out = demos.demo_sam_masks(port, str(images / "target.png"), str(tmp_path / "port.png"))
    assert out.shape == (H, W, 3) and out.dtype == np.uint8
    assert _diff_share(out, ref) <= MAX_DIFF_PIXELS
    assert np.array_equal(cv2.imread(str(tmp_path / "port.png")), out)
    assert (out != cv2.imread(str(images / "target.png"))).any()  # masks were drawn


def _pca_component(tokens):
    t = tokens - tokens.mean(0, keepdims=True)
    return t @ np.linalg.svd(t, full_matrices=False)[2][0]


def test_demo_dinov2_heatmap_matches_jax(models, images, tmp_path):
    """At the demo's 448x448 input (a 32x32 grid, 1025 tokens): the same patch
    tokens and, up to the sign of the first principal component, the same
    heatmap."""
    jax_models, port = models
    path = str(images / "target.png")
    ref = jax_demos.demo_dinov2_heatmap(jax_models, path, str(tmp_path / "jax.jpg"))
    out = demos.demo_dinov2_heatmap(port, path, str(tmp_path / "port.jpg"))
    assert out.shape == ref.shape == (448, 448, 3) and os.path.exists(tmp_path / "port.jpg")
    # the tokens behind both heatmaps
    img = cv2.resize(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), (448, 448)).astype(np.float32) / 255.0
    x = ((img - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])).astype(np.float32)
    ref_tok = np.asarray(jax_models.dinov2.apply(jax_models.dinov2_variables, jnp.asarray(x)[None])["x_norm_patchtokens"][0])
    with torch.no_grad():
        tok = port.dinov2(torch.from_numpy(x)[None])["x_norm_patchtokens"][0].numpy()
    assert tok.shape == (1024, DINO.embed_dim)
    np.testing.assert_allclose(tok, ref_tok, atol=TOL_TOKENS, rtol=0)
    comp, ref_comp = _pca_component(tok), _pca_component(ref_tok)
    sign = np.sign(comp @ ref_comp)
    np.testing.assert_allclose(sign * comp, ref_comp, atol=1e-3 * np.abs(ref_comp).max())
    if sign > 0:  # the same orientation: the same image, a colour level apart at most
        assert np.abs(out.astype(int) - ref).max() <= 8


def test_dinov2_pos_embed_at_the_demo_grid():
    """DINOv2 ViT-S/14's 37x37 pos embed resampled to the 32x32 grid of a
    448x448 input (bicubic, antialiased), against pope_tpu's."""
    pe = np.random.default_rng(5).normal(0, 0.02, (1, 1 + 37 * 37, 384)).astype(np.float32)
    ref = np.asarray(jax_interpolate_pos_embed(jnp.asarray(pe), (32, 32), None))
    out = interpolate_pos_embed(torch.from_numpy(pe), (32, 32)).numpy()
    assert out.shape == ref.shape == (1, 1 + 32 * 32, 384)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_project_points_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-0.1, 0.1, (8, 3))
    R, _ = cv2.Rodrigues(rng.uniform(-0.5, 0.5, 3))
    RT = np.hstack([R, [[0.02], [-0.01], [0.5]]])
    RT_edge = np.hstack([np.eye(3), [[0.0], [0.0], [0.0]]])  # depths 0 and below: the clamp
    for rt in (RT, RT_edge):
        out, dpt = project_points(pts, rt, K)
        ref, ref_dpt = jax_project_points(jnp.asarray(pts), jnp.asarray(rt), jnp.asarray(K))
        np.testing.assert_allclose(dpt.numpy(), np.asarray(ref_dpt), rtol=1e-6)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-3)


def _poses():
    prompt_pose = np.hstack([np.eye(3), [[0], [0], [0.5]]])
    R1, _ = cv2.Rodrigues(np.array([0.1, -0.05, 0.02]))
    target_pose = np.hstack([R1, [[0.05], [0], [0.6]]])
    corners = np.array([[x, y, z] for x in (-0.05, 0.05) for y in (-0.05, 0.05) for z in (-0.05, 0.05)])
    return prompt_pose, target_pose, corners


def test_demo_3dbbox_matches_jax(models, images, tmp_path):
    """One pair through both demos, the port given JAX's PRNGKey(0) draws:
    the same pose and winning box, the same drawings within a few pixels."""
    jax_models, port = models
    prompt_pose, target_pose, corners = _poses()
    args = (str(images / "prompt.png"), str(images / "target.png"), K, K, prompt_pose, corners)
    ref_vis, ref_stack, ref = jax_demos.demo_3dbbox(
        jax_models, *args, target_pose=target_pose, out_query=str(tmp_path / "jq.png"),
        out_bbox=str(tmp_path / "jb.png"))
    noise = torch.from_numpy(jax_noise(jax.random.PRNGKey(0), MATCHER.match_coarse.match_capacity))
    vis, stack, res = demos.demo_3dbbox(
        port, *args, target_pose=target_pose, out_query=str(tmp_path / "q.png"),
        out_bbox=str(tmp_path / "b.png"), noise=noise)
    assert bool(res.ok) == bool(ref.ok)
    np.testing.assert_array_equal(res.pre_bbox.numpy(), np.asarray(ref.pre_bbox))
    assert int(res.n_strong) == int(ref.n_strong)
    np.testing.assert_allclose(res.R.numpy(), np.asarray(ref.R), atol=TOL_POSE)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), atol=TOL_POSE)
    assert stack.shape == ref_stack.shape == (256, 512, 3) and vis.shape == ref_vis.shape == (H, W, 3)
    assert np.array_equal(stack[:, :256], ref_stack[:, :256])  # the resized prompt
    assert np.abs(stack.astype(int) - ref_stack).max() <= 1  # the crop, a rounding step apart
    assert _diff_share(vis, ref_vis) <= MAX_DIFF_PIXELS
    assert np.array_equal(cv2.imread(str(tmp_path / "q.png")), stack)
    assert np.array_equal(cv2.imread(str(tmp_path / "b.png")), vis)


def test_estimate_pair_takes_a_records_path_result(models, images):
    """generate's host result (numpy boxes) feeds estimate_pair directly:
    the same pair result as the eval path's device tensors of it."""
    _, port = models
    img0 = torch.from_numpy(cv2.imread(str(images / "prompt.png"))[..., ::-1].copy())
    img1 = cv2.imread(str(images / "target.png"))[..., ::-1].copy()
    res = port.amg.generate(img1)
    assert isinstance(res.boxes_xywh, np.ndarray) and res.boxes_xywh.shape == (port.amg.cfg.mask_capacity, 4)
    ex = get_executor(port, 64)
    ref_cls = ex.prompt_cls_raw(img0[None])[0]
    noise = torch.from_numpy(jax_noise(jax.random.PRNGKey(1), MATCHER.match_coarse.match_capacity))
    args = (img0.float() / 255.0, torch.from_numpy(img1).float() / 255.0, K, K)
    out = ex.estimate_pair(*args, res, ref_cls, noise)
    as_tensors = res._replace(boxes=torch.from_numpy(res.boxes), valid=torch.from_numpy(res.valid),
                              n_dropped=torch.as_tensor(res.n_dropped))
    ref = ex.estimate_pair(*args, as_tensors, ref_cls, noise)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out.pre_bbox.shape == (4,) and out.R.shape == (3, 3)


@pytest.fixture
def patched_loader(models, monkeypatch):
    """load_models patched to the tiny port bundle (an AMG of the config it is
    given); records each call's keywords."""
    _, port = models
    seen = []

    def load(**kw):
        seen.append(kw)
        amg = AutomaticMaskGenerator(port.sam, kw["config"].amg, device="cpu") if "config" in kw else port.amg
        return PopeModels(sam=port.sam, amg=amg, dinov2=port.dinov2, matcher=port.matcher, config=port.config,
                          device=torch.device("cpu"))

    monkeypatch.setattr(pipeline, "load_models", load)
    return seen


def test_cli_amg(models, images, tmp_path, patched_loader):
    """`amg --device cpu` with AMG flags writes run_amg's outputs for the
    config the flags make."""
    _, port = models
    main(["amg", "--input", str(images / "frames"), "--output", str(tmp_path / "cli"), "--device", "cpu",
          *sum((["--" + k.replace("_", "-"), str(v)] for k, v in AMG_KW.items()), []), "--mask-capacity", "16"])
    kw = patched_loader[-1]
    assert kw["device"] == "cpu" and kw["components"] == ("sam",) and kw["config"].amg.mask_capacity == 16
    amg = AutomaticMaskGenerator(port.sam, kw["config"].amg, device="cpu")
    amg_cli.run_amg(dataclasses.replace(port, amg=amg), str(images / "frames"), str(tmp_path / "direct"))
    for name in ("a", "b"):
        cli, direct = _png_masks(tmp_path / "cli" / name), _png_masks(tmp_path / "direct" / name)
        assert cli.keys() == direct.keys() and all(np.array_equal(cli[f], direct[f]) for f in cli)


def test_cli_demos(models, images, tmp_path, patched_loader):
    """`demo-sam`, `demo-dinov2` and `demo-3dbbox` with --device cpu write
    what the demo functions write; each loads only the towers it uses."""
    _, port = models
    prompt_pose, target_pose, corners = _poses()
    np.savetxt(images / "prompt.txt", prompt_pose)
    np.savetxt(images / "target.txt", target_pose)
    np.savetxt(tmp_path / "K.txt", K)
    np.savetxt(tmp_path / "box.txt", corners)
    main(["demo-sam", "--image", str(images / "target.png"), "--out", str(tmp_path / "sam.png"), "--device", "cpu"])
    main(["demo-dinov2", "--image", str(images / "target.png"), "--out", str(tmp_path / "dino.jpg"),
          "--device", "cpu"])
    main(["demo-3dbbox", "--prompt", str(images / "prompt.png"), "--target", str(images / "target.png"),
          "--k0", str(tmp_path / "K.txt"), "--k1", str(tmp_path / "K.txt"), "--box3d", str(tmp_path / "box.txt"),
          "--out-query", str(tmp_path / "q.png"), "--out-bbox", str(tmp_path / "b.png"), "--device", "cpu"])
    assert [kw.get("components", ("sam", "dinov2", "matcher")) for kw in patched_loader] == [
        ("sam",), ("dinov2",), ("sam", "dinov2", "matcher")]
    assert all(kw["device"] == "cpu" for kw in patched_loader)
    sam_img = demos.demo_sam_masks(port, str(images / "target.png"), str(tmp_path / "sam2.png"))
    assert np.array_equal(cv2.imread(str(tmp_path / "sam.png")), sam_img)
    assert cv2.imread(str(tmp_path / "dino.jpg")).shape == (448, 448, 3)
    vis, stack, _ = demos.demo_3dbbox(port, str(images / "prompt.png"), str(images / "target.png"), K, K,
                                      prompt_pose, corners, target_pose=target_pose,
                                      out_query=str(tmp_path / "q2.png"), out_bbox=str(tmp_path / "b2.png"))
    assert cv2.imread(str(tmp_path / "q.png")).shape == (256, 512, 3)
    assert np.array_equal(cv2.imread(str(tmp_path / "b.png")), vis)


@pytest.mark.parametrize("argv", [
    ["amg", "--input", "x.png", "--output", "out"],
    ["demo-sam", "--image", "x.png"],
    ["demo-dinov2", "--image", "x.png"],
    ["demo-3dbbox", "--prompt", "p.png", "--target", "t.png", "--prompt-pose", "p.txt"],
], ids=["amg", "demo-sam", "demo-dinov2", "demo-3dbbox"])
def test_cli_commands_need_a_gpu_unless_asked_for_cpu(argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.chdir(tmp_path)
    np.savetxt(tmp_path / "p.txt", np.hstack([np.eye(3), np.zeros((3, 1))]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
