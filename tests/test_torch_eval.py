"""The records gate of the port's eval driver: pope_tpu_torch's
`runner.run_pairs` / `evaluate_dataset` against pope_tpu's on one tiny
LINEMOD-layout dataset (4 pairs of 96x128 frames on disk, crop size 64) with
the same weights: a tiny SAM whose decoder has the structured surgery of
tests/test_amg_oracle.py (real AMG boxes), and the tiny DINOv2 and matcher
of tests/test_torch_pipeline.py (matcher threshold 0, so the solves run).

The port draws each pair's solver noise from its own generator; torch cannot
reproduce JAX's threefry bits, so here the port's `runner.pair_noise` is
patched to the JAX draws from the key the JAX runner builds for the pair
(PRNGKey(crc32(name) & 0x7FFFFFFF)). Also: both pipeline depths give
identical records, and the port's serial, batched and ragged runs agree
within the JAX gate's tolerances; the tables, the xlsx export and the
`eval` CLI."""

import dataclasses
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu.eval.manifest as jax_manifest
import pope_tpu.pipeline.runner as jax_runner
import pope_tpu_torch.eval.manifest as port_manifest
from pope_tpu.config import AMGConfig as JaxAMGConfig
from pope_tpu.config import PipelineConfig as JaxPipelineConfig
from pope_tpu.eval import evaluate_dataset as jax_evaluate_dataset
from pope_tpu.eval.evaluate import results_to_xlsx as jax_results_to_xlsx
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.models.sam import AutomaticMaskGenerator as JaxAMG
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu.pipeline.api import PopeModels as JaxModels
from pope_tpu_torch.data.image_io import write_rgb
from pope_tpu_torch.eval import evaluate_dataset, iter_pairs, load_manifest, results_to_xlsx
from pope_tpu_torch.eval.evaluate import results_table
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.sam import AutomaticMaskGenerator
from pope_tpu_torch.pipeline import PopeModels, runner
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax
from tests.test_torch_common import jax_params, port_config, port_sam, seeded_variables, structure_decoder
from tests.test_torch_common import tiny_cfg, to_jax
from tests.test_torch_pipeline import DINO, MATCHER, _bn, _gamma
from tests.test_torch_solver import jax_noise

H, W, CROP, N_PAIRS = 96, 128, 64, 4
AMG_KW = dict(points_per_side=8, pred_iou_thresh=-0.25, stability_score_thresh=0.0, mask_capacity=8)
# R/t errors in degrees: the packed R and t agree within 2e-3
# (tests/test_torch_pipeline.py), about 0.25 degrees of rotation
TOL_DEG = 0.25
# squared symmetric epipolar errors of the kept matches: coordinates within
# 1e-3 px of the JAX package's; relative to the error, plus 1e-7 absolute
# (an error of 0 moves by about (1e-3 px / 100 px focal)^2)
TOL_EPI_REL, TOL_EPI_ABS = 1e-2, 1e-7
TOL_TABLE = 1e-3  # per-object metrics (fractions and degrees)
DISCRETE = ("object", "identifier", "ok", "pre_bbox", "gt_bbox", "n_strong", "n_dropped_masks",
            "n_dropped_matches")


def _scene(rng, h, w):
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
    return np.clip(img, 0, 255)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """LINEMOD layout: the prompt frame a window of a scene, the target a
    shifted, brightened window of the same scene; 4 pairs in one rotation
    bin. Frames written through the port's image_io."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("lm")
    label, seq = "0801-lm1-others", "lm1-3"
    base = root / "LM_dataset" / label / seq
    for sub in ("color", "color_full", "intrin", "intrin_ba", "poses_ba"):
        os.makedirs(base / sub)
    K = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]])
    pairs = []
    for i in range(N_PAIRS):
        scene = _scene(rng, H + 24, W + 24)
        dy, dx = rng.integers(0, 24, 2)
        write_rgb(str(base / "color" / f"{i}.png"), scene[:H, :W].astype(np.uint8))
        write_rgb(str(base / "color_full" / f"{100 + i}.png"),
                  np.clip(scene[dy : dy + H, dx : dx + W] * 1.1, 0, 255).astype(np.uint8))
        np.savetxt(base / "intrin_ba" / f"{i}.txt", K)
        np.savetxt(base / "intrin" / f"{100 + i}.txt", K)
        np.savetxt(base / "poses_ba" / f"{i}.txt", np.hstack([np.eye(3), [[0], [0], [0.6]]]))
        R1, _ = cv2.Rodrigues(rng.uniform(-0.2, 0.2, 3))
        np.savetxt(base / "poses_ba" / f"{100 + i}.txt", np.hstack([R1, [[0.03], [-0.01], [0.62]]]))
        pairs.append(f"{label}/{seq}/color/{i}.png-{100 + i}.png")
    np.savetxt(root / "LM_dataset" / label / "box3d_corners.txt",
               np.array([[x, y, z] for x in (-0.05, 0.05) for y in (-0.05, 0.05) for z in (-0.05, 0.05)]))
    os.makedirs(root / "pairs")
    with open(root / "pairs" / "LINEMOD-test.json", "w") as f:
        json.dump([{"0": pairs}], f)
    with pytest.MonkeyPatch.context() as mp:
        # the tiny matcher's crop size, in both packages' dataset tables
        for mod in (jax_manifest, port_manifest):
            mp.setitem(mod.DATASETS, "linemod", dataclasses.replace(mod.DATASETS["linemod"], crop_size=CROP))
        yield str(root), str(root / "pairs")


@pytest.fixture(scope="module")
def models():
    sam_cfg = tiny_cfg(False)
    sam_params = structure_decoder(jax_params(sam_cfg, seed=0))
    d_vars = seeded_variables(JaxDino(DINO), jnp.zeros((1, 196, 196, 3)), seed=0, fill=_gamma)
    z = jnp.zeros((1, 64, 64, 1))
    m_vars = seeded_variables(JaxMatcher(MATCHER), z, z, seed=1, fill=_bn)
    # a 4 px inlier band: the untrained matcher's matches are near random, and
    # at the shipped 0.5 px only one pair in four would solve
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


def _jax_pair_noise(paths_list, n_matches, n_rounds, device):
    """The JAX runner's per-pair draws (pair_keys_np), for the port."""
    assert n_rounds == 3
    return torch.from_numpy(np.stack([
        jax_noise(jax.random.PRNGKey(runner.pair_seed(p.pair_name)), n_matches) for p in paths_list
    ])).to(device)


@pytest.fixture(scope="module")
def jax_noise_patch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "pair_noise", _jax_pair_noise)
        yield


def _capture(mp, module, name):
    """Wrap module.name (a records-returning finish/run function) so that the
    records it returns are collected; returns the list."""
    got, fn = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        recs = fn(*args, **kwargs)
        got.extend(recs)
        return recs

    mp.setattr(module, name, wrapped)
    return got


@pytest.fixture(scope="module")
def runs(dataset, models, jax_noise_patch):
    """Both packages' evaluate_dataset(batch_size=2) (records and tables),
    their run_pairs on the first two pairs, and the port's serial run_pair,
    run_pairs over all 4 pairs, batches of 3 (a ragged tail) and depth 1."""
    data_root, pairs_dir = dataset
    jax_models, port = models
    spec = port_manifest.DATASETS["linemod"]
    paths = list(iter_pairs(data_root, spec, load_manifest(pairs_dir, spec)))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jax_recs = _capture(mp, jax_runner, "finish_pairs")
        port_recs = _capture(mp, runner, "finish_pairs")
        out["jax_tables"] = jax_evaluate_dataset(jax_models, "linemod", data_root, pairs_dir, batch_size=2,
                                                 progress=False)
        out["port_tables"] = evaluate_dataset(port, "linemod", data_root, pairs_dir, batch_size=2, progress=False)
        out["jax_eval"], out["port_eval"] = list(jax_recs), list(port_recs)
        port_recs.clear()
        evaluate_dataset(port, "linemod", data_root, pairs_dir, batch_size=3, progress=False)
        out["port_b3"] = list(port_recs)
        port_recs.clear()
        mp.setenv("POPE_PIPELINE_DEPTH", "1")
        evaluate_dataset(port, "linemod", data_root, pairs_dir, batch_size=2, progress=False)
        out["port_depth1"] = list(port_recs)
    out["jax_run_pairs"] = jax_runner.run_pairs(jax_models, paths[:2], jax_manifest.DATASETS["linemod"])
    out["port_run_pairs"] = runner.run_pairs(port, paths[:2], spec)
    out["port_b4"] = runner.run_pairs(port, paths, spec)
    out["port_serial"] = [runner.run_pair(port, p, spec) for p in paths]
    return out


def assert_same_records(a, b):
    """Record lists equal field by field (NaN == NaN in the arrays)."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            if isinstance(ra[k], np.ndarray):
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=f"{ra['identifier']}/{k}")
            else:
                assert ra[k] == rb[k], (ra["identifier"], k, ra[k], rb[k])


def assert_records_match_jax(port, ref):
    """Discrete fields equal, errors within the stated tolerances."""
    assert len(port) == len(ref) == len({r["identifier"] for r in ref})
    for p, r in zip(port, ref):
        for k in DISCRETE:
            assert p[k] == r[k], (r["identifier"], k, p[k], r[k])
        if r["ok"]:
            assert abs(p["R_err"] - r["R_err"]) < TOL_DEG and abs(p["t_err"] - r["t_err"]) < TOL_DEG
        np.testing.assert_allclose(p["epi_errs"], r["epi_errs"], rtol=TOL_EPI_REL, atol=TOL_EPI_ABS)
        np.testing.assert_allclose(p["T_0to1"], r["T_0to1"], atol=1e-6)


def test_records_match_jax(runs):
    """evaluate_dataset's records, pair by pair: ok, boxes, strong-match
    counts and drop counts exactly; R/t errors and epipolar errors within
    the stated tolerances. The set holds solved and failed pairs, and more
    than one chosen box."""
    assert_records_match_jax(runs["port_eval"], runs["jax_eval"])
    assert_records_match_jax(runs["port_run_pairs"], runs["jax_run_pairs"])
    ok = [r["ok"] for r in runs["jax_eval"]]
    assert 0 < sum(ok) < len(ok)  # both branches of the record
    assert len({tuple(r["pre_bbox"]) for r in runs["jax_eval"]}) > 1
    assert all(r["epi_errs"].size > 0 for r in runs["jax_eval"])


def test_tables_match_jax(runs):
    port, ref = runs["port_tables"], runs["jax_tables"]
    assert list(port) == list(ref)
    for obj in ref:
        assert list(port[obj]) == list(ref[obj])
        for k, v in ref[obj].items():
            np.testing.assert_allclose(port[obj][k], v, atol=TOL_TABLE, err_msg=f"{obj}/{k}")


def test_pipeline_depth_does_not_change_records(runs):
    """One batch in flight or two: the same batches, the same records."""
    assert_same_records(runs["port_depth1"], runs["port_eval"])


@pytest.mark.parametrize("run", ["port_b4", "port_b3", "port_serial"])
def test_batching_does_not_change_records(runs, run):
    """All 4 pairs in one batch, batches of 3 and 1 (a ragged tail), and one
    pair at a time (run_pair) against batches of 2: each pair's noise is its
    own, so the records agree as closely as the JAX package's do. Not to the
    last bit: the matcher's convolutions and matrix products round
    differently at other batch sizes (about 4e-6 px in the match
    coordinates on the CPU), which moves R and t in their last bits."""
    assert_records_match_jax(runs[run], runs["port_eval"])


def test_results_table_and_xlsx(runs, tmp_path):
    per_obj = runs["port_tables"]
    table = results_table(per_obj)
    assert "Avg" in table and "R:auc@30" in table
    rows = results_to_xlsx(per_obj, str(tmp_path / "port.xlsx"))
    ref_rows = jax_results_to_xlsx(runs["jax_tables"], str(tmp_path / "jax.xlsx"))
    assert [r[0] for r in rows] == [r[0] for r in ref_rows]
    np.testing.assert_allclose(np.asarray([r[1:] for r in rows]), np.asarray([r[1:] for r in ref_rows]),
                               atol=TOL_TABLE + 1e-3)  # rounded to 3 decimals
    import zipfile

    with zipfile.ZipFile(tmp_path / "port.xlsx") as z:
        assert "xl/worksheets/sheet1.xml" in z.namelist()


def test_cli_eval(runs, dataset, models, tmp_path, monkeypatch, capsys):
    """`python -m pope_tpu_torch.cli eval` (batched default and --serial),
    load_models patched to the tiny bundle: the tables of evaluate_dataset."""
    import pope_tpu_torch.pipeline as pipeline
    from pope_tpu_torch.cli import main

    data_root, pairs_dir = dataset
    seen = []
    monkeypatch.setattr(pipeline, "load_models", lambda **kw: seen.append(kw) or models[1])
    for extra, name in ((["--batch-size", "2"], "batched"), (["--serial"], "serial")):
        out = tmp_path / f"{name}.json"
        main(["eval", "--dataset", "linemod", "--data-root", data_root, "--pairs-dir", pairs_dir,
              "--device", "cpu", "--json-out", str(out), "--xlsx", str(tmp_path / f"{name}.xlsx"), *extra])
        with open(out) as f:
            got = json.load(f)
        assert got.keys() == runs["port_tables"].keys()
        for obj, table in runs["port_tables"].items():
            assert got[obj] == pytest.approx(table, abs=TOL_TABLE)
    assert all(kw["device"] == "cpu" for kw in seen)
    assert "Avg" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["eval", "--dataset", "linemod", "--serial", "--batch-size", "2"])
