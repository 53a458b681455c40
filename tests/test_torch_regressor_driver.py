"""The regressor's data, extraction and drivers against pope_tpu's on the CPU:
`make_batches` / `sample_mkpts` / `train_val_split` (the same seeded draws
in the same order), `load_pose_dataset` on dumps written to disk,
`extract_pair` on the eval test's tiny bundle and dataset
(tests/test_torch_eval.py: JAX's solver noise given to the port) writing
the files pope_tpu's writes, and skipping a pair of fewer than 5 matches,
`train_main` (2 epochs: it descends and checkpoints), `test_main`'s metrics
against pope_tpu's on the same weights, and the `extract` /
`train-regressor` / `test-regressor` commands with --device cpu."""

import json
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu.models.regressor.data as jdata
import pope_tpu.models.regressor.driver as jdriver
import pope_tpu_torch.eval.manifest as port_manifest
import pope_tpu_torch.models.regressor.data as tdata
import pope_tpu_torch.models.regressor.driver as tdriver
from pope_tpu.config import RegressorConfig as JaxRegressorConfig
from pope_tpu.eval.extract import extract_pair as jax_extract_pair
from pope_tpu.models.regressor.model import MkptsRegModel as JaxReg
from pope_tpu_torch.eval import extract
from pope_tpu_torch.eval.manifest import iter_pairs, load_manifest
from pope_tpu_torch.models.regressor.model import MkptsRegModel
from pope_tpu_torch.models.regressor.train import create_train_state
from pope_tpu_torch.pipeline.runner import pair_seed
from pope_tpu_torch.utils.checkpoint import save_checkpoint
from pope_tpu_torch.weights import regressor_state_from_jax
from tests.test_torch_common import port_config, seeded_variables
from tests.test_torch_eval import dataset, models  # noqa: F401  (fixtures)
from tests.test_torch_solver import jax_noise

N_DUMPS, NUM_SAMPLE = 12, 16
LABEL, SEQ = "0801-lm1-others", "lm1-3"


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tiny models: two intra-op threads are as fast as eight here, and the
    test run's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rot(rng):
    import cv2

    return cv2.Rodrigues(rng.uniform(-0.3, 0.3, 3))[0]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """A LINEMOD-layout manifest of N_DUMPS + 2 pairs (poses and intrinsics,
    no frames) and dumps for all but two: one missing, one empty. Matches
    are the projections of random points under the pair's known poses."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("reg")
    base = root / "LM_dataset" / LABEL / SEQ
    for sub in ("intrin", "intrin_ba", "poses_ba"):
        os.makedirs(base / sub)
    K = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]])
    names, out = [], root / "dumps"
    for i in range(N_DUMPS + 2):
        np.savetxt(base / "intrin_ba" / f"{i}.txt", K)
        np.savetxt(base / "intrin" / f"{100 + i}.txt", K)
        np.savetxt(base / "poses_ba" / f"{i}.txt", np.hstack([np.eye(3), [[0], [0], [0.6]]]))
        R1, t1 = _rot(rng), np.array([[0.03], [-0.01], [0.62]]) + rng.normal(0, 0.02, (3, 1))
        np.savetxt(base / "poses_ba" / f"{100 + i}.txt", np.hstack([R1, t1]))
        name = f"{LABEL}/{SEQ}/color/{i}.png-{100 + i}.png"
        names.append(name)
        if i == N_DUMPS:
            continue  # no dump
        n = int(rng.integers(8, 30)) if i != N_DUMPS + 1 else 0
        X = rng.uniform(-0.05, 0.05, (n, 3)) + [0, 0, 0.6]
        x0 = (X / X[:, 2:]) @ K.T
        X1 = (X - [0, 0, 0.6]) @ R1.T + t1.T
        x1 = (X1 / X1[:, 2:]) @ K.T
        imgs = [rng.integers(0, 255, (48, 64, 3), np.uint8) for _ in range(2)]
        extract.write_dump(str(out), name, [10.0, 12.0, 70.0, 80.0], x0[:, :2], x1[:, :2], K, *imgs)
    np.savetxt(root / "LM_dataset" / LABEL / "box3d_corners.txt", np.zeros((8, 3)))
    os.makedirs(root / "pairs")
    with open(root / "pairs" / "LINEMOD-test.json", "w") as f:
        json.dump([{"0": names}], f)
    return str(root), str(root / "pairs"), str(out)


def _items(rng, n=7):
    return [{"mkpts0": rng.uniform(0, 99, (m, 2)).astype(np.float32),
             "mkpts1": rng.uniform(0, 99, (m, 2)).astype(np.float32),
             "pose0": np.vstack([np.hstack([_rot(rng), rng.normal(0, 1, (3, 1))]), [0, 0, 0, 1]]),
             "pose1": np.vstack([np.hstack([_rot(rng), rng.normal(0, 1, (3, 1))]), [0, 0, 0, 1]]),
             "img0": rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
             "img1": rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)}
            for m in rng.integers(3, 40, n)]


def test_batches_samples_and_split_match_jax():
    data = _items(np.random.default_rng(1))
    for kw in (dict(seed=5), dict(seed=5, shuffle=False), dict(seed=7, with_images=True)):
        got = list(tdata.make_batches(data, NUM_SAMPLE, 3, **kw))
        want = list(jdata.make_batches(data, NUM_SAMPLE, 3, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    import random

    for n in (5, 40):
        mk = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
        np.testing.assert_array_equal(tdata.sample_mkpts(mk, NUM_SAMPLE, random.Random(3)),
                                      jdata.sample_mkpts(mk, NUM_SAMPLE, random.Random(3)))
    for seed in (0, 20231223):
        got, want = tdata.train_val_split(data, seed), jdata.train_val_split(data, seed)
        assert [[id(d) for d in part] for part in got] == [[id(d) for d in part] for part in want]


def test_load_pose_dataset_matches_jax(dumps):
    data_root, pairs_dir, out = dumps
    for load_images in (False, True):
        got = tdata.load_pose_dataset("linemod", data_root, pairs_dir, out, load_images=load_images)
        want = jdata.load_pose_dataset("linemod", data_root, pairs_dir, out, load_images=load_images)
        assert len(got) == len(want) == N_DUMPS  # the missing and the empty dump skipped
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if isinstance(g[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k], k
    assert tdata.load_pose_dataset("linemod", data_root, pairs_dir, out, max_pairs=3, load_images=False)[2][
        "pair_name"].endswith("2.png-102.png")


def _pairs(dataset_):
    data_root, pairs_dir = dataset_
    spec = port_manifest.DATASETS["linemod"]
    return spec, list(iter_pairs(data_root, spec, load_manifest(pairs_dir, spec)))


def test_extract_pair_matches_jax(dataset, models, tmp_path, monkeypatch):  # noqa: F811
    """The tiny bundle's first pair (18 matches): the same six files as
    pope_tpu's. pre_bbox, pre_K and the prompt frame exactly; the matches
    within the records gate's 1e-3 px; the target crop within 1 (uint8
    truncation of the same bilinear values). A pair whose matches are cut
    to 4 is skipped and writes nothing."""
    jax_models, port = models
    spec, paths = _pairs(dataset)
    p = paths[0]
    key = jax.random.PRNGKey(pair_seed(p.pair_name))
    M = port.config.matcher.match_coarse.match_capacity
    assert jax_extract_pair(jax_models, p, spec, str(tmp_path / "jax"), key=key)
    assert extract.extract_pair(port, p, spec, str(tmp_path / "port"), noise=torch.from_numpy(jax_noise(key, M)))
    pt = lambda root, sub, ext: Path(root) / p.object_label / sub / f"{p.pair_name.split('/')[-1]}.{ext}"
    import cv2

    for sub in extract.SUBDIRS:
        ext = "png" if sub.startswith("img") else "txt"
        got, want = (pt(tmp_path / side, sub, ext) for side in ("port", "jax"))
        if ext == "png":
            a, b = cv2.imread(str(got)).astype(int), cv2.imread(str(want)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= (0 if sub == "img0" else 1), sub
            continue
        a, b = np.loadtxt(got), np.loadtxt(want)
        assert a.shape == b.shape, sub
        np.testing.assert_allclose(a, b, atol=1e-3 if sub.startswith("mkpts") else 1e-5, rtol=0, err_msg=sub)
    assert np.loadtxt(pt(tmp_path / "port", "mkpts0", "txt")).shape[0] >= 5

    estimate = extract.runner.PipelineExecutor.estimate_pair

    def four_matches(self, *args):
        res = estimate(self, *args)
        keep = torch.cumsum(res.match_valid.int(), 0) <= 4
        return res._replace(match_valid=res.match_valid & keep)

    monkeypatch.setattr(extract.runner.PipelineExecutor, "estimate_pair", four_matches)
    assert not extract.extract_pair(port, p, spec, str(tmp_path / "few"))
    assert not (tmp_path / "few").exists()


def _args(dumps_, **kw):
    data_root, pairs_dir, out = dumps_
    base = dict(dataset="linemod", data_root=data_root, pairs_dir=pairs_dir, points_dir=out, num_sample=NUM_SAMPLE,
                net_mode="mkpts", rotation_mode="6d", fusion="cross_attn", vim_size="small", epochs=2,
                device="cpu")
    return types.SimpleNamespace(**{**base, **kw})


def test_train_main_descends_and_checkpoints(dumps, tmp_path, monkeypatch, capsys):
    """2 epochs of RegressorConfig() at lr 1e-3 (the default 1e-5 moves a
    2-epoch loss less than dropout does): the epoch loss falls, and the
    checkpoint of the last epoch holds the trained weights."""
    cfg = tdriver.RegressorConfig
    monkeypatch.setattr(tdriver, "RegressorConfig", lambda **kw: cfg(lr=1e-3, **kw))
    state = tdriver.train_main(_args(dumps, ckpt_dir=str(tmp_path / "ck")))
    lines = capsys.readouterr().out.splitlines()
    losses = [float(line.split()[3]) for line in lines if line.startswith("epoch")]
    assert len(losses) == 2 and losses[1] < losses[0], lines
    assert state.step == 4  # 10 training pairs at batch 8: 2 steps an epoch
    ckpt = tmp_path / "ck" / "step_2"
    assert (ckpt / "checkpoint.pt").exists() and f"saved {ckpt}" in "\n".join(lines)
    saved = torch.load(ckpt / "checkpoint.pt", weights_only=True)["model"]
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(saved[k], v, atol=0, rtol=0)


def test_test_main_matches_jax(dumps, tmp_path):
    """The same weights in both packages' checkpoints (orbax for pope_tpu):
    the same validation metrics (R errors in degrees of the same poses)."""
    cfg = JaxRegressorConfig(num_sample=NUM_SAMPLE)
    z = jnp.zeros((1, NUM_SAMPLE, 2))
    v = seeded_variables(JaxReg(cfg), z, z, seed=3)
    jdriver._save_ckpt(str(tmp_path / "jax"), 1, jax.tree_util.tree_map(jnp.asarray, v["params"]))
    model = MkptsRegModel(port_config(cfg))
    model.load_state_dict(regressor_state_from_jax(v), strict=True)
    save_checkpoint(str(tmp_path / "port"), create_train_state(model, port_config(cfg)))
    got = tdriver.test_main(_args(dumps, ckpt=str(tmp_path / "port")))
    want = jdriver.test_main(_args(dumps, ckpt=str(tmp_path / "jax" / "step_1")))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-2 if "Err" in k else 1e-6, err_msg=k)


def test_regressor_clis(dataset, models, dumps, tmp_path, monkeypatch, capsys):  # noqa: F811
    """`extract` on the eval test's dataset (the tiny bundle, its own pair
    noise), then `train-regressor` for 2 epochs and `test-regressor` on its
    checkpoint over the synthetic dumps, all with --device cpu."""
    import pope_tpu_torch.pipeline as pipeline
    from pope_tpu_torch.cli import main

    data_root, pairs_dir = dataset
    seen = []
    monkeypatch.setattr(pipeline, "load_models", lambda **kw: seen.append(kw) or models[1])
    main(["extract", "--dataset", "linemod", "--data-root", data_root, "--pairs-dir", pairs_dir, "--out-dir",
          str(tmp_path / "x"), "--max-pairs", "2", "--device", "cpu"])
    assert seen[0]["device"] == "cpu"
    out = capsys.readouterr().out
    assert f"/2 pairs -> {tmp_path / 'x'}" in out
    written = int(out.split("extracted ")[1].split("/")[0])
    assert written == len(list((tmp_path / "x").glob("*/mkpts0/*.txt")))
    d_root, d_pairs, d_out = dumps
    common = ["--dataset", "linemod", "--data-root", d_root, "--pairs-dir", d_pairs, "--points-dir", d_out,
              "--num-sample", str(NUM_SAMPLE), "--device", "cpu"]
    main(["train-regressor", *common, "--epochs", "2", "--ckpt-dir", str(tmp_path / "ck")])
    assert "saved" in capsys.readouterr().out
    main(["test-regressor", *common, "--ckpt", str(tmp_path / "ck" / "step_2")])
    out = capsys.readouterr().out
    assert all(k in out for k in tdriver.METRICS)
