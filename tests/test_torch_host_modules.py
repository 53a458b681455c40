"""The port's host modules against pope_tpu on the same inputs: the parse-lm
converter and command, the augmentors, the object-centric scene datasets
and mask2bbox, mask_utils, plotting, the animator, the profiler, the
reference-weights reader, the regressor's load_ckpt and
initialize_distributed in a single process."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu.data.augment as jaug
import pope_tpu.data.scenes as jscenes
import pope_tpu.utils.mask_utils as jmask
import pope_tpu.utils.plotting as jplot
import pope_tpu_torch.data.augment as taug
import pope_tpu_torch.data.scenes as tscenes
import pope_tpu_torch.utils.mask_utils as tmask
import pope_tpu_torch.utils.plotting as tplot
from pope_tpu.cli import main as jax_cli
from pope_tpu.utils.checkpoint import load_torch_state_dict as jax_load_torch
from pope_tpu.utils.profiling import InferenceProfiler as JaxProfiler
from pope_tpu_torch.cli import main as port_cli
from pope_tpu_torch.utils.checkpoint import load_torch_state_dict
from pope_tpu_torch.utils.profiling import InferenceProfiler, PassThroughProfiler, TraceProfiler, build_profiler


def _cdpn_fixture(base):
    """tests/test_manifest_cli.py::test_parse_lm_converter's two-frame
    CDPN-format LINEMOD object."""
    import cv2

    seq = base / "real_train" / "ape"
    seq.mkdir(parents=True)
    (base / "models").mkdir()
    (base / "models" / "models_info.txt").write_text(
        "1 diameter 102.099 min_x -37.93 min_y -38.79 min_z -45.88 size_x 75.86 size_y 77.59 size_z 91.76\n")
    rng = np.random.default_rng(3)
    pose = np.hstack([np.eye(3), np.array([[0.0], [0.0], [0.6]])])
    for i in (0, 1):
        cv2.imwrite(str(seq / f"{i}-color.png"), rng.uniform(0, 255, (480, 640, 3)).astype(np.uint8))
        np.savetxt(str(seq / f"{i}-pose.txt"), pose)
        np.savetxt(str(seq / f"{i}-box.txt"), np.array([200, 150, 120, 100]))
    return base


def test_parse_lm_cli_matches_pope_tpu(tmp_path, capsys):
    """`parse-lm` through both CLIs: every file byte-equal except the crop
    intrinsics, which agree within 1e-6 of the matrix's scale: both are f32
    solves of the crop affine, and pope_tpu's leaves 3.4e-5 (4.5e-8 of the
    focal length) in the skew entry, which is 0 in exact arithmetic and in
    the port."""
    base = _cdpn_fixture(tmp_path / "cdpn")
    args = ["parse-lm", "--data-base-dir", str(base), "--obj-id", "1", "--splits", "train"]
    jax_cli(args + ["--output-dir", str(tmp_path / "jax")])
    port_cli(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert "converted ->" in capsys.readouterr().out
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert got == want and len(got) == 12
    for rel in want:
        a, b = (tmp_path / "jax" / rel), (tmp_path / "port" / rel)
        if rel.parts[-2] == "intrin_ba":
            K, K_ref = np.loadtxt(b), np.loadtxt(a)
            np.testing.assert_allclose(K, K_ref, atol=1e-6 * np.abs(K_ref).max(), rtol=0)
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_augmentors_byte_equal():
    rng = np.random.default_rng(6)
    imgs = [rng.uniform(0, 255, (48, 64, 3)).astype(np.uint8) for _ in range(6)]
    for name in ("dark", "mobile"):
        ja, ta = jaug.build_augmentor(name, seed=4), taug.build_augmentor(name, seed=4)
        for img in imgs:  # six draws: every MobileAug branch comes up
            np.testing.assert_array_equal(ta(img), ja(img))
    assert taug.build_augmentor(None) is None and taug.build_augmentor("none") is None
    with pytest.raises(ValueError):
        taug.build_augmentor("fog")


def test_co3d_dataset_and_mask2bbox(tmp_path):
    """After tests/test_scenes.py:163: the same items from both packages."""
    import cv2

    rng = np.random.default_rng(3)
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    ids = ["a", "b", "c"]
    Ks, poses = {}, {}
    for k, i in enumerate(ids):
        cv2.imwrite(str(tmp_path / "images" / f"{i}.jpg"), rng.uniform(0, 255, (40, 40, 3)).astype(np.uint8))
        m = np.zeros((40, 40), np.uint8)
        m[10:30, 5 + k:25 + k] = 255
        cv2.imwrite(str(tmp_path / "masks" / f"{i}.png"), m)
        Ks[i] = np.array([[50.0, 0, 20], [0, 50, 20], [0, 0, 1]])
        T = np.eye(4)
        T[0, 3] = 0.1 * k
        poses[i] = T[:3]
    with open(tmp_path / "info.pkl", "wb") as f:
        pickle.dump((Ks, poses, ids, {i: 1.0 for i in ids}), f)
    jdb, tdb = jscenes.Co3DResizeDataset(str(tmp_path)), tscenes.Co3DResizeDataset(str(tmp_path))
    assert len(tdb) == len(jdb) == 2 and tdb.get_img_ids() == ids
    np.testing.assert_array_equal(tdb.get_bbox("a"), [5, 10, 19, 19])
    for idx in range(2):
        _same_item(tdb[idx], jdb[idx])
    for m in (np.zeros((8, 8), bool), np.eye(6, dtype=bool)):
        np.testing.assert_array_equal(tscenes.mask2bbox(m), jscenes.mask2bbox(m))


def _same_item(got, want, atol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)
        else:
            assert got[k] == want[k], k


def test_objaverse_and_rendered_views_datasets(tmp_path):
    """After tests/test_scenes.py:195-248: the same draws give the same
    pairs; the rotation and quaternion algebra agrees to f32 rounding."""
    import cv2
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(4)
    data = {}
    for cls in ("x", "y"):
        data[cls] = {v: {"image": rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8),
                         "pose": np.hstack([Rotation.from_rotvec([0, np.deg2rad(10.0 * v), 0]).as_matrix(),
                                            [[0], [0], [1.0 + v * 0.1]]])} for v in range(3)}
    np.save(tmp_path / "pairs.npy", data, allow_pickle=True)
    jds = jscenes.ObjaverseV2PairDataset(str(tmp_path), "pairs.npy", seed=1)
    tds = tscenes.ObjaverseV2PairDataset(str(tmp_path), "pairs.npy", seed=1)
    for idx in (0, 1, 0):
        _same_item(tds[idx], jds[idx], atol=1e-6)

    obj = tmp_path / "objA"
    obj.mkdir()
    for i in range(11):
        cv2.imwrite(str(obj / f"{i:03d}.png"), rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8))
        pose = np.hstack([Rotation.from_rotvec([0, np.deg2rad(i * 8.0), 0]).as_matrix(), [[0], [0], [1.0]]])
        np.save(str(obj / f"{i:03d}.npy"), pose)
    (tmp_path / "classes.txt").write_text("objA\n")
    jrv = jscenes.RenderedViewsPairDataset(str(tmp_path), str(tmp_path / "classes.txt"), seed=3)
    trv = tscenes.RenderedViewsPairDataset(str(tmp_path), str(tmp_path / "classes.txt"), seed=3)
    for _ in range(3):
        _same_item(trv[0], jrv[0])


def test_mask_utils_equal_pope_tpu():
    rng = np.random.default_rng(7)
    mask = np.zeros((40, 50), np.uint8)
    mask[10:30, 15:35] = 1
    mask[5:9, 2:6] = 1
    poly = tmask.convert_mask_to_polygon(mask)
    np.testing.assert_array_equal(poly, jmask.convert_mask_to_polygon(mask))
    np.testing.assert_array_equal(tmask.convert_contour2mask(poly, 40, 50), jmask.convert_contour2mask(poly, 40, 50))
    img = rng.uniform(0, 255, (60, 120, 3)).astype(np.uint8)
    (a, sa), (b, sb) = tmask.common_resize(img, 240), jmask.common_resize(img, 240)
    np.testing.assert_array_equal(a, b)
    assert sa == sb
    np.testing.assert_array_equal(tmask.letterbox_image(img, (100, 90)), jmask.letterbox_image(img, (100, 90)))
    with pytest.raises(ValueError):
        tmask.convert_mask_to_polygon(np.zeros((8, 8), np.uint8))


def test_plotting_and_animator(tmp_path):
    """After tests/test_aux.py and tests/test_ssl.py:456."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from pope_tpu_torch.utils.animator import Animator

    rng = np.random.default_rng(8)
    err = rng.uniform(0, 1, 10)
    np.testing.assert_array_equal(tplot.error_colormap(err, 0.5), jplot.error_colormap(err, 0.5))
    for n in (0, 10, 500, 1500, 5000):
        assert tplot.dynamic_alpha(n) == jplot.dynamic_alpha(n)
    img = rng.uniform(0, 1, (32, 32)).astype(np.float32)
    mk = rng.uniform(0, 32, (10, 2)).astype(np.float32)
    out = tmp_path / "match.png"
    tplot.make_matching_figure(img, img, mk, mk, color=tplot.error_colormap(err, 0.5), text=["x"], path=str(out))
    assert out.stat().st_size > 1000
    an = Animator(xlabel="step", ylabel="loss", legend=["train", "val"])
    for i in range(5):
        an.add(i, [1.0 / (i + 1), 1.2 / (i + 1)])
    assert len(an.X[0]) == 5 and len(an.Y) == 2
    an.save(str(tmp_path / "curve.png"))
    an.close()
    assert (tmp_path / "curve.png").stat().st_size > 1000


def test_profilers(tmp_path):
    """The region timer counts as pope_tpu's does; sync_on takes tensors
    (a CPU tensor needs no wait); the trace profiler writes a trace."""
    prof, jprof = InferenceProfiler(), JaxProfiler()
    x, jx = torch.ones(16, 16), jnp.ones((16, 16))
    for p, a in ((prof, x), (jprof, jx)):
        with p.profile("matmul"):
            y = a @ a
        with p.profile("matmul", sync_on=y):
            y = a @ a
        with p.profile("other", sync_on={"y": y}):
            pass
    assert dict(prof.counts) == dict(jprof.counts) == {"matmul": 2, "other": 1}
    assert prof.summary().splitlines()[0] == jprof.summary().splitlines()[0]
    assert build_profiler(None).summary() == "(passthrough profiler)"
    assert isinstance(build_profiler("other"), PassThroughProfiler)
    tracer = build_profiler(f"trace:{tmp_path / 'tr'}")
    assert isinstance(tracer, TraceProfiler)
    with tracer.profile("region", sync_on=x):
        x @ x
    assert any((tmp_path / "tr").iterdir())


def test_load_torch_state_dict_matches_pope_tpu(tmp_path):
    sd = {"a.weight": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)), "a.bias": torch.zeros(3)}
    for name, obj, key in (("plain", sd, None), ("wrapped", {"state_dict": sd, "epoch": 3}, None),
                           ("model", {"model": sd}, None), ("custom", {"ema": sd, "model": {"x": 1}}, "ema")):
        path = tmp_path / f"{name}.pth"
        torch.save(obj, path)
        got, want = load_torch_state_dict(str(path), key), jax_load_torch(str(path), key)
        assert got.keys() == want.keys() == sd.keys(), name
        for k in sd:
            np.testing.assert_array_equal(got[k], want[k])


def test_regressor_load_ckpt_round_trip(tmp_path):
    from pope_tpu_torch.config import RegressorConfig
    from pope_tpu_torch.models.regressor.driver import load_ckpt
    from pope_tpu_torch.models.regressor.model import MkptsRegModel
    from pope_tpu_torch.models.regressor.train import create_train_state
    from pope_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = RegressorConfig(num_sample=8, d_model=16, nhead=2)
    torch.manual_seed(0)
    state = create_train_state(MkptsRegModel(cfg), cfg)
    state.step = 7
    save_checkpoint(str(tmp_path / "step_7"), state)
    torch.manual_seed(1)
    like = create_train_state(MkptsRegModel(cfg), cfg)
    assert load_ckpt(str(tmp_path / "step_7"), like) is like and like.step == 7
    for (k, a), b in zip(state.model.state_dict().items(), like.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_initialize_distributed_single_process():
    import torch.distributed as dist

    from pope_tpu_torch.parallel.collectives import get_rank, get_world_size, initialize_distributed

    assert initialize_distributed(device="cpu") is None
    assert initialize_distributed(device="cpu", num_processes=1) is None
    assert not dist.is_initialized()
    assert get_world_size() == 1 and get_rank() == 0
    with pytest.raises(RuntimeError):  # a multi-process intent with missing values
        initialize_distributed(device="cpu", num_processes=2)
