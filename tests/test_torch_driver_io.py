"""The eval driver's small modules in the port against pope_tpu's (or cv2):
image_io, ThreadedLoader, the metrics / manifest / state-manifest copies,
the runner's host helpers and per-pair noise, the bench's FLOP budget, the
entry points' refusal to run without a GPU unless asked for the CPU, and the
import boundary (nothing of JAX, flax or pope_tpu)."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import pope_tpu.eval.manifest as jax_manifest
import pope_tpu.pipeline.runner as jax_runner
import pope_tpu.utils.metrics as jax_metrics
import pope_tpu.utils.state_manifest as jax_state_manifest
import pope_tpu_torch.eval.manifest as port_manifest
import pope_tpu_torch.utils.metrics as port_metrics
from pope_tpu.data.loader import ThreadedLoader as JaxLoader
from pope_tpu_torch import bench
from pope_tpu_torch.data import ThreadedLoader
from pope_tpu_torch.data.image_io import read_rgb, write_rgb
from pope_tpu_torch.pipeline import load_models, runner
from pope_tpu_torch.utils import state_manifest
from pope_tpu_torch.utils.state_manifest import StateDictMismatch, synthesize_state_dict
from tests.test_torch_common import port_config

REPO = Path(__file__).resolve().parents[1]


# --- image_io ---------------------------------------------------------------


def test_read_rgb_is_cv2_bgr2rgb(tmp_path):
    """Colour, gray and RGBA PNGs written by cv2: read_rgb gives what the JAX
    runner's cv2.cvtColor(cv2.imread(p), BGR2RGB) gives."""
    rng = np.random.default_rng(0)
    for name, img in (("bgr", rng.integers(0, 256, (37, 53, 3))), ("gray", rng.integers(0, 256, (20, 31))),
                      ("bgra", rng.integers(0, 256, (16, 17, 4)))):
        p = str(tmp_path / f"{name}.png")
        cv2.imwrite(p, img.astype(np.uint8))
        out = read_rgb(p)
        assert out.shape == img.shape[:2] + (3,) and out.dtype == np.uint8
        np.testing.assert_array_equal(out, cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB))
    with pytest.raises(FileNotFoundError):
        read_rgb(str(tmp_path / "missing.png"))


def test_write_rgb_writes_what_cv2_writes(tmp_path):
    """write_rgb(rgb) is cv2.imwrite(bgr) byte for byte (bench.py's files),
    and reads back as the frame."""
    rgb = np.random.default_rng(1).integers(0, 256, (48, 64, 3)).astype(np.uint8)
    write_rgb(str(tmp_path / "port.png"), rgb)
    cv2.imwrite(str(tmp_path / "cv2.png"), rgb[..., ::-1].copy())
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "cv2.png").read_bytes()
    np.testing.assert_array_equal(read_rgb(str(tmp_path / "port.png")), rgb)


def test_make_dataset_matches_bench_py(tmp_path):
    """The port's bench dataset: bench.py's files, byte for byte."""
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    a, b = tmp_path / "port", tmp_path / "jax"
    bench.make_dataset(str(a), n_pairs=2)
    root_bench.make_dataset(str(b), n_pairs=2)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()) and len(files) == 14
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


# --- ThreadedLoader -----------------------------------------------------------


def _slow_square(x):
    time.sleep(0.002 * ((7 * x) % 5))  # out-of-order completion across workers
    return x * x


@pytest.mark.parametrize("workers", [1, 3, 16])
def test_loader_keeps_order(workers):
    """Results in source order, as the JAX loader gives them, with more
    workers than cores and a short switch interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = list(ThreadedLoader(lambda: range(60), num_workers=workers, prefetch=2, fn=_slow_square))
    finally:
        sys.setswitchinterval(old)
    ref = list(JaxLoader(lambda: range(60), num_workers=workers, prefetch=2, fn=_slow_square))
    assert got == ref == [x * x for x in range(60)]


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("where", ["fn", "source"])
def test_loader_raises_at_the_consumer(workers, where):
    """An error in `fn` or in the source reaches the consumer after the items
    before it."""

    def source():
        for i in range(10):
            if where == "source" and i == 5:
                raise ValueError("source failed")
            yield i

    def fn(x):
        if where == "fn" and x == 5:
            raise ValueError("fn failed")
        return x

    got = []
    with pytest.raises(ValueError, match=f"{where} failed"):
        for item in ThreadedLoader(source, num_workers=workers, prefetch=2, fn=fn):
            got.append(item)
    assert got == list(range(5))


def test_loader_threads_end():
    before = threading.active_count()
    assert list(ThreadedLoader(lambda: range(5), num_workers=3, fn=lambda x: x)) == list(range(5))
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


# --- metrics, manifest, state-manifest copies ------------------------------------


def test_metrics_copy_matches_jax():
    rng = np.random.default_rng(2)
    errs = rng.uniform(0, 40, 37)
    epi = [rng.uniform(0, 1e-3, n) for n in (5, 0, 12)]
    m = {"R_errs": errs, "t_errs": errs[::-1], "identifiers": [str(i) for i in range(37)], "epi_errs": epi}
    for name in ("aggregate_metrics", "aggregate_metrics_mean"):
        port, ref = getattr(port_metrics, name)(m), getattr(jax_metrics, name)(m)
        assert list(port) == list(ref) and port == ref
    assert port_metrics.error_acc("R", errs, [2, 7]) == jax_metrics.error_acc("R", errs, [2, 7])
    assert port_metrics.epidist_prec(epi, [1e-4, 5e-4]) == jax_metrics.epidist_prec(epi, [1e-4, 5e-4])
    for a, b in ((rng.integers(0, 50, 4), rng.integers(0, 50, 4)) for _ in range(10)):
        a, b = np.sort(a.reshape(2, 2), 0).ravel(), np.sort(b.reshape(2, 2), 0).ravel()
        assert port_metrics.recall_object(a, b) == jax_metrics.recall_object(a, b)


@pytest.mark.parametrize("dataset", sorted(jax_manifest.DATASETS))
def test_manifest_copy_matches_jax(dataset, tmp_path):
    """Specs and resolved pair paths (YCB-Video's 'png-' split and stride 2
    included) equal pope_tpu's."""
    assert dataclasses.asdict(port_manifest.DATASETS[dataset]) == dataclasses.asdict(jax_manifest.DATASETS[dataset])
    spec = port_manifest.DATASETS[dataset]
    sep = "png-" if spec.split_on == "png-" else "-"
    frames = [(f"{i:06d}-a.png" if sep == "png-" else f"{i}.png") for i in range(7)]
    names = [f"obj{o}/seq/color/{frames[i]}{sep[3:] if sep == 'png-' else sep}{frames[i + 1]}"
             for o in range(2) for i in range(6)]
    manifest = [{"0": names[:6], "1": names[6:]}]
    with open(tmp_path / spec.manifest, "w") as f:
        json.dump(manifest, f)
    port = list(port_manifest.iter_pairs("data", spec, port_manifest.load_manifest(str(tmp_path), spec)))
    ref = list(jax_manifest.iter_pairs("data", jax_manifest.DATASETS[dataset], manifest))
    assert [tuple(p) for p in port] == [tuple(r) for r in ref]
    assert len(port) == (6 if spec.stride == 2 else 12)


@pytest.mark.parametrize("name", sorted(jax_state_manifest.MANIFESTS))
def test_state_manifests_are_copies(name):
    assert state_manifest.load_state_manifest(name) == jax_state_manifest.load_state_manifest(name)
    assert Path(state_manifest.MANIFESTS[name]).is_relative_to(REPO / "pope_tpu_torch")


def _save(sd, path):
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return str(path)


def test_load_models_checks_the_dinov2_manifest(tmp_path):
    """A file with the released vits14 inventory loads; one key renamed or
    one shape changed raises StateDictMismatch before conversion."""
    sd = synthesize_state_dict("dinov2_vits14")
    models = load_models(dinov2_checkpoint=_save(sd, tmp_path / "ok.pth"), components=("dinov2",), device="cpu")
    assert models.dinov2 is not None and models.sam is None
    assert float(models.dinov2.pos_embed.detach().abs().sum()) == 0.0  # the file's zeros, not a seeded init
    renamed = dict(sd)
    renamed["blocks.0.attn.qkv.weightx"] = renamed.pop("blocks.0.attn.qkv.weight")
    reshaped = dict(sd)
    reshaped["norm.weight"] = np.zeros((385,), np.float32)
    for bad, what in ((renamed, "missing keys"), (reshaped, "shape mismatches")):
        with pytest.raises(StateDictMismatch, match=what):
            load_models(dinov2_checkpoint=_save(bad, tmp_path / "bad.pth"), components=("dinov2",), device="cpu")


def test_load_models_checks_the_sam_and_matcher_manifests(tmp_path):
    """The SAM and matcher checks run before any conversion: a file missing
    one key of each inventory raises naming it."""
    for name, kw in (("sam_vit_b", dict(sam_checkpoint=None, sam_type="b", components=("sam",))),
                     ("matcher", dict(matcher_checkpoint=None, components=("matcher",)))):
        sd = synthesize_state_dict(name)
        dropped = sorted(sd)[3]
        del sd[dropped]
        path = _save(sd, tmp_path / f"{name}.pth")
        kw = {k: (path if v is None else v) for k, v in kw.items()}
        with pytest.raises(StateDictMismatch, match=dropped.replace(".", r"\.")):
            load_models(device="cpu", **kw)


# --- runner host helpers and per-pair noise ---------------------------------------


def test_runner_host_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    R, _ = cv2.Rodrigues(rng.uniform(-0.5, 0.5, 3))
    pose0 = np.hstack([np.eye(3), [[0.1], [0.0], [0.6]]])
    pose1 = np.hstack([R, [[0.02], [0.01], [0.7]]])
    for name, pose in (("p0.txt", pose0), ("p1.txt", np.vstack([pose1, [0, 0, 0, 1]]))):
        np.savetxt(tmp_path / name, pose)
    p0, p1 = (runner.load_pose_4x4(str(tmp_path / n)) for n in ("p0.txt", "p1.txt"))
    np.testing.assert_array_equal(p0, jax_runner.load_pose_4x4(str(tmp_path / "p0.txt")))
    T = runner.relative_pose_np(p0, p1)
    np.testing.assert_array_equal(T, jax_runner.relative_pose_np(p0, p1))
    Rt, _ = cv2.Rodrigues(rng.uniform(-0.5, 0.5, 3))
    t = rng.normal(0, 1, 3).astype(np.float32)
    assert runner.pose_errors_np(T, Rt.astype(np.float32), t) == jax_runner.pose_errors_np(T, Rt.astype(np.float32), t)
    K0 = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]])
    K1 = np.array([[300.0, 0, 128], [0, 300, 128], [0, 0, 1]])
    m0, m1 = rng.uniform(0, 400, (30, 2)), rng.uniform(0, 256, (30, 2))
    np.testing.assert_array_equal(runner.epipolar_errors_np(T, m0, m1, K0, K1),
                                  jax_runner.epipolar_errors_np(T, m0, m1, K0, K1))
    corners = np.array([[x, y, z] for x in (-0.05, 0.05) for y in (-0.05, 0.05) for z in (-0.05, 0.05)])
    np.savetxt(tmp_path / "box.txt", corners)
    np.testing.assert_array_equal(runner.gt_bbox_from_box3d(str(tmp_path / "box.txt"), p1, K0),
                                  jax_runner.gt_bbox_from_box3d(str(tmp_path / "box.txt"), p1, K0))
    assert runner.gt_bbox_from_box3d(str(tmp_path / "none.txt"), p1, K0) is None
    small, matches = rng.normal(0, 1, 29).astype(np.float32), rng.normal(0, 1, (16, 6)).astype(np.float32)
    port, ref = runner._unpack_record(small, matches), jax_runner._unpack_record(small, matches)
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])


def _paths(*names):
    return [types.SimpleNamespace(pair_name=n) for n in names]


def test_pair_seed_and_noise_are_per_pair():
    """pair_seed is the seed of the JAX runner's per-pair key; a pair's noise
    does not depend on the other pairs of its batch or its place in it."""
    names = ("obj/seq/color/1.png-101.png", "obj/seq/color/2.png-102.png", "x")
    keys = jax_runner.pair_keys_np(_paths(*names))
    assert [runner.pair_seed(n) for n in names] == keys[:, 1].tolist() and not keys[:, 0].any()
    both = runner.pair_noise(_paths(names[0], names[1]), 16, 3, "cpu")
    assert both.shape == (2, 3, runner.N_HYPS, 16) and both.dtype == torch.float32
    torch.testing.assert_close(runner.pair_noise(_paths(names[1]), 16, 3, "cpu")[0], both[1], rtol=0, atol=0)
    torch.testing.assert_close(runner.pair_noise(_paths(names[2], names[0]), 16, 3, "cpu")[1], both[0], rtol=0, atol=0)
    assert not torch.equal(both[0], both[1])


# --- the bench's FLOP budget --------------------------------------------------------


@pytest.mark.parametrize("which", ["bench", "default"])
def test_flop_budget_matches_bench_py(which):
    """The port's flop_budget equals the root bench.py's on the same configs
    (bench.py's own, 5.553 model TFLOP per pair, and PipelineConfig())."""
    from pope_tpu.config import AMGConfig, CoarseMatchConfig, DinoV2Config, MatcherConfig, PipelineConfig
    from pope_tpu.config import SamConfig, SamEncoderConfig

    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    if which == "bench":
        cfg = PipelineConfig(
            matcher=MatcherConfig(match_coarse=CoarseMatchConfig(match_capacity=512), dtype="bfloat16"),
            dinov2=DinoV2Config(dtype="bfloat16"), sam=SamConfig(encoder=SamEncoderConfig.vit_h()), amg=AMGConfig(),
        )
        assert port_config(cfg) == bench.bench_config()
    else:
        cfg = PipelineConfig()
    ref = root_bench.flop_budget(types.SimpleNamespace(config=cfg))
    assert bench.flop_budget(types.SimpleNamespace(config=port_config(cfg))) == ref
    if which == "bench":
        assert round(ref["total_per_pair"] / 1e12, 3) == 5.553


# --- entry points need a GPU unless asked for the CPU --------------------------------


def test_entry_points_need_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.prepare_batch([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_models(components=("dinov2",))
    with pytest.raises(SystemExit, match="cuda"):
        bench.main(n_reps=1)


# --- import boundary ------------------------------------------------------------------

_BOUNDARY = r"""
import importlib, importlib.abc, pkgutil, sys
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "pope_tpu")
for m in list(sys.modules):
    if m.split(".")[0] in BANNED:
        del sys.modules[m]

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError(f"the port imported {name}")

sys.meta_path.insert(0, Refuse())
import pope_tpu_torch
names = ["pope_tpu_torch"] + [m.name for m in pkgutil.walk_packages(pope_tpu_torch.__path__, "pope_tpu_torch.")]
names += ["pope_tpu_torch.tools.ablate_kernels", "pope_tpu_torch.tools.launch_overhead",
          "pope_tpu_torch.tools.step_pace", "chip_smoke"]
for name in names:
    importlib.import_module(name)
serving = ["pope_tpu_torch.serve", "pope_tpu_torch.serve.pose_service", "pope_tpu_torch.serve.web_demo",
           "pope_tpu_torch.export", "pope_tpu_torch.models.sam.predictor"]
training = ["pope_tpu_torch.train." + m for m in ("supervision", "loss", "optim", "trainer", "matcher_driver")]
training += ["pope_tpu_torch.data.readers", "pope_tpu_torch.data.scenes", "pope_tpu_torch.utils.checkpoint"]
regressor = ["pope_tpu_torch.models.regressor." + m for m in (
    "embedding", "convnextv2", "vim", "model", "dinov2_poser", "convert", "train", "data", "driver")]
regressor += ["pope_tpu_torch.eval.extract", "pope_tpu_torch.geometry.pose", "pope_tpu_torch.weights",
              "pope_tpu_torch.ops.flash_attention", "pope_tpu_torch.ops.window_attention"]
ssl_nvs = ["pope_tpu_torch.train." + m for m in ("ssl", "ssl_driver", "ssl_eval")]
ssl_nvs += ["pope_tpu_torch.data.samplers", "pope_tpu_torch.data.ssl_crops", "pope_tpu_torch.utils.logging",
            "pope_tpu_torch.utils.image_metrics", "pope_tpu_torch.utils.lpips", "pope_tpu_torch.nvs",
            "pope_tpu_torch.nvs.nerf", "pope_tpu_torch.nvs.driver"]
parallel = ["pope_tpu_torch.parallel." + m for m in ("launch", "collectives", "mesh", "pipeline")]
parallel += ["pope_tpu_torch.parallel", "pope_tpu_torch.ops.ring_attention"]
assert "pope_tpu_torch.bench" in names and "pope_tpu_torch.cli" in names
assert set(serving + training + regressor + ssl_nvs + parallel) <= set(names)
leaked = [m for m in sys.modules if m.split(".")[0] in BANNED]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_nothing_of_jax():
    """Every module of pope_tpu_torch (its bench, CLI, serving modules,
    exports, predictor, training modules, the pose regressor and the
    extraction, SSL training and evaluation, the NeRF and LPIPS, the
    parallel layer and ring attention included), its tools and
    chip_smoke.py import in a process that refuses jax, flax, optax, orbax
    and pope_tpu."""
    out = subprocess.run([sys.executable, "-c", _BOUNDARY], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 40
