"""The port's SSL data pipeline, driver, CLI and evaluation protocols
against pope_tpu's: the samplers, crops, masks and collated batches byte
for byte, the resumable batch stream and its rank shards, `train_ssl` and
`cli train-ssl` from the same initial state, a killed and resumed run
against the unbroken one, and kNN, the linear probe and log regression."""

import dataclasses
import itertools
import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu.train.ssl_driver as jdriver
from pope_tpu import cli as jcli
from pope_tpu.config import DinoV2Config
from pope_tpu.data import samplers as jsamplers
from pope_tpu.data import ssl_crops as jcrops
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.train import ssl as jssl
from pope_tpu.train import ssl_eval as jeval
from pope_tpu_torch import cli
from pope_tpu_torch.data import samplers, ssl_crops
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.train import ssl as tssl
from pope_tpu_torch.train import ssl_driver, ssl_eval
from pope_tpu_torch.weights import dinov2_state_from_jax, params_state_from_jax, ssl_state_from_jax
from tests.test_torch_common import port_config, seeded_variables, to_jax
from tests.test_torch_ssl import _jax_state

T = torch.from_numpy
TINY_BB = DinoV2Config(embed_dim=32, depth=2, num_heads=2, patch_size=14, img_size=56)
TINY_SSL = jssl.SSLConfig(
    global_crop_size=56, local_crop_size=28, n_local_crops=2, dino_out_dim=32, ibot_out_dim=32,
    head_hidden_dim=24, head_bottleneck_dim=12, head_nlayers=2, head_dtype="float32", warmup_iters=2,
    total_iters=50, warmup_teacher_temp_iters=4, freeze_last_layer_iters=2, lr=1e-3,
)
# the driver's states after one effective update (step 0 is in warmup at
# lr 0): weights within 1e-6 where the first moment is above 1e-3 of its
# tensor's largest, within 2 lr elsewhere (gradients that are 0 in exact
# arithmetic, as tests/test_torch_ssl.py's step test explains); moments 2e-5
# of each tensor's largest
TOL_WEIGHTS = 1e-6
TOL_MOMENTS = 2e-5


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """Seven PNG images of two sizes in two folders."""
    root = tmp_path_factory.mktemp("ssl_images")
    rng = np.random.default_rng(0)
    for i in range(7):
        h, w = (72, 96) if i % 2 else (90, 64)
        yy, xx = np.mgrid[0:h, 0:w]
        img = (127 + 60 * np.sin(xx / rng.uniform(3, 9))[..., None] + rng.normal(0, 30, (h, w, 3)))
        sub = root / ("a" if i < 4 else "b")
        sub.mkdir(exist_ok=True)
        cv2.imwrite(str(sub / f"img_{i}.png"), np.clip(img, 0, 255).astype(np.uint8))
    return str(root)


# ---------------------------------------------------------------------------
# samplers, crops, masks, collate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["ShardedInfiniteSampler", "InfiniteSampler"])
@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, start=1, step=3, advance=17),
                                dict(seed=1, shuffle=False, start=0, step=2, advance=5)])
def test_samplers_match(cls, kw):
    a = list(itertools.islice(getattr(jsamplers, cls)(23, **kw), 60))
    b = list(itertools.islice(getattr(samplers, cls)(23, **kw), 60))
    assert a == b


def test_sharded_sampler_rank_shards_are_disjoint():
    per_rank = [list(itertools.islice(samplers.ShardedInfiniteSampler(24, seed=5, start=r, step=3), 8))
                for r in range(3)]
    flat = sum(per_rank, [])
    assert sorted(flat) == list(range(24))  # one iteration: every sample once across the ranks


def test_crops_masks_and_collate_bytes():
    cfg = dict(global_crop_size=56, local_crop_size=28, n_local_crops=3)
    samples = {}
    for name, mod in (("jax", jcrops), ("port", ssl_crops)):
        aug = mod.DataAugmentationDINO(mod.MultiCropConfig(**cfg), seed=4)
        imgs = [np.random.default_rng(i).integers(0, 255, (70 + 9 * i, 64, 3)).astype(np.uint8) for i in range(4)]
        samples[name] = [aug(im) for im in imgs]
        gen = mod.MaskingGenerator(input_size=4, seed=2)
        samples[name + "_masks"] = [gen(n) for n in (0, 3, 7, 12)]
        samples[name + "_batch"] = mod.collate_multicrop(samples[name], mod.MaskingGenerator(4, seed=5),
                                                         mask_ratio=(0.2, 0.6), mask_probability=0.5, seed=9)
    for a, b in zip(samples["jax"], samples["port"]):
        for key in ("global_crops", "local_crops"):
            for x, y in zip(a[key], b[key]):
                assert x.tobytes() == y.tobytes()
    for x, y in zip(samples["jax_masks"], samples["port_masks"]):
        assert x.tobytes() == y.tobytes()
    for key in ("global_crops", "local_crops", "masks"):
        assert samples["jax_batch"][key].tobytes() == samples["port_batch"][key].tobytes()
    assert samples["port_batch"]["masks"].any()


# ---------------------------------------------------------------------------
# the batch stream
# ---------------------------------------------------------------------------

STREAM_CFG = dataclasses.replace(TINY_SSL, global_crop_size=28, local_crop_size=14)


def _take(stream, n):
    return [next(stream) for _ in range(n)]


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), k


def test_ssl_batches_match_and_resume(image_root):
    """The port's stream is pope_tpu's byte for byte; advanced by 3 batches it
    is the unbroken stream from batch 3 (past an epoch boundary: 7 readable
    files, batches of 2); rank 1 of 2 is pope_tpu's rank 1."""
    kw = dict(cfg=STREAM_CFG, batch_size=2, seed=3, num_workers=2)
    ref = _take(jdriver.make_ssl_batches(image_root, **kw), 6)
    full = _take(ssl_driver.make_ssl_batches(image_root, **kw), 6)
    _same_batches(full, ref)
    _same_batches(_take(ssl_driver.make_ssl_batches(image_root, advance_batches=3, **kw), 3), full[3:])
    _same_batches(_take(ssl_driver.make_ssl_batches(image_root, rank=1, world=2, **kw), 3),
                  _take(jdriver.make_ssl_batches(image_root, rank=1, world=2, **kw), 3))
    with pytest.raises(FileNotFoundError):
        ssl_driver.make_ssl_batches(os.path.dirname(image_root) + "/missing", **kw)


def test_ssl_batches_skip_unreadable_files(image_root, tmp_path):
    """An unreadable file is skipped as pope_tpu skips it, advanced streams
    included. (Its stream position still counts, so a stream advanced past
    it is not the unbroken one's tail, in either package.)"""
    root = tmp_path / "imgs"
    shutil.copytree(image_root, root)
    (root / "b" / "broken.jpg").write_bytes(b"not an image")
    kw = dict(cfg=STREAM_CFG, batch_size=3, seed=1, num_workers=1)
    for adv in (0, 2):
        _same_batches(_take(ssl_driver.make_ssl_batches(str(root), advance_batches=adv, **kw), 3),
                      _take(jdriver.make_ssl_batches(str(root), advance_batches=adv, **kw), 3))


# ---------------------------------------------------------------------------
# train_ssl and the CLI against pope_tpu's, from the same initial state
# ---------------------------------------------------------------------------


def _use_seeded_init(monkeypatch):
    """Both packages' SSLMetaArch.init_state give the same state:
    tests/test_torch_ssl.py's seeded fill (LayerScale at O(1); the JAX init's
    1e-5 would leave the blocks' gradients within rounding of the heads'),
    keyed by the seed, carried to the port by the bridge."""
    init = jssl.SSLMetaArch.init_state

    def jax_init(self, rng):
        seed = int(jax.random.key_data(rng)[-1]) if jnp.issubdtype(rng.dtype, jax.dtypes.prng_key) else int(rng[-1])
        return jax.tree_util.tree_map(jnp.asarray, _jax_state(self, seed, init))

    def port_init(self, seed=0, device=None):
        arch = jssl.SSLMetaArch(jssl.SSLConfig(**dataclasses.asdict(self.cfg)),
                                DinoV2Config(**dataclasses.asdict(self.backbone_cfg)))
        state = self.state_from_student(self._build())
        return state.load_state_dict(ssl_state_from_jax(_jax_state(arch, seed, init)))

    monkeypatch.setattr(jssl.SSLMetaArch, "init_state", jax_init)
    monkeypatch.setattr(tssl.SSLMetaArch, "init_state", port_init)


def _named(tree) -> dict:
    return {k: v.numpy() for k, v in params_state_from_jax(jax.device_get(tree)).items()}


def _check_state(state, jstate, lr):
    assert state.step == int(jstate.step)
    sd = state.state_dict()
    mu = _named(jstate.mu)
    for key in ("mu", "nu"):
        for k, want in _named(getattr(jstate, key)).items():
            np.testing.assert_allclose(sd[key][k].numpy(), want, atol=TOL_MOMENTS * np.abs(want).max() + 1e-12,
                                       err_msg=f"{key}: {k}")
    for key, bound in (("student", 2 * lr), ("teacher", 2 * lr * 0.01)):
        for k, want in _named(getattr(jstate, key)).items():
            d = np.abs(sd[key][k].numpy() - want)
            ok = np.abs(mu[k]) > 1e-3 * np.abs(mu[k]).max()
            assert d.max() <= bound + TOL_WEIGHTS, (key, k, d.max())
            assert not ok.any() or d[ok].max() <= TOL_WEIGHTS, (key, k, d[ok].max())
    np.testing.assert_allclose(state.dino_center.numpy(), np.asarray(jstate.dino_center), atol=1e-5)
    np.testing.assert_allclose(state.ibot_center.numpy(), np.asarray(jstate.ibot_center), atol=1e-5)


def test_train_ssl_matches_pope_tpu(image_root, monkeypatch):
    _use_seeded_init(monkeypatch)
    kw = dict(batch_size=2, total_steps=2, seed=1)
    jstate = jdriver.train_ssl(image_root, TINY_SSL, TINY_BB, **kw)
    state = ssl_driver.train_ssl(image_root, tssl.SSLConfig(**dataclasses.asdict(TINY_SSL)), port_config(TINY_BB),
                                 device="cpu", **kw)
    _check_state(state, jstate, lr=float(jssl.ssl_schedules(TINY_SSL, 1)["lr"]))


def _tiny_cli(monkeypatch, module, head_kw):
    """`--arch vit_small` at the tiny width, with the tiny heads, in either
    package's driver (the head sizes are not CLI arguments)."""
    bb, ssl = module.DinoV2Config, module.SSLConfig
    monkeypatch.setattr(module, "DinoV2Config", lambda **kw: bb(**{**kw, "embed_dim": 32, "depth": 2, "num_heads": 2}))
    monkeypatch.setattr(module, "SSLConfig", lambda **kw: ssl(**{**kw, **head_kw}))


CLI_ARGS = ["train-ssl", "--arch", "vit_small", "--drop-path-rate", "0", "--global-crop-size", "56",
            "--local-crop-size", "28", "--n-local-crops", "2", "--batch-size", "2", "--total-steps", "2",
            "--lr", "1e-3", "--seed", "2"]
HEAD_KW = dict(dino_out_dim=32, ibot_out_dim=32, head_hidden_dim=24, head_bottleneck_dim=12, head_nlayers=2,
               head_dtype="float32")


def test_cli_train_ssl_matches_pope_tpu(image_root, tmp_path, monkeypatch):
    """Both CLIs with the same arguments (drop path off: torch cannot draw
    threefry's masks) from the same initial state; the port's checkpoints and
    sampler sidecar; --dp > 1 starts that many ranks on this host with its
    arguments (parallel.spawn, here recorded;
    tests/test_torch_parallel_train.py runs the sharded step)."""
    _use_seeded_init(monkeypatch)
    _tiny_cli(monkeypatch, jdriver, HEAD_KW)
    _tiny_cli(monkeypatch, ssl_driver, HEAD_KW)
    got = {}
    for name, module in (("jax", jdriver), ("port", ssl_driver)):
        run = module.train_ssl
        monkeypatch.setattr(module, "train_ssl", lambda *a, _run=run, _name=name, **k: got.setdefault(_name, _run(*a, **k)))
    jcli.main(CLI_ARGS + ["--image-root", image_root])
    ckpt = tmp_path / "ckpt"
    cli.main(CLI_ARGS + ["--image-root", image_root, "--device", "cpu", "--ckpt-dir", str(ckpt), "--ckpt-every", "1"])
    cfg = dataclasses.replace(TINY_SSL, warmup_iters=1, total_iters=2, warmup_teacher_temp_iters=1,
                              freeze_last_layer_iters=1)
    _check_state(got["port"], got["jax"], lr=float(jssl.ssl_schedules(cfg, 1)["lr"]))
    assert sorted(os.listdir(ckpt)) == ["sampler.json", "step_00000001", "step_00000002"]
    meta = json.loads((ckpt / "sampler.json").read_text())
    assert meta == {"seed": 2, "world": 1, "per_host_batch": 2, "consumed_batches": 2}
    import pope_tpu_torch.parallel as parallel

    spawned = []
    monkeypatch.setattr(parallel, "spawn", lambda fn, n, **kw: spawned.append((fn, n, kw)))
    cli.main(CLI_ARGS + ["--image-root", image_root, "--device", "cpu", "--dp", "2"])
    (fn, n, kw), = spawned
    assert n == 2 and kw["tp"] == 1 and kw["device"] == "cpu" and kw["argv"][1] is False


class _Killed(Exception):
    pass


def test_kill_and_resume_matches_the_unbroken_run(image_root, tmp_path, monkeypatch):
    """A run killed after its step-2 checkpoint, resumed from it, ends in the
    unbroken run's state bit for bit (the batch stream fast-forwards; the
    drop-path draws are keyed by the step)."""
    cfg = tssl.SSLConfig(**dataclasses.asdict(TINY_SSL))
    bcfg = port_config(dataclasses.replace(TINY_BB, drop_path_rate=0.3))
    kw = dict(batch_size=2, total_steps=4, ckpt_every=2, seed=4, device="cpu")
    unbroken = ssl_driver.train_ssl(image_root, cfg, bcfg, ckpt_dir=str(tmp_path / "a"), **kw)

    step = tssl.SSLMetaArch.train_step

    def dies_at_step_3(self, state, batch, **k):
        if state.step == 3:
            raise _Killed
        return step(self, state, batch, **k)

    monkeypatch.setattr(tssl.SSLMetaArch, "train_step", dies_at_step_3)
    with pytest.raises(_Killed):
        ssl_driver.train_ssl(image_root, cfg, bcfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert sorted(os.listdir(tmp_path / "b")) == ["sampler.json", "step_00000002"]
    monkeypatch.setattr(tssl.SSLMetaArch, "train_step", step)
    resumed = ssl_driver.train_ssl(image_root, cfg, bcfg, ckpt_dir=str(tmp_path / "b"), **kw)
    a, b = unbroken.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 4
    for key in ("student", "teacher", "mu", "nu"):
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert torch.equal(a["dino_center"], b["dino_center"]) and torch.equal(a["ibot_center"], b["ibot_center"])


# ---------------------------------------------------------------------------
# evaluation protocols
# ---------------------------------------------------------------------------


def test_extract_cls_features():
    variables = seeded_variables(JaxDino(TINY_BB), jnp.zeros((1, 56, 56, 3)), seed=3)
    port = DinoVisionTransformer(port_config(TINY_BB))
    port.load_state_dict(dinov2_state_from_jax(variables))
    images = np.random.default_rng(4).normal(0, 1, (5, 56, 56, 3)).astype(np.float32)
    ref = jeval.extract_cls_features(JaxDino(TINY_BB), to_jax(variables)["params"], images, batch_size=2)
    out = ssl_eval.extract_cls_features(port.eval(), images, batch_size=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _features(seed, n, d=8, classes=3, dup=True):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1, (n, d)).astype(np.float32)
    if dup:  # exact duplicates: equal similarities, so top-k ties
        f[1::3] = f[0::3][: len(f[1::3])]
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    return f, rng.integers(0, classes, n).astype(np.int32)


def test_knn_with_ties():
    trf, trl = _features(1, 30)
    tef, tel = _features(2, 9, dup=False)
    tef[0] = trf[0]  # a test feature equal to two training features
    ks = (1, 2, 5, 20)
    ref = jeval.knn_classify(jnp.asarray(trf), jnp.asarray(trl), jnp.asarray(tef), ks, 0.07, 3)
    out = ssl_eval.knn_classify(T(trf), T(trl), T(tef), ks, 0.07, 3)
    for k in ks:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=0, err_msg=str(k))
    assert ssl_eval.knn_accuracy(T(trf), T(trl), T(tef), T(tel), ks, 0.07) == \
        jeval.knn_accuracy(jnp.asarray(trf), jnp.asarray(trl), jnp.asarray(tef), jnp.asarray(tel), ks, 0.07)


def test_linear_probe_with_given_indices():
    """pope_tpu's batch indices (its scan's per-step randint draws) given to
    the port: the AdamW trajectory, its losses and the accuracy."""
    f, lab = _features(3, 40, dup=False)
    steps, bs, seed = 30, 16, 5
    ref, ref_losses = jeval.train_linear_probe(jnp.asarray(f), jnp.asarray(lab), 3, lr=0.05, weight_decay=1e-2,
                                               steps=steps, batch_size=bs, seed=seed)
    idx = np.stack([np.asarray(jax.random.randint(k, (bs,), 0, 40))
                    for k in jax.random.split(jax.random.PRNGKey(seed), steps)])
    out, losses = ssl_eval.train_linear_probe(T(f), T(lab), 3, lr=0.05, weight_decay=1e-2, steps=steps, batch_size=bs,
                                              indices=idx)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=0, err_msg=k)
    assert ssl_eval.linear_probe_accuracy(out, T(f), T(lab)) == jeval.linear_probe_accuracy(ref, jnp.asarray(f),
                                                                                          jnp.asarray(lab))
    _, drawn = ssl_eval.train_linear_probe(T(f), T(lab), 3, steps=4, batch_size=8, seed=1)
    assert drawn.shape == (4,) and np.isfinite(drawn).all()


def test_log_regression():
    trf, trl = _features(4, 36, dup=False)
    vf, vl = _features(5, 12, dup=False)
    l2 = (1e-4, 1e-2, 1.0)
    ref = jeval.log_regression_accuracy(jnp.asarray(trf), jnp.asarray(trl), jnp.asarray(vf), jnp.asarray(vl),
                                        l2_values=l2, steps=60, num_classes=3)
    out = ssl_eval.log_regression_accuracy(T(trf), T(trl), T(vf), T(vl), l2_values=l2, steps=60, num_classes=3)
    assert out == ref
