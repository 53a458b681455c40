"""The port's novel-view synthesis (pope_tpu_torch/nvs, utils/lpips.py,
utils/image_metrics.py) against pope_tpu's on the same seeded inputs and
weights, carried across by the weights bridge, with pope_tpu's random draws
given to the port: rays, encoding, volume rendering, importance sampling,
render_rays in f32 and bf16, train steps, render_image, the image metrics,
LPIPS and its converters, and the driver and `cli render-novel-view` on a
synthetic sphere."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu.nvs.driver as jnvs_driver
from pope_tpu.nvs import nerf as jnerf
from pope_tpu.utils import image_metrics as jmetrics
from pope_tpu.utils import lpips as jlpips
from pope_tpu_torch import cli
from pope_tpu_torch.nvs import driver as nvs_driver
from pope_tpu_torch.nvs import nerf
from pope_tpu_torch.utils import image_metrics, lpips
from pope_tpu_torch.weights import lpips_params_from_jax, nerf_state_from_jax
from tests.test_nvs import _look_at_pose, _render_sphere_view

T = torch.from_numpy
SMALL = jnerf.NerfConfig(hidden=32, depth=3, skip_at=2, n_coarse=16, n_fine=16, ray_batch=64, lr=2e-3,
                         dtype="float32")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_cfg(cfg):
    return nerf.NerfConfig(**dataclasses.asdict(cfg))


def _models(cfg, seed=0):
    """pope_tpu's field (params and optax state) and the port's with the same
    weights and moments."""
    jmodel, jstate = jnerf.init_nerf(cfg, jax.random.PRNGKey(seed))
    b = nerf_state_from_jax(jax.device_get(jstate))
    model = nerf.NerfMLP(_port_cfg(cfg))
    model.load_state_dict(b["model"], strict=True)
    return jmodel, jstate, model, nerf.NerfState(b["step"], b["mu"], b["nu"])


def _rays(seed, R):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.3, (R, 3)).astype(np.float32) + np.array([0, 0, -2.0], np.float32)
    d = rng.normal(0, 0.2, (R, 3)).astype(np.float32) + np.array([0, 0, 1.0], np.float32)
    return o, d


def _render_draws(rng, R, cfg):
    """render_rays' coarse and fine uniforms as pope_tpu draws them."""
    r1, r2 = jax.random.split(rng)
    return (np.asarray(jax.random.uniform(r1, (R, cfg.n_coarse))),
            np.asarray(jax.random.uniform(r2, (R, cfg.n_fine))))


def test_make_rays_and_encoding():
    K = np.array([[50.0, 0, 16], [0, 50.0, 12], [0, 0, 1]])
    pose = _look_at_pose(np.array([0.4, 0.3, -2.0]))
    for a, b in zip(nerf.make_rays(K, pose, (24, 32)), jnerf.make_rays(K, pose, (24, 32))):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
    x = np.random.default_rng(1).normal(0, 1, (5, 7, 3)).astype(np.float32)
    for n in (4, 10):
        np.testing.assert_allclose(nerf.positional_encoding(T(x), n).numpy(),
                                   np.asarray(jnerf.positional_encoding(jnp.asarray(x), n)), atol=2e-6, rtol=0)


@pytest.mark.parametrize("white", [False, True])
def test_volume_render(white):
    rng = np.random.default_rng(2)
    R, S = 6, 24
    ts = np.sort(rng.uniform(1, 3, (R, S)), axis=-1).astype(np.float32)
    sigma = rng.normal(0, 3, (R, S, 1)).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    dn = rng.uniform(0.8, 1.2, (R,)).astype(np.float32)
    ref = jnerf._volume_render(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(ts), jnp.asarray(dn), white)
    out = nerf._volume_render(T(sigma), T(rgb), T(ts), T(dn), white)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_sample_pdf_with_given_u():
    rng = np.random.default_rng(3)
    R, S, n = 8, 16, 12
    ts_mid = np.sort(rng.uniform(1, 3, (R, S - 1)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (R, S)).astype(np.float32)
    w[0] = 0.0  # an empty histogram: the 1e-5 floor makes it uniform
    w[1, 5] = 50.0  # one dominant bin
    key = jax.random.PRNGKey(4)
    ref = jnerf._sample_pdf(key, jnp.asarray(ts_mid), jnp.asarray(w), n)
    u = np.asarray(jax.random.uniform(key, (R, n)))
    out = nerf._sample_pdf(T(u), T(ts_mid), T(w), n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


# render_rays: f32 to the rounding of two libraries' products (colours in
# [0, 1], depths in [1, 3]; a fine sample's depth moves by the cumsum's
# rounding over its bin mass, so 1e-4, measured 3.8e-5); bf16: the hidden
# layers' products rounded to bf16 by both, a few bf16 ulps after three
# layers and the integration
TOL_RENDER = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("deterministic", [False, True])
def test_render_rays_with_jax_draws(dtype, deterministic):
    cfg = dataclasses.replace(SMALL, dtype=dtype)
    jmodel, jstate, model, _ = _models(cfg, seed=5)
    R = 40
    o, d = _rays(6, R)
    near, far = np.full((R,), 1.0, np.float32), np.full((R,), 3.0, np.float32)
    key = jax.random.PRNGKey(7)
    ref = jnerf.render_rays(jmodel, jstate.params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                            jnp.asarray(far), key, deterministic=deterministic)
    uc, uf = _render_draws(key, R, cfg)
    with torch.no_grad():
        out = nerf.render_rays(model, T(o), T(d), T(near), T(far), T(uc), T(uf), deterministic=deterministic)
    for k in ("rgb", "rgb_coarse", "depth"):
        np.testing.assert_allclose(out[k].float().numpy(), np.asarray(ref[k], np.float32), atol=TOL_RENDER[dtype],
                                   rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="Generator"):
        nerf.render_rays(model, T(o), T(d), T(near), T(far))


def _sphere_rays(n_views=3, hw=(16, 16)):
    K = np.array([[18.0, 0, 8], [0, 18.0, 8], [0, 0, 1]])
    os_, ds, cs = [], [], []
    for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        pose = _look_at_pose(np.array([1.6 * np.sin(a), 0.25, -1.6 * np.cos(a)]))
        o, d = jnerf.make_rays(K, pose, hw)
        os_.append(o.reshape(-1, 3))
        ds.append(d.reshape(-1, 3))
        cs.append(_render_sphere_view(K, pose, hw).reshape(-1, 3))
    return np.concatenate(os_), np.concatenate(ds), np.concatenate(cs).astype(np.float32)


def _train_draws(rng, n_steps, N, cfg):
    """train_nerf's per-step ray indices and uniforms as pope_tpu draws them."""
    out = {"idx": [], "u_coarse": [], "u_fine": []}
    for key in jax.random.split(rng, n_steps):
        r_idx, r_render = jax.random.split(key)
        out["idx"].append(np.asarray(jax.random.randint(r_idx, (cfg.ray_batch,), 0, N)))
        uc, uf = _render_draws(r_render, cfg.ray_batch, cfg)
        out["u_coarse"].append(uc)
        out["u_fine"].append(uf)
    return {k: np.stack(v) for k, v in out.items()}


def _fit_both(n_steps, seed=8):
    jmodel, jstate, model, state = _models(SMALL, seed=seed)
    o, d, c = _sphere_rays()
    key = jax.random.PRNGKey(9)
    jstate = jnerf.train_nerf(jmodel, jstate, jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), 0.9, 2.4, n_steps, key)
    nerf.train_nerf(model, state, T(o), T(d), T(c), 0.9, 2.4, n_steps, draws=_train_draws(key, n_steps, o.shape[0], SMALL))
    return jmodel, jstate, model, state, (o, d)


def test_train_nerf_with_jax_draws():
    """One Adam step from the same weights with pope_tpu's draws: the
    moments within 3e-3 of each tensor's largest (the gradients differ where
    a fine sample's place differs: the inverse CDF divides the cumsum's
    rounding by bin masses down to 1e-5; measured 1.5e-3), the weights
    within 2e-6 where the first moment is above 1e-3 of its tensor's largest
    and within 2 lr elsewhere (gradients that are 0 in exact arithmetic,
    which Adam normalises to +-lr on both sides)."""
    _, jstate, model, state, _ = _fit_both(1)
    want = nerf_state_from_jax(jax.device_get(jstate))
    assert state.step == want["step"] == 1
    for key_ in ("mu", "nu"):
        for k, w in want[key_].items():
            got, w = getattr(state, key_)[k].numpy(), w.numpy()
            np.testing.assert_allclose(got, w, atol=3e-3 * np.abs(w).max() + 1e-12, rtol=0, err_msg=f"{key_}: {k}")
    sd = model.state_dict()
    for k, w in want["model"].items():
        dlt = np.abs(sd[k].numpy() - w.numpy())
        mu = np.abs(want["mu"][k].numpy())
        ok = mu > 1e-3 * mu.max()
        assert dlt.max() <= 2 * SMALL.lr, (k, dlt.max())
        assert not ok.any() or dlt[ok].max() <= 2e-6, (k, dlt[ok].max())
    nerf.train_nerf(model, state, *(T(a) for a in _sphere_rays()), 0.9, 2.4, 1, generator=torch.Generator())
    assert state.step == 2


def test_train_nerf_trajectories_track():
    """Four steps with pope_tpu's draws: the near-zero gradients' +-lr steps
    make the weights drift apart, and the drift feeds the later gradients,
    but the fields render the same rays within 3e-2 in colour and 1e-1 in
    depth (depths 0.9-2.4; measured 1.1e-2 and 2.7e-2)."""
    jmodel, jstate, model, _, (o, d) = _fit_both(4)
    R = 64
    ro, rd = o[::7][:R], d[::7][:R]
    near, far = np.full((R,), 0.9, np.float32), np.full((R,), 2.4, np.float32)
    key = jax.random.PRNGKey(0)
    ref = jnerf.render_rays(jmodel, jstate.params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near),
                            jnp.asarray(far), key, deterministic=True)
    with torch.no_grad():
        out = nerf.render_rays(model, T(ro), T(rd), T(near), T(far), u_fine=T(_render_draws(key, R, SMALL)[1]),
                               deterministic=True)
    for k, tol in (("rgb", 3e-2), ("rgb_coarse", 3e-2), ("depth", 1e-1)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=tol, rtol=0, err_msg=k)


def test_render_image_with_jax_fine_draws():
    """pope_tpu's render_image draws its fine-pass u from PRNGKey(0) (the
    same draw for every chunk); given it, the port renders the same image."""
    cfg = SMALL
    jmodel, jstate, model, _ = _models(cfg, seed=10)
    K = np.array([[20.0, 0, 10], [0, 20.0, 9], [0, 0, 1]])
    pose = _look_at_pose(np.array([0.3, 0.2, -1.7]))
    chunk = 128
    ref = jnerf.render_image(jmodel, jstate.params, K, pose, (18, 20), 0.9, 2.4, chunk=chunk)
    _, uf = _render_draws(jax.random.PRNGKey(0), chunk, cfg)
    out = nerf.render_image(model, K, pose, (18, 20), 0.9, 2.4, chunk=chunk, u_fine=uf)
    assert out.shape == (18, 20, 3)
    np.testing.assert_allclose(out, ref, atol=TOL_RENDER["float32"], rtol=0)


def test_image_metrics():
    rng = np.random.default_rng(11)
    a = rng.uniform(0, 1, (24, 20, 3))
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1)
    assert image_metrics.psnr(a, a) == float("inf")
    assert image_metrics.psnr(b, a) == jmetrics.psnr(b, a)
    assert image_metrics.ssim(b, a) == jmetrics.ssim(b, a)
    assert image_metrics.ssim(b[..., 0], a[..., 0]) == jmetrics.ssim(b[..., 0], a[..., 0])


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------


def _released_layouts(params):
    """The JAX tree in the two released files' raw layouts."""
    alex = {}
    for i, (name, *_r) in zip((0, 3, 6, 8, 10), jlpips._STAGES):
        alex[f"features.{i}.weight"] = params["features"][name]["kernel"].transpose(3, 2, 0, 1).copy()
        alex[f"features.{i}.bias"] = params["features"][name]["bias"]
    lins = {f"lin{i}.model.1.weight": params["lins"][f"lin{i}"].reshape(1, -1, 1, 1).copy() for i in range(5)}
    return alex, lins


def _lpips_images(seed, n=2, hw=(64, 72)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n,) + hw + (3,)).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.15, a.shape), 0, 1).astype(np.float32)


def test_lpips_distance_with_bridged_params():
    jparams = jlpips.init_random_params(3)
    params = lpips_params_from_jax(jparams)
    seeded = lpips.init_random_params(3)  # the same numbers from the same seed
    for name in params["features"]:
        for k in ("weight", "bias"):
            assert torch.equal(params["features"][name][k], seeded["features"][name][k])
    a, b = _lpips_images(4)
    ref = np.asarray(jlpips.lpips_distance(jparams, a, b))
    out = lpips.lpips_distance(params, a, b).numpy()
    assert out.shape == (2,) and (out > 0).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lpips.lpips_distance(params, a, a).numpy(), 0.0, atol=1e-7)


def test_lpips_converters_and_files(tmp_path):
    jparams = jlpips.init_random_params(5)
    alex, lins = _released_layouts(jparams)
    alex["classifier.1.weight"] = np.zeros((4, 9216), np.float32)  # torchvision's head: allowed, ignored
    feats = lpips.convert_alexnet_features(alex)
    heads = lpips.convert_lpips_lins(lins)
    bridged = lpips_params_from_jax(jparams)
    for name in feats:
        assert torch.equal(feats[name]["weight"], bridged["features"][name]["weight"])
    for k in heads:
        assert torch.equal(heads[k], bridged["lins"][k])
    torch.save({k: T(v) for k, v in alex.items()}, tmp_path / "alexnet.pth")
    torch.save({k: T(v) for k, v in lins.items()}, tmp_path / "alex.pth")
    loaded = lpips.lpips_from_torch_files(str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth"))
    a, b = _lpips_images(6, n=1)
    np.testing.assert_allclose(lpips.lpips_distance(loaded, a, b).numpy(),
                               np.asarray(jlpips.lpips_distance(jparams, a, b)), rtol=1e-5)

    bad = dict(alex)
    del bad["features.0.bias"]
    bad["features.3.weight"] = bad["features.3.weight"][:, :10]
    bad["features.99.weight"] = np.zeros(3, np.float32)
    with pytest.raises(lpips.LpipsStateMismatch) as err:
        lpips.convert_alexnet_features(bad)
    msg = str(err.value)
    assert "3 problem(s)" in msg and "missing key: features.0.bias" in msg
    assert "shape mismatch: features.3.weight" in msg and "unknown key: features.99.weight" in msg
    with pytest.raises(lpips.LpipsStateMismatch, match="unknown key: classifier"):
        lpips.convert_lpips_lins({**lins, "classifier.1.weight": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------------
# the driver and the CLI on a 40 x 40 sphere
# ---------------------------------------------------------------------------

HW = (40, 40)
K40 = np.array([[45.0, 0, 20], [0, 45.0, 20], [0, 0, 1]])
DRIVER_CFG = jnerf.NerfConfig(hidden=32, depth=3, skip_at=2, n_coarse=16, n_fine=16, ray_batch=256, lr=2e-3,
                              dtype="float32")


@pytest.fixture(scope="module")
def sphere_seq(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("lm") / "seq"
    for sub in ("color", "poses_ba", "intrin_ba"):
        (root / sub).mkdir(parents=True)
    for i, a in enumerate(np.linspace(0, 2 * np.pi, 6, endpoint=False)):
        pose = _look_at_pose(np.array([1.6 * np.sin(a), 0.25, -1.6 * np.cos(a)]))
        img = _render_sphere_view(K40, pose, HW)
        cv2.imwrite(str(root / "color" / f"{i}.png"), (img[..., ::-1] * 255).astype(np.uint8))
        np.savetxt(str(root / "poses_ba" / f"{i}.txt"), pose)
        np.savetxt(str(root / "intrin_ba" / f"{i}.txt"), K40)
    return str(root)


def test_render_novel_views_matches_pope_tpu(sphere_seq, tmp_path, monkeypatch):
    """Both drivers fit 5 source views for 30 steps and render view 3; the
    port starts from pope_tpu's field and takes its draws (ray batches from
    PRNGKey(seed + 1), render_image's fine u from PRNGKey(0)). PSNR within
    0.05 dB, SSIM within 2e-3, LPIPS (seeded parameters) within 1e-3, the jpg
    pairs written, the ground truths equal and the renders within 10 of 255
    and 1 on average (30 steps of the drift test_train_nerf_trajectories_track
    measures; measured 4)."""
    steps, seed = 30, 0
    kw = dict(source_ids=[0, 1, 2, 4, 5], target_ids=[3], label="lm-test", train_steps=steps, seed=seed)
    ref = jnvs_driver.render_novel_views(sphere_seq, out_dir=str(tmp_path / "jax"), cfg=DRIVER_CFG,
                                         lpips_params=jlpips.init_random_params(0), **kw)

    def jax_init(cfg, seed_, device=None):
        _, jstate = jnerf.init_nerf(DRIVER_CFG, jax.random.PRNGKey(seed_))
        b = nerf_state_from_jax(jax.device_get(jstate))
        model = nerf.NerfMLP(cfg)
        model.load_state_dict(b["model"])
        return model.to(device), nerf.NerfState(b["step"], b["mu"], b["nu"])

    real_train, real_render = nerf.train_nerf, nerf.render_image

    def train_with_jax_draws(model, state, rays_o, *a, generator=None, **k):
        draws = _train_draws(jax.random.PRNGKey(seed + 1), steps, rays_o.shape[0], DRIVER_CFG)
        return real_train(model, state, rays_o, *a, draws=draws, **k)

    def render_with_jax_u(model, *a, **k):
        return real_render(model, *a, u_fine=_render_draws(jax.random.PRNGKey(0), 4096, DRIVER_CFG)[1], **k)

    monkeypatch.setattr(nvs_driver, "init_nerf", jax_init)
    monkeypatch.setattr(nvs_driver, "train_nerf", train_with_jax_draws)
    monkeypatch.setattr(nvs_driver, "render_image", render_with_jax_u)
    out = nvs_driver.render_novel_views(sphere_seq, out_dir=str(tmp_path / "port"), cfg=_port_cfg(DRIVER_CFG),
                                        lpips_params=lpips.init_random_params(0), device="cpu", **kw)
    (idx, p, s, lp), = out
    (_, p_ref, s_ref, lp_ref), = ref
    assert idx == 3 and abs(p - p_ref) < 0.05 and abs(s - s_ref) < 2e-3 and abs(lp - lp_ref) < 1e-3
    import cv2

    for name in ("lm-test_gt_pose_3.jpg", "lm-test_gt_3.jpg"):
        a = cv2.imread(str(tmp_path / "port" / name)).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / name)).astype(int)
        assert a.shape == (40, 40, 3), name
        if "pose" in name:
            assert np.abs(a - b).max() <= 10 and np.abs(a - b).mean() <= 1.0, name
        else:
            assert np.array_equal(a, b), name


def test_cli_render_novel_view(sphere_seq, tmp_path, monkeypatch):
    """`cli render-novel-view --device cpu`: a short fit with the CLI's own
    draws beats a mean-colour image of the held-out view and writes the jpg
    pair; half the LPIPS pair is an error."""
    args = ["render-novel-view", "--seq-root", sphere_seq, "--source-ids", "0,1,2,4,5", "--target-ids", "3",
            "--out-dir", str(tmp_path), "--label", "cli", "--train-steps", "120", "--device", "cpu"]
    got = []
    run = nvs_driver.render_novel_views
    monkeypatch.setattr(nvs_driver, "render_novel_views",
                        lambda *a, **k: got.append(run(*a, **{**k, "cfg": _port_cfg(DRIVER_CFG)})) or got[-1])
    cli.main(args)
    (idx, p, s), = got[0]
    import cv2

    gt = cv2.imread(os.path.join(sphere_seq, "color", "3.png"))[..., ::-1].astype(np.float32) / 255.0
    assert p > image_metrics.psnr(np.broadcast_to(gt.mean((0, 1)), gt.shape), gt) + 3.0, p
    assert sorted(os.listdir(tmp_path)) == ["cli_gt_3.jpg", "cli_gt_pose_3.jpg"]
    with pytest.raises(SystemExit, match="together"):
        cli.main(args + ["--lpips-lins", "x.pth"])
