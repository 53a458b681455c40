"""The port's remaining device functions against pope_tpu on the same
seeded inputs: Kabsch / Umeyama, the fundamental matrix and DLT
triangulation with the host extras, the affine helpers (warpAffine, box
expansion and clamping, the numpy transform), category-aware NMS, the
components' roots and areas, and the module-level estimate_pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu.geometry.affine as jaff
import pope_tpu.geometry.extras as jext
import pope_tpu_torch.geometry.affine as taff
import pope_tpu_torch.geometry.extras as text
from pope_tpu.ops.components import component_roots_and_areas as jax_roots_areas
from pope_tpu.ops.components import label_components as jax_label
from pope_tpu.ops.nms import batched_nms as jax_batched_nms
from pope_tpu.solver.umeyama import kabsch as jax_kabsch
from pope_tpu.solver.umeyama import umeyama_alignment as jax_umeyama
from pope_tpu_torch.ops.components import component_roots_and_areas, label_components
from pope_tpu_torch.ops.nms import batched_nms
from pope_tpu_torch.pipeline import PipelineExecutor, estimate_pair
from pope_tpu_torch.solver import kabsch, recover_pose_from_E, umeyama_alignment
from tests.test_torch_pipeline import B, CROP, _inputs, models  # noqa: F401 (the fixture)
from tests.test_torch_solver import jax_noise

T = torch.from_numpy
TOL = 2e-5  # f32 of the same computation in another order, O(1) values


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q * np.linalg.det(q)


def test_kabsch_and_umeyama_match_jax():
    """After tests/test_solver.py:189: a known similarity with noise and
    weights, through both packages; the batched port call equals the
    unbatched ones."""
    rng = np.random.default_rng(0)
    P = rng.normal(size=(2, 40, 3)).astype(np.float32)
    Rs = np.stack([_rotation(rng) for _ in range(2)])
    Q = (1.7 * P @ Rs.transpose(0, 2, 1) + [0.3, -0.2, 0.5] + rng.normal(0, 0.01, P.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (2, 40)).astype(np.float32)
    R_b, t_b = kabsch(T(P), T(Q), T(w))
    s_b, Ru_b, tu_b = umeyama_alignment(T(P), T(Q))
    for i in range(2):
        R, t = kabsch(T(P[i]), T(Q[i]), T(w[i]))
        jR, jt = jax_kabsch(jnp.asarray(P[i]), jnp.asarray(Q[i]), jnp.asarray(w[i]))
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=TOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=TOL)
        s, Ru, tu = umeyama_alignment(T(P[i]), T(Q[i]))
        js, jRu, jtu = jax_umeyama(jnp.asarray(P[i]), jnp.asarray(Q[i]))
        np.testing.assert_allclose(float(s), float(js), rtol=TOL)
        np.testing.assert_allclose(Ru.numpy(), np.asarray(jRu), atol=TOL)
        np.testing.assert_allclose(tu.numpy(), np.asarray(jtu), atol=TOL)
        np.testing.assert_allclose(Ru.numpy(), Rs[i], atol=2e-2)
        torch.testing.assert_close(R_b[i], R, atol=1e-6, rtol=0)
        torch.testing.assert_close(Ru_b[i], Ru, atol=1e-6, rtol=0)
        torch.testing.assert_close(s_b[i], s, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(tu_b[i], tu, atol=1e-5, rtol=0)
        torch.testing.assert_close(t_b[i], t, atol=1e-5, rtol=0)
    assert callable(recover_pose_from_E)


def test_compute_F_and_triangulation_match_jax():
    rng = np.random.default_rng(1)
    K0 = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]], np.float32)
    K1 = np.array([[480.0, 0, 300], [0, 470, 250], [0, 0, 1]], np.float32)
    R = _rotation(rng).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    F = text.compute_F(K0, K1, R, t)
    np.testing.assert_allclose(F.numpy(), np.asarray(jext.compute_F(K0, K1, R, t)), rtol=1e-4, atol=1e-9)
    X = rng.uniform(-1, 1, (20, 3)) + [0, 0, 4]
    pose0 = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    pose1 = np.hstack([R, t[:, None] * 0.2]).astype(np.float32)
    proj = lambda K, P: (lambda x: x[:, :2] / x[:, 2:])((np.c_[X, np.ones(20)] @ P.T) @ K.T)
    k0, k1 = proj(K0, pose0).astype(np.float32), proj(K1, pose1).astype(np.float32)
    got = text.triangulate_dlt(T(k0), T(k1), T(pose0), T(pose1), T(K0), T(K1)).numpy()
    want = np.asarray(jext.triangulate_dlt(*map(jnp.asarray, (k0, k1, pose0, pose1, K0, K1))))
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, X, atol=1e-3)


def test_host_extras_equal_jax(tmp_path):
    """The numpy copies give pope_tpu's bytes: 2-D transforms, FPS, pickle
    and PLY (ascii and binary) IO."""
    rng = np.random.default_rng(2)
    crop = text.transformation_crop_2d((30.0, 40.0), 1.5, 0.3, 64)
    np.testing.assert_array_equal(crop, jext.transformation_crop_2d((30.0, 40.0), 1.5, 0.3, 64))
    inv = text.transformation_inverse_2d(crop)
    np.testing.assert_array_equal(inv, jext.transformation_inverse_2d(crop))
    pts = rng.normal(size=(10, 2))
    np.testing.assert_array_equal(text.transformation_apply_2d(crop, pts), jext.transformation_apply_2d(crop, pts))
    for a, b in zip(text.transformation_decompose_2d(crop), jext.transformation_decompose_2d(crop)):
        np.testing.assert_array_equal(a, b)
    cloud = rng.normal(size=(200, 3))
    for init_center in (True, False):
        np.testing.assert_array_equal(text.sample_fps_points(cloud, 16, init_center),
                                      jext.sample_fps_points(cloud, 16, init_center))
    text.save_pickle({"a": cloud}, str(tmp_path / "x.pkl"))
    np.testing.assert_array_equal(jext.read_pickle(str(tmp_path / "x.pkl"))["a"], cloud)
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                         "property float z\nend_header\n" + "".join(f"{x} {y} {z}\n" for x, y, z in cloud[:3]))
    bin_ply = tmp_path / "b.ply"
    verts = np.zeros(5, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1")])
    verts["x"], verts["y"], verts["z"] = cloud[:5].T
    bin_ply.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 5\nproperty float x\n"
                        b"property float y\nproperty float z\nproperty uchar red\nend_header\n" + verts.tobytes())
    for path in (ascii_ply, bin_ply):
        np.testing.assert_array_equal(text.load_ply_points(str(path)), jext.load_ply_points(str(path)))


def test_affine_helpers_match_jax():
    """After tests/test_affine.py: the numpy transform (float64, exact), box
    expansion and clamping, and warpAffine on an image with a channel axis
    and without, a rotation and a scale; the batched warp equals the
    unbatched one."""
    rng = np.random.default_rng(3)
    for rot in (0.0, 17.0):
        for inv in (False, True):
            np.testing.assert_array_equal(
                taff.get_affine_transform_np((50.0, 40.0), (60.0, 30.0), rot, (64, 48), inv),
                jaff.get_affine_transform_np((50.0, 40.0), (60.0, 30.0), rot, (64, 48), inv))
    boxes = np.array([[10.0, 20.0, 40.0, 30.0], [-5.0, 100.0, 60.0, 50.0], [90.0, 5.0, 30.0, 80.0]], np.float32)
    for b in boxes:
        np.testing.assert_allclose(taff.compact_box(T(b), 0.3).numpy(), np.asarray(jaff.compact_box(jnp.asarray(b), 0.3)),
                                   rtol=1e-6)
        np.testing.assert_allclose(taff.clamped_scale_box(T(b), 128.0, 120.0, 1.8).numpy(),
                                   np.asarray(jaff.clamped_scale_box(jnp.asarray(b), 128.0, 120.0, 1.8)), rtol=1e-6)
    batched = taff.clamped_scale_box(T(boxes), 128.0, 120.0, 1.8)
    assert batched.shape == (3, 4)
    img = rng.uniform(0, 255, (40, 50, 3)).astype(np.float32)
    M = jaff.get_affine_transform_np((25.0, 20.0), (30.0, 30.0), 20.0, (32, 24)).astype(np.float32)
    want = np.asarray(jaff.warp_affine(jnp.asarray(img), jnp.asarray(M), (24, 32)))
    got = taff.warp_affine(T(img), T(M), (24, 32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    gray = taff.warp_affine(T(img[..., 0]), T(M), (24, 32))
    np.testing.assert_allclose(gray.numpy(), want[..., 0], atol=1e-3)
    both = taff.warp_affine(T(np.stack([img, img[::-1].copy()])), T(np.stack([M, M])), (24, 32))
    torch.testing.assert_close(both[0], got, atol=1e-4, rtol=0)


def test_batched_nms_matches_jax():
    """After tests/test_ops.py:89: overlapping boxes in two categories; a
    box suppressed within its category survives the other's."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 60, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 30, (40, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    idxs = rng.integers(0, 3, 40).astype(np.int32)
    valid = rng.uniform(size=40) > 0.1
    want = np.asarray(jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), 0.5,
                                      jnp.asarray(valid)))
    got = batched_nms(T(boxes), T(scores), T(idxs), 0.5, T(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    two = batched_nms(T(np.stack([boxes, boxes])), T(np.stack([scores, scores])), T(np.stack([idxs, idxs])), 0.5)
    np.testing.assert_array_equal(two[0].numpy(), np.asarray(jax_batched_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), 0.5)))


def test_component_roots_and_areas_match_jax():
    rng = np.random.default_rng(5)
    masks = rng.uniform(size=(2, 24, 32)) > 0.55
    for m in masks:
        jl = jax_label(jnp.asarray(m))
        want_r, want_a = (np.asarray(x) for x in jax_roots_areas(jl, jnp.asarray(m), k=16))
        lab = label_components(T(m))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
        roots, areas = component_roots_and_areas(lab, T(m), k=16)
        assert roots.dtype == areas.dtype == torch.int32
        np.testing.assert_array_equal(roots.numpy(), want_r)
        np.testing.assert_array_equal(areas.numpy(), want_a)
    lab = label_components(T(masks))
    r2, a2 = component_roots_and_areas(lab, T(masks), k=16)
    assert r2.shape == a2.shape == (2, 16)


def test_module_estimate_pair_is_the_executors(models):  # noqa: F811
    _, port = models
    img0, img1, K, boxes, valid = (torch.from_numpy(a) for a in _inputs(2))
    ex = PipelineExecutor(port, crop_size=CROP)
    noise = torch.from_numpy(jax_noise(jax.random.PRNGKey(0), 128))
    amg = type("AMG", (), {"boxes_xywh": boxes[0], "valid": valid[0]})
    cls = ex.prompt_cls_raw(img0[:1])[0]
    want = ex.estimate_pair(img0[0], img1[0], K[0], K[0], amg, cls, noise)
    got = estimate_pair(port, img0[0], img1[0], K[0], K[0], amg, cls, noise, crop_size=CROP)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert (a is None and b is None) or torch.equal(a, b), name
