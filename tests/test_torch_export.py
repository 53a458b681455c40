"""The port's exports (pope_tpu_torch/export.py: torch.export programs saved as
bytes) against pope_tpu's StableHLO artifacts (`jax.export`, run through
`load_exported(blob).call`) on the same inputs and bridged weights: the SAM
decode head and prompt head (tiny SAM of tests/test_torch_common.py, its
structured decoder), the matcher (the tiny matcher of
tests/test_torch_pipeline.py at 64x64 against a 48x48 crop) and DINOv2's cls
token at the serving size 196 (the tiny DINOv2 there). Also: the
`pope::flash_attention` op node in DINOv2's graph, the save ->
`load_exported` round trip in a fresh process, gradients through the ops'
plain backward, and `cli export`."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu import export as jax_export
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu_torch import export
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from pope_tpu_torch.ops.window_attention import windowed_attention_relpos, windowed_attention_relpos_plain
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax
from tests.test_torch_common import f32, jax_params, port_config, port_sam, seeded_variables, structure_decoder
from tests.test_torch_common import tiny_cfg, to_jax
from tests.test_torch_pipeline import DINO, MATCHER, _bn, _gamma
from tests.test_torch_predictor import with_mask_convs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIG_HW = (96, 128)
# f32 programs of the same computation in another order: the SAM heads'
# logits and scores, DINOv2's cls token (O(1)), the matcher's coordinates in
# pixels (tests/test_torch_matcher.py: 1e-3 px) and confidences
TOL_SAM, TOL_CLS, TOL_PX, TOL_CONF = 2e-5, 1e-4, 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tiny models: two intra-op threads are as fast as eight here, and the
    test run's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sams():
    cfg = tiny_cfg(False)
    params = with_mask_convs(structure_decoder(jax_params(cfg, seed=3)))
    return JaxSam(cfg), to_jax(params), port_sam(cfg, params)


@pytest.fixture(scope="module")
def dinos():
    variables = seeded_variables(JaxDino(DINO), jnp.zeros((1, 196, 196, 3)), seed=0, fill=_gamma)
    dino = DinoVisionTransformer(port_config(DINO))
    dino.load_state_dict(dinov2_state_from_jax(variables), strict=True)
    return JaxDino(DINO), to_jax(variables), dino.eval()


@pytest.fixture(scope="module")
def matchers():
    z = jnp.zeros((1, 64, 64, 1))
    variables = seeded_variables(JaxMatcher(MATCHER), z, z, seed=1, fill=_bn)
    matcher = Matcher(port_config(MATCHER))
    matcher.load_state_dict(matcher_state_from_jax(variables), strict=True)
    return JaxMatcher(MATCHER), to_jax(variables), matcher.eval()


def _run(blob, *args):
    """An exported program of the port on numpy inputs."""
    with torch.no_grad():
        out = export.load_exported(blob).module()(*(torch.from_numpy(np.asarray(a)) for a in args))
    return out if isinstance(out, (tuple, list)) else (out,)


def test_export_sam_decoder_matches_jax(sams, tmp_path):
    jsam, jvars, sam = sams
    E = sam.config.image_embedding_size
    rng = np.random.default_rng(0)
    emb = rng.normal(0, 1, (1, E, E, 64)).astype(np.float32)
    pts = np.array([[[70.0, 50.0], [120.0, 90.0], [30.0, 200.0], [0.0, 0.0]]], np.float32)
    lbl = np.array([[1, 0, 1, -1]], np.int32)
    path = tmp_path / "decoder.pt2"
    blob = export.export_sam_decoder(sam, num_points=4, path=str(path))
    assert path.read_bytes() == blob
    ref = jax_export.load_exported(jax_export.export_sam_decoder(jsam, jvars, num_points=4)).call(emb, pts, lbl)
    out = _run(str(path), emb, pts, lbl)
    assert len(out) == len(ref) == 2
    for got, want in zip(out, ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(f32(got), f32(want), atol=TOL_SAM, rtol=0)
    with torch.no_grad():  # the program against the eager module
        eager = sam.decode(*(torch.from_numpy(a) for a in (emb, pts, lbl)))
    for got, want in zip(out, eager):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("single", [False, True], ids=["all_tokens", "single_mask"])
def test_export_sam_prompt_head_matches_jax(sams, single):
    """The SamOnnxModel surface, all four tokens or the single-mask variant
    (click_count 2: the best multimask token), a mask input on."""
    jsam, jvars, sam = sams
    E = sam.config.image_embedding_size
    rng = np.random.default_rng(7)
    args = [rng.normal(0, 1, (1, E, E, 64)).astype(np.float32), np.array([[[70.0, 50.0], [0.0, 0.0]]], np.float32),
            np.array([[1, -1]], np.int32), rng.normal(0, 2, (1, 4 * E, 4 * E, 1)).astype(np.float32),
            np.array([1.0], np.float32)]
    if single:
        args.append(np.array([2.0], np.float32))
    blob = export.export_sam_prompt_head(sam, ORIG_HW, num_points=2, return_single_mask=single)
    ref = jax_export.load_exported(jax_export.export_sam_prompt_head(
        jsam, jvars, ORIG_HW, num_points=2, return_single_mask=single)).call(*args)
    out = _run(blob, *args)
    K = 1 if single else 4
    assert out[0].shape == (1, K, *ORIG_HW) and out[1].shape == (1, K)
    for got, want in zip(out, ref):
        np.testing.assert_allclose(f32(got), f32(want), atol=TOL_SAM, rtol=0)


def test_export_matcher_matches_jax(matchers):
    jm, jvars, matcher = matchers
    rng = np.random.default_rng(1)
    img0 = rng.uniform(0, 1, (1, 64, 64, 1)).astype(np.float32)
    img1 = rng.uniform(0, 1, (1, 48, 48, 1)).astype(np.float32)
    blob = export.export_matcher(matcher, (64, 64), (48, 48))
    ref = jax_export.load_exported(jax_export.export_matcher(jm, jvars, (64, 64), (48, 48))).call(img0, img1)
    mk0, mk1, mconf, valid = _run(blob, img0, img1)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[3]))
    assert valid.sum() > 10
    np.testing.assert_allclose(mk0.numpy(), np.asarray(ref[0]), atol=TOL_PX, rtol=0)
    np.testing.assert_allclose(mk1.numpy(), np.asarray(ref[1]), atol=TOL_PX, rtol=0)
    np.testing.assert_allclose(mconf.numpy(), np.asarray(ref[2]), atol=TOL_CONF, rtol=0)


def test_export_dinov2_matches_jax_and_holds_the_kernel_op(dinos):
    """DINOv2's cls token at 196; its graph runs each block's attention as one
    `pope::flash_attention` node, so a program exported on the card launches
    kernel 3 as the eager model does."""
    jd, jvars, dino = dinos
    img = np.random.default_rng(2).normal(0, 1, (1, 196, 196, 3)).astype(np.float32)
    blob = export.export_dinov2(dino, img_size=196)
    program = export.load_exported(blob)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("pope.flash_attention.default") == DINO.depth
    ref = jax_export.load_exported(jax_export.export_dinov2(jd, jvars, img_size=196)).call(img)
    (cls,) = _run(blob, img)
    assert cls.shape == (1, DINO.embed_dim)
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref), atol=TOL_CLS, rtol=0)


def test_load_exported_in_a_fresh_process(dinos, tmp_path):
    """A saved program runs in a process that imported nothing of the port
    but `load_exported` (which registers the ops)."""
    _, _, dino = dinos
    path = tmp_path / "dinov2.pt2"
    export.export_dinov2(dino, img_size=196, path=str(path))
    img = np.random.default_rng(3).normal(0, 1, (1, 196, 196, 3)).astype(np.float32)
    np.save(tmp_path / "img.npy", img)
    code = ("import sys, numpy as np, torch; from pope_tpu_torch.export import load_exported; "
            "p = load_exported(sys.argv[1]); "
            "out = p.module()(torch.from_numpy(np.load(sys.argv[2]))); np.save(sys.argv[3], out.detach().numpy())")
    subprocess.run([sys.executable, "-c", code, str(path), str(tmp_path / "img.npy"), str(tmp_path / "out.npy")],
                   check=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    with torch.no_grad():
        want = dino(torch.from_numpy(img))["x_norm_clstoken"]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want.numpy())


def test_ops_backward_is_the_plain_versions():
    """The registered ops differentiate as their plain versions (the kernels
    have no VJP; a trainable tower would take this path)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 9, 2, 8)).astype(np.float32)).requires_grad_() for _ in range(3))
    g = torch.from_numpy(rng.normal(0, 1, (2, 9, 16)).astype(np.float32))
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(flash_attention_plain(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    qkv = torch.from_numpy(rng.normal(0, 1, (2, 9, 3 * 16)).astype(np.float32)).requires_grad_()
    rel = [torch.from_numpy(rng.normal(0, 1, (2, 2, 9, 3)).astype(np.float32)) for _ in range(2)]
    got = torch.autograd.grad(windowed_attention_relpos(qkv, *rel, 2, 8, 3, 3), qkv, g)[0]
    want = torch.autograd.grad(windowed_attention_relpos_plain(qkv, *rel, 2, 8, 3, 3), qkv, g)[0]
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cli_export(dinos, tmp_path, monkeypatch, capsys):
    """`cli export --device cpu` writes the program of the target; without a
    GPU the default device raises."""
    import pope_tpu_torch.pipeline as pipeline
    from pope_tpu_torch.cli import main
    from pope_tpu_torch.pipeline import PopeModels

    _, _, dino = dinos
    seen = []
    bundle = PopeModels(sam=None, amg=None, dinov2=dino, matcher=None, config=None, device=torch.device("cpu"))
    monkeypatch.setattr(pipeline, "load_models", lambda **kw: seen.append(kw) or bundle)
    out = tmp_path / "d.pt2"
    main(["export", "--target", "dinov2", "--output", str(out), "--device", "cpu"])
    assert seen[0]["device"] == "cpu" and seen[0]["components"] == ("dinov2",)
    assert f"wrote {out}" in capsys.readouterr().out
    targets = [str(n.target) for n in export.load_exported(str(out)).graph.nodes if n.op == "call_function"]
    assert "pope.flash_attention.default" in targets
    if not torch.cuda.is_available():
        monkeypatch.setattr(pipeline, "load_models", lambda **kw: pipeline.api.resolve_device(kw.get("device")))
        with pytest.raises(RuntimeError):
            main(["export", "--target", "dinov2", "--output", str(tmp_path / "x.pt2")])
