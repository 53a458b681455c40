"""The port's DINOv2 self-supervised training (pope_tpu_torch/train/ssl.py
and the DINOv2 training pieces) against pope_tpu's on the same seeded
inputs and weights, carried across by the weights bridge: mask tokens,
SwiGLU, DropPath, the pos embed's resample gradient, the losses, the DINO
head, the schedules, the parameter groups, the state bridge and whole
train steps in both centering modes, with and without a separate iBOT
head."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.config import DinoV2Config
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.dinov2.model import DropPath as JaxDropPath
from pope_tpu.models.dinov2.model import _interpolate_pos_embed
from pope_tpu.train import ssl as jssl
from pope_tpu_torch.models.dinov2.model import (
    DinoVisionTransformer,
    DropPath,
    drop_path_rates,
    interpolate_pos_embed,
    vit_base,
    vit_giant2,
    vit_large,
    vit_small,
)
from pope_tpu_torch.train import ssl as tssl
from pope_tpu_torch.weights import dinov2_state_from_jax, params_state_from_jax, ssl_state_from_jax
from tests.test_torch_common import port_config, seeded_variables, to_jax

T = torch.from_numpy
# embed 32, depth 2, 2 heads on 56 px crops (a 4x4 patch grid) and 28 px
# local crops (2x2); the pos embed's base grid is 4x4, so the local crops
# resample it
TINY_BB = DinoV2Config(embed_dim=32, depth=2, num_heads=2, patch_size=14, img_size=56)
TINY_SSL = jssl.SSLConfig(
    global_crop_size=56, local_crop_size=28, n_local_crops=2, dino_out_dim=32, ibot_out_dim=32,
    head_hidden_dim=24, head_bottleneck_dim=12, head_nlayers=2, head_dtype="float32", warmup_iters=2,
    total_iters=50, warmup_teacher_temp_iters=4, freeze_last_layer_iters=2, lr=1e-3,
)
# f32 forwards of two blocks and a head, outputs O(1): the same math in
# another order
TOL_FWD = 1e-4


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fill(name, shape, rng):
    if name == "gamma":  # LayerScale at O(1), not 1e-5: the blocks must count
        return rng.uniform(0.5, 1.5, shape)
    if name in ("pos_embed", "mask_token", "cls_token"):
        return rng.normal(0, 0.5, shape)
    if name == "last_g":
        return rng.uniform(0.5, 1.5, shape)
    return None


def _dino(cfg, seed=0):
    variables = seeded_variables(JaxDino(cfg), jnp.zeros((1, 56, 56, 3)), seed=seed, fill=_fill)
    port = DinoVisionTransformer(port_config(cfg))
    port.load_state_dict(dinov2_state_from_jax(variables), strict=True)
    return variables, port


def _masks(seed, B, N):
    rng = np.random.default_rng(seed)
    m = rng.uniform(size=(B, N)) < 0.4
    m[0] = False  # one crop without a mask
    return m


@pytest.mark.parametrize("ffn", ["mlp", "swiglufused"])
@pytest.mark.parametrize("with_masks", [False, True])
def test_dinov2_masks_and_swiglu_f32(ffn, with_masks):
    cfg = dataclasses.replace(TINY_BB, ffn_layer=ffn)
    variables, port = _dino(cfg, seed=1)
    x = np.random.default_rng(2).normal(0, 1, (3, 56, 56, 3)).astype(np.float32)
    masks = _masks(3, 3, 16) if with_masks else None
    ref = JaxDino(cfg).apply(to_jax(variables), jnp.asarray(x), masks=None if masks is None else jnp.asarray(masks))
    with torch.no_grad():
        out = port.eval()(T(x), masks=None if masks is None else T(masks))
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=TOL_FWD, rtol=0, err_msg=key)
    if ffn == "swiglufused":  # round8(2/3 * 4 * 32) = 88 hidden units
        assert port.block_0.mlp.w3.in_features == 88


def test_dinov2_drop_path_with_jax_masks():
    """A train-mode forward at drop_path_rate 0.5 (linspace: blocks at 0 and
    0.5) given the keep masks pope_tpu drew, captured at each DropPath call."""
    cfg = dataclasses.replace(TINY_BB, drop_path_rate=0.5)
    variables, port = _dino(cfg, seed=4)
    x = jnp.asarray(np.random.default_rng(5).normal(0, 1, (8, 56, 56, 3)).astype(np.float32))

    def forward(params, x):
        keeps = []

        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, JaxDropPath) and context.method_name == "__call__":
                keeps.append(jnp.any(out.reshape(out.shape[0], -1) != 0, axis=1))
            return out

        with fnn.intercept_methods(grab):
            out = JaxDino(cfg).apply(params, x, train=True, rngs={"drop_path": jax.random.PRNGKey(9)})
        return out, keeps

    ref, keeps = jax.jit(forward)(to_jax(variables), x)
    assert len(keeps) == 2 * cfg.depth
    keeps = [T(np.array(k)) for k in keeps]
    assert not keeps[2].all() and keeps[2].any()  # block 1 (rate 0.5) dropped some samples, kept others
    drop_keep = [(keeps[2 * i], keeps[2 * i + 1]) for i in range(cfg.depth)]
    with torch.no_grad():
        out = port(T(np.asarray(x)), train=True, drop_keep=drop_keep)
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=TOL_FWD, rtol=0, err_msg=key)


def test_drop_path_semantics():
    """Identity at rate 0 and outside training; in training each sample's
    branch is exactly 0 or exactly x / keep, about `rate` of them dropped;
    without a generator or masks it raises."""
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (512, 4, 8)).astype(np.float32))
    g = torch.Generator().manual_seed(5)
    assert torch.equal(DropPath(0.0)(x, True, g), x)
    assert torch.equal(DropPath(0.3)(x, False, g), x)
    out = DropPath(0.3)(x, True, g).reshape(512, -1)
    dropped = (out == 0).all(dim=1)
    kept = ~dropped
    torch.testing.assert_close(out[kept], x.reshape(512, -1)[kept] / 0.7, rtol=1e-6, atol=0)
    assert 0.2 < dropped.float().mean().item() < 0.4
    keep = torch.arange(512) % 2 == 0
    out = DropPath(0.25)(x, True, keep=keep)
    assert (out[~keep] == 0).all()
    torch.testing.assert_close(out[keep], x[keep] / 0.75, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        DropPath(0.3)(x, True)


@pytest.mark.parametrize("uniform", [False, True])
def test_drop_path_rates(uniform):
    cfg = DinoV2Config(embed_dim=16, depth=5, num_heads=2, drop_path_rate=0.4, drop_path_uniform=uniform)
    want = [0.4] * 5 if uniform else [0.4 * i / 4 for i in range(5)]
    assert drop_path_rates(cfg) == want
    model = DinoVisionTransformer(cfg)
    assert [getattr(model, n).drop_path.rate for n in model.block_names] == want


def test_draw_drop_keep_is_the_per_block_draw_order():
    """All of a step's keep masks drawn at once are the masks the DropPath
    calls would draw one by one (forward by forward, block by block, the
    attention branch first, none at rate 0), and a train-mode forward on a
    generator equals the forward given those masks."""
    cfg = DinoV2Config(embed_dim=16, depth=3, num_heads=2, patch_size=14, img_size=28, drop_path_rate=0.5)
    model = DinoVisionTransformer(cfg)
    sizes = [4, 6]
    keeps = model.draw_drop_keep(sizes, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(3)
    for B, per_block in zip(sizes, keeps):
        assert per_block[0] == (None, None)  # linspace: block 0 at rate 0
        for name, pair in zip(model.block_names[1:], per_block[1:]):
            p = 1.0 - getattr(model, name).drop_path.rate
            for keep in pair:
                assert torch.equal(keep, torch.rand(B, generator=g) < p)
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (4, 28, 28, 3)).astype(np.float32))
    with torch.no_grad():
        drawn = model(x, train=True, generator=torch.Generator().manual_seed(3))
        given = model(x, train=True, drop_keep=keeps[0])
    for key in drawn:
        assert torch.equal(drawn[key], given[key]), key


def test_vit_constructors():
    for fn, dims in ((vit_small, (384, 12, 6)), (vit_base, (768, 12, 12)), (vit_large, (1024, 24, 16)),
                     (vit_giant2, (1536, 40, 24))):
        with torch.device("meta"):  # shapes only, no memory
            m = fn()
        c = m.config
        assert (c.embed_dim, c.depth, c.num_heads) == dims
        assert c.ffn_layer == ("swiglufused" if fn is vit_giant2 else "mlp")
    with torch.device("meta"):
        assert vit_giant2().block_0.mlp.w12.out_features == 2 * 4096  # round8(2/3 * 6144)


@pytest.mark.parametrize("grid", [(2, 2), (3, 5), (6, 6)])
def test_pos_embed_resample_gradient(grid):
    """The bicubic resample of a trained pos embed (shrinking, antialiased,
    and growing) carries pope_tpu's gradient."""
    rng = np.random.default_rng(7)
    pe = rng.normal(0, 1, (1, 1 + 16, 8)).astype(np.float32)
    w = rng.normal(0, 1, (1, 1 + grid[0] * grid[1], 8)).astype(np.float32)
    ref = jax.grad(lambda p: jnp.sum(_interpolate_pos_embed(p, grid, 14) * w))(jnp.asarray(pe))
    p = T(pe).requires_grad_(True)
    (interpolate_pos_embed(p, grid) * T(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# losses and the head
# ---------------------------------------------------------------------------


def _logits(seed, *shape):
    return np.random.default_rng(seed).normal(0, 2, shape).astype(np.float32)


def test_center_and_dino_cross_entropy():
    t, s = _logits(1, 6, 32), _logits(2, 6, 32)
    center = _logits(3, 32) * 0.1
    probs_ref = jssl.softmax_center_teacher(jnp.asarray(t), jnp.asarray(center), 0.07)
    probs = tssl.softmax_center_teacher(T(t), T(center), 0.07)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tssl.dino_cross_entropy(T(s), probs, 0.1).item(),
                               float(jssl.dino_cross_entropy(jnp.asarray(s), probs_ref, 0.1)), rtol=1e-5)
    np.testing.assert_allclose(tssl.update_center(T(center), T(t), 0.9).numpy(),
                               np.asarray(jssl.update_center(jnp.asarray(center), jnp.asarray(t), 0.9)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("weighted", [False, True])
def test_sinkhorn_knopp(weighted):
    """With sample weights, zero-weight columns (padding, unmasked tokens)
    stay exactly 0 and nothing becomes NaN."""
    logits = _logits(4, 10, 32) * 0.1
    w = np.array([1, 0, 1, 1, 0, 0, 1, 1, 1, 0], np.float32) if weighted else None
    ref = jssl.sinkhorn_knopp_teacher(jnp.asarray(logits), 0.07, 3, None if w is None else jnp.asarray(w))
    out = tssl.sinkhorn_knopp_teacher(T(logits), 0.07, 3, None if w is None else T(w))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-4)
    if weighted:
        assert (out[w == 0] == 0).all()


def test_ibot_patch_loss_dense():
    s, t_logits = _logits(5, 4, 16, 32), _logits(6, 4, 16, 32)
    t = np.asarray(jax.nn.softmax(jnp.asarray(t_logits) / 0.07, axis=-1))
    masks = _masks(7, 4, 16)  # crop 0 without a masked patch
    ref = jssl.ibot_patch_loss_dense(jnp.asarray(s), jnp.asarray(t), jnp.asarray(masks), 0.1)
    out = tssl.ibot_patch_loss_dense(T(s), T(t), T(masks), 0.1)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)


def test_koleo_loss_first_index_on_ties():
    """Rows 0 and 3 are equal, so row 0's nearest neighbours tie (rows 3 and
    5 at the same distance after normalization); both take the first."""
    x = _logits(8, 8, 12)
    x[3] = x[0]
    x[5] = 2.0 * x[0]
    out = tssl.koleo_loss(T(x))
    ref = jssl.koleo_loss(jnp.asarray(x))
    assert np.isfinite(out.item())
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)


@pytest.mark.parametrize("nlayers", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dino_head(nlayers, dtype):
    """f32 to rounding; bf16 (the MLP's products rounded to bf16 by two
    libraries, then normalized and projected in f32): within 2e-2 of
    logits of size about 1."""
    jhead = jssl.DINOHead(in_dim=16, out_dim=40, hidden_dim=24, bottleneck_dim=12, nlayers=nlayers,
                          dtype=jnp.dtype(dtype))
    variables = seeded_variables(jhead, jnp.zeros((1, 16)), seed=nlayers, fill=_fill)
    head = tssl.DINOHead(16, 40, 24, 12, nlayers, getattr(torch, dtype))
    head.load_state_dict(params_state_from_jax(variables), strict=True)
    x = _logits(9, 5, 7, 16)
    ref = np.asarray(jhead.apply(to_jax(variables), jnp.asarray(x)))
    with torch.no_grad():
        out = head(T(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 if dtype == "float32" else 2e-2, rtol=0)


def test_schedules():
    cfg = dataclasses.replace(TINY_SSL, warmup_iters=10, total_iters=100, min_lr=1e-5, freeze_last_layer_iters=5,
                              warmup_teacher_temp_iters=10)
    for step in (0, 1, 4, 5, 9, 10, 11, 37, 99, 100, 150):
        ref = jssl.ssl_schedules(cfg, step)
        out = tssl.ssl_schedules(cfg, step)
        for k, v in ref.items():
            assert out[k] == float(np.float32(v)), (step, k, out[k], float(v))


@pytest.mark.parametrize("separate", [False, True])
def test_group_multipliers_through_the_bridge_names(separate):
    """pope_tpu's multiplier trees, carried to the port's parameter names by
    the bridge (each multiplier spread over its parameter's shape), equal the
    port's per-name multipliers."""
    arch = jssl.SSLMetaArch(dataclasses.replace(TINY_SSL, ibot_separate_head=separate), TINY_BB)
    jstate = arch.init_state(jax.random.PRNGKey(0))
    params = jax.device_get(jstate.student)
    tarch = _port_arch(arch)
    got = tarch.multipliers(tarch.init_state(0, "cpu"))
    for tree, mine in zip(jssl.build_group_multipliers(params, arch.cfg, TINY_BB.depth), got):
        spread = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32), tree, params)
        bridged = params_state_from_jax(spread)
        assert bridged.keys() == mine.keys()
        for name, t in bridged.items():
            assert (t == mine[name]).all(), (name, mine[name])
    lr_m = got[0]
    assert lr_m["backbone.patch_embed.weight"] == pytest.approx(0.9 ** 3 * 0.2)
    assert got[1]["backbone.block_0.attn.qkv.weight"] == 1.0 and got[1]["backbone.cls_token"] == 0.0
    assert got[2]["dino_head.last_v"] == 1.0


# ---------------------------------------------------------------------------
# state bridge and train steps
# ---------------------------------------------------------------------------


def _jax_state(arch, seed=0, init=jssl.SSLMetaArch.init_state):
    """pope_tpu's SSLState with student and teacher filled from a numpy seed
    (LayerScale at O(1), non-zero tokens and pos embed, gains near 1) and
    small non-zero centers, as numpy leaves; `init` gives the tree."""
    st = jax.device_get(init(arch, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        a = _fill(name, shape, rng)
        if a is None and name == "kernel":
            a = rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        elif a is None and name == "bias":
            a = rng.normal(0, 0.1, shape)
        elif a is None and name == "scale":
            a = 1.0 + rng.normal(0, 0.1, shape)
        elif a is None:
            a = rng.normal(0, 1, shape)
        return np.asarray(a, np.float32)

    student = jax.tree_util.tree_map_with_path(fill, st.student)
    teacher = jax.tree_util.tree_map_with_path(fill, st.student)
    return st._replace(student=student, teacher=teacher,
                       dino_center=rng.normal(0, 0.1, st.dino_center.shape).astype(np.float32),
                       ibot_center=rng.normal(0, 0.1, st.ibot_center.shape).astype(np.float32))


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    masks = np.zeros((2 * B, 16), bool)
    masks[0, :6] = True
    masks[2, 4:12] = True
    masks[3, 1::3] = True
    return {"global_crops": rng.normal(0, 1, (2 * B, 56, 56, 3)).astype(np.float32),
            "local_crops": rng.normal(0, 1, (TINY_SSL.n_local_crops * B, 28, 28, 3)).astype(np.float32),
            "masks": masks}


def _port_arch(arch):
    return tssl.SSLMetaArch(tssl.SSLConfig(**dataclasses.asdict(arch.cfg)), port_config(arch.backbone_cfg))


def _port_state(arch, jstate):
    state = _port_arch(arch).init_state(0, "cpu")
    return state.load_state_dict(ssl_state_from_jax(jax.device_get(jstate)))


def test_ssl_state_bridge_round_trip():
    """The bridged state holds every leaf of pope_tpu's (the SwiGLU FFN's
    w12 / w3, the heads' mlp_i and last_v / last_g, the mask token) at the
    student's parameter names, and its student backbone gives pope_tpu's
    features."""
    bb = dataclasses.replace(TINY_BB, ffn_layer="swiglufused")
    arch = jssl.SSLMetaArch(dataclasses.replace(TINY_SSL, ibot_separate_head=True), bb)
    jstate = _jax_state(arch, seed=3)
    jstate = jstate._replace(mu=jax.tree_util.tree_map(lambda p: p * 0.5, jstate.student),
                             nu=jax.tree_util.tree_map(lambda p: p * p, jstate.student), step=np.int32(7))
    state = _port_state(arch, jstate)
    names = [n for n, _ in state.student.named_parameters()]
    for key in ("backbone.block_0.mlp.w12.weight", "backbone.block_1.mlp.w3.bias", "backbone.mask_token",
                "dino_head.mlp_1.weight", "ibot_head.last_v", "ibot_head.last_g"):
        assert key in names
    assert state.step == 7 and set(state.mu) == set(names) == set(state.nu)
    sd = state.state_dict()
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(jstate.student)[0]}
    assert len(flat) == len(names)
    np.testing.assert_array_equal(sd["student"]["backbone.block_0.mlp.w12.weight"].numpy(),
                                  flat["backbone/block_0/mlp/w12/kernel"].T)
    np.testing.assert_array_equal(sd["mu"]["ibot_head.last_v"].numpy(), flat["ibot_head/last_v"] * 0.5)
    x = np.random.default_rng(4).normal(0, 1, (2, 56, 56, 3)).astype(np.float32)
    ref = JaxDino(bb).apply({"params": to_jax(jstate.teacher["backbone"])}, jnp.asarray(x))
    with torch.no_grad():
        out = state.teacher["backbone"](T(x))
    np.testing.assert_allclose(out["x_norm_clstoken"].numpy(), np.asarray(ref["x_norm_clstoken"]), atol=TOL_FWD)


def _named(tree) -> dict:
    return {k: v.numpy() for k, v in params_state_from_jax(jax.device_get(tree)).items()}


def _close_to_max(name, got, want, rel):
    """Each tensor within rel of its largest |value|."""
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=rel * np.abs(want[k]).max() + 1e-12, rtol=0,
                                   err_msg=f"{name}: {k}")


def _close_where_conditioned(name, got, want, mu, atol, bound):
    """Within atol where the element's first moment exceeds 1e-3 of its
    tensor's largest, within `bound` everywhere."""
    for k in want:
        d = np.abs(got[k] - want[k])
        ok = np.abs(mu[k]) > 1e-3 * np.abs(mu[k]).max()
        assert d.max() <= bound, (name, k, d.max())
        assert not ok.any() or d[ok].max() <= atol, (name, k, d[ok].max())


# Tolerances of the train steps (f32, losses O(1)):
# - metrics and centers: two libraries' sums of the same f32 products,
#   1e-5 relative (measured 1.5e-7);
# - the moments are EMAs of the gradients and their squares: 2e-5 of each
#   tensor's largest (measured 4e-6);
# - step 0 is in warmup at lr 0, so the weights stay put and the teacher is
#   the EMA toward them: 1e-6;
# - step 1 (lr 5e-4) from pope_tpu's state: an Adam update is lr times
#   mu_hat / sqrt(nu_hat). Where the first moment is above 1e-3 of its
#   tensor's largest the ratio is well conditioned and the weights agree
#   within 1e-6 (measured 6e-8). Where a gradient is 0 in exact arithmetic
#   (the key bias: softmax ignores a constant added to every logit) both
#   sides normalise rounding noise, so the weight may move by up to lr
#   either way: 2 lr there, and the teacher 2 lr (1 - momentum).
TOL_METRIC = 1e-5
TOL_MOMENTS = 2e-5
TOL_WEIGHTS = 1e-6


@pytest.mark.parametrize("centering,separate", [("centering", False), ("centering", True),
                                                ("sinkhorn_knopp", False), ("sinkhorn_knopp", True)])
def test_train_steps_match_pope_tpu(centering, separate):
    """Step 0 (lr 0 in warmup: the moments carry the gradients, the centers
    move) from the same state, then step 1 taken from pope_tpu's state after
    step 0: student, teacher, moments, centers and metrics."""
    arch = jssl.SSLMetaArch(dataclasses.replace(TINY_SSL, centering=centering, ibot_separate_head=separate), TINY_BB)
    jstate0 = _jax_state(arch, seed=5)
    mults = arch.multipliers(jstate0)
    jstep = jax.jit(lambda s, b: arch.train_step(s, b, mults=mults))
    batch = _batch(6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate1, jm1 = jstep(jax.tree_util.tree_map(jnp.asarray, jstate0), jbatch)
    jstate2, jm2 = jstep(jstate1, jbatch)

    tarch = _port_arch(arch)
    tbatch = {k: T(v) for k, v in batch.items()}
    for jprev, jnext, jm in ((jstate0, jstate1, jm1), (jstate1, jstate2, jm2)):
        state = _port_state(arch, jprev)
        state, m = tarch.train_step(state, tbatch)
        assert state.step == int(jnext.step)
        for k, v in jm.items():
            np.testing.assert_allclose(m[k].item(), float(v), rtol=TOL_METRIC, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(state.dino_center.numpy(), np.asarray(jnext.dino_center), atol=TOL_METRIC)
        np.testing.assert_allclose(state.ibot_center.numpy(), np.asarray(jnext.ibot_center), atol=TOL_METRIC)
        sd = {k: {n: t.numpy() for n, t in v.items()} for k, v in state.state_dict().items()
              if k in ("mu", "nu", "student", "teacher")}
        want = {k: _named(getattr(jnext, k)) for k in sd}
        _close_to_max("mu", sd["mu"], want["mu"], TOL_MOMENTS)
        _close_to_max("nu", sd["nu"], want["nu"], TOL_MOMENTS)
        lr = float(jm["lr"])
        mom = float(jm["teacher_momentum"])
        _close_where_conditioned("student", sd["student"], want["student"], want["mu"], TOL_WEIGHTS,
                                 2 * lr + TOL_WEIGHTS)
        _close_where_conditioned("teacher", sd["teacher"], want["teacher"], want["mu"], TOL_WEIGHTS,
                                 2 * lr * (1 - mom) + TOL_WEIGHTS)


def test_drop_path_draws_repeat_by_step():
    """At drop_path_rate > 0 the student's draws come from a CPU generator
    seeded by (1717, step): a resumed step repeats them; other draws give
    another loss."""
    bb = dataclasses.replace(TINY_BB, drop_path_rate=0.4)
    arch = jssl.SSLMetaArch(TINY_SSL, bb)
    jstate = _jax_state(arch, seed=8)._replace(step=np.int32(3))
    tarch = _port_arch(arch)
    batch = {k: T(v) for k, v in _batch(9).items()}
    runs = []
    for gen in (None, torch.Generator().manual_seed((1717 << 32) | 3), torch.Generator().manual_seed(11)):
        state = _port_state(arch, jstate)
        runs.append(tarch.train_step(state, batch, generator=gen)[1]["total_loss"].item())
    assert runs[0] == runs[1] != runs[2]
