"""The port's pose-regressor extension (pope_tpu_torch/models/regressor,
geometry/pose.py's rotation helpers) against pope_tpu's on the same inputs
and bridged weights (weights.regressor_state_from_jax), at tiny sizes:
ConvNeXtV2 'test', Vim 'test' (32 wide, depth 2) on 224 crops, d_model 32,
2 heads, num_sample 16. The pose helpers, nerf_embedding, GRN, ConvNeXtV2,
the selective scan (against JAX's associative scan and a float64 loop), Vim,
MkptsRegModel over its modes, rotation heads and fusions, pose_loss and its
gradients, one train step (JAX's dropout masks given to the port; a frozen
Vim decayed as optax decays it), eval_step, DINOv2Poser with posenet_loss,
the bridge's 3-dim kernels and convert.py's copy."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pope_tpu.geometry.pose as jpose
import pope_tpu.models.regressor.convert as jconvert
import pope_tpu_torch.geometry.pose as tpose
import pope_tpu_torch.models.regressor.convert as tconvert
from pope_tpu.config import RegressorConfig as JaxRegressorConfig
from pope_tpu.models.regressor import train as jtrain
from pope_tpu.models.regressor.convnextv2 import GRN as JaxGRN
from pope_tpu.models.regressor.convnextv2 import ConvNeXtV2 as JaxConvNeXtV2
from pope_tpu.models.regressor.dinov2_poser import DINOv2Poser as JaxPoser
from pope_tpu.models.regressor.dinov2_poser import posenet_loss as jax_posenet_loss
from pope_tpu.models.regressor.embedding import nerf_embedding as jax_nerf
from pope_tpu.models.regressor.model import MkptsRegModel as JaxReg
from pope_tpu.models.regressor.vim import VimConfig as JaxVimConfig
from pope_tpu.models.regressor.vim import VisionMamba as JaxVim
from pope_tpu.models.regressor.vim import selective_scan as jax_scan
from pope_tpu_torch.models.regressor import train
from pope_tpu_torch.models.regressor.convnextv2 import GRN, ConvNeXtV2
from pope_tpu_torch.models.regressor.dinov2_poser import DINOv2Poser, posenet_loss
from pope_tpu_torch.models.regressor.embedding import nerf_embedding
from pope_tpu_torch.models.regressor.model import MkptsRegModel
from pope_tpu_torch.models.regressor.vim import VimConfig, VisionMamba, selective_scan
from pope_tpu_torch.weights import regressor_state_from_jax
from tests.test_torch_common import port_config, seeded_variables, to_jax
from tests.test_torch_pipeline import DINO, _gamma
from tests.test_torch_train import _capture_grads

T = torch.from_numpy
TINY = JaxRegressorConfig(num_sample=16, d_model=32, nhead=2, vim_size="test")
VIM_TEST = dict(embed_dim=32, depth=2, num_classes=0)
IMG_SIDE = {"imgs": 64, "vim": 224}  # ConvNeXtV2 crops; Vim's pos embed is its 224 grid
# f32 of the same computation in another order: rotation algebra (O(1)),
# activations of the tiny towers and the regressor's outputs (O(1)), the
# selective scan (O(1) outputs of a 197-step recurrence)
TOL_POSE, TOL_ACT, TOL_SCAN = 2e-6, 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tiny models: two intra-op threads are as fast as eight here, and the
    test run's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rotations(rng, n):
    """Random rotations, with the four Shepperd branches of matrix_to_quat
    among them (trace > 0, and each of m00, m11, m22 the largest)."""
    q = rng.normal(0, 1, (max(n, 4), 4))
    q[:4] = [[1, 0.1, 0.2, 0.1], [0.05, 1, 0.2, 0.1], [0.05, 0.1, 1, 0.2], [0.05, 0.2, 0.1, 1]]
    return np.array(jpose.quat_to_matrix(jnp.asarray(q[:n], jnp.float32)))


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(0)
    R = _rotations(rng, 8)
    t = rng.normal(0, 1, (8, 3, 1)).astype(np.float32)
    P0, P1 = np.concatenate([R, t], -1), np.concatenate([R[::-1], t[::-1]], -1)
    cases = [
        (tpose.pose_inverse, jpose.pose_inverse, (P0,)),
        (tpose.pose_compose, jpose.pose_compose, (P0, P1)),
        (tpose.to_homo_pose, jpose.to_homo_pose, (P0,)),
        (tpose.relative_pose, jpose.relative_pose, (P0, P1)),
        (tpose.matrix_to_quat, jpose.matrix_to_quat, (R,)),
        (tpose.quat_to_matrix, jpose.quat_to_matrix, (rng.normal(0, 1, (8, 4)).astype(np.float32),)),
        (tpose.o6d_to_matrix, jpose.o6d_to_matrix, (rng.normal(0, 1, (8, 6)).astype(np.float32),)),
        (lambda a, b: tpose.geodesic_distance(a, b, "none"), lambda a, b: jpose.geodesic_distance(a, b, "none"),
         (R, R[::-1].copy())),
        (tpose.geodesic_distance, jpose.geodesic_distance, (R, R[::-1].copy())),
        (tpose.geodesic_distance, jpose.geodesic_distance, (R[0],)),  # against the identity
    ]
    for port_fn, jax_fn, args in cases:
        got = port_fn(*map(T, args)).numpy()
        want = np.asarray(jax_fn(*map(jnp.asarray, args)))
        np.testing.assert_allclose(got, want, atol=TOL_POSE, rtol=0, err_msg=port_fn.__name__)
    # the clamp: identical rotations give arccos(0.999999), not 0
    np.testing.assert_allclose(tpose.geodesic_distance(T(R), T(R), "none").numpy(), np.arccos(np.float32(0.999999)),
                               rtol=1e-6)


def test_nerf_embedding_matches_jax():
    x = np.random.default_rng(1).normal(0, 50, (2, 5, 4)).astype(np.float32)
    for logscale in (False, True):
        got = nerf_embedding(T(x), 9, logscale).numpy()
        want = np.asarray(jax_nerf(jnp.asarray(x), 9, logscale))
        assert got.shape == (2, 5, 76)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-5)  # sin/cos of arguments up to 1e4


def _port(module, variables, strict=True):
    module.load_state_dict(regressor_state_from_jax(variables), strict=strict)
    return module.eval()


def test_grn_and_convnextv2_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 5, 6, 8)).astype(np.float32)
    v = seeded_variables(JaxGRN(8), jnp.asarray(x), seed=0)
    got = _port(GRN(8), v)(T(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(JaxGRN(8).apply(to_jax(v), jnp.asarray(x))), atol=TOL_ACT, rtol=0)
    img = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    for num_classes in (0, 10):
        jm = JaxConvNeXtV2.from_name("test", num_classes=num_classes)
        v = seeded_variables(jm, jnp.asarray(img), seed=1)
        with torch.no_grad():
            got = _port(ConvNeXtV2.from_name("test", num_classes=num_classes), v)(T(img)).numpy()
        want = np.asarray(jax.jit(jm.apply)(to_jax(v), jnp.asarray(img)))
        assert got.shape == (2, num_classes or 128)
        np.testing.assert_allclose(got, want, atol=TOL_ACT, rtol=0)


def _scan_inputs(rng, Bt=2, L=197, Din=8, N=4):
    u = rng.normal(0, 1, (Bt, L, Din)).astype(np.float32)
    delta = np.log1p(np.exp(rng.normal(0, 1, (Bt, L, Din)))).astype(np.float32)  # softplus
    A = -np.exp(rng.normal(0.5, 1, (Din, N))).astype(np.float32)
    B, C = (rng.normal(0, 1, (Bt, L, N)).astype(np.float32) for _ in range(2))
    return u, delta, A, B, C, rng.normal(0, 1, (Din,)).astype(np.float32)


def _scan_loop(u, delta, A, B, C, D):
    """The recurrence step by step in float64."""
    u, delta, A, B, C, D = (np.asarray(x, np.float64) for x in (u, delta, A, B, C, D))
    h = np.zeros(u.shape[:1] + A.shape)
    ys = []
    for t in range(u.shape[1]):
        h = np.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1) + u[:, t] * D)
    return np.stack(ys, 1)


@pytest.mark.parametrize("chunk", [16, 5, 1], ids=["chunk16", "chunk5_ragged", "chunk1"])
def test_selective_scan_matches_jax_and_a_loop(chunk):
    """Outputs up to 21 in magnitude. Within a chunk the factors are
    exp(S_t - S_s) of f32 cumulative sums, whose rounding grows with the
    chunk's length: 2e-6 from the float64 loop at chunk 1 or 4, 7e-6 at the
    default 16, 6e-5 for one chunk of all 197 steps (JAX's scan: 2e-6)."""
    args = _scan_inputs(np.random.default_rng(3))
    got = selective_scan(*map(T, args), chunk=chunk).numpy()
    u, delta, A, B, C, D = map(jnp.asarray, args)
    want = np.asarray(jax.vmap(jax_scan, in_axes=(0, 0, None, 0, 0, None))(u, delta, A, B, C, D))
    np.testing.assert_allclose(got, want, atol=TOL_SCAN, rtol=0)
    np.testing.assert_allclose(got, _scan_loop(*args), atol=TOL_SCAN, rtol=0)


def test_vim_forward_matches_jax():
    img = np.random.default_rng(4).normal(0, 1, (2, 224, 224, 3)).astype(np.float32)
    jm = JaxVim(JaxVimConfig(**VIM_TEST))
    v = seeded_variables(jm, jnp.asarray(img), seed=2)
    with torch.no_grad():
        got = _port(VisionMamba(VimConfig(**VIM_TEST)), v)(T(img)).numpy()
    want = np.asarray(jax.jit(jm.apply)(to_jax(v), jnp.asarray(img)))
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got, want, atol=TOL_ACT, rtol=0)


def _batch(cfg, seed, B=2, n_real=(10, 16)):
    """mkpts (zero-padded past n_real), crops for the image branch, GT."""
    rng = np.random.default_rng(seed)
    mk = rng.uniform(0, 256, (2, B, cfg.num_sample, 2)).astype(np.float32)
    for b, n in enumerate(n_real[:B]):
        mk[:, b, n:] = 0.0
    out = {"mkpts0": mk[0], "mkpts1": mk[1]}
    side = IMG_SIDE["vim" if "vim" in cfg.net_mode else "imgs"]
    if "imgs" in cfg.net_mode or "vim" in cfg.net_mode:
        out["img0"], out["img1"] = (rng.uniform(0, 1, (B, side, side, 3)).astype(np.float32) for _ in range(2))
    out["gt_R"] = _rotations(rng, B)
    out["gt_t"] = rng.normal(0, 1, (B, 3)).astype(np.float32)
    return out


def _models(cfg, seed=0):
    """pope_tpu's MkptsRegModel (ConvNeXtV2 'test') with seeded variables,
    and the port's with the same weights."""
    jm = JaxReg(cfg, cnn_name="test")
    b = _batch(cfg, 0)
    v = seeded_variables(jm, *(jnp.asarray(b[k]) if k in b else None for k in ("mkpts0", "mkpts1", "img0", "img1")),
                         seed=seed)
    return jm, v, _port(MkptsRegModel(port_config(cfg), cnn_name="test"), v)


def _inputs(b):
    return tuple(b.get(k) for k in ("mkpts0", "mkpts1", "img0", "img1"))


MODES = [("mkpts", "6d", "cross_attn"), ("mkpts", "quat", "cross_attn"), ("mkpts", "matrix", "cross_attn"),
         ("imgs", "6d", "cross_attn"), ("vim", "quat", "cross_attn"), ("mkpts+imgs", "6d", "cross_attn"),
         ("mkpts+imgs", "matrix", "transformer"), ("mkpts+vim", "6d", "transformer"), ("mkpts+vim", "quat", "cross_attn")]


@pytest.mark.parametrize("mode,rotation,fusion", MODES, ids=["-".join(m) for m in MODES])
def test_mkpts_reg_model_matches_jax(mode, rotation, fusion):
    cfg = dataclasses.replace(TINY, net_mode=mode, rotation_mode=rotation, fusion=fusion)
    jm, v, model = _models(cfg)
    b = _batch(cfg, 1)
    with torch.no_grad():
        t, R = model(*(None if x is None else T(x) for x in _inputs(b)))
    jt, jR = jax.jit(jm.apply)(to_jax(v), *(None if x is None else jnp.asarray(x) for x in _inputs(b)))
    assert t.shape == (2, 3) and R.shape == (2, 3, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=TOL_ACT, rtol=0)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=TOL_ACT, rtol=0)


def test_pose_loss_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    pred_t, gt_t = (rng.normal(0, 1, (4, 3)).astype(np.float32) for _ in range(2))
    pred_R = rng.normal(0, 1, (4, 3, 3)).astype(np.float32) * 0.3 + _rotations(rng, 4)
    gt_R = _rotations(rng, 4)

    def jloss(pt, pR):
        return jtrain.pose_loss(pt, pR, jnp.asarray(gt_t), jnp.asarray(gt_R))[0]

    want, (wt, wr) = jtrain.pose_loss(*map(jnp.asarray, (pred_t, pred_R, gt_t, gt_R)))
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pred_t), jnp.asarray(pred_R))
    pt, pR = T(pred_t).requires_grad_(), T(pred_R).requires_grad_()
    loss, (tl, rl) = train.pose_loss(pt, pR, T(gt_t), T(gt_R))
    loss.backward()
    np.testing.assert_allclose([loss.item(), tl.item(), rl.item()], [float(want), float(wt), float(wr)], rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jg[0]), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(pR.grad.numpy(), np.asarray(jg[1]), atol=1e-6, rtol=1e-5)


def _jax_dropout_masks(jm, params, b, rng):
    """The keep masks of the MLP's four nn.Dropout layers for this dropout
    rng (flax derives each layer's from the rng and its path, so the train
    step's forward draws the same)."""
    def forward(params, inputs):
        masks = []

        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout):
                masks.append((out != 0) | (args[0] == 0))
            return out

        with fnn.intercept_methods(grab):
            jm.apply({"params": params}, *inputs, deterministic=False, rngs={"dropout": rng})
        return masks

    masks = jax.jit(forward)(params, tuple(None if x is None else jnp.asarray(x) for x in _inputs(b)))
    assert len(masks) == 4
    return [T(np.array(m)) for m in masks]


def test_train_step_matches_pope_tpu():
    """One AdamW step of 'mkpts+vim' (transformer fusion; the Vim frozen) from
    the same weights with the same dropout masks: the loss, the gradients
    within 1e-4 of each tensor's largest, and the weights after the step.
    Adam's first step moves a weight by lr * g / (|g| + eps), lr at most
    either way, so the weights agree within 2 lr everywhere and within
    1e-3 lr where |g| exceeds 1e-3 of the tensor's largest; the frozen
    Vim's gradients are 0 on both sides and its weights are decayed alike,
    to p (1 - lr wd)."""
    cfg = dataclasses.replace(TINY, net_mode="mkpts+vim", fusion="transformer", lr=1e-3, weight_decay=1e-2)
    jm, v, model = _models(cfg, seed=3)
    b = _batch(cfg, 6)
    params = to_jax(v["params"])
    tx = optax.chain(_capture_grads(), optax.adamw(cfg.lr, weight_decay=cfg.weight_decay))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params), tx=tx,
                              apply_fn=jm.apply)
    rng = jax.random.PRNGKey(11)
    masks = _jax_dropout_masks(jm, params, b, rng)
    new_state, ref = jax.jit(jtrain.train_step)(state, {k: jnp.asarray(x) for k, x in b.items()}, rng)
    pstate = train.create_train_state(model, port_config(cfg))
    got = train.train_step(pstate, {k: T(x) for k, x in b.items()}, masks)
    for k in ("loss", "t_loss", "r_loss"):
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)
    ref_g = regressor_state_from_jax({"params": jax.device_get(new_state.opt_state[0])})
    ref_p = regressor_state_from_jax({"params": jax.device_get(new_state.params)})
    before = regressor_state_from_jax(v)
    g_max = max(g.abs().max().item() for g in ref_g.values())
    for name, p in model.named_parameters():
        g, want_g = p.grad, ref_g[name]
        scale = want_g.abs().max().item()
        diff = (p.detach() - ref_p[name]).abs()
        assert diff.max().item() <= 2 * cfg.lr + 1e-7, name
        if name.endswith("key.bias"):
            # the softmax is invariant to the key bias: its gradient is 0 up
            # to rounding on both sides, whose sign Adam's first step turns
            # into +-lr
            assert max(scale, g.abs().max().item()) <= 1e-6 * g_max, name
            continue
        torch.testing.assert_close(g, want_g, atol=1e-4 * scale + 1e-12, rtol=0, msg=name)
        big = want_g.abs() > 1e-3 * scale
        if big.any():
            assert diff[big].max().item() <= 1e-3 * cfg.lr + 1e-7, name
        if name.startswith("vim."):
            assert scale == 0.0 and g.abs().max().item() == 0.0, name
            torch.testing.assert_close(p.detach(), before[name] * (1 - cfg.lr * cfg.weight_decay), atol=1e-7,
                                       rtol=1e-6, msg=name)


def test_eval_step_matches_jax():
    cfg = TINY
    jm, v, model = _models(cfg, seed=4)
    b = _batch(cfg, 7)
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=to_jax(v["params"]), opt_state=None,
                              tx=optax.identity(), apply_fn=jm.apply)
    ref = jtrain.eval_step(state, {k: jnp.asarray(x) for k, x in b.items()})
    got = train.eval_step(train.create_train_state(model, port_config(cfg)), {k: T(x) for k, x in b.items()})
    for k in ("pred_t", "pred_R"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=TOL_ACT, rtol=0, err_msg=k)
    for k in ("t_err", "R_err"):  # degrees
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-2, rtol=0, err_msg=k)


def test_dinov2_poser_and_posenet_loss_match_jax():
    rng = np.random.default_rng(8)
    img0, img1 = (rng.normal(0, 1, (2, 56, 56, 3)).astype(np.float32) for _ in range(2))
    jm = JaxPoser(dinov2=DINO, token_dim=64, nhead=4, depth=1)

    def fill(name, shape, rng):
        return _gamma(name, shape, rng)

    v = seeded_variables(jm, jnp.asarray(img0), jnp.asarray(img1), seed=5, fill=fill)
    model = _port(DINOv2Poser(port_config(DINO), token_dim=64, nhead=4, depth=1), v)
    with torch.no_grad():
        t, q = model(T(img0), T(img1))
    jt, jq = jax.jit(jm.apply)(to_jax(v), jnp.asarray(img0), jnp.asarray(img1))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=TOL_ACT, rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=TOL_ACT, rtol=0)
    gt_R, gt_t = _rotations(rng, 2), rng.normal(0, 1, (2, 3)).astype(np.float32)
    got = posenet_loss(t, q, T(gt_t), T(gt_R)).item()
    want = float(jax_posenet_loss(jt, jq, jnp.asarray(gt_t), jnp.asarray(gt_R)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # training the head: the frozen tower gets no gradient, the head does
    model.train()
    posenet_loss(*model(T(img0), T(img1)), T(gt_t), T(gt_R)).backward()
    assert all(p.grad is None for p in model.dino.parameters())
    assert model.head_fc2.weight.grad is not None and model.cls_token.grad is not None


def test_bridge_maps_the_three_dim_kernels():
    """flax MultiHeadDotProductAttention's (d, nh, hd) query kernels and
    (nh, hd) biases, its (nh, hd, d) out kernel, and conv1d (k, 1, Din)
    kernels become the port's Linear and Conv1d weights."""
    rng = np.random.default_rng(9)
    qk, qb, ok = rng.normal(0, 1, (6, 2, 3)), rng.normal(0, 1, (2, 3)), rng.normal(0, 1, (2, 3, 6))
    ck = rng.normal(0, 1, (4, 1, 5))
    sd = regressor_state_from_jax({"params": {"attn": {"query": {"kernel": qk, "bias": qb}, "out": {"kernel": ok}},
                                              "conv1d": {"kernel": ck}}})
    np.testing.assert_array_equal(sd["attn.query.weight"].numpy(), qk.reshape(6, 6).T.astype(np.float32))
    np.testing.assert_array_equal(sd["attn.query.bias"].numpy(), qb.reshape(6).astype(np.float32))
    np.testing.assert_array_equal(sd["attn.out.weight"].numpy(), ok.reshape(6, 6).T.astype(np.float32))
    np.testing.assert_array_equal(sd["conv1d.weight"].numpy(), ck.transpose(2, 1, 0).astype(np.float32))


def _torch_state(shapes, rng):
    return {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in shapes.items()}


def test_convert_copy_matches_jax():
    """convert.py's copy gives pope_tpu's trees on reference-layout state
    dicts (a ConvNeXtV2 'test' in FCMAE layout and a Vim of depth 2), and
    the port runs them through the bridge as pope_tpu runs them."""
    rng = np.random.default_rng(10)
    cnn = ConvNeXtV2.from_name("test", num_classes=0)
    sd = {}
    for k, p in cnn.state_dict().items():  # the reference's names for the port's tensors
        sd[k] = p.numpy()
    ref_keys = {}
    depths, dims = (1, 1, 2, 1), (16, 32, 64, 128)
    ref_keys["downsample_layers.0.0.weight"] = (dims[0], 3, 4, 4)
    ref_keys["downsample_layers.0.0.bias"] = (dims[0],)
    ref_keys["downsample_layers.0.1.weight"] = ref_keys["downsample_layers.0.1.bias"] = (dims[0],)
    for i in (1, 2, 3):
        ref_keys[f"downsample_layers.{i}.0.weight"] = ref_keys[f"downsample_layers.{i}.0.bias"] = (dims[i - 1],)
        ref_keys[f"downsample_layers.{i}.1.weight"] = (dims[i], dims[i - 1], 2, 2)
        ref_keys[f"downsample_layers.{i}.1.bias"] = (dims[i],)
    for i, depth in enumerate(depths):
        for j in range(depth):
            s, c = f"stages.{i}.{j}", dims[i]
            ref_keys.update({f"{s}.dwconv.weight": (c, 1, 7, 7), f"{s}.dwconv.bias": (c,), f"{s}.norm.weight": (c,),
                             f"{s}.norm.bias": (c,), f"{s}.pwconv1.weight": (4 * c, c), f"{s}.pwconv1.bias": (4 * c,),
                             f"{s}.grn.gamma": (1, 1, 1, 4 * c), f"{s}.grn.beta": (1, 1, 1, 4 * c),
                             f"{s}.pwconv2.weight": (c, 4 * c), f"{s}.pwconv2.bias": (c,)})
    ref_keys["norm.weight"] = ref_keys["norm.bias"] = (dims[-1],)
    sd = _torch_state(ref_keys, rng)
    want = jconvert.convert_torch_convnextv2_state(sd, depths)
    got = tconvert.convert_torch_convnextv2_state(sd, depths)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    img = rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        out = _port(cnn, got)(T(img)).numpy()
    ref = np.asarray(JaxConvNeXtV2.from_name("test", num_classes=0).apply(to_jax(want), jnp.asarray(img)))
    np.testing.assert_allclose(out, ref, atol=TOL_ACT, rtol=0)
    # the FCMAE remap
    fcmae = {"encoder.stages.0.0.dwconv.kernel": rng.normal(0, 1, (49, 16)),
             "encoder.stages.0.0.pwconv1.linear.weight": rng.normal(0, 1, (64, 16)),
             "encoder.downsample_layers.1.1.kernel": rng.normal(0, 1, (4, 16, 32)),
             "encoder.stages.0.0.grn.gamma": rng.normal(0, 1, (1, 64)),
             "decoder.x": np.zeros(1), "mask_token": np.zeros(1), "encoder.stem.bias": rng.normal(0, 1, (1, 16))}
    a, b = tconvert.remap_fcmae_keys(fcmae), jconvert.remap_fcmae_keys(fcmae)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # Vim, bidirectional
    vim = VisionMamba(VimConfig(**VIM_TEST))
    vsd = {}
    for k, p in vim.state_dict().items():
        k = k.replace("block_", "layers.").replace("A_log_b", "A_b_log")
        k = {"patch_embed.weight": "patch_embed.proj.weight", "patch_embed.bias": "patch_embed.proj.bias"}.get(k, k)
        vsd[k] = rng.normal(0, 0.2, p.shape).astype(np.float32)
    want = jconvert.convert_torch_vim_state(vsd, depth=2)
    got = tconvert.convert_torch_vim_state(vsd, depth=2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    img = rng.normal(0, 1, (1, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        out = _port(vim, got)(T(img)).numpy()
    ref = np.asarray(jax.jit(JaxVim(JaxVimConfig(**VIM_TEST)).apply)(to_jax(want), jnp.asarray(img)))
    np.testing.assert_allclose(out, ref, atol=TOL_ACT, rtol=0)
