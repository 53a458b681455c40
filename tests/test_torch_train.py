"""The port's matcher training (pope_tpu_torch/train, the train-mode
matcher, sinkhorn and GT padding) against pope_tpu's on the same seeded
inputs and weights, carried across by the weights bridge: supervision,
losses and their gradients, GT padding, the sinkhorn assignment, train-mode
BatchNorm, schedules, optimizers and clipping, and two whole train steps
with the dual-softmax and the sinkhorn assignment."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.models.matcher.backbone import ResNetFPN as JaxResNetFPN
from pope_tpu.models.matcher.matching import CoarseMatches as JaxCoarseMatches
from pope_tpu.models.matcher.matching import gt_pad_matches as jax_gt_pad_matches
from pope_tpu.models.matcher.matching import sinkhorn_confidence as jax_sinkhorn
from pope_tpu.train import loss as jax_loss
from pope_tpu.train import optim as jax_optim
from pope_tpu.train import supervision as jax_spv
from pope_tpu.train.trainer import MatcherTrainState as JaxState
from pope_tpu.train.trainer import matcher_train_step as jax_train_step
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.matcher.backbone import ResNetFPN
from pope_tpu_torch.models.matcher.matching import CoarseMatches, gt_pad_matches, sinkhorn_confidence
from pope_tpu_torch.train import loss, optim, supervision, trainer
from pope_tpu_torch.weights import matcher_state_from_jax
from tests.test_torch_common import port_config, seeded_variables, to_jax
from tests.test_train import _tiny_matcher

T = torch.from_numpy
TINY = _tiny_matcher().config  # ResNet-FPN 16/24/32, coarse d 32, fine d 16, capacity 32
SINKHORN = dataclasses.replace(TINY, match_coarse=dataclasses.replace(TINY.match_coarse, match_type="sinkhorn"))
LR = 1e-3


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tiny models: two intra-op threads are as fast as eight here, and the
    test run's parallel workers share the cores (with eight each, the
    validation solver's many small ops ran 70x slower under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _bn(name, shape, rng):
    # running statistics away from flax's init (0 and 1), so that a wrong
    # momentum or a dropped update shows
    return {"mean": rng.normal(0, 0.2, shape), "var": rng.uniform(0.5, 2.0, shape)}.get(name)


def _geometry_batch(seed, B=2, H=64, W=80):
    """Smooth textures, a tilted, bumpy depth surface and a rotation plus
    translation between the views: warps that are neither pure shifts nor
    planar, in numpy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = {k: [] for k in ("image0", "image1", "depth0", "depth1", "T_0to1", "T_1to0", "K0", "K1")}
    for _ in range(B):
        for k in ("image0", "image1"):
            out[k].append(rng.uniform(0, 1, (H, W, 1)))
        for k in ("depth0", "depth1"):
            d = 2.0 + 0.3 * np.sin(xx / rng.uniform(5, 9)) + 0.002 * rng.uniform(-1, 1) * yy * xx
            d[rng.uniform(size=(H, W)) < 0.05] = 0.0  # holes
            out[k].append(d)
        a, b = rng.uniform(-0.08, 0.08, 2)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]) @ np.array(
            [[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        Tm = np.eye(4)
        Tm[:3, :3], Tm[:3, 3] = R, rng.uniform(-0.15, 0.15, 3)
        out["T_0to1"].append(Tm)
        out["T_1to0"].append(np.linalg.inv(Tm))
        f = rng.uniform(70, 110)
        out["K0"].append(np.array([[f, 0, W / 2 + 1.5], [0, f * 1.02, H / 2 - 0.5], [0, 0, 1]]))
        out["K1"].append(np.array([[f * 0.95, 0, W / 2], [0, f * 0.97, H / 2], [0, 0, 1]]))
    return {k: np.stack(v).astype(np.float32) for k, v in out.items()}


def _both(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}, {k: T(v) for k, v in batch.items()}


# --- supervision ---------------------------------------------------------------------------

def test_warp_kpts():
    """Warped keypoints to f32 rounding, the same validity flags."""
    b = _geometry_batch(0)
    kp = np.random.default_rng(1).uniform(-2, 82, (2, 200, 2)).astype(np.float32)
    jb, tb = _both(b)
    args = ("depth0", "depth1", "T_0to1", "K0", "K1")
    rv, rw = jax.jit(jax_spv.warp_kpts)(jnp.asarray(kp), *(jb[k] for k in args))
    v, w = supervision.warp_kpts(T(kp), *(tb[k] for k in args))
    assert 20 < int(rv.sum()) < 400  # some of each
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scale0-scale1"])
def test_spvs_coarse_and_fine(scaled):
    """The GT matrix, rows and columns exactly; the warped points and fine
    offsets to f32 rounding (1e-5 of a window)."""
    b = _geometry_batch(2)
    if scaled:  # MegaDepth-style resize scales, images stay 64x80
        b["scale0"] = np.array([[1.0, 1.0], [1.25, 1.25]], np.float32)
        b["scale1"] = np.array([[1.0, 1.0], [0.8, 0.8]], np.float32)
    jb, tb = _both(b)
    ref = jax.jit(jax_spv.spvs_coarse, static_argnums=1)(jb, 8)
    out = supervision.spvs_coarse(tb, 8)
    assert int(ref["spv_valid"].sum()) > 10
    for key in ("conf_matrix_gt", "spv_valid", "spv_j_of_i"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    for key in ("spv_w_pt0_i", "spv_grid_pt1_i"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-3, rtol=1e-5, err_msg=key)
    rng = np.random.default_rng(3)
    i_ids, j_ids = rng.integers(0, 80, (2, 2, 30))
    ref_f = jax_spv.spvs_fine(ref, jnp.asarray(i_ids), jnp.asarray(j_ids), 2, 5)
    out_f = supervision.spvs_fine(out, T(i_ids), T(j_ids), 2, 5)
    np.testing.assert_allclose(out_f.numpy(), np.asarray(ref_f), atol=1e-5 * np.abs(ref_f).max(), rtol=0)


def test_spvs_fine_scale1_gap():
    """pope_tpu's trainer calls spvs_fine without scale1; the reference
    scales the fine window by scale * scale1 where a batch carries
    scale0 (MegaDepth). With scale1 != 1 the two targets differ by that
    factor: the port copies pope_tpu's call (ROADMAP Queue 3)."""
    b = _geometry_batch(4)
    b["scale0"] = np.full((2, 2), 1.5, np.float32)
    b["scale1"] = np.full((2, 2), 1.5, np.float32)
    tb = {k: T(v) for k, v in b.items()}
    spv = supervision.spvs_coarse(tb, 8)
    i_ids = torch.nonzero(spv["spv_valid"][0])[:, 0][None].expand(2, -1)[:, :20]
    j_ids = spv["spv_j_of_i"].gather(1, i_ids)
    without = supervision.spvs_fine(spv, i_ids, j_ids, 2, 5)
    with_s = supervision.spvs_fine(spv, i_ids, j_ids, 2, 5, scale1=tb["scale1"])
    torch.testing.assert_close(without, with_s * 1.5, atol=1e-6, rtol=1e-6)
    assert (without - with_s).abs().max() > 0.05  # the gap is real


# --- losses ----------------------------------------------------------------------------------

@pytest.mark.parametrize("coarse_type", ["focal", "cross_entropy"])
def test_coarse_loss_and_gradient(coarse_type):
    """Value and d/d conf against jax.grad, f32 rounding (rtol 1e-5)."""
    rng = np.random.default_rng(5)
    conf = rng.uniform(0, 1, (2, 30, 40)).astype(np.float32) ** 3
    conf[0, 0, :3] = [0.0, 1.0, 1e-7]  # the clip's ends
    gt = (rng.uniform(size=conf.shape) > 0.97).astype(np.float32)
    w = rng.uniform(0.5, 1.5, conf.shape).astype(np.float32)
    cfg = jax_loss.LossConfig(coarse_type=coarse_type, pos_weight=1.3, neg_weight=0.7)
    tcfg = loss.LossConfig(**dataclasses.asdict(cfg))
    for weight in (None, w):
        f = lambda c: jax_loss.coarse_loss(c, jnp.asarray(gt), cfg, None if weight is None else jnp.asarray(weight))
        ref, ref_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(conf))
        c = T(conf).requires_grad_()
        out = loss.coarse_loss(c, T(gt), tcfg, None if weight is None else T(weight))
        out.backward()
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-5 * np.abs(ref_g).max())


@pytest.mark.parametrize("fine_type", ["l2", "l2_with_std"])
def test_fine_loss_and_gradient(fine_type):
    """Value and d/d expec_f against jax.grad (the std weight detached in
    both), f32 rounding (rtol 1e-5)."""
    rng = np.random.default_rng(6)
    expec = np.concatenate([rng.uniform(-1, 1, (2, 24, 2)), rng.uniform(0.05, 1.5, (2, 24, 1))], -1)
    expec = expec.astype(np.float32)
    gt = rng.uniform(-1.3, 1.3, (2, 24, 2)).astype(np.float32)  # some outside the window
    valid = rng.uniform(size=(2, 24)) > 0.2
    cfg = jax_loss.LossConfig(fine_type=fine_type)
    f = lambda e: jax_loss.fine_loss(e, jnp.asarray(gt), jnp.asarray(valid), cfg)
    ref, ref_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(expec))
    e = T(expec).requires_grad_()
    out = loss.fine_loss(e, T(gt), T(valid), loss.LossConfig(fine_type=fine_type))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-6 * np.abs(ref_g).max())
    if fine_type == "l2_with_std":
        assert np.all(np.asarray(ref_g)[..., 2] == 0) and np.all(e.grad[..., 2].numpy() == 0)


# --- GT padding and sinkhorn -------------------------------------------------------------------

@pytest.mark.parametrize("keyed", [False, True], ids=["hash", "key"])
@pytest.mark.parametrize("M,L", [(12, 64), (40, 30)], ids=["M<L", "M>L"])
def test_gt_pad_matches(keyed, M, L):
    """Exactly pope_tpu's slots: its fixed hash noise, or its
    jax.random.uniform draw passed in as the noise. Many rows tie at -1 (no
    GT), which the stable sort orders as jax.lax.top_k does."""
    rng = np.random.default_rng(7 + M)
    B = 3
    valid = rng.uniform(size=(B, M)) > 0.4
    conf = np.where(valid, rng.uniform(0.2, 1, (B, M)), 0).astype(np.float32)
    i_ids, j_ids = rng.integers(0, L, (2, B, M))
    gt_valid = rng.uniform(size=(B, L)) > 0.6
    gt_valid[2] = False  # a pair without GT
    gt_valid[1, :] = gt_valid[1, :] & (np.arange(L) % 7 == 0)  # one with few
    gt_j = rng.integers(0, L, (B, L))
    key = jax.random.PRNGKey(11) if keyed else None
    noise = T(np.array(jax.random.uniform(key, (B, L)))) if keyed else None
    jcm = JaxCoarseMatches(jnp.asarray(i_ids), jnp.asarray(j_ids), jnp.asarray(conf), jnp.asarray(valid),
                           jnp.zeros(B, jnp.int32))
    pad = jax.jit(functools.partial(jax_gt_pad_matches, gt_min=M // 3))
    ref = pad(jcm, jnp.asarray(gt_valid), jnp.asarray(gt_j), key=key)
    cm = CoarseMatches(T(i_ids), T(j_ids), T(conf), T(valid), torch.zeros(B, dtype=torch.int64))
    out = gt_pad_matches(cm, T(gt_valid), T(gt_j), gt_min=M // 3, noise=noise)
    for name in ("i_ids", "j_ids", "mconf", "valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("prefilter", [True, False])
def test_sinkhorn_confidence_and_bin_score_gradient(prefilter):
    """The confidence (f32 rounding, 1e-6 absolute on values up to 1) and
    d loss / d bin_score against jax.grad (rtol 1e-4)."""
    rng = np.random.default_rng(8)
    f0 = (rng.normal(0, 1, (2, 24, 16)) * 3).astype(np.float32)
    f1 = np.concatenate([f0[:, 4:20] + 0.3 * rng.normal(0, 1, (2, 16, 16)),
                         rng.normal(0, 3, (2, 14, 16))], 1).astype(np.float32)
    w = rng.uniform(0, 1, (2, 24, 30)).astype(np.float32)
    conf = lambda b: jax_sinkhorn(jnp.asarray(f0), jnp.asarray(f1), b, 3, prefilter)
    ref, vjp = jax.vjp(jax.jit(conf), jnp.asarray(0.7))
    ref, ref_g = np.asarray(ref), float(vjp(jnp.asarray(w))[0])
    b = torch.tensor(0.7, requires_grad=True)
    out = sinkhorn_confidence(T(f0), T(f1), b, iters=3, prefilter=prefilter)
    (out * T(w)).sum().backward()
    if prefilter:
        assert 0 < (ref == 0).mean() < 1  # some rows or columns went to the dustbin
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(b.grad.item(), ref_g, rtol=1e-4)


# --- train-mode BatchNorm ----------------------------------------------------------------------

def test_train_mode_batchnorm():
    """The backbone in train mode against flax's mutable=["batch_stats"]:
    outputs (2e-4 of the largest, as the eval-mode test) and the running
    statistics after one step (rtol 1e-4: momentum 0.9 and the biased
    variance)."""
    bb = JaxResNetFPN(initial_dim=16, block_dims=(16, 24, 32))
    x = np.random.default_rng(9).uniform(0, 1, (3, 48, 64, 1)).astype(np.float32)
    variables = seeded_variables(bb, jnp.zeros((1, 48, 64, 1)), seed=3, fill=_bn)
    (ref_c, ref_f), mutated = jax.jit(functools.partial(bb.apply, train=True, mutable=["batch_stats"]))(
        to_jax(variables), jnp.asarray(x))
    port = ResNetFPN(16, (16, 24, 32))
    port.load_state_dict(matcher_state_from_jax(variables))
    port.train()
    out_c, out_f = port(T(x))
    for got, want in ((out_c, ref_c), (out_f, ref_f)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4 * np.abs(want).max(), rtol=0)
    stats = matcher_state_from_jax({"params": {}, "batch_stats": jax.device_get(mutated["batch_stats"])})
    before = matcher_state_from_jax(variables)
    state = port.state_dict()
    for name, want in stats.items():
        assert not torch.equal(want, before[name])
        torch.testing.assert_close(state[name], want, rtol=1e-4, atol=1e-6)
    port.eval()  # eval mode reads the updated running statistics
    with torch.no_grad():
        assert torch.equal(port(T(x))[0], port(T(x))[0])


# --- schedules, optimizers, clipping ---------------------------------------------------------------

SCHEDULES = [
    dict(scheduler="MultiStepLR", mslr_milestones=(1, 2), steps_per_epoch=4, warmup_steps=3, warmup_ratio=0.1),
    dict(scheduler="CosineAnnealing", cosa_tmax=2, steps_per_epoch=5, warmup_steps=4, warmup_type="constant",
         warmup_ratio=0.25),
    dict(scheduler="ExponentialLR", elr_gamma=0.9, warmup_steps=5),
    dict(scheduler="MultiStepLR", mslr_milestones=(1,), steps_per_epoch=3, warmup_steps=0),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"{kw['scheduler']}-w{kw['warmup_steps']}")
def test_schedules(kw):
    """The lr at steps 0..14 against the optax schedules (f32 there: rtol
    1e-6), through the torch scheduler as the optimizer sees it."""
    cfg = jax_optim.OptimConfig(lr=0.01, **kw)
    sched = jax_optim.build_schedule(cfg)
    ref = [float(sched(jnp.asarray(k))) for k in range(15)]
    tcfg = optim.OptimConfig(lr=0.01, **kw)
    fn = optim.build_schedule(tcfg)
    np.testing.assert_allclose([fn(k) for k in range(15)], ref, rtol=1e-6, atol=1e-12)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, sch = optim.build_optimizer([p], tcfg)
    seen = []
    for _ in range(15):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sch.step()
    np.testing.assert_allclose(seen, ref, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("kw", [dict(warmup_steps=0), dict(warmup_steps=4, warmup_ratio=0.2)],
                         ids=["no-warmup", "warmup"])
def test_optimizer_and_clip_three_updates(name, kw):
    """optax.chain(clip_by_global_norm(0.5), build_optimizer(cfg)) against
    clip_by_global_norm_ + build_optimizer over 3 updates from the same
    gradients: one under the clip norm, two above. Parameters to 1e-6
    (Adam's steps are about lr = 0.01 here)."""
    rng = np.random.default_rng(10)
    params = {"a": rng.normal(0, 1, (4, 3)), "b": rng.normal(0, 1, (5,))}
    grads = [{k: rng.normal(0, s, v.shape) for k, v in params.items()} for s in (0.05, 1.0, 3.0)]
    cfg = jax_optim.OptimConfig(optimizer=name, lr=0.01, weight_decay=0.1, scheduler="ExponentialLR",
                                elr_gamma=0.95, **kw)
    tx = optax.chain(optax.clip_by_global_norm(0.5), jax_optim.build_optimizer(cfg))
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(T(v.astype(np.float32))) for k, v in params.items()}
    opt, sch = optim.build_optimizer(list(tp.values()), optim.OptimConfig(**dataclasses.asdict(cfg)))
    norms = []
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = T(g[k].astype(np.float32))
        norms.append(optim.clip_by_global_norm_(list(tp.values()), 0.5).item())
        opt.step()
        sch.step()
    assert norms[0] < 0.5 < norms[1]
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)


# --- whole train steps ---------------------------------------------------------------------------------

def _capture_grads():
    """A first link of an optax chain that keeps the step's raw gradients in
    its state, so that pope_tpu's own train step hands them out."""
    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _run_both(cfg, batch, n_steps=2):
    """n_steps of pope_tpu's matcher_train_step (jitted) and of the port's,
    from the same seeded weights and BatchNorm statistics, on one batch; the
    optimizer is the driver's: clip 0.5, then AdamW without warmup. Returns,
    per step, pope_tpu's metrics, its gradients, its state before the step
    (as a state_dict), the port's metrics and gradients, and pope_tpu's Adam
    moments before the step (two state_dicts); then both final states."""
    z = jnp.zeros((1,) + batch["image0"].shape[1:])
    variables = seeded_variables(JaxMatcher(cfg), z, z, seed=5, fill=_bn)
    ocfg = dict(lr=LR, warmup_steps=0, scheduler="ExponentialLR", elr_gamma=0.99)
    tx = optax.chain(_capture_grads(), optax.clip_by_global_norm(0.5),
                     jax_optim.build_optimizer(jax_optim.OptimConfig(**ocfg)))
    params = to_jax(variables["params"])
    state = JaxState(jnp.zeros((), jnp.int32), params, to_jax(variables["batch_stats"]), tx.init(params))
    step = jax.jit(lambda s, b: jax_train_step(JaxMatcher(cfg), tx, s, b))

    port = Matcher(port_config(cfg))
    port.load_state_dict(matcher_state_from_jax(variables), strict=True)
    pstate = trainer.init_matcher_train_state(port, optim.OptimConfig(**ocfg), grad_clip=0.5)
    grads = []
    apply = trainer.apply_gradients

    def spy(s, *args):
        grads.append({n: p.grad.clone() for n, p in s.model.named_parameters()})
        apply(s, *args)

    as_state = lambda s: matcher_state_from_jax({"params": jax.device_get(s.params),
                                                 "batch_stats": jax.device_get(s.batch_stats)})
    jb, tb = _both(batch)
    out = []
    for _ in range(n_steps):
        before = as_state(state)
        adam = state.opt_state[2][0]
        moments = tuple(matcher_state_from_jax({"params": jax.device_get(m)}) for m in (adam.mu, adam.nu))
        state, ref = step(state, jb)
        trainer.apply_gradients = spy
        try:
            got = trainer.matcher_train_step(pstate, tb)
        finally:
            trainer.apply_gradients = apply
        ref_grads = matcher_state_from_jax({"params": jax.device_get(state.opt_state[0])})
        out.append((ref, ref_grads, before, got, grads[-1], moments))
    return out, as_state(state), pstate


def _port_step_from(cfg, state_dict, moments, n_steps_before, batch):
    """The port's train step from pope_tpu's state: its weights and
    statistics, its Adam moments and its step count. Returns the state
    after the step."""
    port = Matcher(port_config(cfg))
    port.load_state_dict(state_dict, strict=True)
    pstate = trainer.init_matcher_train_state(
        port, optim.OptimConfig(lr=LR, warmup_steps=0, scheduler="ExponentialLR", elr_gamma=0.99), grad_clip=0.5)
    mu, nu = moments
    for name, p in port.named_parameters():
        pstate.optimizer.state[p] = {"step": torch.tensor(float(n_steps_before)), "exp_avg": mu[name].clone(),
                                     "exp_avg_sq": nu[name].clone()}
    with warnings.catch_warnings():  # the schedule advanced without its optimizer's steps
        warnings.simplefilter("ignore", UserWarning)
        for _ in range(n_steps_before):
            pstate.scheduler.step()
    trainer.matcher_train_step(pstate, batch)
    return port.state_dict()


def _port_grads(cfg, state_dict, batch):
    """The port's gradients of one step's loss at the given weights."""
    port = Matcher(port_config(cfg))
    port.load_state_dict(state_dict, strict=True)
    port.train()
    total, _ = trainer.train_loss(port, batch)
    total.backward()
    return {n: p.grad for n, p in port.named_parameters()}


@pytest.mark.parametrize("cfg,batch_seed", [(TINY, 17), (SINKHORN, 19)], ids=["dual_softmax", "sinkhorn"])
def test_two_train_steps_match_pope_tpu(cfg, batch_seed):
    """Two steps on one batch (B = 2, 64x80, the tiny matcher of
    tests/test_train.py, capacity 32 of which GT pads at least 16).

    Gradients, tightly: each step's gradient at pope_tpu's weights before
    that step, within 2e-4 of the tensor's largest gradient (20-odd f32
    layers forward and back). The loss is ill-conditioned wherever a
    confidence sits a few ulps below 1 or a fine heatmap is one-hot (1 -
    conf, or the clipped variance behind the inverse-std weight, keeps a few
    bits): a 3e-7 relative change of one input image then moves the port's
    own gradients by 5e-3. The batch and weights here have neither. A ReLU
    whose input lies within the two packages' forward rounding of 0 (1e-5
    here) takes the other side in one of them, and through the batch
    statistics and LayerNorms that moves whole tensors' gradients by up to
    4e-2 of their largest; about half of the seeded batches have one at one
    of the two steps' weights, so each assignment's batch is one without
    (seed 17 dual-softmax, 19 sinkhorn; the gradients then agree within
    1.1e-4).

    The port's own two steps: loss, loss_coarse and loss_fine to rtol 1e-4.
    Its weights after the first step differ from pope_tpu's wherever a
    gradient is near zero: Adam's first step is lr * g / (|g| + eps), so a
    sign that flips on a gradient within rounding of 0 moves that weight by
    up to 2 lr. Its second step's gradients at those weights then differ
    from pope_tpu's by as much as the ReLU flips above make them: 2e-3 of a
    tensor's largest on one machine, 0.24 on another (sinkhorn,
    layer3_0.cb2.conv; at pope_tpu's own weights the two agree within 1e-5
    on both). So after the port's own two steps: parameters within 4 lr of
    pope_tpu's everywhere (two Adam steps of at most lr each, either side;
    measured 1.4 lr), BatchNorm statistics to rtol 2e-3 (measured 8.5e-4).
    And the port's second step taken from pope_tpu's state after the first
    (weights, statistics, Adam moments): parameters within 0.1 lr of
    pope_tpu's where both steps' gradients exceed 0.1 of the tensor's
    largest and share a sign (Adam's moments do not cancel there).
    The loss falls from step 1 to step 2 in both."""
    batch = _geometry_batch(batch_seed)
    steps, ref_state, pstate = _run_both(cfg, batch)
    tb = {k: T(v) for k, v in batch.items()}
    for i, (ref, ref_g, before, got, got_g, _) in enumerate(steps):
        for k in ("loss", "loss_coarse", "loss_fine"):
            np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
        assert float(ref["loss_fine"]) > 1e-4  # the GT-padded fine stage has signal
        at_ref = got_g if i == 0 else _port_grads(cfg, before, tb)
        assert set(ref_g) == set(at_ref)
        for name, want in ref_g.items():
            scale = want.abs().max().item()
            torch.testing.assert_close(at_ref[name], want, atol=2e-4 * scale + 1e-12, rtol=0, msg=name)
    assert steps[1][3]["loss"] < steps[0][3]["loss"] and float(steps[1][0]["loss"]) < float(steps[0][0]["loss"])
    state = pstate.model.state_dict()
    assert set(state) == set(ref_state)
    from_ref = _port_step_from(cfg, steps[1][2], steps[1][5], 1, tb)
    n_tight = 0
    for name, want in ref_state.items():
        got = state[name]
        if "running_" in name:
            torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-6, msg=name)
            continue
        assert (got - want).abs().max().item() <= 4 * LR, name
        got = from_ref[name]
        g1, g2 = (s[1][name] for s in steps)
        big = (g1.abs() > 0.1 * g1.abs().max()) & (g2.abs() > 0.1 * g2.abs().max()) & (g1 * g2 > 0)
        if big.any():
            n_tight += int(big.sum())
            assert (got - want)[big].abs().max().item() <= 0.1 * LR, name
    assert n_tight > 10000
    if cfg is SINKHORN:
        assert "bin_score" in state and state["bin_score"].ndim == 0
