"""The port's parallel layer (pope_tpu_torch/parallel, ops/ring_attention.py)
on four gloo CPU ranks, spawned once for the file, against numpy and
against pope_tpu on conftest's virtual devices: the collectives and their
gradients, shard_batch, shard_params_tp's choice of leaves (pope_tpu's
NamedSharding specs) and its sharded forwards, GPipe's loss and gradients
(pp = 2, and pp = 2 x dp = 2), its stage-count error and its bubble, and
ring attention over sp = 2, values and gradients, in f32 and in bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pope_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.models.regressor.model import MkptsRegModel as JaxReg
from pope_tpu.parallel import make_mesh as jax_make_mesh
from pope_tpu.parallel import shard_params_tp as jax_shard_params_tp
from pope_tpu.parallel.pipeline import pipeline_loss_and_grad as jax_pipeline_loss_and_grad
from pope_tpu.parallel.pipeline import shard_stage_params as jax_shard_stage_params
from pope_tpu.parallel.pipeline import stack_stage_params as jax_stack_stage_params
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.regressor.model import MkptsRegModel
from pope_tpu_torch.weights import matcher_state_from_jax, regressor_state_from_jax
from tests.test_torch_common import port_config, seeded_variables
from tests.test_torch_parallel_common import WORLD, Fields, rank_array, spawn_suite
from tests.test_torch_regressor import TINY as TINY_REG
from tests.test_torch_regressor import _batch as reg_batch
from tests.test_torch_train import TINY as TINY_MATCHER
from tests.test_torch_train import _bn

T = torch.from_numpy
D, N_MICRO, MB = 16, 5, 4
# f32 tolerances: GPipe runs the serial composition's own products (one
# reduction order), so its loss and gradients agree with pope_tpu's to f32
# rounding of O(1) values; ring attention sums the two K/V blocks' online
# softmax in another order than one softmax does: 1e-5 on O(1) outputs,
# 1e-4 on gradients (the JAX package's own bounds, tests/test_ring_attention.py)
TOL_PP = 1e-6
TOL_PP_GRAD = 1e-5
TOL_RING = 1e-5
TOL_RING_GRAD = 1e-4
# bf16 inputs accumulate in f32: one bf16 rounding of the O(1) output
TOL_RING_BF16 = 1.5e-2
# the tp forward gathers each sharded layer's output features: the same
# products, split by columns; f32 rounding of the models' O(1) outputs
TOL_TP = 1e-5


def _stages(rng, S):
    return [{"w": rng.normal(0, 0.5, (D, D)).astype(np.float32), "b": rng.normal(0, 0.1, (D,)).astype(np.float32)}
            for _ in range(S)]


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_norm_stage(p, x):
    x = x @ p["w"] + p["b"]
    return x / jnp.linalg.norm(x, axis=-1, keepdims=True)


def _mse(o, t):
    return jnp.mean((o - t) ** 2)


def _jax_pipeline(stage, stages, x, y, axes):
    devs = np.array(jax.devices()[: 2 * len(axes)])
    mesh = Mesh(devs.reshape((2,) * len(axes)), axes)
    stacked = jax_shard_stage_params(jax_stack_stage_params([jax.tree.map(jnp.asarray, s) for s in stages]),
                                     mesh, "pp")
    loss, grads = jax_pipeline_loss_and_grad(stage, _mse, mesh, "pp", "dp" if "dp" in axes else None)(
        stacked, jnp.asarray(x), jnp.asarray(y))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _full_attention(q, k, v):
    s = jnp.einsum("...nd,...md->...nm", q, k) / (q.shape[-1] ** 0.5)
    return jnp.einsum("...nm,...md->...nd", jax.nn.softmax(s, axis=-1), v)


def _jax_ring(q, k, v):
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    sharding = NamedSharding(mesh, P(*([None] * (q.ndim - 2)), "sp", None))
    attn = jax_ring_attention(mesh, "sp")
    put = lambda t: jax.device_put(jnp.asarray(t), sharding)
    out = np.asarray(jax.jit(attn)(put(q), put(k), put(v)).astype(jnp.float32))
    if q.dtype != np.float32:
        return out, None
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(attn(a, b, c) ** 2), argnums=(0, 1, 2)))(put(q), put(k), put(v))
    return out, [np.asarray(g) for g in grads]


def _jax_sharded_leaves(tree, state_from_jax):
    """The port's names of the leaves pope_tpu's shard_params_tp puts on tp
    (dp = 4 x tp = 2 of the 8 virtual devices): the bridge carries a tree
    of 1 (sharded) / 0 (replicated) markers across."""
    mesh = jax_make_mesh(8, tp=2)
    placed = jax_shard_params_tp(mesh, jax.tree.map(jnp.asarray, tree))
    marks = jax.tree.map(lambda a: np.full(a.shape, float("tp" in tuple(a.sharding.spec)), np.float32), placed)
    return sorted(k for k, v in state_from_jax({"params": marks}).items() if v.numel() and bool((v == 1).all()))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs, ref = {}, {}

    # shard_params_tp on the tiny matcher and the tiny 'mkpts+imgs' regressor
    z = jnp.zeros((1, 64, 80, 1))
    m_vars = seeded_variables(JaxMatcher(TINY_MATCHER), z, z, seed=1, fill=_bn)
    matcher = Matcher(port_config(TINY_MATCHER))
    matcher.load_state_dict(matcher_state_from_jax(m_vars), strict=True)
    imgs = tuple(T(rng.uniform(0, 1, (2, 64, 80, 1)).astype(np.float32)) for _ in range(2))
    reg_cfg = dataclasses.replace(TINY_REG, net_mode="mkpts+imgs")
    b = reg_batch(reg_cfg, 2)
    jreg = JaxReg(reg_cfg, cnn_name="test")
    r_vars = seeded_variables(jreg, *(jnp.asarray(b[k]) for k in ("mkpts0", "mkpts1", "img0", "img1")), seed=2)
    reg = MkptsRegModel(port_config(reg_cfg), cnn_name="test")
    reg.load_state_dict(regressor_state_from_jax(r_vars), strict=True)
    reg_args = tuple(T(b[k]) for k in ("mkpts0", "mkpts1", "img0", "img1"))
    tp_models = {"matcher": (Fields(matcher.eval(), ("mkpts0", "mkpts1", "mconf", "valid", "expec_f")), imgs),
                 "regressor": (reg.eval(), reg_args)}
    with torch.no_grad():
        ref["tp_out"] = {k: [t.numpy() for t in m(*a)] for k, (m, a) in tp_models.items()}
    ref["tp_leaves"] = {"matcher": _jax_sharded_leaves(m_vars["params"], matcher_state_from_jax),
                        "regressor": _jax_sharded_leaves(r_vars["params"], regressor_state_from_jax)}
    inputs["tp_models"] = tp_models

    # GPipe
    stages4 = _stages(rng, 4)
    x = rng.normal(0, 1, (N_MICRO, MB, D)).astype(np.float32)
    y = rng.normal(0, 1, (N_MICRO, MB, D)).astype(np.float32)
    stack = lambda ss: {k: torch.stack([T(s[k]) for s in ss]) for k in ss[0]}
    inputs["pipeline"] = {"stacked2": stack(stages4[:2]), "stacked4": stack(stages4), "x": T(x), "y": T(y)}
    ref["pp2"] = _jax_pipeline(_jax_stage, stages4[:2], x, y, ("pp",))
    ref["pp2_dp2"] = _jax_pipeline(_jax_stage, stages4[:2], x, y, ("pp", "dp"))
    ref["bubble"] = _jax_pipeline(_jax_norm_stage, stages4[:2], x, np.zeros_like(x), ("pp",))
    h = x
    for s in stages4[:2]:
        h = np.asarray(_jax_stage(jax.tree.map(jnp.asarray, s), h))
    ref["pp2_apply"] = h

    # ring attention
    ring = {}
    for name, shape, dtype in (("lead", (2, 3, 32, 8), np.float32), ("plain", (32, 8), np.float32),
                               ("bf16", (128, 16), jnp.bfloat16)):
        q, k, v = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(3))
        if dtype == np.float32:
            ring[name] = tuple(map(T, (q, k, v)))
            ref[f"ring_{name}"] = _jax_ring(q, k, v) + (np.asarray(_full_attention(q, k, v)),)
        else:
            qb, kb, vb = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16)) for t in (q, k, v))
            ring[name] = tuple(T(t.astype(np.float32)).to(torch.bfloat16) for t in (qb, kb, vb))
            full = _full_attention(*(jnp.asarray(t).astype(jnp.float32) for t in (qb, kb, vb)))
            ref[f"ring_{name}"] = _jax_ring(qb, kb, vb) + (np.asarray(full),)
    inputs["ring"] = ring

    work = tmp_path_factory.mktemp("parallel")
    torch.save(inputs, work / "inputs.pt")
    return spawn_suite(work, "parallel"), ref


def test_collectives_match_numpy(run):
    got, _ = run
    xs = [rank_array(r) for r in range(WORLD)]
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["all_reduce"], sum(xs), rtol=1e-6)
        np.testing.assert_array_equal(out["all_gather"], np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(out["broadcast"], xs[2])
        np.testing.assert_array_equal(out["shift"], xs[(r - 1) % WORLD])
        np.testing.assert_array_equal(out["all_gather_arrays"]["a"], np.stack(xs))
        np.testing.assert_allclose(out["all_gather_arrays"]["b"][0], [x.sum() for x in xs], rtol=1e-6)
        np.testing.assert_allclose(out["reduce_dict"]["loss"], np.mean([x.astype(np.float64).sum() for x in xs]),
                                   rtol=1e-6)
        assert out["reduce_dict"]["n"] == 1.5 and out["reduce_dict_sum"]["n"] == 6.0
        assert out["gather_to_main"] == ([{"rank": i} for i in range(WORLD)] if r == 0 else None)
        # host tensors under gloo: nothing staged
        assert out["stats"]["calls"] >= 8 and out["stats"]["staged_bytes"] == 0


def test_differentiable_collectives(run):
    """psum over dp (ranks {0, 2} and {1, 3} of the (dp 2, tp 2) mesh): the
    sum, and a gradient summed over the group; gather_parts over tp: each
    rank's gradient is the sum of both ranks' gradients of its slice."""
    got, _ = run
    xs = [rank_array(r) for r in range(WORLD)]
    for r, out in enumerate(got):
        group = [r % 2, r % 2 + 2]
        y = sum(xs[i] * (i + 1) for i in group)
        np.testing.assert_allclose(out["psum_in_mesh"], y, rtol=1e-6)
        # d/dx_r of sum over the group's ranks of |y|^2, each rank's y the same
        np.testing.assert_allclose(out["psum_grad"], 2 * 2 * y * (r + 1), rtol=1e-5)
        tp_rank = r % 2
        w = np.arange(2 * xs[r].size, dtype=np.float32).reshape(2 * xs[r].shape[0], -1)
        np.testing.assert_array_equal(out["gather_parts_grad"], 2 * w[tp_rank * 3:(tp_rank + 1) * 3])


def test_shard_batch(run):
    """dp rank r // 2 takes rows [4 (r // 2), 4 (r // 2 + 1)); the sp axis
    goes over tp where it divides (6 columns), not where it does not (3)."""
    got, _ = run
    a, b = np.arange(48).reshape(8, 6), np.arange(24).reshape(8, 3)
    for r, out in enumerate(got):
        sb, split = out["shard_batch"]
        d, t = r // 2, r % 2
        np.testing.assert_array_equal(sb["a"], a[4 * d:4 * d + 4, 3 * t:3 * t + 3])
        np.testing.assert_array_equal(sb["b"], b[4 * d:4 * d + 4])
        assert split == ["a"]


@pytest.mark.parametrize("name", ["matcher", "regressor"])
def test_shard_params_tp_leaves_and_forward(run, name):
    """The port cuts the kernels pope_tpu's rule puts on tp (at least 2-D,
    at least 1024 elements, output features divisible by tp), with their
    layers' biases (a layer computes its output-feature shard), and the
    sharded forward (tp = 2) gives the unsharded one."""
    got, ref = run
    assert ref["tp_leaves"][name], "the tiny model must have leaves to shard"
    for out in got:
        leaves, outputs = out[f"tp_{name}"]
        leaves = [n.removeprefix("module.") for n in leaves]
        kernels = sorted(n for n in leaves if n.endswith(".weight"))
        assert kernels == ref["tp_leaves"][name]
        assert set(leaves) - set(kernels) <= {k[: -len("weight")] + "bias" for k in kernels}
        for a, b in zip(outputs, ref["tp_out"][name]):
            np.testing.assert_allclose(a, b, atol=TOL_TP, rtol=TOL_TP)


@pytest.mark.parametrize("case", ["pp2", "pp2_dp2", "bubble"])
def test_gpipe_loss_and_grads_match_pope_tpu(run, case):
    """One loss over the replicated output and each rank's stage gradient,
    against pope_tpu's pipeline_loss_and_grad on the same mesh shape; the
    bubble case's stage divides by the activation norm, so a zero
    placeholder would give NaN gradients."""
    got, ref = run
    want_loss, want_grads = ref[case]
    for r, out in enumerate(got):
        loss, grads = out[case]
        stage = r // 2 if case == "pp2_dp2" else r % 2
        np.testing.assert_allclose(loss, want_loss, rtol=TOL_PP, atol=TOL_PP)
        for k, g in grads.items():
            assert g.shape == (1,) + want_grads[k].shape[1:]
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g[0], want_grads[k][stage], atol=TOL_PP_GRAD, rtol=0, err_msg=k)


def test_gpipe_apply_and_stage_count(run):
    """pipeline_apply gives the serial composition on every rank; 4 stages
    on 2 pp ranks cut cleanly but are refused: one stage per rank."""
    got, ref = run
    for out in got:
        np.testing.assert_allclose(out["pp2_apply"], ref["pp2_apply"], atol=TOL_PP)
        assert out["mismatch"] is not None and "one stage per rank" in out["mismatch"]


@pytest.mark.parametrize("name", ["lead", "plain"])
def test_ring_attention_matches_pope_tpu(run, name):
    """Each rank's token block of the output and of the q / k / v gradients
    of sum(out^2), against pope_tpu's ring attention over sp = 2 and the
    plain full softmax."""
    got, ref = run
    want, want_grads, full = ref[f"ring_{name}"]
    for r, out in enumerate(got):
        res = out[f"ring_{name}"]
        n = want.shape[-2] // 2
        rows = slice((r % 2) * n, (r % 2 + 1) * n)
        np.testing.assert_allclose(res["out"], want[..., rows, :], atol=TOL_RING)
        np.testing.assert_allclose(res["out"], full[..., rows, :], atol=TOL_RING)
        for g, w in zip(res["grads"], want_grads):
            np.testing.assert_allclose(g, w[..., rows, :], atol=TOL_RING_GRAD)


def test_ring_attention_bf16_accumulates_f32(run):
    """bf16 in, bf16 out, f32 accumulators: within one bf16 rounding of the
    f32 attention of the same bf16 inputs, as pope_tpu's."""
    got, ref = run
    want, _, full = ref["ring_bf16"]
    for r, out in enumerate(got):
        res = out["ring_bf16"]
        assert res["dtype"] == "torch.bfloat16"
        rows = slice((r % 2) * 64, (r % 2 + 1) * 64)
        assert np.abs(res["out"] - full[rows]).max() < TOL_RING_BF16
        assert np.abs(res["out"] - want[rows]).max() < TOL_RING_BF16
