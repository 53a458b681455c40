"""The port's sharded programs on four gloo CPU ranks (spawned once for the
file), each against the port's single-process result on the global batch
and, where pope_tpu runs the same program, against pope_tpu's sharded
result on conftest's virtual devices:
- stage 2 at dp = 2 (`PipelineExecutor.batched(mesh=)`, as
  tests/test_pipeline_e2e.py::test_batched_pairs_dp_sharded) and the eval
  driver at dp = 2 (`evaluate_dataset(mesh=)`, records gathered to rank 0);
- the matcher's train step at dp = 2 and at tp = 2 (BatchNorm statistics
  included);
- the SSL step at dp = 2 with an FSDP-cut state (shard_ssl_state);
- the pose regressor's step at dp = 2 x tp = 2 (program 1 of
  __graft_entry__.dryrun_multichip);
- train_ssl and train_matcher over a mesh, the latter at dp = 2 and tp = 2
  with checkpoints and a resume, against the single runs.
Two-rank cases run on both halves of the four ranks."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pope_tpu.train.ssl as jssl
import pope_tpu_torch.train.ssl as tssl
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.pipeline.api import PopeModels as JaxModels
from pope_tpu.parallel import make_mesh as jax_make_mesh
from pope_tpu.pipeline.pose_pipeline import PipelineExecutor as JaxExecutor
from pope_tpu_torch.config import RegressorConfig
from pope_tpu_torch.eval import evaluate_dataset
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.regressor import train as rtrain
from pope_tpu_torch.models.regressor.model import MkptsRegModel, dropout_masks
from pope_tpu_torch.pipeline import PipelineExecutor, PopeModels, runner
from pope_tpu_torch.train import optim, trainer
from pope_tpu_torch.train.matcher_driver import TrainMatcherConfig, train_matcher
from pope_tpu_torch.utils.checkpoint import load_payload
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax
from tests.test_torch_common import port_config, seeded_variables
from tests.test_torch_eval import CROP as EVAL_CROP
from tests.test_torch_eval import assert_records_match_jax, assert_same_records, dataset, models, table_tol  # noqa: F401
from tests.test_torch_parallel_common import relu_signs, spawn_suite
from tests.test_torch_pipeline import CFG, CROP, DINO, MATCHER, _gamma, _inputs
from tests.test_torch_solver import jax_noise
from tests.test_torch_ssl import TINY_BB, TINY_SSL, TOL_METRIC, TOL_MOMENTS, TOL_WEIGHTS
from tests.test_torch_ssl import _batch as ssl_batch
from tests.test_torch_ssl import _close_to_max, _close_where_conditioned, _jax_state, _named, _port_arch, _port_state
from tests.test_torch_ssl_driver import image_root  # noqa: F401
from tests.test_torch_train import TINY as TINY_MATCHER
from tests.test_torch_train import _bn, _geometry_batch
from tests.test_train_matcher_driver import SynthScene, _fast_cfg

T = torch.from_numpy
B = 4  # the global batch of every program
# Tolerances against the port's single-process step on the global batch:
# the same products, but BatchNorm's statistics, the loss normalisers and
# the gradients are summed across ranks in another order.
TOL_LOSS = 1e-5  # relative, losses O(1)
TOL_GRAD = 1e-4  # of each tensor's largest |gradient|
TOL_STATS = 1e-5  # BatchNorm running statistics, O(1)
TOL_MOMENTS_2 = 1e-4  # Adam moments after two such steps, of each tensor's largest
# stage 2 (tests/test_torch_pipeline.py's bounds against pope_tpu): match
# coordinates 1e-3 px, R and t 2e-3; against the port's own single run the
# dp run computes each pair's rows in batches of 2 instead of 4 (the
# matcher's convolutions round differently per batch shape)
TOL_PX, TOL_RT = 1e-3, 2e-3


def _stage2_models():
    """tests/test_torch_pipeline.py's tiny DINOv2 and matcher, in both
    packages, from the same seeded weights."""
    z = jnp.zeros((1, 64, 64, 1))
    d_vars = seeded_variables(JaxDino(DINO), jnp.zeros((1, 196, 196, 3)), seed=0, fill=_gamma)
    m_vars = seeded_variables(JaxMatcher(MATCHER), z, z, seed=1, fill=_bn)
    jax_models = JaxModels(
        sam=None, sam_variables=None, dinov2=JaxDino(DINO), dinov2_variables=jax.tree.map(jnp.asarray, d_vars),
        matcher=JaxMatcher(MATCHER), matcher_variables=jax.tree.map(jnp.asarray, m_vars), amg=None, config=CFG,
    )
    dino = DinoVisionTransformer(port_config(DINO))
    dino.load_state_dict(dinov2_state_from_jax(d_vars), strict=True)
    matcher = Matcher(port_config(MATCHER))
    matcher.load_state_dict(matcher_state_from_jax(m_vars), strict=True)
    port = PopeModels(sam=None, amg=None, dinov2=dino.eval(), matcher=matcher.eval(),
                      config=port_config(CFG), device=torch.device("cpu"))
    return jax_models, port


def _records(fn):
    """(records of every finish_pairs call during fn(), fn())."""
    recs = []
    finish = runner.finish_pairs

    def capture(pending):
        got = finish(pending)
        recs.extend(got)
        return got

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "finish_pairs", capture)
        return recs, fn()


def _stage2_inputs():
    """Stage 2's inputs for 4 pairs (tests/test_torch_pipeline.py's two
    batches of 2) and the JAX keys of their solver noise."""
    parts = [_inputs(seed) for seed in (0, 1)]
    img0, img1, K, boxes, valid = (np.concatenate(x) for x in zip(*parts))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    return (img0, img1, K, K, boxes, valid), keys


@pytest.fixture(scope="module")
def run(tmp_path_factory, dataset, models, image_root):  # noqa: F811
    rng = np.random.default_rng(0)
    inputs, ref = {}, {}

    # stage 2
    jax_models, port = _stage2_models()
    args, keys = _stage2_inputs()
    noise = T(np.stack([jax_noise(k, MATCHER.match_coarse.match_capacity) for k in keys]))
    targs = tuple(map(T, args)) + (None, noise)
    inputs["eval"] = {"models": port, "crop": CROP, "args": targs}
    ref["batched_port"] = [t.numpy() for t in PipelineExecutor(port, crop_size=CROP).batched()(*targs, packed=True)]
    jrun = JaxExecutor(jax_models, crop_size=CROP).build_batched(B, mesh=jax_make_mesh(2, tp=1), fold_prompt=True)
    ref["batched_jax"] = [np.asarray(x) for x in jrun(*map(jnp.asarray, args), None, keys, packed=True)]

    # the eval driver: the port's single-process runs at B = 2 (what each
    # dp rank computes of a batch of 4)
    data_root, pairs_dir = dataset
    _, eval_port = models
    inputs["dataset"] = {"models": eval_port, "root": data_root, "pairs": pairs_dir, "crop": EVAL_CROP}
    for name, kw in (("eval_b4", {}), ("eval_ragged", {"max_pairs": 3})):
        ref[name] = _records(lambda: evaluate_dataset(eval_port, "linemod", data_root, pairs_dir, batch_size=2,
                                                      progress=False, **kw))

    # the matcher's train step
    z = jnp.zeros((1, 64, 80, 1))
    m_vars = seeded_variables(JaxMatcher(TINY_MATCHER), z, z, seed=5, fill=_bn)
    work = tmp_path_factory.mktemp("parallel_train")
    matcher = Matcher(port_config(TINY_MATCHER))
    matcher.load_state_dict(matcher_state_from_jax(m_vars), strict=True)
    torch.save(matcher, work / "matcher.pt")
    ocfg = optim.OptimConfig(lr=1e-3, warmup_steps=0, scheduler="ExponentialLR", elr_gamma=0.99)
    batch = {k: T(v) for k, v in _geometry_batch(0, B=B).items()}
    inputs["matcher"] = {"model": str(work / "matcher.pt"), "ocfg": ocfg, "clip": 0.5, "batch": batch}
    state = trainer.init_matcher_train_state(torch.load(work / "matcher.pt", weights_only=False), ocfg, grad_clip=0.5)
    with relu_signs() as signs:
        metrics = trainer.matcher_train_step(state, batch)
    ref["matcher"] = {"metrics": {k: v.item() for k, v in metrics.items()},
                      "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
                      "state": state.model.state_dict(), "signs": signs.masks}

    # the SSL step: from pope_tpu's seeded state (its sharded step the
    # reference too), and with stochastic depth and sinkhorn (the port alone)
    ssl_cases = {
        "ssl": (jssl.SSLMetaArch(TINY_SSL, TINY_BB), True),
        "ssl_drop_path": (jssl.SSLMetaArch(dataclasses.replace(TINY_SSL, centering="sinkhorn_knopp"),
                                           dataclasses.replace(TINY_BB, drop_path_rate=0.3)), False),
    }
    inputs["ssl"] = {}
    for name, (arch, with_jax) in ssl_cases.items():
        jstate = _jax_state(arch, seed=5)
        sbatch = ssl_batch(6, B=B)
        tarch = _port_arch(arch)
        path = work / f"{name}.pt"
        torch.save(_port_state(arch, jstate), path)
        inputs["ssl"][name] = {"arch": tarch, "state": str(path), "min_size": 256,
                               "batch": {k: T(v) for k, v in sbatch.items()}}
        state = torch.load(path, weights_only=False)
        grads = {}
        update = tarch._apply_update

        def spy(st, sched, mults):
            grads.update({n: None if p.grad is None else p.grad.clone() for n, p in st.student.named_parameters()})
            update(st, sched, mults)

        tarch._apply_update = spy
        state, m = tarch.train_step(state, {k: T(v) for k, v in sbatch.items()})
        tarch._apply_update = update
        ref[name] = {"metrics": {k: v.item() for k, v in m.items()}, "grads": grads, "state": state.state_dict()}
        if with_jax:
            mesh = jax_make_mesh(2, tp=1)
            from jax.sharding import NamedSharding, PartitionSpec as P

            put = lambda v: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("dp", *([None] * (v.ndim - 1)))))
            jstep = jssl.make_sharded_ssl_step(arch, mesh, mults=arch.multipliers(jstate))
            jnext, jm = jstep(jssl.shard_ssl_state(jax.tree_util.tree_map(jnp.asarray, jstate), mesh),
                              {k: put(v) for k, v in sbatch.items()})
            ref[f"{name}_jax"] = (jax.device_get(jnext), {k: float(v) for k, v in jm.items()})

    # train_ssl over dp = 2 on one host: every rank reads the one stream of
    # global batches; the run must equal the single run at that batch
    from pope_tpu_torch.train.ssl_driver import train_ssl

    arch = _port_arch(jssl.SSLMetaArch(TINY_SSL, TINY_BB))
    kw = dict(batch_size=B, total_steps=2, log_every=100, seed=3)
    inputs["ssl_driver"] = {"root": image_root, "cfg": arch.cfg, "bcfg": arch.backbone_cfg, "kw": kw}
    single = train_ssl(image_root, arch.cfg, arch.backbone_cfg, device="cpu", **kw)
    ref["ssl_driver"] = single.state_dict()

    # the regressor's dp x tp step (dryrun_multichip's program 1, at B = 4)
    cfg = RegressorConfig(num_sample=64, net_mode="mkpts+imgs", d_model=64)
    torch.manual_seed(0)
    path = work / "regressor.pt"
    torch.save(MkptsRegModel(cfg, cnn_name="atto"), path)
    rbatch = {"mkpts0": rng.uniform(0, 256, (B, 64, 2)), "mkpts1": rng.uniform(0, 256, (B, 64, 2)),
              "img0": rng.uniform(-1, 1, (B, 32, 32, 3)), "img1": rng.uniform(-1, 1, (B, 32, 32, 3)),
              "gt_t": rng.normal(0, 1, (B, 3)), "gt_R": np.broadcast_to(np.eye(3), (B, 3, 3))}
    rbatch = {k: T(np.ascontiguousarray(v, np.float32)) for k, v in rbatch.items()}
    masks = dropout_masks(B, torch.Generator().manual_seed(1))
    inputs["regressor"] = {"model": str(path), "cfg": cfg, "batch": rbatch, "masks": masks}
    state = rtrain.create_train_state(torch.load(path, weights_only=False), cfg)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m = rtrain.train_step(state, rbatch, masks)
    ref["regressor"] = {"metrics": {k: v.item() for k, v in m.items()}, "before": before,
                        "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
                        "state": state.model.state_dict(),
                        "moments": {n: state.optimizer.state[p]["exp_avg"] for n, p in state.model.named_parameters()},
                        "lr": cfg.lr}

    # train_matcher: the single runs (one epoch, then a resume to two) that
    # the dp and tp runs are held against
    tcfg = TrainMatcherConfig(**dataclasses.asdict(_fast_cfg(n_samples_per_subset=4)))
    scenes = [SynthScene(s, n=4) for s in (1, 2, 3)]
    train = [[ds[i] for i in range(len(ds))] for ds in scenes[:2]]
    val = [scenes[2][i] for i in range(2)]
    root = work / "matcher_driver"
    inputs["matcher_driver"] = {"train": train, "val": val, "cfg": tcfg, "batch_size": B, "root": str(root)}
    runs = []
    for epochs, resume in ((1, False), (2, True)):
        state, history = train_matcher(torch.load(work / "matcher.pt", weights_only=False), train, val,
                                       dataclasses.replace(tcfg, epochs=epochs), batch_size=B,
                                       ckpt_dir=str(root / "single"), resume=resume, log_every=100, num_workers=1,
                                       device="cpu")
        runs.append({"history": history, "step": state.step})
    ref["matcher_driver"] = {"runs": runs, "root": root, "lr": tcfg.canonical_lr}

    torch.save(inputs, work / "inputs.pt")
    return spawn_suite(work, "train"), ref


def _close_grads(got, want, rel=TOL_GRAD):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        scale = w.abs().max().item()
        torch.testing.assert_close(got[k], w, atol=rel * scale + 1e-12, rtol=0, msg=lambda m, k=k: f"{k}: {m}")


def test_stage2_dp_matches_single_and_pope_tpu(run):
    """Every rank gets the whole batch's packed records back: equal to the
    port's unsharded run and to pope_tpu's dp = 2 run (ok, pre_bbox,
    n_strong and drop counts exactly; matches and R / t within the stage's
    bounds)."""
    got, ref = run
    exact = [12, 13, 14, 15, 16, 26, 27, 28]
    for out in got:
        small, matches = out["batched"]
        assert small.shape == (B, 29)
        for want_small, want_matches in (ref["batched_port"], ref["batched_jax"]):
            np.testing.assert_array_equal(small[:, exact], want_small[:, exact])
            np.testing.assert_array_equal(matches[..., 5], want_matches[..., 5])
            np.testing.assert_allclose(matches[..., :4], want_matches[..., :4], atol=TOL_PX)
            ok = small[:, 12] == 1
            assert ok.any()
            np.testing.assert_allclose(small[ok, :12], want_small[ok, :12], atol=TOL_RT)


@pytest.mark.parametrize("name", ["eval_b4", "eval_ragged"])
def test_eval_dp_records_on_rank_zero(run, name):
    """evaluate_dataset(batch_size=4, mesh=dp 2): rank 0 holds every
    record in pair order, equal to the single-process run's at batch size 2
    (what each rank computes); the other ranks hold none. The ragged 3-pair
    run pads rank 1's pair to 2 and drops the pad's record."""
    got, ref = run
    want, want_tables = ref[name]
    recs, tables = got[0][name]  # every record finish_pairs gathered, the pad's too
    pad = [] if name == "eval_b4" else want[-1:]
    ids = [r["identifier"] for r in recs]
    assert ids == [r["identifier"] for r in want + pad]
    recs = recs[:len(want)]
    if name == "eval_b4":
        assert_same_records(recs, want)
        assert tables == want_tables
    else:  # rank 1 ran pair 3 twice in one batch: batch-shape rounding
        assert_records_match_jax(recs, want)
        for obj, row in want_tables.items():
            for k, v in row.items():
                np.testing.assert_allclose(tables[obj][k], v, atol=table_tol(k), err_msg=f"{obj}/{k}")
    # ranks 0 and 2 are dp rank 0 of their halves; 1 and 3 hold nothing
    assert [x["identifier"] for x in got[2][name][0]] == ids
    assert got[1][name] == got[3][name] == ([], {})


def _relu_flips(want, ranks, dp):
    """ReLU inputs whose sign differs from the single run's: the dp ranks'
    masks put back in global batch order (the backbone's batch is [image0;
    image1], the rest per pair), or each tp rank's whole masks."""
    if not dp:
        return max(sum(int((a != b).sum()) for a, b in zip(r, want)) for r in ranks)
    n = 0
    for w, m0, m1 in zip(want, *ranks):
        if m0.shape[0] * 2 != w.shape[0]:
            return -1  # not the same program
        half = m0.shape[0] // 2
        both = torch.cat([m0[:half], m1[:half], m0[half:], m1[half:]]) if w.shape[0] == 2 * B else torch.cat([m0, m1])
        n += int((both != w).sum())
    return n


# A ReLU input within rounding of 0 (here within the dp run's other
# summation order of the BatchNorm moments) takes the other side; in about
# a third of seeded batches one does, and then the backbone's gradients move
# by up to 5.2e-2 of a tensor's largest (measured over 30 batches; 1-2e-5
# without a flip). The gradients are held to TOL_GRAD when no ReLU flipped,
# to TOL_GRAD_FLIP when one did.
TOL_GRAD_FLIP = 0.1


@pytest.mark.parametrize("name", ["matcher_dp", "matcher_tp"])
def test_matcher_step_matches_single(run, name):
    """One step over the global batch of 4: the loss terms, every gradient
    (after the clip), and the BatchNorm running statistics, which dp ranks
    compute from the global batch's moments."""
    got, ref = run
    want = ref["matcher"]
    ranks = [[out[name]["signs"] for out in got[:2]]] if name == "matcher_dp" else [[o[name]["signs"] for o in got]]
    flips = _relu_flips(want["signs"], *ranks, name == "matcher_dp")
    assert flips >= 0 and len(want["signs"]) > 0
    for out in got:
        res = out[name]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=TOL_LOSS, err_msg=k)
        _close_grads(res["grads"], want["grads"], TOL_GRAD if flips == 0 else TOL_GRAD_FLIP)
        for k, v in want["state"].items():
            if "running" in k:
                torch.testing.assert_close(res["state"][k], v, atol=TOL_STATS, rtol=0, msg=k)
        if name == "matcher_dp":
            assert res["comm"]["calls"] > 0 and res["comm"]["staged_bytes"] == 0


def test_ssl_dp_fsdp_matches_single_and_pope_tpu(run):
    """One SSL step (lr 0 in warmup: the moments carry the gradients, the
    centers move) at dp = 2 with the large leaves cut: the global batch's
    losses, centers, gradients and moments, against the port's step on the
    global batch and pope_tpu's make_sharded_ssl_step on shard_ssl_state;
    each rank holds about half the cut leaves' bytes."""
    got, ref = run
    want = ref["ssl"]
    jnext, jm = ref["ssl_jax"]
    for out in got:
        res = out["ssl"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=TOL_METRIC, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(res["metrics"][k], jm[k], rtol=TOL_METRIC, atol=1e-7, err_msg=k)
        _close_grads(res["grads"], want["grads"])
        sd = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v) for k, v in res["state"].items()}
        for c in ("dino_center", "ibot_center"):
            np.testing.assert_allclose(sd[c].numpy(), np.asarray(getattr(jnext, c)), atol=TOL_METRIC)
        for k in ("mu", "nu"):
            _close_to_max(k, sd[k], _named(getattr(jnext, k)), TOL_MOMENTS)
        for k in ("student", "teacher"):
            _close_where_conditioned(k, sd[k], _named(getattr(jnext, k)), _named(jnext.mu), TOL_WEIGHTS,
                                     TOL_WEIGHTS)
        whole, sharded = res["bytes"]
        assert res["n_sharded"] > 0 and sharded < whole


def test_ssl_dp_with_drop_path_matches_single(run):
    """Stochastic depth (each rank takes its images' rows of the global
    draw) and sinkhorn centering (global sums), against the port's step on
    the global batch."""
    got, ref = run
    want = ref["ssl_drop_path"]
    for out in got:
        res = out["ssl_drop_path"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=TOL_METRIC, atol=1e-7, err_msg=k)
        _close_grads(res["grads"], want["grads"])
        for k in ("mu", "nu"):
            _close_to_max(k, {n: t.numpy() for n, t in res["state"][k].items()},
                          {n: t.numpy() for n, t in want["state"][k].items()}, TOL_MOMENTS)


def test_regressor_dp_tp_step_matches_single(run):
    """dp = 2 x tp = 2, the keypoint token axis cut over tp, the large
    layers and their Adam moments tp-sharded: the loss, the gradients, the
    first moments, and the weights after AdamW's first step (within 2 lr
    everywhere, Adam's bound where a gradient is rounding noise; within
    1e-3 lr where |g| exceeds 1e-3 of its tensor's largest)."""
    got, ref = run
    want = ref["regressor"]
    lr = want["lr"]
    for out in got:
        res = out["regressor"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=TOL_LOSS, err_msg=k)
        g_max = max(g.abs().max().item() for g in want["grads"].values())
        # the softmax ignores the attention keys' bias: its gradient is 0 up
        # to rounding on both sides (tests/test_torch_regressor.py)
        noise = [n for n in want["grads"] if n.endswith("key.bias")]
        for n in noise:
            assert max(want["grads"][n].abs().max().item(), res["grads"][n].abs().max().item()) <= 1e-6 * g_max, n
        keep = lambda d: {n: v for n, v in d.items() if n not in noise}
        _close_grads(keep(res["grads"]), keep(want["grads"]))
        _close_grads(keep(res["moments"]), keep(want["moments"]))
        for n, g in keep(want["grads"]).items():
            diff = (res["state"][n] - want["state"][n]).abs()
            assert diff.max().item() <= 2 * lr + 1e-7, n
            big = g.abs() > 1e-3 * g.abs().max()
            if big.any():
                assert diff[big].max().item() <= 1e-3 * lr + 1e-7, n


def test_train_ssl_dp_equals_single_run(run):
    """train_ssl(mesh=dp 2) for two steps (the second at lr 5e-4) against
    the single-process run at the same global batch of 4, from the same
    seed: the moments to TOL_MOMENTS_2 of each tensor's largest (two steps'
    gradients, each summed over the ranks in another order: measured 1.5e-5
    of the largest for one step above, 2.8e-5 here where LayerScale's 1e-5
    init leaves a tensor's gradients at rounding size), the centers to
    TOL_METRIC, the weights within TOL_WEIGHTS where the first moment is
    conditioned and 2 lr (Adam's bound on rounding noise) elsewhere."""
    got, ref = run
    want = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v) for k, v in ref["ssl_driver"].items()}
    lr = float(tssl.ssl_schedules(_port_arch(jssl.SSLMetaArch(TINY_SSL, TINY_BB)).cfg, 1)["lr"])
    for out in got:
        sd = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v)
              for k, v in out["ssl_driver"].items()}
        assert sd["step"] == want["step"] == 2
        for k in ("mu", "nu"):
            _close_to_max(k, sd[k], want[k], TOL_MOMENTS_2)
        for c in ("dino_center", "ibot_center"):
            np.testing.assert_allclose(sd[c].numpy(), want[c].numpy(), atol=TOL_METRIC)
        for k in ("student", "teacher"):
            _close_where_conditioned(k, sd[k], want[k], want["mu"], TOL_WEIGHTS, 2 * lr + TOL_WEIGHTS)


# train_matcher at dp = 2 / tp = 2 against the single runs after four steps.
# A ReLU input within rounding of 0 takes the other side in the dp run (see
# TOL_GRAD_FLIP), and the runs then drift apart: measured 0.127 of a
# tensor's norm in the Adam moments, 3.6e-4 in the BatchNorm statistics,
# 2e-5 of the train loss (the tp run: 3e-5 of the moments; with softplus in
# place of the ReLUs the dp run too agrees to 1.4e-5). Planted faults, each
# rank loading the same half of the batch or the dp gradients left unsummed:
# 2.7 of the moments' norm, 0.03 in the statistics, 2.7e-2 of the loss.
TOL_RUN_LOSS, TOL_RUN_MOMENTS, TOL_RUN_STATS = 1e-3, 0.5, 3e-3


def test_train_matcher_dp_and_tp_checkpoint_and_resume(run):
    """train_matcher(mesh=) at dp = 2 and at tp = 2 (B = 4, two steps an
    epoch): one epoch with checkpoints, then a resume to two, against the
    single process's same two runs. Every rank runs the whole validation
    and returns the same history; the resumed tp run cuts the restored full
    state again; the main rank's directory holds what the single run's
    does, its `last` the full (tp-gathered) state after four steps: the
    moments and statistics within the bounds above, the weights within 2 lr
    a step (Adam's bound where a gradient is rounding noise)."""
    got, ref = run
    want = ref["matcher_driver"]
    root = want["root"]
    for r, out in enumerate(got):
        res = out["matcher_driver"]
        assert res["mesh"] == ("dp" if r < 2 else "tp")
        assert res["runs"] == got[r - r % 2]["matcher_driver"]["runs"]  # the two ranks of a half agree
        for g, w in zip(res["runs"], want["runs"]):
            assert g["step"] == w["step"]
            assert [h["epoch"] for h in g["history"]] == [h["epoch"] for h in w["history"]]
            for hg, hw in zip(g["history"], w["history"]):
                assert hg.keys() == hw.keys()
                np.testing.assert_allclose(hg["train_loss"], hw["train_loss"], rtol=TOL_RUN_LOSS)
                assert all(np.isfinite(hg[k]) for k in ("auc@5", "auc@10", "auc@20"))
        if res["mesh"] == "tp":
            assert res["runs"][0]["tp_sharded"] == res["runs"][1]["tp_sharded"] > 0
    single = load_payload(str(root / "single" / "last"), "cpu")
    with open(root / "single" / "index.json") as f:
        want_index = json.load(f)
    for key in ("dp", "tp"):
        with open(root / key / "index.json") as f:
            index = json.load(f)
        assert index["epoch"] == want_index["epoch"] == 2
        assert [b["epoch"] for b in index["best"]] == [b["epoch"] for b in want_index["best"]]
        assert sorted(os.listdir(root / key)) == sorted([b["name"] for b in index["best"]] + ["index.json", "last"])
        last = load_payload(str(root / key / "last"), "cpu")
        assert last["step"] == single["step"] == 4
        assert last["model"].keys() == single["model"].keys()
        for k, v in single["model"].items():
            tol = TOL_RUN_STATS if "running" in k else 2 * want["lr"] * 4
            torch.testing.assert_close(last["model"][k], v, atol=tol, rtol=0, msg=lambda m, k=k: f"{key} {k}: {m}")
        for i, st in single["optimizer"]["state"].items():
            for m in ("exp_avg", "exp_avg_sq"):
                d = last["optimizer"]["state"][i][m] - st[m]
                assert (d.norm() / st[m].norm()).item() <= TOL_RUN_MOMENTS, (key, i, m)
