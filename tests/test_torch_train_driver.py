"""The port's matcher-training driver (pope_tpu_torch/train/matcher_driver.py,
data/{scenes,readers,loader}.py, utils/checkpoint.py, `cli train-matcher`)
against pope_tpu's: collation, the scene-balanced sampler and local split,
the ScanNet and MegaDepth datasets on scenes written to disk, the top-k
checkpointer, the validation table given pope_tpu's RANSAC noise, a 2-epoch
run that descends, checkpoints and resumes, and the CLI on the CPU."""

import dataclasses
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pope_tpu_torch.config as port_config_module
from pope_tpu.config import BackboneConfig, CoarseMatchConfig, LoFTRStageConfig, MatcherConfig
from pope_tpu.data import scenes as jax_scenes
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.train import matcher_driver as jax_driver
from pope_tpu.train.trainer import MatcherTrainState as JaxState
from pope_tpu_torch import cli
from pope_tpu_torch.data import DevicePrefetcher, scenes
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.train import TopKCheckpointer, TrainMatcherConfig, matcher_driver, supervision, train_matcher
from pope_tpu_torch.train.optim import OptimConfig
from pope_tpu_torch.train.trainer import init_matcher_train_state
from pope_tpu_torch.utils.checkpoint import latest_checkpoint
from pope_tpu_torch.weights import matcher_state_from_jax
from tests.test_scenes import _write_megadepth_scene
from tests.test_torch_common import port_config, seeded_variables, to_jax
from tests.test_train import _tiny_matcher
from tests.test_train_matcher_driver import SynthScene, _fast_cfg

T = torch.from_numpy
# the tiny matcher with threshold 0 and no border cut, so that validation
# has matches to solve
VAL_MATCHER = MatcherConfig(
    backbone=BackboneConfig(initial_dim=16, block_dims=(16, 24, 32)),
    coarse=LoFTRStageConfig(d_model=32, d_ffn=32, nhead=2, layer_names=("self", "cross")),
    fine=LoFTRStageConfig(d_model=16, d_ffn=16, nhead=2, layer_names=("self", "cross")),
    match_coarse=CoarseMatchConfig(match_capacity=32, thr=0.0, border_rm=0),
)
# validation against pope_tpu: R / t errors in degrees (the eval gate's
# tolerance, tests/test_torch_eval.py); squared epipolar errors of the kept
# matches relative, plus 1e-7 absolute; the table's fractions and AUCs
TOL_DEG = 0.25
TOL_EPI_REL, TOL_EPI_ABS = 1e-2, 1e-7
TOL_TABLE = 1e-3


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Tiny models: two intra-op threads are as fast as eight here, and the
    test run's parallel workers share the cores (with eight each, the
    validation solver's many small ops ran 70x slower under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _port_cfg(cfg):
    return TrainMatcherConfig(**dataclasses.asdict(cfg))


def test_collate_pairs_equals_pope_tpu():
    ds = SynthScene(0, n=3)
    ref = jax_driver.collate_pairs([ds[0], ds[2]])
    out = matcher_driver.collate_pairs([ds[0], ds[2]])
    assert set(out) == set(ref) and out["image0"].shape == (2, 64, 64, 1)
    for k in ref:
        assert out[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert matcher_driver.pair_names([ds[1]]) == jax_driver.pair_names([ds[1]])


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("kw", [dict(), dict(subset_replacement=False), dict(shuffle=False, repeat=2),
                                dict(subset_replacement=False, repeat=3)],
                         ids=["default", "no-replacement", "repeat", "no-replacement-repeat"])
def test_sampler_and_local_split_index_order(kw):
    """The same index sequence as pope_tpu's (the same numpy draws)."""
    sizes = [5, 30, 12]
    ref = list(jax_scenes.RandomConcatSampler(jax_scenes.ConcatDataset([_Sized(n) for n in sizes]), 8,
                                              seed=3, **kw))
    concat = scenes.ConcatDataset([_Sized(n) for n in sizes])
    out = list(scenes.RandomConcatSampler(concat, 8, seed=3, **kw))
    assert out == ref and len(out) == len(scenes.RandomConcatSampler(concat, 8, seed=3, **kw))
    assert concat[17] == jax_scenes.ConcatDataset([_Sized(n) for n in sizes])[17]
    for world, rank in ((3, 0), (3, 2), (4, 1)):
        assert scenes.get_local_split(list(range(10)), world, rank) == jax_scenes.get_local_split(
            list(range(10)), world, rank)


def _same_items(out, ref):
    assert set(out) == set(ref)
    for k, want in ref.items():
        if isinstance(want, np.ndarray):
            assert out[k].dtype == want.dtype, k
            np.testing.assert_array_equal(out[k], want, err_msg=k)
        else:
            assert out[k] == want, k


def test_scannet_dataset_reads_what_pope_tpu_reads(tmp_path):
    paths = chip_smoke.write_scannet_scene(tmp_path, n_frames=3, shift_px=24)
    args = (paths["data_root"], paths["train_npz"], paths["intrinsic_path"])
    ref = jax_scenes.ScanNetPairDataset(*args, min_overlap_score=0.4)
    out = scenes.ScanNetPairDataset(*args, min_overlap_score=0.4)
    assert len(out) == len(ref) == 2
    for i in range(len(ref)):
        _same_items(out[i], ref[i])
    assert out[0]["image0"].shape == (1, 480, 640)


def test_megadepth_dataset_and_the_spvs_fine_scale1_gap(tmp_path):
    """The MegaDepth dataset reads what pope_tpu's reads (resized to 48:
    scale != 1). On its item, pope_tpu's trainer calls spvs_fine without
    scale1 where the reference scales the fine window by scale * scale1;
    the port copies that call (ROADMAP Queue 3). The gap: the targets
    without scale1 are those with it times scale1."""
    npz = _write_megadepth_scene(tmp_path, np.random.default_rng(0))
    kw = dict(mode="train", min_overlap_score=0.4, img_resize=48, df=8, img_padding=True, depth_max_size=64)
    ref = jax_scenes.MegaDepthPairDataset(str(tmp_path), npz, **kw)
    out = scenes.MegaDepthPairDataset(str(tmp_path), npz, **kw)
    assert len(out) == len(ref) == 1
    item = out[0]
    _same_items(item, ref[0])
    np.testing.assert_allclose(item["scale1"], [64 / 48, 64 / 48])

    batch = {k: T(v) for k, v in matcher_driver.collate_pairs([item]).items()}
    spv = supervision.spvs_coarse(batch, 8)
    i_ids = torch.nonzero(spv["spv_valid"][0])[:, 0][None]
    assert i_ids.shape[1] > 5
    j_ids = spv["spv_j_of_i"].gather(1, i_ids)
    without = supervision.spvs_fine(spv, i_ids, j_ids, 2, 5)
    with_scale = supervision.spvs_fine(spv, i_ids, j_ids, 2, 5, scale1=batch["scale1"])
    torch.testing.assert_close(without, with_scale * batch["scale1"][:, None], atol=1e-6, rtol=1e-6)
    assert (without - with_scale).abs().max() > 0.05


def test_device_prefetcher_on_the_cpu():
    batches = [{"a": np.full((2, 3), i, np.float32), "b": np.arange(i + 1)} for i in range(4)]
    out = list(DevicePrefetcher(iter(batches), "cpu"))
    assert len(out) == 4
    for i, b in enumerate(out):
        assert torch.equal(b["a"], torch.full((2, 3), float(i))) and b["b"].tolist() == list(range(i + 1))


def _tiny_state(cfg=VAL_MATCHER):
    port = Matcher(port_config(cfg))
    return init_matcher_train_state(port, OptimConfig(lr=1e-3, warmup_steps=0), grad_clip=0.5)


def test_topk_checkpointer_eviction_and_resume(tmp_path):
    """save_top_k=2 on auc@10 (tests/test_train_matcher_driver.py's
    sequence): the two best kept, the evicted and the re-run epoch's stale
    directories deleted, `last` always the newest; a restore gives back the
    weights, the optimizer's moments, the schedule and the step;
    latest_checkpoint picks the highest step_<n>."""
    ckpt = TopKCheckpointer(str(tmp_path), monitor="auc@10", top_k=2)
    state = _tiny_state()
    for e, s in enumerate([0.3, 0.5, 0.1, 0.7]):
        state.step = e
        ckpt.save(state, e, {"auc@5": s, "auc@10": s, "auc@20": s})
    assert ckpt.best_score == 0.7 and ckpt.start_epoch == 4
    assert sorted(b["score"] for b in ckpt.index["best"]) == [0.5, 0.7]
    names = {b["name"] for b in ckpt.index["best"]}
    assert {d for d in os.listdir(tmp_path) if d.startswith("epoch=")} == names
    ckpt2 = TopKCheckpointer(str(tmp_path), monitor="auc@10", top_k=1)  # a resume re-running epoch 1
    ckpt2.save(state, 1, {"auc@5": 0.5, "auc@10": 0.5, "auc@20": 0.5})
    names = {b["name"] for b in ckpt2.index["best"]}
    assert {d for d in os.listdir(tmp_path) if d.startswith("epoch=")} == names == {
        "epoch=3-auc5=0.700-auc10=0.700-auc20=0.700"}
    assert os.path.isfile(tmp_path / "last" / "checkpoint.pt")
    for name in ("step_3", "step_12", "step_x"):
        os.makedirs(tmp_path / "steps" / name)
    assert latest_checkpoint(str(tmp_path / "steps")) == str(tmp_path / "steps" / "step_12")
    assert latest_checkpoint(str(tmp_path / "none")) is None

    for p in state.model.parameters():  # one update, so the optimizer has moments to save
        p.grad = torch.randn_like(p)
    state.optimizer.step()
    state.scheduler.step()
    w = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt2.save(state, 4, {"auc@5": 0.9, "auc@10": 0.9, "auc@20": 0.9})
    fresh = _tiny_state()
    assert not all(torch.equal(fresh.model.state_dict()[k], v) for k, v in w.items())
    restored = TopKCheckpointer(str(tmp_path), top_k=1).restore_last(fresh)
    assert restored.step == 3 and all(torch.equal(restored.model.state_dict()[k], v) for k, v in w.items())
    saved, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert all(torch.equal(got["state"][i][k], v) for i, st in saved["state"].items() for k, v in st.items())
    assert restored.scheduler.last_epoch == 1 and restored.optimizer.param_groups[0]["lr"] == 1e-3


class ShiftedScene:
    """Validation pairs whose image 1 is a shifted window of image 0's smooth
    texture, under a known rotation and translation (the pixels do not
    follow the pose: what matters here is that both packages solve the same
    matches with the same noise)."""

    def __init__(self, seed, n=3, H=64, W=80):
        rng = np.random.default_rng(seed)
        K = np.array([[90.0, 0, W / 2], [0, 90.0, H / 2], [0, 0, 1]], np.float32)
        self.items = []
        for i in range(n):
            tex = chip_smoke.texture(rng, H + 16, W + 16, n_blobs=40)
            dy, dx = rng.integers(0, 16, 2)
            Tm = np.eye(4, dtype=np.float32)
            Tm[:3, :3] = cv2.Rodrigues(rng.uniform(-0.2, 0.2, 3))[0]
            Tm[:3, 3] = [0.1, -0.03, 0.02]
            self.items.append({
                "image0": tex[None, :H, :W].copy(), "image1": tex[None, dy:dy + H, dx:dx + W].copy(),
                "depth0": np.full((H, W), 2.0, np.float32), "depth1": np.full((H, W), 2.0, np.float32),
                "T_0to1": Tm, "T_1to0": np.linalg.inv(Tm).astype(np.float32), "K0": K, "K1": K,
                "pair_name": f"shifted{seed}/{i}",
            })

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _jax_noise(seed, cfg):
    """The solver noise pope_tpu's validate draws for the batch at `lo`: one
    key per pair from PRNGKey(seed + lo), each split into the rounds'
    keys, a Gumbel (n_hyps, M) draw per round."""

    def noise(lo, B, M):
        keys = jax.random.split(jax.random.PRNGKey(seed + lo), B)
        return T(np.stack([np.stack([np.asarray(jax.random.gumbel(k, (cfg.val_n_hyps, M)))
                                     for k in jax.random.split(key, cfg.val_n_rounds)]) for key in keys]))

    return noise


def test_validate_gives_pope_tpus_table():
    """Per-pair R / t errors within 0.25 degrees and the kept matches'
    epipolar errors as tests/test_torch_eval.py holds the eval driver; the
    aggregate table (aggregate_metrics' R / t AUCs, accuracies and medians,
    prec@thr, the auc@{5,10,20} monitors) within 1e-3. Three pairs in
    batches of 2 (a ragged tail), seeded weights bridged across."""
    z = jnp.zeros((1, 64, 80, 1))
    variables = seeded_variables(JaxMatcher(VAL_MATCHER), z, z, seed=2,
                                 fill=lambda n, s, r: {"mean": r.normal(0, 0.2, s),
                                                       "var": r.uniform(0.5, 2.0, s)}.get(n))
    jstate = JaxState(jnp.zeros((), jnp.int32), to_jax(variables["params"]), to_jax(variables["batch_stats"]), {})
    cfg = _fast_cfg(val_n_hyps=128, val_n_rounds=2, epi_err_thr=1e-3)
    val_ds = ShiftedScene(5)
    jm = JaxMatcher(VAL_MATCHER)
    jstep = jax_driver.make_val_step(jm, cfg)
    ref_table = jax_driver.validate(jm, jstate, val_ds, cfg, 2, val_step=jstep, seed=9)
    ref = {"R": [], "t": [], "epi": []}
    for lo in (0, 2):
        items = [val_ds[min(i, 2)] for i in (lo, lo + 1)]
        keys = jax.random.split(jax.random.PRNGKey(9 + lo), 2)
        o = jax.device_get(jstep(jstate.params, jstate.batch_stats, jax_driver.collate_pairs(items), keys))
        for b in range(2 if lo == 0 else 1):
            ref["R"].append(float(o["R_errs"][b]))
            ref["t"].append(float(o["t_errs"][b]))
            ref["epi"].append(o["epi_errs"][b][o["match_valid"][b]])

    port = Matcher(port_config(VAL_MATCHER))
    port.load_state_dict(matcher_state_from_jax(variables))
    pcfg = _port_cfg(cfg)
    noise = _jax_noise(9, pcfg)
    errs = matcher_driver.validation_errors(port, val_ds, pcfg, 2, seed=9, noise=noise)
    assert errs["identifiers"] == [it["pair_name"] for it in val_ds.items]
    np.testing.assert_allclose(errs["R_errs"], ref["R"], atol=TOL_DEG)
    np.testing.assert_allclose(errs["t_errs"], ref["t"], atol=TOL_DEG)
    assert max(ref["R"]) < 90  # solved
    for got, want in zip(errs["epi_errs"], ref["epi"]):
        assert len(got) == len(want) > 8
        np.testing.assert_allclose(got, want, rtol=TOL_EPI_REL, atol=TOL_EPI_ABS)
    table = matcher_driver.validate(port, val_ds, pcfg, 2, seed=9, noise=noise)
    assert list(table) == list(ref_table)
    np.testing.assert_allclose([table[k] for k in ref_table], [ref_table[k] for k in ref_table], atol=TOL_TABLE)
    assert port.training  # validation leaves the module in the mode it found it in


def test_train_matcher_descends_checkpoints_and_resumes(tmp_path):
    """tests/test_train_matcher_driver.py's run on the port, on the CPU: two
    scenes, two epochs; the loss descends, every epoch has the monitors,
    the checkpoint directory holds last + index + the best; a resume to 3
    epochs runs epoch 2 only."""
    cfg = _port_cfg(_fast_cfg())
    train_ds = [SynthScene(1, n=8), SynthScene(2, n=8)]
    val_ds = SynthScene(3, n=3)
    ckpt_dir = str(tmp_path / "ckpt")
    state, history = train_matcher(Matcher(port_config(_tiny_matcher().config)), train_ds, val_ds, cfg,
                                   batch_size=4, ckpt_dir=ckpt_dir, log_every=100, device="cpu")
    assert [h["epoch"] for h in history] == [0, 1] and state.step == 8
    losses = [h["train_loss"] for h in history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for h in history:
        for k in ("auc@5", "auc@10", "auc@20", "R:auc@10", "prec@5e-04"):
            assert k in h and np.isfinite(h[k]), (k, h)
    with open(os.path.join(ckpt_dir, "index.json")) as f:
        index = json.load(f)
    assert index["epoch"] == 2 and index["monitor"] == "auc@10" and len(index["best"]) >= 1
    for b in index["best"]:
        assert os.path.isdir(os.path.join(ckpt_dir, b["name"])) and b["name"].startswith(f"epoch={b['epoch']}-auc5=")

    fresh = Matcher(port_config(_tiny_matcher().config))
    state2, history2 = train_matcher(fresh, train_ds, val_ds, dataclasses.replace(cfg, epochs=3), batch_size=4,
                                     ckpt_dir=ckpt_dir, resume=True, log_every=100, device="cpu")
    assert [h["epoch"] for h in history2] == [2] and state2.step == 12
    with open(os.path.join(ckpt_dir, "index.json")) as f:
        assert json.load(f)["epoch"] == 3


def _cli_args(paths, ckpt, *extra):
    return ["train-matcher", "--data-source", "scannet", "--data-root", paths["data_root"],
            "--train-npz", paths["train_npz"], "--val-npz", paths["val_npz"],
            "--intrinsic-path", paths["intrinsic_path"], "--batch-size", "2", "--n-samples-per-subset", "2",
            "--warmup-steps", "0", "--ckpt-dir", ckpt, *extra]


def test_cli_train_matcher(tmp_path, monkeypatch):
    """`cli train-matcher --device cpu` on a ScanNet-layout scene of 640x480
    frames (the tiny matcher in place of MatcherConfig(), which is the
    card's size): 2 epochs, the history and index.json with its top-k
    (chip_smoke.py runs the command on the card, --resume included). Without
    --device it runs on CUDA, which raises where there is no GPU; --dp x --tp
    above 1 starts that many ranks with its arguments (parallel.spawn, here
    recorded; tests/test_torch_parallel_train.py runs the sharded step)."""
    tiny = port_config(_tiny_matcher().config)
    monkeypatch.setattr(port_config_module, "MatcherConfig", lambda: tiny)
    paths = chip_smoke.write_scannet_scene(tmp_path / "scans", n_frames=3, shift_px=24)
    ckpt = str(tmp_path / "ckpt")
    hist = str(tmp_path / "history.json")
    cli.main(_cli_args(paths, ckpt, "--epochs", "2", "--device", "cpu", "--history-out", hist))
    with open(hist) as f:
        history = json.load(f)
    assert [h["epoch"] for h in history] == [0, 1] and np.isfinite([h["train_loss"] for h in history]).all()
    with open(os.path.join(ckpt, "index.json")) as f:
        index = json.load(f)
    assert index["epoch"] == 2 and 1 <= len(index["best"]) <= 5
    assert sorted(d for d in os.listdir(ckpt) if d.startswith("epoch=")) == sorted(b["name"] for b in index["best"])

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(_cli_args(paths, ckpt, "--epochs", "1"))
    import pope_tpu_torch.parallel as parallel

    spawned = []
    monkeypatch.setattr(parallel, "spawn", lambda fn, n, **kw: spawned.append((fn, n, kw)))
    cli.main(_cli_args(paths, ckpt, "--epochs", "1", "--device", "cpu", "--dp", "2", "--tp", "2"))
    (fn, n, kw), = spawned
    assert n == 4 and kw["tp"] == 2 and kw["device"] == "cpu" and kw["argv"][0].dp == 2
