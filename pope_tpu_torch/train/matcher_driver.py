"""Matcher (LoFTR) training driver (port of pope_tpu/train/matcher_driver.py,
one device): multi-scene datasets -> scene-balanced sampling -> train steps
-> per-epoch validation with pose-AUC aggregation -> auc@10-monitored top-k
checkpoints with resume.

Behavioral spec: scripts/train.py:57-123 (lr and warmup scaled with the
batch size; ModelCheckpoint monitor='auc@10', save_top_k=5, mode='max',
save_last) and src/lightning/lightning_loftr.py:60-203. The monitors
auc@{5,10,20} are the AUC of max(R_err, t_err), original LoFTR's semantics
(the reference's own aggregate emits other keys).

Host reads and collation run on ThreadedLoader threads; DevicePrefetcher
uploads each batch one step ahead on a copy stream. Validation's RANSAC
noise is an input: by default each batch of pairs draws it from a
torch.Generator on the device seeded seed + (the batch's first index).

Over a (dp, tp) mesh (`mesh=`, one rank per device) each rank loads its dp
slice of every global batch and runs trainer.make_sharded_train_step;
validation runs whole on every rank (the model is replicated over dp), and
only the mesh's first rank writes checkpoints, each with the full
(tp-gathered) state; a resume reads the full state on every rank and cuts
it again.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from pope_tpu_torch.data.loader import DevicePrefetcher, ThreadedLoader
from pope_tpu_torch.data.scenes import ConcatDataset, RandomConcatSampler
from pope_tpu_torch.train.loss import LossConfig
from pope_tpu_torch.train.optim import OptimConfig
from pope_tpu_torch.train.trainer import (
    MatcherTrainState,
    init_matcher_train_state,
    make_sharded_train_step,
    matcher_train_step,
)
from pope_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from pope_tpu_torch.utils.device import resolve_device
from pope_tpu_torch.utils.metrics import aggregate_metrics, error_auc

logger = logging.getLogger("pope_tpu_torch.train_matcher")


@dataclasses.dataclass(frozen=True)
class TrainMatcherConfig:
    """Trainer hyperparameters (src/config/default.py:104-155 defaults)."""

    canonical_bs: int = 64  # TRAINER.CANONICAL_BS
    canonical_lr: float = 6e-3  # TRAINER.CANONICAL_LR
    warmup_steps: int = 4800  # TRAINER.WARMUP_STEP, pre-scaling
    warmup_ratio: float = 0.0
    grad_clip: float = 0.5  # TRAINER.GRADIENT_CLIPPING
    scheduler: str = "MultiStepLR"
    mslr_milestones: Sequence[int] = (3, 6, 9, 12)  # epochs (MSLR_MILESTONES)
    mslr_gamma: float = 0.5
    epochs: int = 30
    n_samples_per_subset: int = 200  # TRAINER.N_SAMPLES_PER_SUBSET
    epi_err_thr: float = 5e-4  # TRAINER.EPI_ERR_THR (5e-4 ScanNet, 1e-4 MegaDepth)
    monitor: str = "auc@10"  # ModelCheckpoint(monitor='auc@10', mode='max')
    save_top_k: int = 5
    seed: int = 66  # TRAINER.SEED
    # validation RANSAC budget (the eval pipeline's by default)
    val_n_hyps: int = 2048
    val_n_rounds: int = 3
    val_thresh_px: float = 0.5  # TRAINER.RANSAC_PIXEL_THR for pose estimation


def collate_pairs(items: List[dict]) -> Dict[str, np.ndarray]:
    """Stack scene-dataset items into the trainer's batch layout: images
    (1, h, w) -> NHWC f32; ScanNet items share one 'K', MegaDepth items
    carry K0 / K1 and resize scales."""

    def stack(key, alt=None):
        return np.stack([it[key if key in it else alt] for it in items])

    batch = {
        "image0": stack("image0").transpose(0, 2, 3, 1).astype(np.float32),
        "image1": stack("image1").transpose(0, 2, 3, 1).astype(np.float32),
        "depth0": stack("depth0").astype(np.float32),
        "depth1": stack("depth1").astype(np.float32),
        "T_0to1": stack("T_0to1").astype(np.float32),
        "T_1to0": stack("T_1to0").astype(np.float32),
        "K0": stack("K0", "K").astype(np.float32),
        "K1": stack("K1", "K").astype(np.float32),
    }
    if "scale0" in items[0]:
        batch["scale0"] = stack("scale0").astype(np.float32)
        batch["scale1"] = stack("scale1").astype(np.float32)
    return batch


def pair_names(items: List[dict]) -> List[str]:
    return [it.get("pair_name", "?") for it in items]


def make_val_step(matcher, cfg: TrainMatcherConfig):
    """One validation batch on the device: the matcher forward (eval mode) ->
    each match's symmetric epipolar error against the GT pose -> RANSAC ->
    R / t angular errors, failed solves counted as 90 degrees (the eval
    drivers' penalty). noise: the solver's (B, n_rounds, n_hyps, M) Gumbel
    noise or a torch.Generator on the device."""
    from pope_tpu_torch.geometry.epipolar import compute_symmetric_epipolar_errors
    from pope_tpu_torch.geometry.pose import relative_pose_error
    from pope_tpu_torch.solver.ransac import estimate_pose_ransac

    @torch.no_grad()
    def step(batch, noise):
        res = matcher(batch["image0"], batch["image1"])
        # matches are in resized-image pixels; the errors use the original
        # intrinsics, so scale back first
        ones = torch.ones(batch["image0"].shape[0], 2, device=res.mkpts0.device)
        mk0 = res.mkpts0 * batch.get("scale0", ones)[:, None]
        mk1 = res.mkpts1 * batch.get("scale1", ones)[:, None]
        epi = compute_symmetric_epipolar_errors(batch["T_0to1"], mk0, mk1, batch["K0"], batch["K1"])
        sol = estimate_pose_ransac(mk0, mk1, batch["K0"], batch["K1"], res.valid, noise,
                                   thresh_px=cfg.val_thresh_px, n_hyps=cfg.val_n_hyps, n_rounds=cfg.val_n_rounds)
        t_err, r_err = relative_pose_error(batch["T_0to1"], sol.R, sol.t)
        failed = torch.full_like(r_err, 90.0)
        return {
            "epi_errs": epi,
            "match_valid": res.valid,
            "R_errs": torch.where(sol.ok, r_err, failed),
            "t_errs": torch.where(sol.ok, t_err, failed),
            "inliers": sol.inliers,
        }

    return step


def validation_errors(matcher, val_ds, cfg: TrainMatcherConfig, batch_size: int, val_step=None, seed: int = 0,
                      noise: Optional[Callable] = None) -> dict:
    """Per-pair errors over the whole validation set: {"identifiers",
    "epi_errs" (each pair's valid matches), "R_errs", "t_errs"}. The ragged
    tail batch is padded with its last pair. noise(lo, B, M) -> the solver
    noise of the batch starting at pair lo; default a torch.Generator on the
    model's device seeded seed + lo."""
    val_step = val_step or make_val_step(matcher, cfg)
    dev = next(matcher.parameters()).device
    was_training = matcher.training
    matcher.eval()
    metrics = {"identifiers": [], "epi_errs": [], "R_errs": [], "t_errs": []}
    n = len(val_ds)
    capacity, stride = matcher.config.match_coarse.match_capacity, matcher.config.coarse_stride
    try:
        for lo in range(0, n, batch_size):
            idx = list(range(lo, min(lo + batch_size, n)))
            n_real = len(idx)
            items = [val_ds[i] for i in idx + [idx[-1]] * (batch_size - n_real)]
            batch = {k: torch.from_numpy(v).to(dev) for k, v in collate_pairs(items).items()}
            H, W = batch["image0"].shape[1:3]
            M = min(capacity, (H // stride) * (W // stride))  # coarse_matching's slots
            g = (noise(lo, batch_size, M).to(dev) if noise is not None
                 else torch.Generator(device=dev).manual_seed(seed + lo))
            out = {k: v.cpu().numpy() for k, v in val_step(batch, g).items()}
            names = pair_names(items)
            for b in range(n_real):
                metrics["identifiers"].append(names[b])
                metrics["epi_errs"].append(out["epi_errs"][b][out["match_valid"][b]])
                metrics["R_errs"].append(float(out["R_errs"][b]))
                metrics["t_errs"].append(float(out["t_errs"][b]))
    finally:
        matcher.train(was_training)
    return metrics


def validate(matcher, val_ds, cfg: TrainMatcherConfig, batch_size: int, val_step=None, seed: int = 0,
             noise: Optional[Callable] = None) -> Dict[str, float]:
    """The full validation pass: aggregate_metrics' table plus the checkpoint
    monitors auc@{5,10,20}, the AUC of max(R_err, t_err)."""
    metrics = validation_errors(matcher, val_ds, cfg, batch_size, val_step, seed, noise)
    agg = aggregate_metrics(metrics, cfg.epi_err_thr)
    pose_err = np.maximum(np.asarray(metrics["R_errs"]), np.asarray(metrics["t_errs"]))
    for thr, v in zip((5, 10, 20), error_auc("Rt", pose_err, [5, 10, 20]).values()):
        agg[f"auc@{thr}"] = v
    return agg


class TopKCheckpointer:
    """ModelCheckpoint(monitor, save_top_k, mode='max', save_last) analogue
    (scripts/train.py:94-97) on checkpoint directories + a json index.

    Layout: <dir>/last (always the newest), <dir>/<name> for each of the k
    best, <dir>/index.json with their scores and the epoch counter, so that
    training resumes mid-schedule."""

    def __init__(self, ckpt_dir: str, monitor: str = "auc@10", top_k: int = 5):
        self.dir = ckpt_dir
        self.monitor = monitor
        self.top_k = top_k
        self.index = {"best": [], "epoch": 0, "monitor": monitor}
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, "index.json")
        if os.path.exists(path):
            with open(path) as f:
                self.index = json.load(f)

    def _write_index(self):
        with open(os.path.join(self.dir, "index.json"), "w") as f:
            json.dump(self.index, f, indent=1)

    def save(self, state: MatcherTrainState, epoch: int, val_metrics: Dict[str, float]):
        score = float(val_metrics[self.monitor])
        # filename pattern '{epoch}-{auc@5:.3f}-{auc@10:.3f}-{auc@20:.3f}'
        name = "epoch={}-auc5={:.3f}-auc10={:.3f}-auc20={:.3f}".format(
            epoch, val_metrics.get("auc@5", 0.0), val_metrics.get("auc@10", 0.0),
            val_metrics.get("auc@20", 0.0),
        )
        self.index["epoch"] = epoch + 1
        save_checkpoint(os.path.join(self.dir, "last"), state)

        best = [b for b in self.index["best"] if b["name"] != name]
        if len(best) < self.top_k or score > min(b["score"] for b in best):
            save_checkpoint(os.path.join(self.dir, name), state)
            best.append({"name": name, "score": score, "epoch": epoch})
            best.sort(key=lambda b: b["score"], reverse=True)
            for evicted in best[self.top_k:]:
                shutil.rmtree(os.path.join(self.dir, evicted["name"]), ignore_errors=True)
            best = best[: self.top_k]
        else:
            # a re-saved name (a resume re-running an epoch) that no longer
            # qualifies loses its directory too, or index.json and the
            # directories drift apart
            shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
        self.index["best"] = best
        self._write_index()

    @property
    def start_epoch(self) -> int:
        return int(self.index.get("epoch", 0))

    @property
    def best_score(self) -> Optional[float]:
        return self.index["best"][0]["score"] if self.index["best"] else None

    def restore_last(self, like: MatcherTrainState) -> MatcherTrainState:
        return load_checkpoint(os.path.join(self.dir, "last"), like=like)


def train_matcher(
    matcher,
    train_datasets: Sequence,
    val_ds,
    cfg: TrainMatcherConfig = TrainMatcherConfig(),
    batch_size: int = 4,
    mesh=None,
    ckpt_dir: Optional[str] = None,
    resume: bool = False,
    loss_cfg: LossConfig = LossConfig(),
    log_every: int = 10,
    num_workers: int = 2,
    device=None,
):
    """Run the train / validation schedule on `device` (default CUDA; raises
    without a GPU unless device="cpu"), training `matcher` from the weights
    it holds. Returns (state, history), history one dict per epoch
    {'epoch', 'train_loss', <validation metrics>}. lr and warmup scale with
    the global batch size as scripts/train.py:71-77 does. mesh: optional
    (dp, tp) mesh; batch_size stays the global batch and must divide by
    dp."""
    dev = resolve_device(device)
    matcher.to(dev)
    concat = ConcatDataset(list(train_datasets))
    sampler_len = len(concat.datasets) * cfg.n_samples_per_subset
    steps_per_epoch = max(sampler_len // batch_size, 1)

    # TRUE_LR = canonical_lr * (true_bs / canonical_bs), warmup_step =
    # floor(warmup / scaling)
    scaling = batch_size / cfg.canonical_bs
    ocfg = OptimConfig(
        lr=cfg.canonical_lr * scaling,
        warmup_steps=math.floor(cfg.warmup_steps / scaling) if cfg.warmup_steps else 0,
        warmup_ratio=cfg.warmup_ratio,
        scheduler=cfg.scheduler,
        mslr_milestones=tuple(cfg.mslr_milestones),
        mslr_gamma=cfg.mslr_gamma,
        steps_per_epoch=steps_per_epoch,
    )
    state = init_matcher_train_state(matcher, ocfg, grad_clip=cfg.grad_clip)  # gradient_clip_val=0.5

    ckpt = TopKCheckpointer(ckpt_dir, cfg.monitor, cfg.save_top_k) if ckpt_dir else None
    start_epoch = 0
    if resume and ckpt and ckpt.start_epoch > 0:
        state = ckpt.restore_last(state)
        start_epoch = ckpt.start_epoch
        logger.info("resumed from %s at epoch %d", ckpt_dir, start_epoch)

    if mesh is None:
        step_fn, local = (lambda s, b: matcher_train_step(s, b, loss_cfg)), (lambda idxs: idxs)
        main = True
    else:
        from pope_tpu_torch.parallel.mesh import (
            axis_size,
            is_mesh_main,
            mesh_barrier,
            shard_batch,
            shard_params_tp,
            tp_gathered,
        )

        dp = axis_size(mesh, "dp")
        if batch_size % dp:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={dp}")
        shard_params_tp(mesh, matcher, optimizer=state.optimizer)
        step_fn = make_sharded_train_step(mesh, loss_cfg)
        local = lambda idxs: list(shard_batch(mesh, np.asarray(idxs)))
        main = is_mesh_main(mesh)

    val_step = make_val_step(matcher, cfg)
    history = []
    for epoch in range(start_epoch, cfg.epochs):
        # a fresh sampler seed per epoch: reproducible given (seed, epoch),
        # and right across a resume
        sampler = RandomConcatSampler(concat, cfg.n_samples_per_subset, seed=cfg.seed + epoch)

        def gen_index_batches():
            buf = []
            for i in sampler:
                buf.append(i)
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            # the ragged tail is dropped (DataLoader drop_last)

        def load_batch(idxs):
            return collate_pairs([concat[i] for i in local(idxs)])

        losses = []
        t0 = time.time()
        batches = ThreadedLoader(gen_index_batches, num_workers=num_workers, fn=load_batch)
        for k, batch in enumerate(DevicePrefetcher(batches, dev)):
            metrics = step_fn(state, batch)
            losses.append(metrics["loss"])
            if (k + 1) % log_every == 0:
                logger.info(
                    "epoch %d step %d/%d loss=%.4f (c=%.4f f=%.4f) %.2f s/it",
                    epoch, k + 1, steps_per_epoch, float(metrics["loss"]),
                    float(metrics["loss_coarse"]), float(metrics["loss_fine"]), (time.time() - t0) / (k + 1),
                )
        train_loss = float(torch.stack(losses).mean()) if losses else float("nan")

        val_metrics = validate(matcher, val_ds, cfg, batch_size, val_step=val_step, seed=cfg.seed + epoch)
        logger.info("epoch %d done: train_loss=%.4f auc@5=%.3f auc@10=%.3f auc@20=%.3f", epoch, train_loss,
                    val_metrics["auc@5"], val_metrics["auc@10"], val_metrics["auc@20"])
        history.append({"epoch": epoch, "train_loss": train_loss, **val_metrics})
        if ckpt and mesh is None:
            ckpt.save(state, epoch, val_metrics)
        elif ckpt:
            with tp_gathered(matcher, state.optimizer):
                if main:
                    ckpt.save(state, epoch, val_metrics)
            mesh_barrier(mesh)  # no rank reads the directory before it is whole
    return state, history


def build_datasets(args):
    """The CLI's datasets: ScanNet / MegaDepth npz-index scenes
    (src/lightning/data.py MultiSceneDataModule file layout)."""
    from pope_tpu_torch.data.scenes import MegaDepthPairDataset, ScanNetPairDataset

    def build(npz_list, mode):
        out = []
        for npz in npz_list:
            if args.data_source == "scannet":
                out.append(ScanNetPairDataset(args.data_root, npz, args.intrinsic_path,
                                              min_overlap_score=args.min_overlap_score))
            else:
                out.append(MegaDepthPairDataset(
                    args.data_root, npz, mode=mode, min_overlap_score=args.min_overlap_score,
                    img_resize=args.img_resize, df=8, img_padding=True, depth_max_size=args.depth_max_size,
                ))
        return out

    return build(args.train_npz, "train"), ConcatDataset(build(args.val_npz, "val"))


def train_main(args):
    """CLI entry (`python -m pope_tpu_torch.cli train-matcher`): the full
    MatcherConfig() in f32, its weights drawn from --seed. With --dp x --tp
    > 1 it starts that many ranks on this host (parallel.launch.spawn), one
    device each; rank 0 writes the checkpoints and the history."""
    if args.dp * args.tp > 1:
        from pope_tpu_torch.parallel import spawn

        spawn(_train_ranked, args.dp * args.tp, argv=(args,), tp=args.tp, device=args.device)
        return None
    return _train_ranked(None, args)


def _train_ranked(mesh, args):
    from pope_tpu_torch.config import MatcherConfig
    from pope_tpu_torch.models.matcher import Matcher
    from pope_tpu_torch.pipeline.api import init_matcher_weights

    dev = resolve_device(args.device)
    cfg = TrainMatcherConfig(
        epochs=args.epochs,
        n_samples_per_subset=args.n_samples_per_subset,
        canonical_lr=args.canonical_lr,
        warmup_steps=args.warmup_steps,
        epi_err_thr=args.epi_err_thr,
        seed=args.seed,
    )
    train_ds, val_ds = build_datasets(args)
    matcher = Matcher(MatcherConfig())
    init_matcher_weights(matcher, torch.Generator().manual_seed(cfg.seed))
    state, history = train_matcher(matcher, train_ds, val_ds, cfg, batch_size=args.batch_size, mesh=mesh,
                                   ckpt_dir=args.ckpt_dir, resume=args.resume, device=dev)
    if args.history_out and (mesh is None or mesh.get_rank() == 0):
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return history
