"""Regressor training and eval drivers, the CLI bodies (port of
pope_tpu/models/regressor/driver.py: seed 20231223, batch 8, AdamW 1e-5 /
wd 1e-5, num_sample 500, loss MSE(t) + geodesic(R), a checkpoint every
epochs / 5 epochs and at the end; the eval's per-category accuracy table).
Checkpoints are utils/checkpoint.py's torch.save directories
(`<ckpt_dir>/step_<epoch>`); orbax checkpoints are not read.

As in the JAX package, test_main builds RegressorConfig(num_sample), the
'mkpts' model: it evaluates checkpoints of that mode only.
"""

from __future__ import annotations

import os
import time

import torch

from pope_tpu_torch.config import RegressorConfig
from pope_tpu_torch.models.regressor.data import load_pose_dataset, make_batches, train_val_split
from pope_tpu_torch.models.regressor.model import MkptsRegModel
from pope_tpu_torch.models.regressor.train import create_train_state, eval_step, train_step
from pope_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from pope_tpu_torch.utils.device import resolve_device
from pope_tpu_torch.utils.metrics import aggregate_metrics_mean

METRICS = ("R:ACC15", "R:ACC30", "R:auc@30", "R:medianErr", "R:meanErr")


def load_ckpt(path: str, like):
    """Restore the checkpoint directory `path` (utils/checkpoint.py's format,
    as train_main writes it) into `like`, a RegressorTrainState of the same
    architecture, in place; returns it. pope_tpu restores an orbax
    checkpoint here."""
    return load_checkpoint(path, like)


def _on(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_main(args):
    """Train MkptsRegModel on the extraction dumps; returns the train state."""
    dev = resolve_device(getattr(args, "device", None))
    cfg = RegressorConfig(num_sample=args.num_sample, net_mode=args.net_mode, rotation_mode=args.rotation_mode,
                          fusion=getattr(args, "fusion", "cross_attn"), vim_size=getattr(args, "vim_size", "small"))
    with_images = "imgs" in cfg.net_mode or "vim" in cfg.net_mode
    data = load_pose_dataset(args.dataset, args.data_root, getattr(args, "pairs_dir", "data/pairs"), args.points_dir,
                             load_images=with_images)
    if not data:
        raise SystemExit("no extraction dumps found; run `extract` first")
    train, val = train_val_split(data, seed=cfg.seed)
    print(f"dataset: {len(train)} train / {len(val)} val pairs")
    torch.manual_seed(cfg.seed)
    with torch.device(dev):
        model = MkptsRegModel(cfg)
    state = create_train_state(model, cfg)
    dropout = torch.Generator(device=dev).manual_seed(1)
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = [train_step(state, _on(batch, dev), dropout)["loss"] for batch in make_batches(
            train, cfg.num_sample, cfg.batch_size, seed=cfg.seed + epoch, with_images=with_images)]
        print(f"epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} ({time.time() - t0:.1f}s)")
        if (epoch + 1) % max(args.epochs // 5, 1) == 0 or epoch == args.epochs - 1:
            path = save_checkpoint(os.path.abspath(os.path.join(args.ckpt_dir, f"step_{epoch + 1}")), state)
            print(f"saved {path}")
    return state


def test_main(args):
    """Evaluate an 'mkpts' checkpoint on the validation split; prints and
    returns aggregate_metrics_mean's table."""
    dev = resolve_device(getattr(args, "device", None))
    cfg = RegressorConfig(num_sample=args.num_sample)
    data = load_pose_dataset(args.dataset, args.data_root, getattr(args, "pairs_dir", "data/pairs"), args.points_dir,
                             load_images=False)
    _, val = train_val_split(data, seed=cfg.seed)
    with torch.device(dev):
        state = create_train_state(MkptsRegModel(cfg), cfg)
    load_ckpt(args.ckpt, state)
    R_errs, t_errs = [], []
    for batch in make_batches(val, cfg.num_sample, cfg.batch_size, seed=cfg.seed, shuffle=False):
        out = eval_step(state, _on(batch, dev))
        R_errs.extend(out["R_err"].cpu().numpy().tolist())
        t_errs.extend(out["t_err"].cpu().numpy().tolist())
    metrics = aggregate_metrics_mean({"R_errs": R_errs, "t_errs": t_errs, "identifiers": []})
    for k in METRICS:
        print(f"{k}: {metrics[k]:.4f}")
    return metrics
