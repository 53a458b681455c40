"""SSL pretraining driver (port of pope_tpu/train/ssl_driver.py): an image
folder -> the multi-crop loader -> SSLMetaArch.train_step, with periodic
checkpoints and auto-resume.

The batch stream is the JAX package's byte for byte: every random decision
(shuffle order, crop / jitter / blur parameters, iBOT masks, collate
sampling) is a pure function of (seed, rank, stream position), so a killed
and resumed run reproduces the unbroken run's batches, and the sampler
fast-forwards past the batches the checkpoint's step already consumed.

Over a dp mesh (`mesh=`, one rank per device) the state is FSDP-cut
(ssl.shard_ssl_state) and each step is ssl.make_sharded_ssl_step. On one
host (`--dp N`) every rank reads the one stream of global batches and
takes its images, so the run equals `--dp 1` at the same global batch;
with `own_stream` (`--distributed`, one process per rank, on any number of
hosts) each rank reads its own shard of the files, batch / world images a
step, as the JAX package's processes do. Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator, Optional

import numpy as np

from pope_tpu_torch.config import DinoV2Config
from pope_tpu_torch.data.loader import DevicePrefetcher, ThreadedLoader
from pope_tpu_torch.data.samplers import ShardedInfiniteSampler
from pope_tpu_torch.data.ssl_crops import DataAugmentationDINO, MaskingGenerator, MultiCropConfig, collate_multicrop
from pope_tpu_torch.train.ssl import (
    SSLConfig,
    SSLMetaArch,
    fsdp_gathered,
    make_sharded_ssl_step,
    shard_ssl_batch,
    shard_ssl_state,
)
from pope_tpu_torch.utils.checkpoint import latest_checkpoint, load_payload, save_payload
from pope_tpu_torch.utils.device import resolve_device
from pope_tpu_torch.utils.logging import get_logger

logger = get_logger("pope_tpu_torch.ssl")

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

# `cli train-ssl --arch`: backbone sizes
ARCH_SIZES = {
    "vit_small": dict(embed_dim=384, depth=12, num_heads=6),
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large": dict(embed_dim=1024, depth=24, num_heads=16),
    "vit_giant": dict(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused"),
}


def iter_image_files(root: str):
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTS):
                yield os.path.join(dirpath, f)


def make_ssl_batches(image_root: str, cfg: SSLConfig, batch_size: int, seed: int = 0, num_workers: int = 4,
                     rank: int = 0, world: int = 1, advance_batches: int = 0,
                     stop: Optional[threading.Event] = None) -> Iterator[dict]:
    """Endless stream of collated multi-crop batches (host numpy), resumable
    mid-epoch: every rank draws a disjoint strided shard of one shared epoch
    permutation, and `advance_batches` fast-forwards this rank's stream by
    that many consumed batches. The loader thread ends once `stop` is set."""
    import cv2

    # sorted: os.walk's order is the filesystem's; the sampler's indices must
    # name the same files across restarts
    files = sorted(iter_image_files(image_root))
    if not files:
        raise FileNotFoundError(f"no images under {image_root}")
    crop_cfg = MultiCropConfig(global_crop_size=cfg.global_crop_size, local_crop_size=cfg.local_crop_size,
                               n_local_crops=cfg.n_local_crops)
    n_tokens_side = cfg.global_crop_size // 14

    def forever():
        sampler = ShardedInfiniteSampler(len(files), shuffle=True, seed=seed, start=rank, step=world,
                                         advance=advance_batches * batch_size)
        aug = DataAugmentationDINO(crop_cfg, seed=0)
        gen = MaskingGenerator(input_size=n_tokens_side, seed=0)
        pos = advance_batches * batch_size  # this rank's stream position
        b = advance_batches  # this rank's batch counter
        batch = []
        for idx in sampler:
            if stop is not None and stop.is_set():
                return
            img = cv2.imread(files[idx], cv2.IMREAD_COLOR)
            pos += 1  # advances on failed reads too: the position stays pure
            if img is None:
                continue
            # each sample's augmentation stream is keyed by its position
            aug.rng = np.random.default_rng(np.random.SeedSequence([seed, rank, pos, 3]))
            batch.append(aug(img[..., ::-1]))  # BGR -> RGB
            if len(batch) == batch_size:
                gen.rng = np.random.default_rng(np.random.SeedSequence([seed, rank, b, 7]))
                yield collate_multicrop(
                    batch, gen, mask_ratio=(cfg.mask_ratio_min, cfg.mask_ratio_max),
                    mask_probability=cfg.mask_sample_probability,
                    seed=int(np.random.default_rng(np.random.SeedSequence([seed, rank, b, 13])).integers(1 << 31)),
                )
                b += 1
                batch = []

    return iter(ThreadedLoader(forever, num_workers=num_workers))


def _sidecar_mismatch(ckpt_dir: str, expect: dict) -> dict:
    """The sampler.json fields that differ from `expect`, as (saved, now)."""
    meta_path = os.path.join(ckpt_dir, "sampler.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        meta = json.load(f)
    return {k: (meta.get(k), v) for k, v in expect.items() if meta.get(k) != v}


def train_ssl(image_root: str, cfg: SSLConfig = SSLConfig(), backbone_cfg: DinoV2Config = DinoV2Config(),
              batch_size: int = 8, total_steps: Optional[int] = None, ckpt_dir: Optional[str] = None,
              ckpt_every: int = 1000, log_every: int = 10, mesh=None, seed: int = 0, device=None,
              own_stream: bool = False):
    """Run SSL pretraining on `device` (default CUDA); returns the final
    SSLState (FSDP-cut over a mesh). With `ckpt_dir`, resumes from its
    latest `step_*` checkpoint and continues the same batch stream.
    batch_size is the global batch; mesh: an optional dp mesh;
    own_stream: each rank reads its own stream (multi-process runs)."""
    dev = resolve_device(device)
    arch = SSLMetaArch(cfg, backbone_cfg)
    state = arch.init_state(seed, dev)
    if ckpt_dir:
        path = latest_checkpoint(ckpt_dir)
        if path:
            logger.info("resuming from %s", path)
            state.load_state_dict(load_payload(path, dev))
    mults = arch.multipliers(state)
    step_fn = lambda st, b: arch.train_step(st, b, mults=mults)
    rank, world, local = 0, 1, lambda b: b
    if mesh is not None:
        from pope_tpu_torch.parallel.collectives import get_rank, get_world_size

        step_fn = make_sharded_ssl_step(arch, mesh, mults=mults)
        state = shard_ssl_state(state, mesh)
        if own_stream:
            rank, world = get_rank(), get_world_size()
        else:
            local = lambda b: shard_ssl_batch(mesh, b)
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must be divisible by process count {world}")
    per_host_batch = batch_size // world
    main = True
    if mesh is not None:
        from pope_tpu_torch.parallel.mesh import is_mesh_main, mesh_barrier

        main = is_mesh_main(mesh)

    total = total_steps if total_steps is not None else cfg.total_iters
    start = state.step
    sidecar = {"seed": seed, "world": world, "per_host_batch": per_host_batch}
    if ckpt_dir and start:
        mismatch = _sidecar_mismatch(ckpt_dir, sidecar)
        if mismatch:
            logger.warning("sampler stream NOT resumable (%s changed: %s); the data order restarts from the "
                           "advance point", ",".join(mismatch), mismatch)
    stop = threading.Event()
    stream = make_ssl_batches(image_root, cfg, per_host_batch, seed=seed, rank=rank, world=world,
                              advance_batches=start, stop=stop)
    batches = iter(DevicePrefetcher((local(b) for b in stream), dev))

    def save(name, st):
        with fsdp_gathered(st):
            if main:
                save_payload(os.path.join(ckpt_dir, name), st.state_dict())
                # everything needed to resume the data stream (the
                # consumed-batch count itself is the step)
                with open(os.path.join(ckpt_dir, "sampler.json"), "w") as f:
                    json.dump(sidecar | {"consumed_batches": st.step}, f)
        if mesh is not None:
            mesh_barrier(mesh)  # no rank reads the directory before it is whole

    t0 = time.time()
    try:
        for i in range(start, total):
            state, metrics = step_fn(state, next(batches))
            if (i + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logger.info(
                    "step %d/%d loss=%.4f dino_g=%.4f dino_l=%.4f ibot=%.4f koleo=%.4f lr=%.2e (%.2f s/it)",
                    i + 1, total, m["total_loss"], m["dino_global_crops_loss"], m.get("dino_local_crops_loss", 0.0),
                    m.get("ibot_loss", 0.0), m.get("koleo_loss", 0.0), m["lr"],
                    (time.time() - t0) / max(i + 1 - start, 1),
                )
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                save(f"step_{i + 1:08d}", state)
    finally:
        stop.set()  # the loader thread reads no further
    if ckpt_dir:
        save(f"step_{total:08d}", state)
    return state


def ssl_configs(args):
    """(SSLConfig, DinoV2Config) of `cli train-ssl`'s arguments: the
    schedules scale with --total-steps."""
    bcfg = DinoV2Config(patch_size=14, drop_path_rate=getattr(args, "drop_path_rate", 0.0), **ARCH_SIZES[args.arch])
    cfg = SSLConfig(
        global_crop_size=args.global_crop_size,
        local_crop_size=args.local_crop_size,
        n_local_crops=args.n_local_crops,
        total_iters=args.total_steps,
        warmup_iters=max(args.total_steps // 10, 1),
        warmup_teacher_temp_iters=max(args.total_steps // 4, 1),
        freeze_last_layer_iters=max(args.total_steps // 100, 1),
        lr=args.lr,
    )
    return cfg, bcfg


def train_main(args):
    """CLI entry (`cli train-ssl`). --distributed: this process is one rank
    of the topology that parallel.launch.resolve_env finds (--coordinator
    / --num-processes / --process-id, else POPE_* or SLURM variables), the
    mesh spans every rank, and --dp must be 1 or the world size. --dp N
    alone starts N ranks on this host (parallel.launch.spawn)."""
    if getattr(args, "distributed", False):
        from pope_tpu_torch.parallel.launch import launch, resolve_env

        env = resolve_env(coordinator=args.coordinator, num_processes=args.num_processes,
                          process_id=args.process_id)
        return launch(_train_ranked, env=env, tp=1, argv=(args, True), device=args.device)
    if args.dp > 1:
        from pope_tpu_torch.parallel import spawn

        spawn(_train_ranked, args.dp, argv=(args, False), tp=1, device=args.device)
        return None
    return _train_ranked(None, args, False)


def _train_ranked(mesh, args, own_stream: bool):
    if mesh is not None:
        world = mesh.size()
        if own_stream and args.dp not in (1, world):
            raise ValueError(f"--dp {args.dp} with --distributed: the mesh is the {world} processes")
        if world == 1:
            mesh = None
    cfg, bcfg = ssl_configs(args)
    return train_ssl(args.image_root, cfg, bcfg, batch_size=args.batch_size, total_steps=args.total_steps,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, mesh=mesh, seed=args.seed,
                     device=args.device, own_stream=own_stream)
