"""Benchmark of the port: the shipped eval driver over an on-disk
LINEMOD-layout dataset on one CUDA card (the counterpart of the root
bench.py) —
pope_tpu_torch.eval.evaluate_dataset -> pipeline.runner dispatch/finish
(batched pair axis) -> SAM ViT-H encode + 256-prompt AMG + small-region
cleanup -> DINOv2 retrieval + matching + RANSAC -> records and metrics.

    python3 -m pope_tpu_torch.bench

Prints ONE JSON line in bench.py's format: the steady-state eval-driver
pairs/s (median of POPE_BENCH_REPS windows of 4 batches of POPE_BENCH_BATCH
pairs each, inside one continuous run, between a fill batch and a tail of
POPE_PIPELINE_DEPTH batches), the device-only pairs/s in the same
run (inputs already on the card, 4 batches queued before one synchronize:
no file IO, uploads or record building), the host edge between the two, the
model-FLOP budget per pair (the same formula as bench.py) and the model
FLOP/s against the H100's dense bf16 peak, with the card's name and power
limit. Weights are seeded (no checkpoint is in the repo); the compute path
is the released weights'. Needs a CUDA card; a CUDA out-of-memory error is a
failure (no smaller batch is tried).
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

H100_BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
WINDOW_BATCHES = 4  # batches per timed window

H, W = 480, 640  # LINEMOD frame


def _vit_flops(n_tokens, depth, embed, mlp_ratio=4.0, window=0, n_windows=0, n_global=0):
    """Model FLOPs (2*MACs) of a ViT forward: qkv/proj/mlp matmuls + attention
    einsums. For windowed ViTDet layers (window>0) the quadratic term uses the
    window token count over `n_windows` (possibly rect) windows; `n_global`
    layers attend over the full grid (bench.py's formula)."""
    C = embed
    lin = 2 * n_tokens * C * C * (3 + 1 + 2 * mlp_ratio)  # qkv+proj+mlp per layer
    flops = float(depth) * lin
    if window:
        flops += (depth - n_global) * 4 * n_windows * (window * window) ** 2 * C
        flops += n_global * 4 * n_tokens * n_tokens * C
    else:
        flops += depth * 4 * n_tokens * n_tokens * C
    return flops


def flop_budget(models, n_candidates=None, crop_size=256):
    """Per-pair model-FLOP budget of the two device stages at the bench's
    640x480 frames, from the model configs: bench.py's formula term for
    term (the rect-encoded 48x64 token grid with AMGConfig.rect_encode, the
    decode at eval_decode_subsample, DINOv2 on mask_capacity + 1 crops, the
    matcher on top_k crops)."""
    cfg = models.config
    enc = cfg.sam.encoder
    grid = enc.img_size // enc.patch_size
    if cfg.amg.rect_encode:
        from pope_tpu_torch.models.sam.sam import rect_frame, resize_longest_side

        fh, fw = rect_frame(resize_longest_side(H, W, enc.img_size), enc.patch_size)
        gh, gw = fh // enc.patch_size, fw // enc.patch_size
    else:
        gh = gw = grid
    n_tok = gh * gw
    ws = enc.window_size
    n_windows = (-(-gh // ws)) * (-(-gw // ws))
    n_global = len(enc.global_attn_indexes)
    C = enc.embed_dim
    sam_encode = _vit_flops(
        n_tok, enc.depth, C, enc.mlp_ratio,
        window=ws, n_windows=n_windows, n_global=n_global,
    )
    # AMG decode: per prompt the image side of the two-way transformer's
    # cross attentions (7 units of 2*n_tok*D*(D/2); 3 more once per image)
    # and the upscaling convs, of which the subsampled decode runs 1/sub^2
    D = cfg.sam.prompt_embed_dim
    n_cand = n_candidates or (cfg.amg.points_per_side**2 * 3)
    n_prompts = n_cand // 3
    unit = 2 * n_tok * D * (D // 2)
    two_way = 7 * unit
    two_way_per_image = 3 * unit
    upscale = 2 * (4 * n_tok) * D * (D // 4) * 4 + 2 * (16 * n_tok) * (D // 4) * (D // 8) * 4
    upscale /= float(cfg.amg.eval_decode_subsample) ** 2
    amg_decode = n_prompts * (two_way + upscale) + two_way_per_image
    # retrieval: DINOv2 on mask_capacity crops + 1 prompt, 196 px -> 14x14 + cls
    dt = cfg.dinov2
    d_tokens = (196 // dt.patch_size) ** 2 + 1
    dinov2_fwd = _vit_flops(d_tokens, dt.depth, dt.embed_dim, dt.mlp_ratio)
    retrieval = (cfg.amg.mask_capacity + 1) * dinov2_fwd
    # matcher on (ref, top_k crops): linear attention O(N d^2) + a rough conv stack
    m = cfg.matcher
    l_tok = (480 // 8) * (640 // 8)
    s_tok = (crop_size // 8) ** 2
    d_c = m.coarse.d_model
    coarse_attn = len(m.coarse.layer_names) * 2 * (l_tok + s_tok) * d_c * d_c * 8
    backbone = 2 * (480 * 640 + crop_size * crop_size) * 64 * 64 * 9 * 3
    matcher = cfg.top_k * (coarse_attn + backbone)
    total = sam_encode + amg_decode + retrieval + matcher
    return {
        "sam_encode": sam_encode,
        "amg_decode": amg_decode,
        "retrieval": retrieval,
        "matcher": matcher,
        "total_per_pair": total,
    }


def make_dataset(root: str, n_pairs: int):
    """LINEMOD-layout on-disk dataset (random frames at the real resolution),
    exercising the same file IO the production driver does: bench.py's
    frames, intrinsics and poses, written through data/image_io.py.
    Returns (data_root, pairs_dir)."""
    import cv2

    from pope_tpu_torch.data.image_io import write_rgb

    rng = np.random.default_rng(0)
    label, seq = "0801-lm1-others", "lm1-3"
    base = os.path.join(root, "LM_dataset", label, seq)
    for sub in ("color", "color_full", "intrin", "intrin_ba", "poses_ba"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    K = np.array([[572.4, 0, 320], [0, 573.6, 240], [0, 0, 1]])
    pairs = []
    for i in range(n_pairs):
        # bench.py's BGR arrays, written as the same files
        ref = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        tgt = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        cv2.rectangle(tgt, (200, 140), (440, 340), (250, 240, 20), -1)
        write_rgb(os.path.join(base, "color", f"{i}.png"), ref[..., ::-1])
        write_rgb(os.path.join(base, "color_full", f"{1000+i}.png"), tgt[..., ::-1])
        np.savetxt(os.path.join(base, "intrin_ba", f"{i}.txt"), K)
        np.savetxt(os.path.join(base, "intrin", f"{1000+i}.txt"), K)
        pose0 = np.hstack([np.eye(3), [[0], [0], [0.6]]])
        R1, _ = cv2.Rodrigues(np.array([0.05, 0.2, -0.1]))
        pose1 = np.hstack([R1, [[0.02], [0.0], [0.62]]])
        np.savetxt(os.path.join(base, "poses_ba", f"{i}.txt"), pose0)
        np.savetxt(os.path.join(base, "poses_ba", f"{1000+i}.txt"), pose1)
        pairs.append(f"{label}/{seq}/color/{i}.png-{1000+i}.png")
    np.savetxt(
        os.path.join(root, "LM_dataset", label, "box3d_corners.txt"),
        np.array([[x, y, z] for x in (-0.05, 0.05) for y in (-0.05, 0.05) for z in (-0.05, 0.05)]),
    )
    pairs_dir = os.path.join(root, "pairs")
    os.makedirs(pairs_dir, exist_ok=True)
    with open(os.path.join(pairs_dir, "LINEMOD-test.json"), "w") as f:
        json.dump([{"0": pairs}], f)
    return root, pairs_dir


def bench_config():
    """bench.py's configs: SAM ViT-H (bf16 weight storage, as load_models
    applies), DINOv2 ViT-S/14 in bf16, the matcher in bf16 with a match
    capacity of 512, AMGConfig()."""
    from pope_tpu_torch.config import (
        AMGConfig, CoarseMatchConfig, DinoV2Config, MatcherConfig, PipelineConfig, SamConfig, SamEncoderConfig,
    )

    mcfg = MatcherConfig(match_coarse=CoarseMatchConfig(match_capacity=512), dtype="bfloat16")
    return PipelineConfig(
        matcher=mcfg, dinov2=DinoV2Config(dtype="bfloat16"),
        sam=SamConfig(encoder=SamEncoderConfig.vit_h()), amg=AMGConfig(),
    )


def build_models(device=None):
    """Full-scale models at bench_config(), seeded weights, on the card."""
    from pope_tpu_torch.pipeline import load_models

    return load_models(bench_config(), sam_type="h", seed=0, device=device)


def device_only_pairs_per_s(models, chunk, crop_size, n_reps, window=WINDOW_BATCHES):
    """Median device-side throughput: one batch's inputs already on the card,
    only the two stages (and the per-pair noise draw) timed — no file IO,
    uploads or record building. Per sample, `window` batches are queued
    before one synchronize, the queue depth the pipelined driver keeps."""
    from pope_tpu_torch.pipeline import runner

    _, dev = runner.prepare_batch(chunk, models.device)
    dev = dev.wait()
    run = runner.get_executor(models, crop_size).batched()
    cfg = models.config

    def dispatch():
        noise = runner.pair_noise(chunk, cfg.matcher.match_coarse.match_capacity, cfg.ransac_rounds, models.device)
        boxes_b, valid_b, dropped_b = models.amg.generate_boxes_batch(dev.img1_u8)
        return run(dev.img0_u8, dev.img1_u8, dev.K0, dev.K1, boxes_b, valid_b, None, noise, dropped_b, packed=True)

    dispatch()
    torch.cuda.synchronize()
    samples = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        for _ in range(window):
            dispatch()
        torch.cuda.synchronize()
        samples.append(window * len(chunk) / (time.perf_counter() - t0))
    return float(np.median(samples)), samples


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main(n_reps=None, batch=None, models=None) -> dict:
    """Run the benchmark, print its JSON line and return it. n_reps / batch
    default to POPE_BENCH_REPS (5) / POPE_BENCH_BATCH (4); `models` to
    build_models()."""
    if not torch.cuda.is_available():
        raise SystemExit("pope_tpu_torch.bench: torch.cuda.is_available() is false; it runs on a CUDA card")
    from pope_tpu_torch.eval.evaluate import evaluate_dataset
    from pope_tpu_torch.eval.manifest import DATASETS, iter_pairs, load_manifest

    batch = batch or int(os.environ.get("POPE_BENCH_BATCH", "4"))
    n_reps = n_reps or int(os.environ.get("POPE_BENCH_REPS", "5"))
    # 1 fill batch (the pipeline has no overlap for batch 1) + n_reps windows
    # + `depth` tail batches: the driver's last `depth` batches complete in
    # its final drain with no dispatch between them, and a window that held
    # them would read high while dispatch takes host time (bench.py's TPU
    # dispatch did not)
    depth = max(1, int(os.environ.get("POPE_PIPELINE_DEPTH", "2")))
    n_batches = 1 + n_reps * WINDOW_BATCHES + depth
    models = models if models is not None else build_models()
    spec = DATASETS["linemod"]
    with tempfile.TemporaryDirectory() as tmp:
        data_root, pairs_dir = make_dataset(tmp, n_pairs=n_batches * batch)

        def run(max_pairs, on_batch=None):
            return evaluate_dataset(
                models, "linemod", data_root, pairs_dir,
                max_pairs=max_pairs, batch_size=batch, progress=False, on_batch=on_batch,
            )

        # warm every stage at this batch shape (allocator, cuBLAS handles,
        # the kernels' first launches)
        run(3 * batch)

        # ONE continuous timed run; the driver's on_batch hook stamps each
        # batch's completion, giving n_reps steady-state windows of
        # WINDOW_BATCHES batches between the fill batch and the tail
        stamps = [time.perf_counter()]
        per_obj = run(n_batches * batch, on_batch=lambda _n: stamps.append(time.perf_counter()))
        if not per_obj:
            raise RuntimeError("the driver produced no records")
        w = WINDOW_BATCHES
        samples = [(w * batch) / (stamps[1 + (k + 1) * w] - stamps[1 + k * w]) for k in range(n_reps)]
        pairs_per_s = float(np.median(samples))

        chunk = list(iter_pairs(data_root, spec, load_manifest(pairs_dir, spec)))[:batch]
        dev_pairs_per_s, dev_samples = device_only_pairs_per_s(models, chunk, spec.crop_size, n_reps)

    budget = flop_budget(models)
    model_flops_per_s = budget["total_per_pair"] * pairs_per_s
    line = {
        "metric": (
            "shipped eval-driver pairs/sec/card (evaluate_dataset->dispatch/finish_pairs: "
            f"SAM-H AMG + DINOv2 retrieval + match + RANSAC + records, 640x480, B={batch})"
        ),
        "value": round(pairs_per_s, 3),
        "unit": "pairs/s",
        "n": len(samples),
        "median": round(pairs_per_s, 3),
        "min": round(min(samples), 3),
        "max": round(max(samples), 3),
        "samples": [round(s, 3) for s in samples],
        # device-only throughput in the SAME run; the shipped/device ratio
        # is the host edge the driver's pipelining must hide
        "device_only_pairs_per_s": round(dev_pairs_per_s, 3),
        "device_only_samples": [round(s, 3) for s in dev_samples],
        "host_edge_pct": round(100.0 * (1.0 - pairs_per_s / dev_pairs_per_s), 1),
        "model_tflops_per_pair": round(budget["total_per_pair"] / 1e12, 3),
        "model_tflops_per_s": round(model_flops_per_s / 1e12, 2),
        "mfu_vs_h100_bf16_peak": round(model_flops_per_s / H100_BF16_PEAK_FLOPS, 4),
        "flops_split_tflops": {k: round(v / 1e12, 3) for k, v in budget.items() if k != "total_per_pair"},
        "card": card_name(),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
