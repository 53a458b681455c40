#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: print the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from pope_tpu_torch/csrc with nvcc (one
     process per source, in parallel), print ptxas's registers, shared
     memory and spills for the short kernel's 12 instantiations and the long
     kernel's 9, none of which may spill;
  3. kernels: each ported kernel at the shape the main path gives it (SAM
     ViT-H's AMG program on B=4 640x480 frames, rect 48x64 token grid, for
     the two rel-pos kernels; DINOv2 ViT-S/14's retrieval forward over 4
     pairs x 65 crops for the bias-free one), through the design the main
     path takes there (the short kernel for 1 and 3, the long one for 2),
     held against its plain PyTorch version, and timed beside the plain
     version, the bound of the card, the exponentials' floor on the
     special-function units (at the card's highest SM clock; in the
     kernel_phase row, not in the kernels line) and one library call
     (SDPA, with a materialised bias mask where the kernel has a bias).
     The streaming design (the previous one at each shape) is checked and
     timed too, in turns with the main path's (previous, new, new,
     previous). Each time is the card's: the calls are queued behind a
     sleep on the card, so the host's time per call does not enter it.
     Kernels 1 and 2 are also held and timed at the serving path's square
     64x64 token grid (one frame: 25 windows, N = 4096), kernel 2 at the
     multi-crop sweep's 52x64 grid (one crop, N = 3328) and kernel 3 through
     the long bias-free design at demo-dinov2's N = 1025 (one image, a
     masked key tail); the long kernel's launcher reports the Q and K/V
     stages it picks at the three grids;
  4. reference: a small SAM (ViT-H width, 2 blocks, f32) encodes and decodes
     on the card and on the CPU, where the port runs its plain versions
     (which the CPU test suite holds against pope_tpu); the two must agree;
  5. stage-2 reference: a small DINOv2 (ViT-S width, 2 blocks), a small
     matcher (full widths, 2 coarse layers) and the solver, f32, on the card
     and on the CPU, the solver's noise drawn once on the CPU;
  6. solver: 4 synthetic pairs of 1024 correspondences from known poses
     (1 px noise, 30% outliers) in one batched RANSAC call on the card,
     which must recover each rotation within a few degrees;
  7. main path: load_models(sam_type="h") with seeded weights for SAM,
     DINOv2 and the matcher; stage 1,
     AutomaticMaskGenerator.generate_boxes_batch on four 640x480 target
     frames, then stage 2, PipelineExecutor.batched() (retrieve -> match ->
     solve) on four prompt frames and the stage-1 boxes. Each stage runs with
     the kernels' launch counts (in all and per design) set to 0 just before
     it and read just after: 28 windowed launches through the short kernel
     and 4 global ones through the long kernel per SAM forward, 12 DINOv2
     launches through the short kernel per stage-2 call;
     then both are timed and profiled, and stage 1 and 2 run once more with
     the AMG filters open;
  8. serving (run_serve_phase), with the main path's models: SamPredictor
     on a 640x480 frame (set_image on the square frame, the counts set to 0
     just before and read just after: 28 short + 4 long launches; predict
     with points and a box, predict_batched of 16 boxes whose row 0 must be
     predict's), the WebDemo against the predictor's best multimask slot and
     its ms per click and per HTTP /predict, and the PoseService at B=4:
     one batch's launches (28, 4, 12), a full batch equal to
     runner.run_pairs on the same frames and names, a single request's
     latency and 8 concurrent requests' p50/p90, requests/s and batch fill;
  9. records (run_records_phase), with the main path's models and the AMG
     filters open, the counts set to 0 just before each step and read just
     after: generate on a 640x480 frame (28 short + 4 long launches, the
     median ms split into encode, decode + filters + cut, download and host
     cleanup); generate_batch of 4 frames with and without the logits, each
     image's valid candidates as generate gives them alone; generate_records
     at crop_n_layers 0 and 1 (28 + 4 and 140 + 20 launches), every RLE
     decoding to its segmentation; run_amg over 2 frames in both output
     modes, the COCO JSON decoding back to the PNG masks; the demo-sam,
     demo-dinov2 (12 long bias-free launches at N = 1025) and demo-3dbbox
     (28 + 4 + 24 short) commands, their images' shapes; and a small f32
     SAM's records on the card against the CPU;
 10. eval driver: bench.py's configs at full width (pope_tpu_torch/bench.py:
     SAM ViT-H, DINOv2 ViT-S/14 and the matcher in bf16, seeded weights),
     a LINEMOD-layout dataset of 16 pairs of 640x480 PNG frames on disk
     (the port's make_dataset), pope_tpu_torch.eval.evaluate_dataset in
     batches of 4 with two in flight, the counts set to 0 just before and
     read just after: each batch launches the three kernels 28, 4 and 12
     times; 16 records, R/t finite where solved; depth 1 gives the same
     records as depth 2 on the first 2 batches, and run_pair, one pair at a
     time, the same discrete fields. One batch then runs in series with
     each part timed (decode + upload, stage 1, crop + DINOv2, matcher,
     solver, download + records) and is profiled. Then
     pope_tpu_torch.bench.main at
     BENCH_REPS windows of 4 batches prints its JSON line (bench.py's keys,
     MFU against the H100's bf16 peak, the card's name and power limit).
     The image reader in use is in the eval_phase line.
 11. matcher training (run_train_phase): a small matcher's two train steps
     on the card against the CPU from the same weights and batch; then
     MatcherConfig() in f32 at B=4 on 480x640 planar pairs of known depth
     and pose, 2 warm-up and 10 timed steps on one batch (ms per step split
     into supervision + forward, backward and clip + optimizer, the losses
     of every step, finite and the 10th below the 1st, peak memory, the
     FLOPs of a step, one profiled step and its idle share), the
     backbone's forward + backward with and without cuDNN, and `cli
     train-matcher` on a ScanNet-layout scene written with cv2 (2 epochs,
     top-k checkpoints, then --resume to 3 epochs); the counts set to 0 just
     before the steps and the CLI runs and read just after: none of the
     three kernels launches.
 12. export (run_export_phase): the four serving programs at full width,
     each exported with torch.export, saved under build/export/, loaded
     with load_exported and run against the eager module on the same
     inputs: the SAM ViT-H prompt head at 480x640 with 8 slots (all four
     tokens and the single-mask variant), the decoder, the matcher
     (MatcherConfig(), threshold 0) at 480x640 against a 256 crop and
     DINOv2 at 196; each call's launches (DINOv2: 12 of kernel 3 through
     its 12 `pope::flash_attention` nodes, the others 0), ms and transient
     peak memory eager and exported; the exported matcher within
     EXPORT_PEAK_MARGIN of the eager peak and 2x its time (its convs stay
     outside cuDNN in the program);
 13. pose regressor (run_regressor_phase): a small 'mkpts+vim' step on the
     card against the CPU; RegressorConfig() at B=8 in three modes
     ('mkpts', 'mkpts+imgs' with ConvNeXtV2-large, 'mkpts+vim' with the
     frozen Vim-small and the transformer fusion), 2 warm-up and 10 timed
     steps each (forward, backward, optimizer; peak memory; FLOPs; the
     eval loss falls; no kernel launches); Vim-small's forward and the
     selective scan's share; a DINOv2Poser forward (24 launches of kernel
     3); `cli extract` on 4 of the bench's pairs (28 + 4 + 24 launches a
     pair; seeded weights write none), then `cli train-regressor` (2
     epochs) and `cli test-regressor` over synthetic dumps of known poses.
The last three lines are the `kernels` JSON line (each kernel's launches on
the main path, per eval batch, on the serving path, on the records path, on
the training path, per exported program and on the regressor's paths, its
times and bound, and the same at the square grid for kernels 1 and 2, at
the crop grid for kernel 2 and at N = 1025 for kernel 3), the nvidia-smi line
and {"ok": true, "device": {...}}. A copy of the results, the full profiles
included, goes to build/chip_smoke.json (gitignored).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
EX2_PER_SM_CLOCK = 16  # Hopper's special-function units: 16 ex2 results a clock per SM
# kernel vs plain in bf16, scaled to the output: the outputs are softmax
# averages of v ~ N(0, 1) over N keys, so their size falls with N (rms about
# 0.15 at N = 196, 0.04 at N = 3072). The largest error may be a few bf16 ulps
# of the largest output (the windowed body rounds its softmax weights before
# normalising, the plain version after); the rms error is rounding noise, well
# under 1% of the rms output. A kernel that dropped one 64-key tile of 3072
# would miss both by several times.
TOL_MAX_REL = 2.5e-2  # max |out - ref| / max |ref|
TOL_RMS_REL = 1e-2  # rms(out - ref) / rms(ref)
TOL_F32 = 1e-3  # small SAM / DINOv2 on the card vs on the CPU, f32, outputs O(1)
# small matcher, card vs CPU, f32: the dual-softmax confidences (in [0, 1]);
# the match sets, of which a near-tie may flip a slot; the refined image-1
# coordinates of the slots both sides keep (coarse pixel + 4 x a softmax
# expectation, so 1e-3 px is 2.5e-4 of the expectation)
TOL_CONF = 1e-4
MIN_SAME_MATCHES = 0.99
TOL_MKPTS_PX = 1e-3
# solver, card vs CPU on the same correspondences and noise: R and t entries
# (1e-3 is about 0.06 degrees), and at most this many inlier flags may
# differ (points on the threshold)
TOL_POSE = 1e-3
MAX_INLIER_FLIPS = 2
# solver on synthetic pairs with known poses (1 px noise, 30% outliers): the
# JAX package's own solver test holds 300 points at 0.5 px noise to R < 3 and
# t < 8 degrees; at twice that noise the limits are widened, since the noise
# draw alone moves a pair's error by a few degrees
MAX_R_ERR_DEG, MAX_T_ERR_DEG = 5.0, 15.0
LINEMOD_K = ((572.4114, 0.0, 325.2611), (0.0, 573.57043, 242.04899), (0.0, 0.0, 1.0))

SAM_H_HEADS, SAM_H_HEAD_DIM, SAM_WINDOW = 16, 80, 14  # SAM ViT-H's attention
SHORT_SOURCE = "pope_tpu_torch/csrc/attention_short.cu"
LONG_SOURCE = "pope_tpu_torch/csrc/attention_long.cu"
DEV = "cuda"  # where the stage-2 phases and the main path run
PROFILER_OWN_EVENTS = ("Buffer Flush", "Activity Buffer Request")  # the tracer's, not the program's
# cuda_ms holds the card this many clocks (about 10 ms) before its start event,
# so that the host has issued every timed call before the first one runs
HOST_LEAD_CYCLES = 20_000_000


def ex2_per_s() -> float:
    """The card's peak ex2 rate: EX2_PER_SM_CLOCK a clock on each SM at the
    highest SM clock nvidia-smi reports (clocks.max.sm; 1980 MHz on an H100
    SXM, which makes 4.18e12/s over its 132 SMs)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    return EX2_PER_SM_CLOCK * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls. The card
    sleeps HOST_LEAD_CYCLES before the start event, so the calls run back to
    back on the card whatever the host's time per call: a wrapper's Python
    takes 0.04-0.12 ms, as long as a short-kernel launch
    (tools/launch_overhead.py)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, out, ref):
    """Kernel output against its plain version, scaled to the output."""
    ref = ref.float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    rms_err = diff.square().mean().sqrt().item()
    ref_max, ref_rms = ref.abs().max().item(), ref.square().mean().sqrt().item()
    if not (err <= TOL_MAX_REL * ref_max and rms_err <= TOL_RMS_REL * ref_rms):
        raise AssertionError(
            f"{name}: kernel vs plain max abs err {err} (limit {TOL_MAX_REL} x {ref_max}), "
            f"rms err {rms_err} (limit {TOL_RMS_REL} x {ref_rms})"
        )
    return {"max_abs_err": err, "rms_err": rms_err, "ref_max_abs": ref_max, "ref_rms": ref_rms}


def kernel_phase(name, replaces, source, kernel, plain, library, args, reps, nbytes, flops, exps,
                 ex2_rate, previous=None):
    """Hold `kernel` (the design the main path takes at this shape) against
    its plain version and time it beside the plain version, one library call,
    the card's bound and the floor of its `exps` exponentials on the
    special-function units at `ex2_rate` a second (computed, not measured: it
    stays out of the `kernels` line). `previous`, the streaming design at
    the same shape, is held to the same limits and timed in turns with the
    kernel (previous, kernel, kernel, previous)."""
    ref = plain(*args)
    errs = check_close(name, kernel(*args), ref)
    if previous is not None:
        errs["previous"] = check_close(f"{name} (previous design)", previous(*args), ref)
    torch.cuda.synchronize()
    del ref
    if previous is None:
        turns = [cuda_ms(lambda: kernel(*args), reps)]
        ms, previous_ms = turns[0], None
    else:
        turns = [cuda_ms(lambda: fn(*args), reps) for fn in (previous, kernel, kernel, previous)]
        ms, previous_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    plain_ms = cuda_ms(lambda: plain(*args), max(2, reps // 5), warmup=1)
    library_ms = cuda_ms(library, reps)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, **errs,
        "tol": {"max_rel": TOL_MAX_REL, "rms_rel": TOL_RMS_REL},
        "ms": ms, "kernel_ms": ms, "previous_ms": previous_ms, "turns_ms": turns, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "exp_floor_ms": exps / ex2_rate * 1e3, "ex2_per_s": ex2_rate,
        "library_ms": library_ms, "bytes": nbytes, "flops": flops, "exps": exps, "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
    }
    print(json.dumps({"kernel_phase": row}), flush=True)
    return row


def run_kernel_phases():
    from pope_tpu_torch.ops.cuda_kernels import launch_attention, launch_attention_relpos, long_layout
    from pope_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
        flash_attention_relpos,
        flash_attention_relpos_plain,
    )
    from pope_tpu_torch.ops.window_attention import (
        _split_qkv,
        windowed_attention_relpos,
        windowed_attention_relpos_plain,
    )

    F = torch.nn.functional
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    ex2_rate = ex2_per_s()
    rows = {}

    def windowed_stream(qkv, rel_h, rel_w, nh, d, hk, wk):
        return launch_attention_relpos(*_split_qkv(qkv, nh, d), rel_h, rel_w, hk, wk, "stream")

    def windowed_row(key, BW, previous):
        """Kernel 1 on BW windows of 14x14, 16 heads, d = 80."""
        nh, d, ws, N = SAM_H_HEADS, SAM_H_HEAD_DIM, SAM_WINDOW, SAM_WINDOW ** 2
        C = nh * d
        qkv = torch.randn(BW, N, 3 * C, device=dev, generator=g).to(bf16)
        rel_h = (0.5 * torch.randn(BW, nh, N, ws, device=dev, generator=g)).to(bf16)
        rel_w = (0.5 * torch.randn(BW, nh, N, ws, device=dev, generator=g)).to(bf16)
        q, k, v = (t.transpose(1, 2) for t in qkv.view(BW, N, 3, nh, d).unbind(2))
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(BW, nh, N, N)
        rows[key] = kernel_phase(
            "windowed_attention_relpos", "pope_tpu/ops/window_attention.py:80", SHORT_SOURCE,
            windowed_attention_relpos, windowed_attention_relpos_plain,
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            (qkv, rel_h, rel_w, nh, d, ws, ws), reps=20,
            nbytes=2 * (qkv.numel() + rel_h.numel() + rel_w.numel() + BW * N * C),
            flops=4.0 * BW * nh * N * N * d, exps=BW * nh * N * N, ex2_rate=ex2_rate,
            previous=previous,
        )

    def global_row(key, B, H, W, reps, previous):
        """Kernel 2 on B frames of an H x W token grid, 16 heads, d = 80."""
        nh, d, N = SAM_H_HEADS, SAM_H_HEAD_DIM, H * W
        C = nh * d
        qkv = torch.randn(B, N, 3, nh, d, device=dev, generator=g).to(bf16)
        qn, kn, vn = qkv.unbind(2)
        rel_h = (0.5 * torch.randn(B, nh, N, H, device=dev, generator=g)).to(bf16)
        rel_w = (0.5 * torch.randn(B, nh, N, W, device=dev, generator=g)).to(bf16)
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, nh, N, N)
        q, k, v = (t.transpose(1, 2) for t in (qn, kn, vn))
        rows[key] = kernel_phase(
            "flash_attention_relpos", "pope_tpu/ops/flash_attention.py:140", LONG_SOURCE,
            flash_attention_relpos, flash_attention_relpos_plain,
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            (qn, kn, vn, rel_h, rel_w, H, W), reps=reps,
            nbytes=2 * (qkv.numel() + rel_h.numel() + rel_w.numel() + B * N * C),
            flops=4.0 * B * nh * N * N * d, exps=B * nh * N * N, ex2_rate=ex2_rate,
            previous=previous,
        )
        rows[key]["long_layout"] = long_layout(d, H, W)  # the launcher's Q and K/V stages

    # kernel 1: 28 windowed layers; 4 frames x 20 windows of 14x14 (the rect
    # 48x64 grid pads to 56x70)
    windowed_row("windowed_attention_relpos", 80, windowed_stream)
    # kernel 2: 4 global layers; 4 frames x 48x64 tokens
    global_row("flash_attention_relpos", 4, 48, 64, 10, lambda *a: launch_attention_relpos(*a, "stream"))
    # the serving path's square frame (SamPredictor.set_image): one frame of
    # 64x64 tokens; kernel 1 on its 25 windows (the grid pads to 70x70)
    windowed_row("windowed_attention_relpos_square", 25, None)
    global_row("flash_attention_relpos_square", 1, 64, 64, 20, None)
    # the multi-crop sweep's crops of a 640x480 frame (generate_records with
    # crop_n_layers=1): each 321-322 x 401-402 px, resized to about 820x1024,
    # padded to a 52x64 token grid
    global_row("flash_attention_relpos_crop", 1, 52, 64, 20, None)
    print(json.dumps({"long_layout": {key: rows[key]["long_layout"] for key in
                                      ("flash_attention_relpos", "flash_attention_relpos_square",
                                       "flash_attention_relpos_crop")}}), flush=True)

    # kernel 3: DINOv2 ViT-S/14's 12 blocks in the retrieval forward; 4 pairs
    # x (64 candidate crops + the prompt), 14x14 patches + cls, 6 heads, d=64
    B, N, nh, d = 4 * 65, 197, 6, 64
    C = nh * d
    qkv = torch.randn(B, N, 3, nh, d, device=dev, generator=g).to(bf16)
    qn, kn, vn = qkv.unbind(2)
    q, k, v = (t.transpose(1, 2) for t in (qn, kn, vn))
    rows["flash_attention"] = kernel_phase(
        "flash_attention", "pope_tpu/ops/flash_attention.py:114", SHORT_SOURCE,
        flash_attention, flash_attention_plain,
        lambda: F.scaled_dot_product_attention(q, k, v),
        (qn, kn, vn), reps=20,
        nbytes=2 * (qkv.numel() + B * N * C),
        flops=4.0 * B * nh * N * N * d, exps=B * nh * N * N, ex2_rate=ex2_rate,
        previous=lambda q, k, v: launch_attention(q, k, v, "stream"),
    )
    # kernel 3 through the long bias-free design: demo-dinov2's 448x448 input,
    # a 32x32 patch grid + cls (N = 1025, a masked key tail), one image; the
    # streaming design timed beside it
    B, N = 1, 1025
    qkv = torch.randn(B, N, 3, nh, d, device=dev, generator=g).to(bf16)
    qn, kn, vn = qkv.unbind(2)
    q, k, v = (t.transpose(1, 2) for t in (qn, kn, vn))
    rows["flash_attention_n1025"] = kernel_phase(
        "flash_attention", "pope_tpu/ops/flash_attention.py:114", LONG_SOURCE,
        flash_attention, flash_attention_plain,
        lambda: F.scaled_dot_product_attention(q, k, v),
        (qn, kn, vn), reps=20,
        nbytes=2 * (qkv.numel() + B * N * C),
        flops=4.0 * B * nh * N * N * d, exps=B * nh * N * N, ex2_rate=ex2_rate,
        previous=lambda q, k, v: launch_attention(q, k, v, "stream"),
    )
    del qkv, q, k, v
    torch.cuda.empty_cache()
    return rows


PTXAS_KERNELS = {  # the hand-written Hopper kernels' instantiations, by mangled name
    "attn_short_kernel": (re.compile(r"attn_short_kernelILi(\d+)ELb([01])ELb([01])E"), 12),
    "attn_long_kernel": (re.compile(r"attn_long_kernelILi(\d+)ELi(\d)E"), 9),
}


def ptxas_rows(log: str) -> list:
    """ptxas's registers, shared memory and spills for each instantiation of
    the short kernel (attn_short_kernel<D, HAS_BIAS, WIDE>) and the long one
    (attn_long_kernel<D, BIAS>), from nvcc's -v log."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            for kernel, (pattern, _) in PTXAS_KERNELS.items():
                t = pattern.search(m.group(1))
                if t:
                    cur = {"kernel": f"{kernel}<{', '.join(t.groups())}>"}
                    rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def check_ptxas(rows: list) -> None:
    """Every instantiation of the two Hopper kernels built, none spilled."""
    for kernel, (_, count) in PTXAS_KERNELS.items():
        mine = [r for r in rows if r["kernel"].startswith(kernel + "<")]
        if len(mine) != count or any(r.get("spill_stores", 1) or r.get("spill_loads", 1) for r in mine):
            raise AssertionError(f"{kernel}: its {count} instantiations must build without spills: {mine}")


def run_reference_phase():
    """A small f32 SAM at ViT-H width on the card against the same module on
    the CPU (plain versions of the kernels)."""
    from pope_tpu_torch.config import SamConfig, SamEncoderConfig
    from pope_tpu_torch.models.sam import Sam
    from pope_tpu_torch.pipeline.api import init_sam_weights

    cfg = SamConfig(
        encoder=SamEncoderConfig(
            img_size=256, depth=2, global_attn_indexes=(1,), dtype="float32", gelu="erf",
        ),
        image_embedding_size=16, decoder_dtype="float32",
    )
    cpu = Sam(cfg)
    init_sam_weights(cpu, torch.Generator().manual_seed(1))
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(-2, 2, (2, 192, 256, 3)).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(0, 256, (16, 2, 2)).astype(np.float32))
    labels = torch.tensor([[1, -1]]).expand(16, 2)
    errs = {}
    with torch.no_grad():
        emb_c, emb_g = cpu.encode_image(x), gpu.encode_image(x.cuda())
        errs["embedding"] = (emb_g.cpu() - emb_c).abs().max().item()
        for sub in (1, 4):
            m_c, i_c = cpu.decode(emb_c[:1], pts, labels, subsample=sub)
            m_g, i_g = gpu.decode(emb_c[:1].cuda(), pts.cuda(), labels.cuda(), subsample=sub)
            errs[f"masks_sub{sub}"] = (m_g.cpu() - m_c).abs().max().item()
            errs[f"iou_sub{sub}"] = (i_g.cpu() - i_c).abs().max().item()
    print(json.dumps({"reference_phase": {"max_abs_err": errs, "tol": TOL_F32}}), flush=True)
    bad = {k: e for k, e in errs.items() if not e < TOL_F32}
    if bad:
        raise AssertionError(f"card vs CPU disagree beyond {TOL_F32}: {bad}")
    return errs


def run_stage2_reference_phase():
    """A small f32 DINOv2 (ViT-S width, 2 blocks), a small f32 matcher (full
    widths, 2 coarse layers, threshold lowered so that there are matches to
    compare) and the solver on the card against the same modules on the CPU
    (plain versions of the kernels)."""
    from pope_tpu_torch.config import CoarseMatchConfig, DinoV2Config, LoFTRStageConfig, MatcherConfig
    from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
    from pope_tpu_torch.models.matcher import Matcher
    from pope_tpu_torch.pipeline.api import init_dinov2_weights, init_matcher_weights
    from pope_tpu_torch.solver import draw_gumbel, estimate_pose_ransac

    errs, bad = {}, []
    rng = np.random.default_rng(4)
    cpu = DinoVisionTransformer(DinoV2Config(depth=2)).eval()
    init_dinov2_weights(cpu, torch.Generator().manual_seed(5))
    gpu = copy.deepcopy(cpu).to(DEV)
    x = torch.from_numpy(rng.normal(0, 1, (3, 196, 196, 3)).astype(np.float32))
    with torch.no_grad():
        ref, out = cpu(x), gpu(x.to(DEV))
    for key in ref:
        errs[f"dinov2_{key}"] = (out[key].cpu() - ref[key]).abs().max().item()
    bad += [k for k in errs if not errs[k] < TOL_F32]

    cfg = MatcherConfig(
        coarse=LoFTRStageConfig(layer_names=("self", "cross")),
        match_coarse=CoarseMatchConfig(thr=0.0, border_rm=0),
    )
    cpu_m = Matcher(cfg).eval()
    init_matcher_weights(cpu_m, torch.Generator().manual_seed(6))
    gpu_m = copy.deepcopy(cpu_m).to(DEV)
    img0 = torch.from_numpy(rng.uniform(0, 1, (1, 120, 160, 1)).astype(np.float32))
    img1 = torch.cat([img0[:, y:y + 64, x:x + 64] for y, x in ((8, 16), (40, 64), (24, 88))]).contiguous()
    with torch.no_grad():
        ref = cpu_m(img0, img1, return_aux=True)
        out = gpu_m(img0.to(DEV), img1.to(DEV), return_aux=True)
    out = type(out)(*(None if t is None else t.cpu() for t in out))
    same = (out.i_ids == ref.i_ids) & (out.j_ids == ref.j_ids) & (out.valid == ref.valid)
    both = same & ref.valid
    errs["matcher_conf"] = (out.conf_matrix - ref.conf_matrix).abs().max().item()
    errs["matcher_same_slots"] = same.float().mean().item()
    errs["matcher_valid"] = int(ref.valid.sum())
    errs["matcher_mkpts1_px"] = (out.mkpts1 - ref.mkpts1)[both].abs().max().item() if both.any() else 0.0
    if not (errs["matcher_conf"] < TOL_CONF and errs["matcher_same_slots"] >= MIN_SAME_MATCHES
            and errs["matcher_mkpts1_px"] < TOL_MKPTS_PX and errs["matcher_valid"] > 0):
        bad.append("matcher")

    pairs = [synth_pair(np.random.default_rng(s), n=512) for s in (7, 8)]
    p0, p1, K = (torch.from_numpy(np.stack([p[i] for p in pairs])) for i in range(3))
    valid = torch.ones(p0.shape[:2], dtype=torch.bool)
    noise = draw_gumbel((2, 3, 2048, 512), torch.Generator().manual_seed(9))
    ref = estimate_pose_ransac(p0, p1, K, K, valid, noise)
    out = estimate_pose_ransac(p0.to(DEV), p1.to(DEV), K.to(DEV), K.to(DEV), valid.to(DEV), noise.to(DEV))
    errs["solver_ok"] = [bool(a) and bool(b) for a, b in zip(ref.ok, out.ok.cpu())]
    errs["solver_R"] = (out.R.cpu() - ref.R).abs().max().item()
    errs["solver_t"] = (out.t.cpu() - ref.t).abs().max().item()
    errs["solver_inlier_flips"] = int((out.inliers.cpu() != ref.inliers).sum())
    if not (all(errs["solver_ok"]) and errs["solver_R"] < TOL_POSE and errs["solver_t"] < TOL_POSE
            and errs["solver_inlier_flips"] <= MAX_INLIER_FLIPS):
        bad.append("solver")

    print(json.dumps({"stage2_reference_phase": {"errors": errs, "tol": {
        "f32": TOL_F32, "conf": TOL_CONF, "same_slots": MIN_SAME_MATCHES, "mkpts_px": TOL_MKPTS_PX,
        "pose": TOL_POSE, "inlier_flips": MAX_INLIER_FLIPS}}}), flush=True)
    if bad:
        raise AssertionError(f"stage 2, card vs CPU disagree: {bad}: {errs}")
    return errs


def synth_pair(rng, n=1024, noise_px=1.0, outlier_frac=0.3, f=500.0, max_angle_deg=40.0):
    """tests/test_solver.py's synthetic pair: n points in front of both
    cameras under a known (R, t), pixel noise, a fraction of outliers.
    Returns f32 (pix0, pix1, K) and f64 (R, t)."""
    axis = rng.normal(0, 1, 3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(5.0, max_angle_deg))
    W = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * W + (1 - np.cos(angle)) * W @ W  # Rodrigues
    t = rng.normal(0, 1, 3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 5.0])
    K = np.array([[f, 0, 320], [0, f, 240], [0, 0, 1]], np.float64)

    def proj(Xc):
        p = Xc @ K.T
        return p[:, :2] / p[:, 2:3]

    pix0, pix1 = proj(X), proj(X @ R.T + t)
    pix0 += rng.normal(0, noise_px, pix0.shape)
    pix1 += rng.normal(0, noise_px, pix1.shape)
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        pix1[idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return pix0.astype(np.float32), pix1.astype(np.float32), K.astype(np.float32), R, t


def run_solver_phase():
    """Four synthetic pairs (1024 correspondences, 1 px noise, 30% outliers)
    in one batched RANSAC call on the card, noise from a seeded generator on
    the card; each rotation within MAX_R_ERR_DEG of the truth."""
    from pope_tpu_torch.geometry import rotation_angle_deg, translation_angle_deg
    from pope_tpu_torch.solver import estimate_pose_ransac

    pairs = [synth_pair(np.random.default_rng(s)) for s in range(10, 14)]
    p0, p1, K = (torch.from_numpy(np.stack([p[i] for p in pairs])).to(DEV) for i in range(3))
    R_gt, t_gt = (torch.from_numpy(np.stack([p[i] for p in pairs])).float().to(DEV) for i in (3, 4))
    valid = torch.ones(p0.shape[:2], dtype=torch.bool, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = estimate_pose_ransac(p0, p1, K, K, valid, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    r_err = rotation_angle_deg(res.R, R_gt).tolist()
    t_err = translation_angle_deg(res.t, t_gt).tolist()
    row = {"pairs": list(p0.shape[:2]), "ok": res.ok.tolist(), "R_err_deg": r_err, "t_err_deg": t_err,
           "n_inliers": res.n_inliers.tolist(), "ms": ms,
           "limits_deg": {"R": MAX_R_ERR_DEG, "t": MAX_T_ERR_DEG}}
    print(json.dumps({"solver_phase": row}), flush=True)
    if not (all(row["ok"]) and max(r_err) < MAX_R_ERR_DEG and max(t_err) < MAX_T_ERR_DEG):
        raise AssertionError(f"solver on synthetic pairs: {row}")
    return row


def frames(seed: int, n: int = 4, h: int = 480, w: int = 640) -> np.ndarray:
    """Structured uint8 frames: a gradient, coloured boxes and mild noise."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        img = np.zeros((h, w, 3), np.float32)
        img[..., 0] = np.linspace(30, 200, w)[None, :]
        img[..., 1] = np.linspace(180, 40, h)[:, None]
        img[..., 2] = 90
        for _ in range(6):
            y0, x0 = rng.integers(0, h - 80), rng.integers(0, w - 80)
            img[y0 : y0 + rng.integers(40, 200), x0 : x0 + rng.integers(40, 260)] = rng.integers(0, 255, 3)
        img += rng.normal(0, 4, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


SCANNET_K = ((577.87, 0.0, 319.5), (0.0, 577.87, 239.5), (0.0, 0.0, 1.0))  # ScanNet's 640x480 depth camera


def texture(rng, h: int, w: int, n_blobs: int = 60) -> np.ndarray:
    """A smooth random grayscale texture in [0, 1]: a sum of Gaussian blobs
    (something for the matcher to match)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    scale = max(h, w) / 160
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sd, a = rng.uniform(3, 12) * scale, rng.uniform(-1, 1)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sd * sd))
    return (img - img.min()) / (img.max() - img.min())


def planar_items(seed: int, n: int, h: int = 480, w: int = 640, shift_px: int = 50) -> list:
    """Training items of known depth and pose, as the JAX tests' SynthScene
    builds them at 64x64: a fronto-parallel plane at depth 2 seen by two
    cameras a pure x-translation apart. Here image 1 is image 0's texture
    moved by the translation's disparity (shift_px), so the GT warps hold
    for the pixels too."""
    rng = np.random.default_rng(seed)
    K = np.array(SCANNET_K, np.float32)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -shift_px * 2.0 / K[0, 0]  # x1 = x0 - f * b / z
    items = []
    for i in range(n):
        tex = texture(rng, h, w + shift_px)
        items.append({
            "image0": tex[None, :, :w].copy(), "image1": tex[None, :, shift_px:].copy(),
            "depth0": np.full((h, w), 2.0, np.float32), "depth1": np.full((h, w), 2.0, np.float32),
            "T_0to1": T, "T_1to0": np.linalg.inv(T).astype(np.float32), "K0": K, "K1": K,
            "pair_name": f"plane{seed}/{i}",
        })
    return items


def write_scannet_scene(root, n_frames: int = 4, shift_px: int = 40, seed: int = 0) -> dict:
    """A ScanNet-layout scene written with cv2 under `root`: scene0000_00/
    color/<i>.jpg (gray frames, PNG-encoded: lossless), depth/<i>.png
    (16-bit, mm), pose/<i>.txt (cam2world), an intrinsics npz and train /
    val npz pair indices. Frame i is a 640x480 window of one wide texture
    moved i * shift_px to the left, seen by a camera i baselines to the right
    of frame 0's over a plane at 2 m, so the poses, depths and pixels agree.
    Returns the CLI's paths."""
    import cv2

    root = Path(root)
    scene = root / "scene0000_00"
    for sub in ("color", "depth", "pose"):
        (scene / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = 480, 640
    tex = (texture(rng, h, w + shift_px * (n_frames - 1)) * 255).astype(np.uint8)
    K = np.array(SCANNET_K)
    baseline = shift_px * 2.0 / K[0, 0]
    for i in range(n_frames):
        ok, png = cv2.imencode(".png", np.ascontiguousarray(tex[:, i * shift_px:i * shift_px + w]))
        (scene / "color" / f"{i}.jpg").write_bytes(png.tobytes())
        cv2.imwrite(str(scene / "depth" / f"{i}.png"), np.full((h, w), 2000, np.uint16))
        pose = np.eye(4)
        pose[0, 3] = i * baseline
        np.savetxt(scene / "pose" / f"{i}.txt", pose)
    np.savez(root / "intrinsics.npz", scene0000_00=K)

    def index(name, pairs):
        np.savez(root / name, name=np.array([[0, 0, a, b] for a, b in pairs]), score=np.full(len(pairs), 0.6))
        return str(root / name)

    pairs = [(a, b) for a in range(n_frames) for b in range(a + 1, n_frames)]
    return {"data_root": str(root), "intrinsic_path": str(root / "intrinsics.npz"),
            "train_npz": index("train.npz", pairs[1:]), "val_npz": index("val.npz", pairs[:2])}


def kernel_category(name: str) -> str:
    """Coarse class of a CUDA kernel, by its name, for the time breakdown."""
    n = name.lower()
    if "attn_relpos" in n:
        return "attention (csrc/attention_relpos.cu)"
    if "attn_short" in n:
        return "attention (csrc/attention_short.cu)"
    if "attn_long" in n:
        return "attention (csrc/attention_long.cu)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "magma")):
        return "gemm"
    if any(s in n for s in ("syevj", "gesvd", "getrf", "getrs", "potrf", "jacobi", "cusolver")):
        return "linalg (cusolver)"
    if "conv" in n or "cudnn" in n:
        return "conv"
    if "layer_norm" in n:
        return "layer_norm"
    if "copy" in n or "catarray" in n:
        return "copy/cast/cat"
    if "reduce" in n or "sort" in n or "scan" in n:
        return "reduce/sort/scan"
    return "other elementwise"


def wall_ms_by_part(parts, fn) -> dict:
    """Run fn() once with each (owner, attribute, label) of `parts` wrapped
    to add its wall ms, fenced by device syncs, to the result under label;
    the whole call is "total". The attributes are restored afterwards."""
    acc = {}

    def timed(label, f):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            torch.cuda.synchronize()
            acc[label] = acc.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    saved = [(owner, attr, vars(owner).get(attr)) for owner, attr, _ in parts]
    for owner, attr, label in parts:
        setattr(owner, attr, timed(label, getattr(owner, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        acc["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, old in saved:
            if old is None:  # a bound method: drop the instance attribute
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
    return acc


def stage_times(amg, imgs) -> dict:
    """Wall ms of each stage of one generate_boxes_batch call: the encoder
    (resize, preprocess, ViT), the decoder (all prompt chunks), the filters
    + NMS + capacity cut (the rest of _generate_impl) and the small-region
    cleanup."""
    from pope_tpu_torch.models.sam import amg as amg_module

    acc = wall_ms_by_part(
        [(amg, "_encode", "encode"), (amg, "_generate_impl", "generate"), (amg.sam, "decode", "decode"),
         (amg_module, "postprocess_small_regions_device", "cleanup")],
        lambda: amg.generate_boxes_batch(imgs),
    )
    return {"encode": acc["encode"], "decode": acc["decode"],
            "filters_nms_cut": acc["generate"] - acc["decode"],
            "cleanup": acc.get("cleanup", 0.0), "total": acc["total"]}


def profile_call(fn, untraced_ms: float) -> dict:
    """Where the time of one fn() goes, by CUDA kernel, kernel class and
    PyTorch op (self device time: the kernels an op launched itself). The
    profiler's own cost inflates the traced wall time, so the idle share is
    taken against the untraced median."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [
        {"kernel": e.key[:100], "device_ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    ]
    by_category = {}
    for e in kernels:
        cat = kernel_category(e.key)
        ms, n = by_category.get(cat, (0.0, 0))
        by_category[cat] = (ms + e.self_device_time_total / 1e3, n + e.count)
    by_category = {c: {"device_ms": ms, "count": n}
                   for c, (ms, n) in sorted(by_category.items(), key=lambda kv: -kv[1][0])}
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0
           and e.key not in PROFILER_OWN_EVENTS]
    top_ops = [
        {"op": e.key, "device_ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]
    ]
    return {"device_busy_ms": busy_ms, "kernel_launches": sum(e.count for e in kernels),
            "idle_share": 1.0 - busy_ms / untraced_ms,
            "by_category": by_category, "top_kernels": top, "top_ops": top_ops}


def counted_run(counters, fn):
    """fn() with every kernel's launch counts (in all and per design) set to 0
    just before it; returns (fn's result, wall ms, the counts read just
    after, the counts per design)."""
    for f in counters.values():
        f.launches = 0
        f.launches_by_design.update(dict.fromkeys(f.launches_by_design, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, ms, {name: f.launches for name, f in counters.items()},
            {name: dict(f.launches_by_design) for name, f in counters.items()})


def designs(short: int = 0, long: int = 0, stream: int = 0) -> dict:
    return {"short": short, "long": long, "stream": stream}


def timed_runs(fn, n: int = 3) -> list:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def stage2_times(run, args) -> dict:
    """Wall ms of each part of one stage-2 call: crop + DINOv2 + top-k
    (retrieve_top_k), the matcher (match_and_score) and the solver
    (estimate_pose_ransac); "other" is the prompt preprocess, the winner's
    selection and the packing."""
    from pope_tpu_torch.pipeline import pose_pipeline as pp

    labels = {"retrieve_top_k": "crop_dinov2_topk", "match_and_score": "matcher",
              "estimate_pose_ransac": "solver"}
    acc = wall_ms_by_part([(pp, name, label) for name, label in labels.items()],
                          lambda: run(*args, packed=True))
    acc["other"] = acc["total"] - sum(acc[label] for label in labels.values())
    return acc


@contextlib.contextmanager
def cudnn_convs():
    """The matcher backbone's convs through F.conv2d, with cuDNN's own
    algorithm choice, for the comparisons of matcher_backbone_ms and
    backbone_train_ms (the port runs them outside cuDNN on the card:
    backbone.native_conv2d)."""
    from pope_tpu_torch.models.matcher import backbone

    native = backbone.native_conv2d
    backbone.native_conv2d = lambda x, w, stride, padding: torch.nn.functional.conv2d(x, w, None, stride, padding)
    try:
        yield
    finally:
        backbone.native_conv2d = native


def matcher_backbone_ms(matcher, prompts) -> dict:
    """Wall ms of the matcher backbone on the gray prompt frames as the port
    runs it (convs outside cuDNN) and with cuDNN's own algorithm choice, one
    call each after a warm-up call."""
    from pope_tpu_torch.pipeline.pose_pipeline import _rgb01_to_gray, _to_rgb01

    gray = _rgb01_to_gray(_to_rgb01(prompts))[..., None]
    out = {}
    with torch.no_grad():
        for name, convs in (("port", contextlib.nullcontext), ("cudnn", cudnn_convs)):
            with convs():
                matcher.backbone(gray)
                out[name] = timed_runs(lambda: matcher.backbone(gray), 1)[0]
    torch.cuda.empty_cache()
    return out


def check_stage2_outputs(small, matches, B: int, M: int) -> None:
    if tuple(small.shape) != (B, 29) or tuple(matches.shape) != (B, M, 6):
        raise AssertionError(f"stage-2 shapes {tuple(small.shape)} {tuple(matches.shape)}")
    ok = small[:, 12] > 0.5
    if not (torch.isfinite(small[ok]).all() and torch.isfinite(small[:, 12:]).all()
            and torch.isfinite(matches).all()):
        raise AssertionError("non-finite stage-2 outputs")


def stage2_summary(small, matches) -> dict:
    return {"ok": (small[:, 12] > 0.5).tolist(), "n_strong": small[:, 26].tolist(),
            "n_matches": matches[..., 5].sum(-1).tolist(), "pre_bbox": small[:, 13:17].tolist(),
            "n_dropped_matches": small[:, 28].tolist()}


def run_main_path(counters):
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator
    from pope_tpu_torch.pipeline import PipelineExecutor, load_models

    t0 = time.perf_counter()
    models = load_models(components=("sam", "dinov2", "matcher"), sam_type="h", seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prompts, targets = frames(4), frames(3)
    B = targets.shape[0]
    K = torch.tensor(LINEMOD_K, device=DEV).expand(B, 3, 3).contiguous()
    amg = models.amg
    enc = models.sam.config.encoder
    n_global = len(enc.global_attn_indexes)
    stage1_counts = {"windowed_attention_relpos": enc.depth - n_global,
                     "flash_attention_relpos": n_global, "flash_attention": 0}
    stage2_counts = {"windowed_attention_relpos": 0, "flash_attention_relpos": 0,
                     "flash_attention": models.config.dinov2.depth}
    # the windowed layers and DINOv2 take the short kernel, the global layers
    # the long one
    stage1_designs = {"windowed_attention_relpos": designs(short=enc.depth - n_global),
                      "flash_attention_relpos": designs(long=n_global), "flash_attention": designs()}
    stage2_designs = {"windowed_attention_relpos": designs(), "flash_attention_relpos": designs(),
                      "flash_attention": designs(short=models.config.dinov2.depth)}

    # stage 1: AMG on the target frames
    torch.cuda.reset_peak_memory_stats()
    (boxes, valid, n_dropped), first_ms, launches1, designs1 = counted_run(
        counters, lambda: amg.generate_boxes_batch(targets))
    if launches1 != stage1_counts or designs1 != stage1_designs:
        raise AssertionError(f"stage 1 launches {launches1} {designs1} != {stage1_counts} {stage1_designs} "
                             "for one encoder forward")
    cap = amg.cfg.mask_capacity
    if (tuple(boxes.shape), tuple(valid.shape), tuple(n_dropped.shape)) != ((B, cap, 4), (B, cap), (B,)):
        raise AssertionError(f"shapes {boxes.shape} {valid.shape} {n_dropped.shape}")
    if not torch.isfinite(boxes).all():
        raise AssertionError("non-finite boxes")
    times = timed_runs(lambda: amg.generate_boxes_batch(targets))
    total = {name: fn.launches for name, fn in counters.items()}
    if total != {k: 4 * v for k, v in stage1_counts.items()}:
        raise AssertionError(f"stage 1 launch counts over 4 runs: {total}")
    peak = torch.cuda.max_memory_allocated()

    # the same weights with the filters open: NMS, the top-64 cut and the
    # small-region cleanup see full candidate sets
    open_cfg = dataclasses.replace(amg.cfg, pred_iou_thresh=float("-inf"), stability_score_thresh=0.0)
    amg_open = AutomaticMaskGenerator(models.sam, open_cfg, device=models.device)
    t0 = time.perf_counter()
    ob, ov, od = amg_open.generate_boxes_batch(targets)
    torch.cuda.synchronize()
    open_ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(ob).all():
        raise AssertionError("non-finite boxes (filters open)")

    stage1 = {
        "model": "sam_vit_h (seeded random weights)", "frames": list(targets.shape),
        "first_ms": first_ms, "ms_per_batch": times,
        "median_ms_per_batch": statistics.median(times), "peak_bytes": peak,
        "launches_per_forward": launches1, "launches_by_design": designs1, "valid": valid.sum(1).tolist(),
        "n_dropped": n_dropped.tolist(), "open_filters": {
            "ms": open_ms, "valid": ov.sum(1).tolist(), "n_dropped": od.tolist(),
        },
        "stages_ms": stage_times(amg, targets),
        "profile": profile_call(lambda: amg.generate_boxes_batch(targets), statistics.median(times)),
    }
    print(json.dumps({"main_path_stage1": stage1}), flush=True)

    # stage 2: retrieve -> match -> solve on the stage-1 boxes, the prompt
    # folded into the retrieval forward, the solver's noise drawn on the card
    run = PipelineExecutor(models).batched()
    gen = torch.Generator(device=DEV)
    prompts_d = torch.from_numpy(prompts).to(DEV)
    targets_d = torch.from_numpy(targets).to(DEV)

    def args(bx=boxes, vd=valid, dr=n_dropped):
        return (prompts_d, targets_d, K, K, bx, vd, None, gen.manual_seed(0), dr)

    M = models.config.matcher.match_coarse.match_capacity
    torch.cuda.reset_peak_memory_stats()
    (small, matches), first2_ms, launches2, designs2 = counted_run(counters, lambda: run(*args(), packed=True))
    if launches2 != stage2_counts or designs2 != stage2_designs:
        raise AssertionError(f"stage 2 launches {launches2} {designs2} != {stage2_counts} {stage2_designs} "
                             "for one call")
    check_stage2_outputs(small, matches, B, M)
    times2 = timed_runs(lambda: run(*args(), packed=True))
    total = {name: fn.launches for name, fn in counters.items()}
    if total != {k: 4 * v for k, v in stage2_counts.items()}:
        raise AssertionError(f"stage 2 launch counts over 4 runs: {total}")
    peak2 = torch.cuda.max_memory_allocated()
    small_open, matches_open = run(*args(ob, ov, od), packed=True)
    check_stage2_outputs(small_open, matches_open, B, M)
    backbone_ms = matcher_backbone_ms(models.matcher, prompts_d)

    stage2 = {
        "models": "dinov2_vits14 bf16 + tanh, matcher MatcherConfig() f32 (seeded random weights)",
        "prompts": list(prompts.shape), "first_ms": first2_ms, "ms_per_batch": times2,
        "median_ms_per_batch": statistics.median(times2), "peak_bytes": peak2,
        "launches_per_call": launches2, "launches_by_design": designs2,
        "outputs": stage2_summary(small, matches),
        "open_filters": {"valid": ov.sum(1).tolist(), **stage2_summary(small_open, matches_open)},
        "stages_ms": stage2_times(run, args()),
        "matcher_backbone_ms": backbone_ms,
        "profile": profile_call(lambda: run(*args(), packed=True), statistics.median(times2)),
    }
    print(json.dumps({"main_path_stage2": stage2}), flush=True)
    row = {"load_s": load_s, "stage1": stage1, "stage2": stage2}
    return row, {**{k: launches1[k] for k in ("windowed_attention_relpos", "flash_attention_relpos")},
                 "flash_attention": launches2["flash_attention"]}, models


SERVE_B, SERVE_CONCURRENT = 4, 8  # the pose service's batch; the requests sent at once
SERVE_CROP = 256  # the service's crop size (cli serve-pose's default)
# predict_batched's row 0 against predict of the same box: the bf16 decoder at
# another prompt batch rounds differently (tests/test_torch_decoder.py's bf16
# limit on O(1) logits), binary masks agree on MIN_MASK_AGREE of the pixels
TOL_BATCH_ROW = 0.06
MIN_MASK_AGREE = 0.99
TOL_DEMO_SCORE = 1e-3  # the demo's score against the predictor's best slot (tests/test_web_demo.py)


class _Pair(NamedTuple):
    """What runner.run_pairs reads of a manifest pair besides its files."""

    pair_name: str
    object_label: str = "serve"
    box3d: str = ""


class _Spec(NamedTuple):
    crop_size: int


def check_masks(name, out, K, hw, low_hw, n=None):
    """A predictor output: (masks, iou, low-res) of the expected shapes, finite."""
    masks, iou, low = out
    lead = (K,) if n is None else (n, K)
    if (masks.shape, iou.shape, low.shape) != (lead + hw, lead, lead + low_hw) or masks.dtype != bool:
        raise AssertionError(f"{name}: shapes {masks.shape} {iou.shape} {low.shape}")
    if not (np.isfinite(iou).all() and np.isfinite(low).all()):
        raise AssertionError(f"{name}: non-finite outputs")


def service_vs_records(results, recs) -> list:
    """(name, field) where a service result and run_pairs's record differ."""
    out = []
    for res, rec in zip(results, recs):
        same = {
            "ok": res["ok"] == rec["ok"], "R": np.array_equal(res["R"], rec["R"], equal_nan=True),
            "t": np.array_equal(res["t"], rec["t"], equal_nan=True), "pre_bbox": res["pre_bbox"].tolist() == rec["pre_bbox"],
            "n_matches": res["mkpts0"].shape[0] == rec["epi_errs"].size,
            **{k: res[k] == rec[k] for k in ("n_strong", "n_dropped_masks", "n_dropped_matches")},
        }
        out += [(res["name"], k) for k, ok in same.items() if not ok]
    return out


def run_serve_phase(counters, models):
    """The serving path at full width on the card, with the main path's models
    (SAM ViT-H in bf16, DINOv2, the matcher; seeded weights):
      - SamPredictor.set_image on a 640x480 frame, encoded on the square 1024
        frame (a 64x64 token grid), the counts set to 0 just before and read
        just after: 28 windowed launches through the short kernel, 4 global
        ones through the long kernel; predict with points and with a box,
        predict_batched of 16 boxes, whose row 0 must be predict's;
      - WebDemo: at a capacity of 2 (a click and the pad point) a click's
        mask and score against the predictor's best multimask slot; ms per
        click at the default capacity of 8, and over HTTP (POST /predict);
      - PoseService at B=4 on 640x480 frames: the launches of one batch (28,
        4 and 12), one full batch's results equal to runner.run_pairs on the
        same frames and names, a single request's latency, 8 concurrent
        requests' p50/p90 latency, requests/s and batch fill, and the
        worker's host ms in dispatch (which waits on the solver's sync) and in
        finish."""
    import threading
    import urllib.request

    from pope_tpu_torch.models.sam.predictor import SamPredictor
    from pope_tpu_torch.pipeline import pose_pipeline as pp
    from pope_tpu_torch.pipeline import runner
    from pope_tpu_torch.serve import PoseService, WebDemo, make_demo_server

    enc = models.sam.config.encoder
    n_global = len(enc.global_attn_indexes)
    grid = enc.img_size // enc.patch_size
    encode_counts = {"windowed_attention_relpos": enc.depth - n_global, "flash_attention_relpos": n_global,
                     "flash_attention": 0}
    encode_designs = {"windowed_attention_relpos": designs(short=enc.depth - n_global),
                      "flash_attention_relpos": designs(long=n_global), "flash_attention": designs()}
    frame = frames(5, n=1)[0]
    hw = frame.shape[:2]
    row = {"frame": list(frame.shape)}

    # the predictor
    predictor = SamPredictor(models.sam, device=models.device)
    predictor.set_image(frame)  # warm: allocator, library handles
    feats, first_ms, launches, by_design = counted_run(counters, lambda: predictor.set_image(frame))
    if launches != encode_counts or by_design != encode_designs:
        raise AssertionError(f"set_image launches {launches} {by_design} != {encode_counts} {encode_designs}")
    if tuple(feats.shape) != (1, grid, grid, models.sam.config.prompt_embed_dim) or not torch.isfinite(feats).all():
        raise AssertionError(f"set_image embedding {tuple(feats.shape)}")
    set_image_ms = timed_runs(lambda: predictor.set_image(frame), 5)
    pt, lbl = np.array([[320.0, 240.0]]), np.array([1])
    box = np.array([200.0, 120.0, 460.0, 380.0])
    out = predictor.predict(point_coords=pt, point_labels=lbl)
    low_hw = (4 * grid, 4 * grid)
    check_masks("predict (points)", out, 3, hw, low_hw)
    check_masks("predict (box)", predictor.predict(box=box, multimask_output=False), 1, hw, low_hw)
    rng = np.random.default_rng(6)
    xy = rng.uniform([0, 0], [480, 320], (16, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(60, 160, (16, 2))], 1)
    batched = predictor.predict_batched(boxes=boxes)
    check_masks("predict_batched", batched, 3, hw, low_hw, n=16)
    one = predictor.predict(box=boxes[0])
    row0 = {"low_res_max_abs": float(np.abs(batched[2][0] - one[2]).max()),
            "iou_max_abs": float(np.abs(batched[1][0] - one[1]).max()),
            "mask_agree": float((batched[0][0] == one[0]).mean())}
    predict_ms = [timed_runs(lambda: predictor.predict(point_coords=pt, point_labels=lbl), 1)[0] for _ in range(10)]
    batched_ms = timed_runs(lambda: predictor.predict_batched(boxes=boxes), 3)
    row["predictor"] = {
        "set_image_first_ms": first_ms, "set_image_ms": set_image_ms, "set_image_median_ms": statistics.median(set_image_ms),
        "launches": launches, "launches_by_design": by_design, "embedding": list(feats.shape),
        "predict_points_median_ms": statistics.median(predict_ms), "predict_batched_16_median_ms": statistics.median(batched_ms),
        "iou_points": out[1].tolist(), "batched_row0_vs_predict": row0,
        "tol": {"low_res": TOL_BATCH_ROW, "mask_agree": MIN_MASK_AGREE},
        "set_image_profile": profile_call(lambda: predictor.set_image(frame), statistics.median(set_image_ms)),
    }
    print(json.dumps({"serve_predictor": row["predictor"]}), flush=True)
    if not (row0["low_res_max_abs"] <= TOL_BATCH_ROW and row0["iou_max_abs"] <= TOL_BATCH_ROW
            and row0["mask_agree"] >= MIN_MASK_AGREE):
        raise AssertionError(f"predict_batched row 0 vs predict: {row0}")

    # the web demo
    masks, iou, _ = out
    best = int(np.argmax(iou))
    demo2 = WebDemo(models.sam, frame, max_points=2, device=models.device)
    mask2, score2 = demo2.predict(pt.tolist(), lbl.tolist())
    demo2.close()
    demo = WebDemo(models.sam, frame, device=models.device)
    clicks = rng.uniform([0, 0], [640, 480], (21, 2))
    demo.predict(clicks[:1].tolist(), [1])  # warm
    click_ms = []
    for c in clicks[1:]:
        t0 = time.perf_counter()
        mask, _ = demo.predict([c.tolist()], [1])
        click_ms.append((time.perf_counter() - t0) * 1e3)
    srv = make_demo_server(demo, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    http_ms = []
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/predict"
        for c in clicks[:11]:
            body = json.dumps({"points": [c.tolist()], "labels": [1]}).encode()
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=60) as resp:
                reply = json.loads(resp.read())
            http_ms.append((time.perf_counter() - t0) * 1e3)
            if "mask_png" not in reply:
                raise AssertionError(f"/predict: {reply}")
    finally:
        srv.shutdown()
        srv.server_close()
    click_profile = profile_call(lambda: demo.predict([clicks[0].tolist()], [1]), statistics.median(click_ms))
    demo.close()
    row["web_demo"] = {
        "capacity2_vs_best_slot": {"mask_agree": float((mask2 == masks[best]).mean()),
                                   "score_abs_err": abs(score2 - float(iou[best]))},
        "tol": {"mask_agree": MIN_MASK_AGREE, "score": TOL_DEMO_SCORE},
        "mask_shape": list(mask.shape), "click_ms": click_ms, "click_median_ms": statistics.median(click_ms),
        "click_profile": click_profile,
        "http_predict_ms": http_ms[1:], "http_predict_median_ms": statistics.median(http_ms[1:]),
    }
    print(json.dumps({"serve_web_demo": row["web_demo"]}), flush=True)
    err = row["web_demo"]["capacity2_vs_best_slot"]
    if not (err["mask_agree"] >= MIN_MASK_AGREE and err["score_abs_err"] <= TOL_DEMO_SCORE and mask.shape == hw):
        raise AssertionError(f"web demo vs the predictor's best slot: {err}")
    del demo2, demo, predictor
    torch.cuda.empty_cache()

    # the pose service
    K = np.asarray(LINEMOD_K, np.float32)
    prompts, targets = frames(7, n=SERVE_CONCURRENT), frames(8, n=SERVE_CONCURRENT)
    svc = PoseService(models, crop_size=SERVE_CROP, batch_size=SERVE_B)
    host_ms = {"dispatch": [], "finish": []}

    def timed(label, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            host_ms[label].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    svc._dispatch, svc._finish = timed("dispatch", svc._dispatch), timed("finish", svc._finish)
    request = lambda i, name: svc.submit(prompts[i], targets[i], K, K, name=name)
    try:
        request(0, "warm").result(timeout=600)
        _, _, batch_launches, batch_designs = counted_run(counters, lambda: request(0, "serve-0").result(timeout=600))
        single_ms = []
        for i in range(3):
            t0 = time.perf_counter()
            request(i, f"single-{i}").result(timeout=600)
            single_ms.append((time.perf_counter() - t0) * 1e3)
        # where a single request's time goes: the parts of the worker's
        # dispatch fenced by device syncs, then one traced request
        parts = [(runner, "upload_frames", "upload"), (models.amg, "generate_boxes_batch", "stage1"),
                 (pp, "retrieve_top_k", "crop_dinov2_topk"), (pp, "match_and_score", "matcher"),
                 (pp, "estimate_pose_ransac", "solver")]
        parts_ms = wall_ms_by_part(parts, lambda: request(1, "parts").result(timeout=600))
        parts_ms["other"] = parts_ms["total"] - sum(parts_ms.get(label, 0.0) for _, _, label in parts)
        pose_profile = profile_call(lambda: request(2, "profiled").result(timeout=600), statistics.median(single_ms))
        # one full batch against run_pairs on the same frames and names
        names = [f"pair-{i}" for i in range(SERVE_B)]
        results = [f.result(timeout=600) for f in [request(i, n) for i, n in enumerate(names)]]
        eye = np.eye(4, dtype=np.float32)
        dev = runner.upload_frames(prompts[:SERVE_B], targets[:SERVE_B], np.stack([K] * SERVE_B),
                                   np.stack([K] * SERVE_B), models.device)
        recs = runner.run_pairs(models, [_Pair(n) for n in names], _Spec(SERVE_CROP),
                                hosts=[(prompts[i], targets[i], K, K, eye, eye) for i in range(SERVE_B)], dev=dev)
        diffs = service_vs_records(results, recs)
        # concurrent requests
        before = svc.stats()
        done = {}
        t0 = time.perf_counter()
        futs = [request(i, f"conc-{i}") for i in range(SERVE_CONCURRENT)]
        for i, f in enumerate(futs):
            f.add_done_callback(lambda _, i=i: done.__setitem__(i, time.perf_counter()))
        conc = [f.result(timeout=600) for f in futs]
        t_end = max(done[i] for i in range(SERVE_CONCURRENT))
        after = svc.stats()
    finally:
        svc.shutdown(drain=False)
    lat = [(done[i] - t0) * 1e3 for i in range(SERVE_CONCURRENT)]
    slots = (after["requests"] + after["padded_slots"]) - (before["requests"] + before["padded_slots"])
    pose_counts = {"windowed_attention_relpos": enc.depth - n_global, "flash_attention_relpos": n_global,
                   "flash_attention": models.config.dinov2.depth}
    pose_designs = {**encode_designs, "flash_attention": designs(short=models.config.dinov2.depth)}
    row["pose_service"] = {
        "batch": SERVE_B, "crop_size": SERVE_CROP, "max_wait_ms": svc.max_wait_s * 1e3,
        "launches_per_batch": batch_launches, "launches_by_design": batch_designs,
        "single_request_ms": single_ms, "single_request_median_ms": statistics.median(single_ms),
        "single_request_parts_ms": parts_ms, "single_request_profile": pose_profile,
        "concurrent": {"requests": SERVE_CONCURRENT, "latency_ms": lat, "p50_ms": float(np.percentile(lat, 50)),
                       "p90_ms": float(np.percentile(lat, 90)), "requests_per_s": SERVE_CONCURRENT / (t_end - t0),
                       "batches": after["batches"] - before["batches"],
                       "batch_fill": (after["requests"] - before["requests"]) / slots},
        "worker_host_ms": {k: {"median": statistics.median(v), "all": v} for k, v in host_ms.items()},
        "stats": after, "vs_run_pairs_diffs": diffs,
        "outputs": [{"ok": r["ok"], "n_matches": int(r["mkpts0"].shape[0]), "pre_bbox": r["pre_bbox"].tolist()}
                    for r in results],
    }
    print(json.dumps({"serve_pose_service": row["pose_service"]}, default=str), flush=True)
    if batch_launches != pose_counts or batch_designs != pose_designs:
        raise AssertionError(f"pose batch launches {batch_launches} {batch_designs} != {pose_counts} {pose_designs}")
    if diffs:
        raise AssertionError(f"pose service vs run_pairs: {diffs}")
    bad = [r["name"] for r in results + conc if r["R"].shape != (3, 3) or r["t"].shape != (3,)
           or r["ok"] and not (np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all())]
    if bad or len(conc) != SERVE_CONCURRENT:
        raise AssertionError(f"pose service: misshapen results, or non-finite R/t where solved: {bad}")
    return row, {"set_image": launches, "pose_batch": batch_launches}


RECORDS_REPS = 5  # timed generate calls
# an image of generate_batch against generate on it alone: the encoder's
# GEMMs round another batch size differently in bf16 (batch invariance is
# not bitwise, ROADMAP Queue 3), which can move a mask edge by one low-res
# cell, 640 / 256 = 2.5 px of a 640x480 frame, and let two candidates of
# near-equal score trade slots; the valid candidates' prompts must agree
TOL_CELL_PX = 2.5
MIN_RECORD_IOU = 0.99  # card vs CPU, the f32 small SAM: one record's full-resolution masks
TOL_RECORD_SCORE = 1e-3  # card vs CPU, f32: predicted IoU and stability of one record


def structure_decoder(sam) -> None:
    """tests/test_torch_common.py::structure_decoder on a port Sam: identity
    upscaling, one-hot hypernetworks, a -0.5 bias, so that a mask logit is
    GELU(one embedding channel) - 0.5, with O(0.3) structure instead of an
    untrained decoder's sign noise around zero."""
    md = sam.mask_decoder
    with torch.no_grad():
        for name in ("up_conv1", "up_conv2"):
            conv = getattr(md, name)
            conv.kernel.zero_()
            for j in range(min(conv.kernel.shape[2], conv.kernel.shape[3])):
                conv.kernel[:, :, j, j] = 1.0
            conv.bias.zero_()
        md.up_conv2.bias.fill_(-0.5)
        md.up_ln.weight.fill_(1.0)
        md.up_ln.bias.zero_()
        for i in range(md.num_mask_tokens):
            lin = getattr(md, f"hyper_{i}").lin2
            lin.weight.zero_()
            lin.bias.zero_()
            lin.bias[(7 * i) % lin.bias.shape[0]] = 1.0


def valid_rows(res) -> np.ndarray:
    """The valid candidates' (point_idx, box) rows of a host result, sorted."""
    rows = np.concatenate([res.point_idx[res.valid, None].astype(np.float64), res.boxes[res.valid]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def batch_vs_alone(out, alone) -> dict:
    """One image of generate_batch against generate on it alone."""
    same_slots = bool(np.array_equal(out.valid, alone.valid) and np.array_equal(out.point_idx, alone.point_idx))
    a, b = valid_rows(out), valid_rows(alone)
    same_prompts = a.shape == b.shape and bool(np.array_equal(a[:, 0], b[:, 0]))
    box_err = float(np.abs(a[:, 1:] - b[:, 1:]).max(initial=0.0)) if same_prompts else None
    return {"same_slots": same_slots, "same_prompts": same_prompts, "box_max_abs_px": box_err,
            "valid": int(out.valid.sum())}


def check_records(name, recs, hw) -> None:
    """Records of one frame: whole, the RLE decoding (native library) to the
    segmentation."""
    from pope_tpu_torch import native

    if not recs:
        raise AssertionError(f"{name}: no records")
    for r in recs:
        seg = r["segmentation"]
        if seg.shape != hw or seg.dtype != bool or r["area"] != int(seg.sum()):
            raise AssertionError(f"{name}: record of shape {seg.shape} {seg.dtype}, area {r['area']}")
        if not np.array_equal(native.rle_decode(r["rle"]), seg):
            raise AssertionError(f"{name}: an RLE does not decode to its segmentation")


def records_card_vs_cpu() -> dict:
    """The reference phase's small SAM (ViT-H width, 2 blocks, f32) with the
    structured decoder through generate_records on the card and on the CPU,
    the same weights and frame, filters open: the same records, boxes within
    one low-res cell, masks by IoU."""
    from pope_tpu_torch.config import AMGConfig, SamConfig, SamEncoderConfig
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator, Sam
    from pope_tpu_torch.pipeline.api import init_sam_weights

    cfg = SamConfig(
        encoder=SamEncoderConfig(img_size=256, depth=2, global_attn_indexes=(1,), dtype="float32", gelu="erf"),
        image_embedding_size=16, decoder_dtype="float32",
    )
    cpu = Sam(cfg)
    init_sam_weights(cpu, torch.Generator().manual_seed(1))
    structure_decoder(cpu)
    gpu = copy.deepcopy(cpu)
    amg_cfg = AMGConfig(pred_iou_thresh=-1e9, stability_score_thresh=0.0)
    frame = frames(11, n=1)[0]
    ref = AutomaticMaskGenerator(cpu, amg_cfg, device="cpu").generate_records(frame)
    out = AutomaticMaskGenerator(gpu, amg_cfg, device=DEV).generate_records(frame)
    check_records("card vs CPU", out, frame.shape[:2])
    row = {"records": len(out), "cpu_records": len(ref), "min_mask_iou": None, "bbox_max_abs_px": None,
           "score_max_abs": None, "same_rle": 0}
    if len(out) == len(ref):
        ious, boxes, scores = [], [], []
        for r, q in zip(out, ref):
            a, b = r["segmentation"], q["segmentation"]
            ious.append(float((a & b).sum() / max((a | b).sum(), 1)))
            boxes.append(float(np.abs(np.subtract(r["bbox"], q["bbox"])).max()))
            scores.append(max(abs(r["predicted_iou"] - q["predicted_iou"]),
                              abs(r["stability_score"] - q["stability_score"])))
            row["same_rle"] += r["rle"] == q["rle"]
            if r["crop_box"] != q["crop_box"] or r["point_coords"] != q["point_coords"]:
                raise AssertionError(f"card vs CPU records: crop box or point {r['crop_box']} {q['crop_box']} "
                                     f"{r['point_coords']} {q['point_coords']}")
        row.update(min_mask_iou=min(ious), bbox_max_abs_px=max(boxes), score_max_abs=max(scores))
    row["tol"] = {"mask_iou": MIN_RECORD_IOU, "bbox_px": TOL_CELL_PX, "score": TOL_RECORD_SCORE}
    return row


def run_records_phase(counters, models):
    """The records path and its tools at full width on the card, with the
    main path's models (SAM ViT-H bf16, DINOv2, the matcher; seeded weights)
    and the AMG filters open; the counts set to 0 just before each step and
    read just after:
      1. generate on a 640x480 frame: 28 short + 4 long launches,
         masks_low_res (64, 192, 256), a valid slot; the median of
         RECORDS_REPS calls split into encode, decode + filters + cut,
         download and host cleanup;
      2. generate_batch of 4 frames, keep_logits False and True: one encoder
         forward; each image's valid candidates as generate gives them alone;
      3. generate_records at crop_n_layers 0 and 1 (1 + 4 encodes, the crops
         on a 52x64 token grid): 28 + 4 and 140 + 20 launches; every RLE
         decodes (native library) to its segmentation; steps 2 and 3 also
         with the structured decoder (a copy of SAM), whose masks are not
         all frame-filling;
      4. run_amg (the structured decoder) over 2 frames in both output
         modes: the PNG folders, the metadata.csv files, the COCO JSON
         decoding back to the PNG masks;
      5. the demo-sam, demo-dinov2 (a 32x32 grid: 12 long bias-free launches
         at N = 1025) and demo-3dbbox (28 + 4 + 24 short) commands into a
         temporary directory, their images' shapes;
      6. the f32 small SAM's records on the card against the CPU."""
    from pope_tpu_torch import cli, native
    from pope_tpu_torch.data.image_io import write_rgb
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator
    from pope_tpu_torch.models.sam import amg as amg_module
    from pope_tpu_torch.pipeline.amg_cli import coco_decode_rle, run_amg

    t0 = time.perf_counter()
    native.library()
    row = {"native_build_s": time.perf_counter() - t0}
    enc = models.sam.config.encoder
    n_global = len(enc.global_attn_indexes)
    n_win, n_dino = enc.depth - n_global, models.config.dinov2.depth
    counts = lambda w=0, g=0, f=0: {"windowed_attention_relpos": w, "flash_attention_relpos": g, "flash_attention": f}
    by_design = lambda w=0, g=0, f=designs(): {"windowed_attention_relpos": designs(short=w),
                                               "flash_attention_relpos": designs(long=g), "flash_attention": f}
    launches = {}

    def counted(name, fn, want, want_designs):
        out, ms, got, got_designs = counted_run(counters, fn)
        launches[name] = got
        if got != want or got_designs != want_designs:
            raise AssertionError(f"{name}: launches {got} {got_designs} != {want} {want_designs}")
        return out, ms

    open_cfg = dataclasses.replace(models.amg.cfg, pred_iou_thresh=-1e9, stability_score_thresh=0.0)
    amg = AutomaticMaskGenerator(models.sam, open_cfg, device=models.device)
    frame = frames(9, n=1)[0]
    hw = frame.shape[:2]

    # 1. generate
    amg.generate(frame)  # warm
    res, first_ms = counted("generate", lambda: amg.generate(frame), counts(n_win, n_global), by_design(n_win, n_global))
    cap = open_cfg.mask_capacity
    if res.masks_low_res.shape != (cap, 192, 256) or not res.valid.any() or not np.isfinite(res.boxes).all():
        raise AssertionError(f"generate: masks {res.masks_low_res.shape}, {int(res.valid.sum())} valid")
    parts = ((amg, "_encode", "encode"), (amg, "_generate_impl", "decode_filters_cut"), (amg.sam, "decode", "decode"),
             (amg_module, "download_result", "download"), (amg_module, "postprocess_small_regions_host", "cleanup"))
    runs = [wall_ms_by_part(parts, lambda: amg.generate(frame)) for _ in range(RECORDS_REPS)]
    row["generate"] = {
        "first_ms": first_ms, "valid": int(res.valid.sum()), "n_dropped": int(res.n_dropped),
        "masks_low_res": list(res.masks_low_res.shape), "ms": [r["total"] for r in runs],
        "median_ms": {k: statistics.median(r[k] for r in runs) for k in runs[0]},
    }
    print(json.dumps({"records_generate": row["generate"]}), flush=True)

    # steps 2 and 3 also run on a copy of SAM with the structured decoder: the
    # seeded decoder's masks fill the frame, and NMS leaves one of them
    sam_structured = copy.deepcopy(models.sam)
    structure_decoder(sam_structured)
    variants = {"seeded": models.sam, "structured": sam_structured}
    row["generate_batch"], row["generate_records"] = {}, {}
    batch = frames(10, n=4)
    for variant, sam in variants.items():
        # 2. generate_batch of 4 frames against each frame alone
        gen = amg if variant == "seeded" else AutomaticMaskGenerator(sam, open_cfg, device=models.device)
        alone = [gen.generate(f) for f in batch]
        for keep in (False, True):
            key = f"{variant}_{'logits' if keep else 'binary'}"
            outs, ms = counted(f"generate_batch_{key}", lambda: gen.generate_batch(batch, keep_logits=keep),
                               counts(n_win, n_global), by_design(n_win, n_global))
            cmp = [batch_vs_alone(o, a) for o, a in zip(outs, alone)]
            row["generate_batch"][key] = {"ms": ms, "vs_alone": cmp}
            if not all(c["same_prompts"] and c["box_max_abs_px"] <= TOL_CELL_PX for c in cmp):
                raise AssertionError(f"generate_batch ({key}) vs generate alone: {cmp}")

        # 3. generate_records, single crop and the multi-crop sweep
        for layers in (0, 1):
            gen = AutomaticMaskGenerator(sam, dataclasses.replace(open_cfg, crop_n_layers=layers),
                                         device=models.device)
            gen.generate_records(frame)  # warm: the sweep's layer generators
            n = 1 if layers == 0 else 5
            name = f"records_crop{layers}" + ("" if variant == "seeded" else "_structured")
            recs, ms = counted(name, lambda: gen.generate_records(frame),
                               counts(n * n_win, n * n_global), by_design(n * n_win, n * n_global))
            check_records(f"generate_records ({variant}, crop_n_layers={layers})", recs, hw)
            row["generate_records"][f"{variant}_crop_n_layers_{layers}"] = {
                "ms": ms, "records": len(recs), "crop_boxes": sorted({tuple(r["crop_box"]) for r in recs})}
    print(json.dumps({"records_batch_and_records": {k: row[k] for k in ("generate_batch", "generate_records")}}),
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 4. the amg tool in both output modes
        (tmp / "in").mkdir()
        for i, f in enumerate(frames(12, n=2)):
            write_rgb(str(tmp / "in" / f"frame{i}.png"), f)
        open_models = dataclasses.replace(
            models, amg=AutomaticMaskGenerator(sam_structured, open_cfg, device=models.device))
        t0 = time.perf_counter()
        done = run_amg(open_models, str(tmp / "in"), str(tmp / "png"))
        png_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_amg(open_models, str(tmp / "in"), str(tmp / "json"), convert_to_rle=True)
        json_s = time.perf_counter() - t0
        import cv2

        masks_per_image = []
        for i in range(len(done)):
            folder = tmp / "png" / f"frame{i}"
            with open(folder / "metadata.csv") as fh:
                n_rows = len(fh.read().splitlines()) - 1
            with open(tmp / "json" / f"frame{i}.json") as fh:
                anns = json.load(fh)
            if not (len(done) == 2 and n_rows == len(anns) > 0):
                raise AssertionError(f"run_amg: {len(done)} images, {n_rows} metadata rows, {len(anns)} annotations")
            for j, ann in enumerate(anns):
                png = cv2.imread(str(folder / f"{j}.png"), cv2.IMREAD_UNCHANGED)
                if png is None or not np.array_equal(native.rle_decode(coco_decode_rle(ann["segmentation"])), png > 0):
                    raise AssertionError(f"run_amg: frame{i} mask {j}: the COCO RLE does not decode to the PNG")
            masks_per_image.append(len(anns))
        row["amg_tool"] = {"png_folder_s": png_s, "coco_json_s": json_s, "masks": masks_per_image}
        del open_models, sam_structured, variants

        # 5. the demos through the CLI
        prompt, target = frames(13, n=2)
        write_rgb(str(tmp / "prompt.png"), prompt)
        write_rgb(str(tmp / "target.png"), target)
        np.savetxt(tmp / "prompt.txt", np.hstack([np.eye(3), [[0.0], [0.0], [0.5]]]))
        np.savetxt(tmp / "target.txt", np.hstack([np.eye(3), [[0.05], [0.0], [0.6]]]))
        demos = {
            "demo_sam": (["demo-sam", "--image", str(tmp / "target.png"), "--out", str(tmp / "sam.png")],
                         counts(n_win, n_global), by_design(n_win, n_global), {"sam.png": (480, 640, 3)}),
            "demo_dinov2": (["demo-dinov2", "--image", str(tmp / "target.png"), "--out", str(tmp / "dino.jpg")],
                            counts(f=n_dino), by_design(f=designs(long=n_dino)), {"dino.jpg": (448, 448, 3)}),
            "demo_3dbbox": (["demo-3dbbox", "--prompt", str(tmp / "prompt.png"), "--target", str(tmp / "target.png"),
                             "--out-query", str(tmp / "query.png"), "--out-bbox", str(tmp / "bbox.png")],
                            counts(n_win, n_global, 2 * n_dino), by_design(n_win, n_global, designs(short=2 * n_dino)),
                            {"query.png": (256, 512, 3), "bbox.png": (480, 640, 3)}),
        }
        row["demos"] = {}
        for name, (argv, want, want_designs, images) in demos.items():
            _, ms = counted(name, lambda: cli.main(argv), want, want_designs)
            shapes = {f: cv2.imread(str(tmp / f)).shape for f in images}
            row["demos"][name] = {"ms_with_load": ms, "images": shapes}
            if shapes != images:
                raise AssertionError(f"{name}: images {shapes} != {images}")
    torch.cuda.empty_cache()

    # 6. card against CPU
    row["card_vs_cpu"] = records_card_vs_cpu()
    row["launches"] = launches
    print(json.dumps({"records_phase": row}, default=str), flush=True)
    err = row["card_vs_cpu"]
    if not (err["records"] == err["cpu_records"] and err["min_mask_iou"] >= MIN_RECORD_IOU
            and err["bbox_max_abs_px"] <= TOL_CELL_PX and err["score_max_abs"] <= TOL_RECORD_SCORE):
        raise AssertionError(f"records, card vs CPU: {err}")
    return row, launches


TRAIN_B = 4  # pairs per training step at full width (cli train-matcher's default batch)
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# card vs CPU, two steps of a small matcher, f32: the losses to rtol 1e-3;
# each parameter's first-step gradient to 2e-2 of its norm (a ReLU input
# within the two devices' rounding of 0 takes another side and moves a
# tensor's gradient by up to 1e-2 of its norm; the CPU tests measured
# pope_tpu against the port); the weights within 4 lr after two Adam steps
# (a near-zero gradient whose sign flips moves a weight by up to 2 lr a
# step); the BatchNorm statistics to rtol 1e-2
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD, TOL_TRAIN_STATS = 1e-3, 2e-2, 1e-2
TRAIN_LR = 6e-3 * TRAIN_B / 64  # TrainMatcherConfig's canonical lr scaled to the batch


def train_batch(items, dev) -> dict:
    from pope_tpu_torch.train.matcher_driver import collate_pairs

    return {k: torch.from_numpy(v).to(dev) for k, v in collate_pairs(items).items()}


def train_card_vs_cpu() -> dict:
    """Two train steps of a small matcher (ResNet-FPN 32/48/64, coarse d 64,
    2 layers, fine d 32, capacity 128) on B=2 planar pairs of 96x128, on the
    card and on the CPU from the same weights and batch."""
    from pope_tpu_torch.config import BackboneConfig, CoarseMatchConfig, LoFTRStageConfig, MatcherConfig
    from pope_tpu_torch.models.matcher import Matcher
    from pope_tpu_torch.pipeline.api import init_matcher_weights
    from pope_tpu_torch.train import trainer
    from pope_tpu_torch.train.optim import OptimConfig

    cfg = MatcherConfig(
        backbone=BackboneConfig(initial_dim=32, block_dims=(32, 48, 64)),
        coarse=LoFTRStageConfig(d_model=64, d_ffn=64, nhead=4, layer_names=("self", "cross")),
        fine=LoFTRStageConfig(d_model=32, d_ffn=32, nhead=4, layer_names=("self", "cross")),
        match_coarse=CoarseMatchConfig(match_capacity=128),
    )
    items = planar_items(11, 2, h=96, w=128, shift_px=16)
    cpu = Matcher(cfg)
    init_matcher_weights(cpu, torch.Generator().manual_seed(12))
    runs = {}
    for dev, model in (("cpu", cpu), (DEV, copy.deepcopy(cpu).to(DEV))):
        state = trainer.init_matcher_train_state(model, OptimConfig(lr=1e-3, warmup_steps=0), grad_clip=0.5)
        batch, grads, losses = train_batch(items, dev), [], []
        apply = trainer.apply_gradients

        def spy(st):
            grads.append({n: p.grad.detach().cpu().clone() for n, p in st.model.named_parameters()})
            apply(st)

        trainer.apply_gradients = spy
        try:
            for _ in range(2):
                losses.append({k: v.item() for k, v in trainer.matcher_train_step(state, batch).items()})
        finally:
            trainer.apply_gradients = apply
        runs[dev] = (losses, grads[0], {k: v.cpu() for k, v in model.state_dict().items()})
    (l_c, g_c, w_c), (l_g, g_g, w_g) = runs["cpu"], runs[DEV]
    errs = {
        "loss_rel": max(abs(a[k] - b[k]) / abs(a[k]) for a, b in zip(l_c, l_g) for k in a),
        "grad_rel_norm": max(((g_g[n] - g).norm() / g.norm()).item() for n, g in g_c.items() if g.norm() > 0),
        "weights_lr": max((w_g[n] - w).abs().max().item() for n, w in w_c.items() if "running_" not in n) / 1e-3,
        "stats_rel": max(((w_g[n] - w).abs() / w.abs().clamp(min=1e-3)).max().item()
                         for n, w in w_c.items() if "running_" in n),
        "losses_cpu": l_c, "losses_card": l_g,
    }
    if not (errs["loss_rel"] < TOL_TRAIN_LOSS and errs["grad_rel_norm"] < TOL_TRAIN_GRAD
            and errs["weights_lr"] <= 4.0 and errs["stats_rel"] < TOL_TRAIN_STATS):
        raise AssertionError(f"train steps, card vs CPU disagree: {errs}")
    return errs


def backbone_train_ms(matcher, images) -> dict:
    """Wall ms of the matcher backbone's forward + backward on the training
    frames, as training runs it (convs outside cuDNN, both ways) and with
    cuDNN's own algorithm choice, one call each after a warm-up call."""
    def step():
        c, f = matcher.backbone(images)
        (c.square().mean() + f.square().mean()).backward()
        matcher.zero_grad(set_to_none=True)

    out = {}
    for name, convs in (("port", contextlib.nullcontext), ("cudnn", cudnn_convs)):
        with convs():
            step()
            out[name] = timed_runs(step, 1)[0]
    torch.cuda.empty_cache()
    return out


def run_train_phase(counters) -> dict:
    """Matcher training on the card: MatcherConfig() in f32 at B=4 on
    480x640 planar pairs (2 warm-up + 10 timed steps on one batch, split
    into supervision + forward, backward, clip + optimizer; peak memory; one
    profiled step; the FLOPs of a step), the backbone's forward + backward
    with and without cuDNN, a small matcher's two steps against the CPU, and
    `cli train-matcher` on a ScanNet-layout scene (2 epochs, then --resume to
    3). The kernels' launch counts are set to 0 before the full-width steps
    and the CLI run and read after: no attention kernel lies on this path."""
    from torch.utils.flop_counter import FlopCounterMode

    from pope_tpu_torch import cli
    from pope_tpu_torch.config import MatcherConfig
    from pope_tpu_torch.models.matcher import Matcher
    from pope_tpu_torch.pipeline.api import init_matcher_weights
    from pope_tpu_torch.train import trainer
    from pope_tpu_torch.train.optim import OptimConfig

    row = {"config": "MatcherConfig() f32", "batch": TRAIN_B, "frame": [480, 640]}
    row["card_vs_cpu"] = train_card_vs_cpu()

    matcher = Matcher(MatcherConfig())
    init_matcher_weights(matcher, torch.Generator().manual_seed(66))
    matcher.to(DEV)
    state = trainer.init_matcher_train_state(matcher, OptimConfig(lr=TRAIN_LR, warmup_steps=0), grad_clip=0.5)
    batch = train_batch(planar_items(21, TRAIN_B), DEV)
    losses, parts = [], []

    def steps():
        for k in range(TRAIN_WARMUP + TRAIN_STEPS):
            box = {}
            acc = wall_ms_by_part([(trainer, "train_loss", "supervision_forward"),
                                   (trainer, "apply_gradients", "clip_optimizer")],
                                  lambda: box.update(trainer.matcher_train_step(state, batch)))
            losses.append({k2: v.item() for k2, v in box.items()})
            if k >= TRAIN_WARMUP:
                parts.append(acc)

    torch.cuda.reset_peak_memory_stats()
    _, row["steps_wall_ms"], launches, _ = counted_run(counters, steps)
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    med = lambda key: statistics.median(p[key] for p in parts)
    row["ms_per_step"] = med("total")
    row["parts_ms"] = {"supervision_forward": med("supervision_forward"), "clip_optimizer": med("clip_optimizer"),
                       "backward": statistics.median(p["total"] - p["supervision_forward"] - p["clip_optimizer"]
                                                     for p in parts)}
    row["losses"] = losses
    first, tenth = losses[0]["loss"], losses[9]["loss"]
    if not (all(np.isfinite(list(m.values())).all() for m in losses) and tenth < first):
        raise AssertionError(f"training losses not finite or not falling: {losses}")
    # the same products through F.conv2d: FlopCounterMode's formula for
    # aten._slow_conv2d_forward takes convolution's arguments and fails
    with cudnn_convs(), FlopCounterMode(display=False) as flops:
        trainer.matcher_train_step(state, batch)
    row["tflop_per_step"] = flops.get_total_flops() / 1e12
    row["tflop_per_s"] = row["tflop_per_step"] / (row["ms_per_step"] / 1e3)
    row["profile"] = profile_call(lambda: trainer.matcher_train_step(state, batch), row["ms_per_step"])
    images = torch.cat([batch["image0"], batch["image1"]])
    row["backbone_fwd_bwd_ms"] = backbone_train_ms(matcher, images)
    del state, matcher, batch, images
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_scannet_scene(Path(tmp) / "scans", n_frames=4, shift_px=40)
        ckpt, hist = str(Path(tmp) / "ckpt"), str(Path(tmp) / "history.json")
        base = ["train-matcher", "--data-source", "scannet", "--data-root", paths["data_root"],
                "--train-npz", paths["train_npz"], "--val-npz", paths["val_npz"],
                "--intrinsic-path", paths["intrinsic_path"], "--batch-size", "2",
                "--n-samples-per-subset", "4", "--ckpt-dir", ckpt, "--history-out", hist]
        cli_runs = {}
        for name, extra in (("epochs_2", ["--epochs", "2"]), ("resume_3", ["--epochs", "3", "--resume"])):
            _, ms, cli_launches, _ = counted_run(counters, lambda: cli.main(base + extra))
            with open(hist) as f:
                history = json.load(f)
            with open(Path(ckpt) / "index.json") as f:
                index = json.load(f)
            cli_runs[name] = {"ms": ms, "launches": cli_launches, "epochs": [h["epoch"] for h in history],
                              "train_loss": [h["train_loss"] for h in history],
                              "auc@10": [h["auc@10"] for h in history], "index": index,
                              "dirs": sorted(os.listdir(ckpt))}
            launches = {k: launches[k] + cli_launches[k] for k in launches}
        row["cli"] = cli_runs
    two, resumed = cli_runs["epochs_2"], cli_runs["resume_3"]
    best = {b["name"] for b in resumed["index"]["best"]}
    if not (two["epochs"] == [0, 1] and resumed["epochs"] == [2] and resumed["index"]["epoch"] == 3
            and 1 <= len(best) <= 5 and best <= set(resumed["dirs"]) and "last" in resumed["dirs"]
            and np.isfinite(two["train_loss"] + resumed["train_loss"]).all()):
        raise AssertionError(f"cli train-matcher: {cli_runs}")
    row["launches"] = launches
    if any(launches.values()):
        raise AssertionError(f"attention kernels launched on the training path: {launches}")
    print(json.dumps({"train_phase": row}, default=str), flush=True)
    return row


EVAL_PAIRS_PER_BATCH, EVAL_BATCHES = 4, 4  # the eval-driver phase's dataset: 16 pairs of 640x480 frames
BENCH_REPS = 3  # pope_tpu_torch.bench windows (of 4 batches) in this script; the bench's default is 5
# a record's fields that must agree exactly between runs of the same pairs
EVAL_DISCRETE = ("object", "identifier", "ok", "pre_bbox", "gt_bbox", "n_strong", "n_dropped_masks",
                 "n_dropped_matches")
# R/t errors of solved pairs in another batching: f32 rounding of other batch
# shapes moves R and t in their last bits (tests/test_torch_eval.py)
TOL_EVAL_DEG = 0.25


def record_diffs(a, b, tol_deg=None) -> list:
    """(pair, field) of two record lists that differ: exactly when tol_deg is
    None, else discrete fields exactly and the R/t errors of solved pairs
    within tol_deg (the match sets' sizes exactly)."""
    if len(a) != len(b):
        return [("count", len(a), len(b))]
    out = []
    for ra, rb in zip(a, b):
        for k in ra:
            if tol_deg is not None and k not in EVAL_DISCRETE:
                continue
            x, y = ra[k], rb[k]
            same = np.array_equal(x, y, equal_nan=True) if isinstance(x, np.ndarray) else x == y
            if not same:
                out.append((ra["identifier"], k))
        if tol_deg is not None:
            if ra["ok"] and rb["ok"] and max(abs(ra["R_err"] - rb["R_err"]), abs(ra["t_err"] - rb["t_err"])) > tol_deg:
                out.append((ra["identifier"], "R_err/t_err"))
            if ra["epi_errs"].shape != rb["epi_errs"].shape:
                out.append((ra["identifier"], "epi_errs"))
    return out


def eval_batch_times(models, paths, spec) -> dict:
    """Wall ms of each part of one eval batch run in series
    (runner.run_pairs, each part fenced by device syncs): decode + upload
    (prepare_batch), stage 1 (generate_boxes_batch), stage 2's crop +
    DINOv2 + top-k, matcher and solver, and the download + records
    (finish_pairs); "other" is the rest (noise draw, selection, packing)."""
    from pope_tpu_torch.pipeline import pose_pipeline as pp
    from pope_tpu_torch.pipeline import runner

    parts = [(runner, "prepare_batch", "decode_upload"), (models.amg, "generate_boxes_batch", "stage1"),
             (pp, "retrieve_top_k", "crop_dinov2_topk"), (pp, "match_and_score", "matcher"),
             (pp, "estimate_pose_ransac", "solver"), (runner, "finish_pairs", "download_records")]
    acc = wall_ms_by_part(parts, lambda: runner.run_pairs(models, paths, spec))
    acc["other"] = acc["total"] - sum(acc.get(label, 0.0) for _, _, label in parts)
    return acc


def run_eval_phase(counters, per_batch_counts):
    """The eval driver at full width on the card: bench.py's configs (SAM
    ViT-H, DINOv2 ViT-S/14 and the matcher in bf16, seeded weights), a
    LINEMOD-layout dataset of EVAL_BATCHES x EVAL_PAIRS_PER_BATCH pairs of
    640x480 PNG frames written by the port's make_dataset, evaluate_dataset
    in batches of 4 with two in flight. Every batch must launch each kernel
    per_batch_counts times; the records must be whole and finite where
    solved; depth 1 and depth 2 must give identical records on the first 2
    batches, and the serial run_pair the same discrete fields (R/t errors
    within TOL_EVAL_DEG). Then pope_tpu_torch.bench at BENCH_REPS windows,
    whose JSON line it prints."""
    from pope_tpu_torch import bench
    from pope_tpu_torch.data.image_io import reader
    from pope_tpu_torch.eval import DATASETS, evaluate_dataset, iter_pairs, load_manifest
    from pope_tpu_torch.pipeline import runner

    B = EVAL_PAIRS_PER_BATCH
    t0 = time.perf_counter()
    models = bench.build_models()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dispatch, finish = runner.dispatch_pairs, runner.finish_pairs
    batches, records = [], []

    def counting_dispatch(*args, **kwargs):
        before = {name: f.launches for name, f in counters.items()}
        out = dispatch(*args, **kwargs)
        batches.append({name: f.launches - before[name] for name, f in counters.items()})
        return out

    def recording_finish(pending):
        recs = finish(pending)
        records.extend(recs)
        return recs

    row = {"reader": reader(), "configs": "bench.py's (bench_config)", "pairs": B * EVAL_BATCHES,
           "batch": B, "load_s": load_s}
    with tempfile.TemporaryDirectory() as tmp:
        data_root, pairs_dir = bench.make_dataset(tmp, n_pairs=B * EVAL_BATCHES)

        def evaluate(depth, max_pairs):
            os.environ["POPE_PIPELINE_DEPTH"] = str(depth)
            records.clear()
            batches.clear()
            tables = evaluate_dataset(models, "linemod", data_root, pairs_dir, batch_size=B,
                                      max_pairs=max_pairs, progress=False)
            return tables, list(records), list(batches)

        runner.dispatch_pairs, runner.finish_pairs = counting_dispatch, recording_finish
        try:
            evaluate(2, B)  # warm: allocator, library handles, first launches
            (tables, recs2, per_batch), ms, launches, _ = counted_run(
                counters, lambda: evaluate(2, B * EVAL_BATCHES))
            _, recs1, _ = evaluate(1, 2 * B)
        finally:
            runner.dispatch_pairs, runner.finish_pairs = dispatch, finish
            os.environ.pop("POPE_PIPELINE_DEPTH", None)
        spec = DATASETS["linemod"]
        paths = list(iter_pairs(data_root, spec, load_manifest(pairs_dir, spec)))[: 2 * B]
        serial = [runner.run_pair(models, p, spec) for p in paths]
        row["batch_ms"] = eval_batch_times(models, paths[:B], spec)
        row["profile"] = profile_call(lambda: runner.run_pairs(models, paths[:B], spec), row["batch_ms"]["total"])

    if len(recs2) != B * EVAL_BATCHES or len({r["identifier"] for r in recs2}) != len(recs2):
        raise AssertionError(f"eval driver: {len(recs2)} records for {B * EVAL_BATCHES} pairs")
    bad = [r["identifier"] for r in recs2 if r["ok"] and not (np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all())]
    if bad:
        raise AssertionError(f"eval driver: non-finite R/t for solved pairs {bad}")
    if per_batch != [per_batch_counts] * EVAL_BATCHES or launches != {
            k: v * EVAL_BATCHES for k, v in per_batch_counts.items()}:
        raise AssertionError(f"eval driver launches per batch {per_batch} (in all {launches}), "
                             f"expected {per_batch_counts} each")
    depth_diffs = record_diffs(recs1, recs2[: 2 * B])
    serial_exact = record_diffs(serial, recs2[: 2 * B])
    serial_diffs = record_diffs(serial, recs2[: 2 * B], TOL_EVAL_DEG)
    row.update({
        "ms": ms, "pairs_per_s": B * EVAL_BATCHES / ms * 1e3, "launches": launches, "launches_per_batch": per_batch,
        "ok": [r["ok"] for r in recs2], "n_strong": [r["n_strong"] for r in recs2],
        "n_matches": [int(r["epi_errs"].size) for r in recs2], "pre_bbox": [r["pre_bbox"] for r in recs2],
        "objects": list(tables), "depth1_vs_depth2_diffs": depth_diffs,
        "serial_vs_batched_exact_diffs": serial_exact, "serial_vs_batched_diffs": serial_diffs,
    })
    print(json.dumps({"eval_phase": row}, default=str), flush=True)
    if depth_diffs or serial_diffs:
        raise AssertionError(f"eval driver: depth 1 vs 2 {depth_diffs}, serial vs batched {serial_diffs}")

    row["bench"] = bench.main(n_reps=BENCH_REPS, models=models)
    if row["bench"]["model_tflops_per_pair"] != 5.553:
        raise AssertionError(f"bench FLOP budget {row['bench']['model_tflops_per_pair']} != bench.py's 5.553")
    del models
    torch.cuda.empty_cache()
    return row


EXPORT_ORIG_HW = (480, 640)  # cli export's default frame
EXPORT_POINTS = 8  # the prompt heads' slots (cli export's --num-points)
EXPORT_REPS = 5  # timed calls of each program, eager and exported
# the exported matcher's transient peak may exceed the eager one's by this
# much: the cuDNN FFT algorithms the backbone avoids take tens of GB
EXPORT_PEAK_MARGIN = lambda eager_bytes: 0.1 * eager_bytes + 256 * 2 ** 20
# an exported program against the eager module on the same inputs: the
# same aten ops, so the same kernels up to a library's other algorithm
TOL_EXPORT_REL = 1e-5


def call_stats(fn, reps: int = EXPORT_REPS) -> dict:
    """fn()'s median wall ms over reps calls after a warm-up, and the
    transient peak of one call above what was allocated before it."""
    fn()
    torch.cuda.synchronize()
    ms = statistics.median(timed_runs(fn, reps))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated() - base}


def export_row(name, blob_fn, module, args, counters, check, path: Path) -> dict:
    """Export `module` (blob_fn writes the .pt2 to `path`), load it with
    load_exported, run both on args: the kernels' launches of one exported
    call, the outputs' agreement (check(out, ref) -> dict, raises), and each
    one's ms and transient peak."""
    from pope_tpu_torch.export import load_exported

    t0 = time.perf_counter()
    blob_fn(str(path))
    export_s = time.perf_counter() - t0
    program = load_exported(str(path)).module()
    with torch.no_grad():
        ref = module(*args)
        out, _, launches, by_design = counted_run(counters, lambda: program(*args))
        row = {"program": name, "bytes": path.stat().st_size, "export_s": export_s, "launches": launches,
               "launches_by_design": by_design, "agreement": check(out, ref),
               "eager": call_stats(lambda: module(*args)), "exported": call_stats(lambda: program(*args))}
    return row


def rel_err(out, ref) -> float:
    outs, refs = (out, ref) if isinstance(out, (tuple, list)) else ((out,), (ref,))
    errs = [((o.float() - r.float()).abs().max() / r.float().abs().max().clamp(min=1e-12)).item()
            for o, r in zip(outs, refs) if o.is_floating_point()]
    return max(errs)


def check_rel(name):
    def check(out, ref):
        err = rel_err(out, ref)
        if not err <= TOL_EXPORT_REL:
            raise AssertionError(f"exported {name}: max |out - eager| / max |eager| = {err}")
        return {"max_rel_err": err, "tol": TOL_EXPORT_REL}
    return check


def check_matcher(out, ref):
    mk0, mk1, mconf, valid = out
    same = (valid == ref[3]).float().mean().item()
    both = valid & ref[3]
    px = max((mk0 - ref[0])[both].abs().max().item() if both.any() else 0.0,
             (mk1 - ref[1])[both].abs().max().item() if both.any() else 0.0)
    conf = (mconf - ref[2])[both].abs().max().item() if both.any() else 0.0
    if same < MIN_SAME_MATCHES or px > TOL_MKPTS_PX or conf > TOL_CONF or not valid.any():
        raise AssertionError(f"exported matcher: valid agree {same}, max px {px}, max conf {conf}")
    return {"valid_agree": same, "max_px": px, "max_conf": conf, "n_valid": int(valid.sum()),
            "tol_px": TOL_MKPTS_PX, "tol_conf": TOL_CONF}


def run_export_phase(counters) -> dict:
    """The four serving programs at full width (seeded weights): the SAM
    ViT-H prompt head at 480x640 with 8 slots (all four tokens, and the
    single-mask variant), the decoder, the matcher (MatcherConfig(), f32) at
    480x640 against a 256 crop and DINOv2 ViT-S/14 at 196, each exported,
    saved under build/export/, loaded with load_exported and run: its
    outputs against the eager module's, the kernels' launches per call
    (DINOv2: 12 of kernel 3), the `pope::` op nodes of DINOv2's graph, ms
    and transient peak eager and exported; the exported matcher's peak
    within EXPORT_PEAK_MARGIN of the eager one's and its time within 2x."""
    from pope_tpu_torch import export
    from pope_tpu_torch.export import MatcherHead, SamDecoderHead, sam_prompt_head
    from pope_tpu_torch.pipeline import load_models

    out_dir = Path(__file__).resolve().parent / "build" / "export"
    out_dir.mkdir(parents=True, exist_ok=True)
    models = load_models(sam_type="h", device=DEV)
    sam, g = models.sam, torch.Generator(device=DEV).manual_seed(3)
    E, C = sam.config.image_embedding_size, sam.config.prompt_embed_dim
    emb = torch.randn(1, E, E, C, device=DEV, generator=g)
    pts = torch.rand(1, EXPORT_POINTS, 2, device=DEV, generator=g) * 1024
    lbl = torch.tensor([[1, 0, 1, 1, -1, -1, -1, -1]], dtype=torch.int32, device=DEV)
    mask = torch.randn(1, 4 * E, 4 * E, 1, device=DEV, generator=g)
    one = torch.ones(1, device=DEV)
    rows = []
    for single in (False, True):
        head = sam_prompt_head(sam, EXPORT_ORIG_HW, EXPORT_POINTS, return_single_mask=single)
        args = (emb, pts, lbl, mask, one) + ((torch.full((1,), 4.0, device=DEV),) if single else ())
        name = "sam_prompt_head_single" if single else "sam_prompt_head"
        rows.append(export_row(name, lambda p, s=single: export.export_sam_prompt_head(
            sam, EXPORT_ORIG_HW, EXPORT_POINTS, return_single_mask=s, path=p), head, args, counters,
            check_rel(name), out_dir / f"{name}.pt2"))
    rows.append(export_row("sam_decoder", lambda p: export.export_sam_decoder(sam, EXPORT_POINTS, path=p),
                           SamDecoderHead(sam), (emb, pts, lbl), counters, check_rel("sam_decoder"),
                           out_dir / "sam_decoder.pt2"))
    imgs = torch.from_numpy(frames(31, 1)).to(DEV).float() / 255.0
    image0 = imgs.mean(-1, keepdim=True)
    image1 = image0[:, 100:356, 200:456].contiguous()
    # threshold 0, so that the seeded matcher fills its capacity and the
    # coordinates are compared (at the shipped 0.2 it keeps none)
    mcfg = models.matcher.config
    models.matcher.config = dataclasses.replace(mcfg, match_coarse=dataclasses.replace(mcfg.match_coarse, thr=0.0))
    rows.append(export_row("matcher", lambda p: export.export_matcher(models.matcher, EXPORT_ORIG_HW, (256, 256),
                                                                      path=p),
                           MatcherHead(models.matcher), (image0, image1), counters, check_matcher,
                           out_dir / "matcher.pt2"))
    crop = torch.randn(1, 196, 196, 3, device=DEV, generator=g)
    dino_path = out_dir / "dinov2.pt2"
    rows.append(export_row("dinov2", lambda p: export.export_dinov2(models.dinov2, 196, path=p),
                           export.Dinov2Head(models.dinov2), (crop,), counters, check_rel("dinov2"), dino_path))
    nodes = [str(n.target) for n in export.load_exported(str(dino_path)).graph.nodes if n.op == "call_function"]
    by_name = {r["program"]: r for r in rows}
    by_name["dinov2"]["pope_op_nodes"] = {t: nodes.count(t) for t in set(nodes) if t.startswith("pope.")}
    depth = models.config.dinov2.depth
    want = {r["program"]: {"windowed_attention_relpos": 0, "flash_attention_relpos": 0,
                           "flash_attention": depth if r["program"] == "dinov2" else 0} for r in rows}
    got = {r["program"]: r["launches"] for r in rows}
    if got != want or by_name["dinov2"]["pope_op_nodes"] != {"pope.flash_attention.default": depth}:
        raise AssertionError(f"exported launches {got} (want {want}), DINOv2 op nodes "
                             f"{by_name['dinov2']['pope_op_nodes']}")
    m = by_name["matcher"]
    margin = EXPORT_PEAK_MARGIN(m["eager"]["peak_bytes"])
    m["peak_margin_bytes"] = margin
    if m["exported"]["peak_bytes"] > m["eager"]["peak_bytes"] + margin or m["exported"]["ms"] > 2 * m["eager"]["ms"]:
        raise AssertionError(f"exported matcher left the cuDNN-free convs: {m}")
    row = {"programs": rows, "dir": str(out_dir)}
    print(json.dumps({"export_phase": row}), flush=True)
    del models
    torch.cuda.empty_cache()
    return row


REG_B = 8  # RegressorConfig().batch_size
REG_WARMUP, REG_STEPS = 2, 10
REG_MODES = (("mkpts", "cross_attn"), ("mkpts+imgs", "cross_attn"), ("mkpts+vim", "transformer"))
REG_CROP = 224  # the regressor's crops (data.py)
# cli extract, per pair: the records-path AMG (one SAM ViT-H forward), the
# prompt's DINOv2 forward and the candidates'
EXTRACT_LAUNCHES_PER_PAIR = {"windowed_attention_relpos": 28, "flash_attention_relpos": 4, "flash_attention": 24}
# card against CPU, a small regressor's step: f32 of the same computation in
# another order, gradients within 2e-4 of each tensor's largest (the matcher
# step's bound, tests/test_torch_train.py); Adam's first step moves a weight
# by at most lr either way
TOL_REG_LOSS_REL, TOL_REG_GRAD_REL = 1e-5, 2e-4


def reg_batch(cfg, B: int, rng, dev) -> dict:
    """mkpts of B pairs (zero-padded past a random count), crops for the image
    branch, relative rotations and translations."""
    import cv2

    n = cfg.num_sample
    mk = rng.uniform(0, 480, (2, B, n, 2)).astype(np.float32)
    for b in range(B):
        mk[:, b, rng.integers(n // 2, n + 1):] = 0.0
    batch = {"mkpts0": mk[0], "mkpts1": mk[1],
             "gt_R": np.stack([cv2.Rodrigues(rng.uniform(-0.5, 0.5, 3))[0] for _ in range(B)]).astype(np.float32),
             "gt_t": rng.normal(0, 1, (B, 3)).astype(np.float32)}
    if cfg.net_mode != "mkpts":
        batch["img0"], batch["img1"] = (rng.uniform(0, 1, (B, REG_CROP, REG_CROP, 3)).astype(np.float32)
                                        for _ in range(2))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def reg_card_vs_cpu() -> dict:
    """A small 'mkpts+vim' regressor (d_model 32, Vim 'test', num_sample 16):
    one train step on the card and on the CPU from the same weights, batch
    and dropout masks (drawn on the CPU)."""
    from pope_tpu_torch.config import RegressorConfig
    from pope_tpu_torch.models.regressor import train
    from pope_tpu_torch.models.regressor.model import MkptsRegModel, dropout_masks

    cfg = RegressorConfig(num_sample=16, d_model=32, nhead=2, net_mode="mkpts+vim", vim_size="test",
                          fusion="transformer", lr=1e-3)
    torch.manual_seed(0)
    cpu = MkptsRegModel(cfg)
    card = copy.deepcopy(cpu).to(DEV)
    batch = reg_batch(cfg, 2, np.random.default_rng(1), "cpu")
    masks = dropout_masks(2, torch.Generator().manual_seed(2))
    got = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, DEV)):
        state = train.create_train_state(model, cfg)
        m = train.train_step(state, {k: v.to(dev) for k, v in batch.items()}, [x.to(dev) for x in masks])
        got[name] = (m["loss"].item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {n: p.detach().cpu() for n, p in model.named_parameters()})
    loss_rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    grad_rel = max(((got["card"][1][n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                   for n, g in got["cpu"][1].items() if g.abs().max() > 1e-6 * max(
                       h.abs().max() for h in got["cpu"][1].values()))
    weight_lr = max((got["card"][2][n] - w).abs().max().item() for n, w in got["cpu"][2].items()) / cfg.lr
    row = {"loss_rel": loss_rel, "grad_rel": grad_rel, "max_weight_diff_lr": weight_lr}
    if not (loss_rel <= TOL_REG_LOSS_REL and grad_rel <= TOL_REG_GRAD_REL and weight_lr <= 2.0 + 1e-3):
        raise AssertionError(f"regressor step, card against CPU: {row}")
    return row


def reg_mode_row(mode: str, fusion: str, counters) -> dict:
    """RegressorConfig() at B = 8 in one mode: 2 warm-up and 10 timed steps on
    one batch (forward, backward, optimizer), peak memory, the FLOPs of a
    step, the eval loss before and after the steps."""
    from torch.utils.flop_counter import FlopCounterMode

    from pope_tpu_torch.config import RegressorConfig
    from pope_tpu_torch.models.regressor import train
    from pope_tpu_torch.models.regressor.model import MkptsRegModel

    cfg = RegressorConfig(net_mode=mode, fusion=fusion)
    torch.manual_seed(0)
    with torch.device(DEV):
        model = MkptsRegModel(cfg)
    state = train.create_train_state(model, cfg)
    batch = reg_batch(cfg, REG_B, np.random.default_rng(5), DEV)
    gen = torch.Generator(device=DEV).manual_seed(1)

    def eval_loss():
        out = train.eval_step(state, batch)
        return train.pose_loss(out["pred_t"], out["pred_R"], batch["gt_t"], batch["gt_R"])[0].item()

    before = eval_loss()
    losses, parts = [], []

    def steps():
        for k in range(REG_WARMUP + REG_STEPS):
            box = {}
            acc = wall_ms_by_part([(train, "_predict", "forward"), (state.optimizer, "step", "optimizer")],
                                  lambda: box.update(train.train_step(state, batch, gen)))
            losses.append(box["loss"].item())
            if k >= REG_WARMUP:
                parts.append(acc)

    torch.cuda.reset_peak_memory_stats()
    _, wall, launches, _ = counted_run(counters, steps)
    med = lambda key: statistics.median(p[key] for p in parts)
    row = {"mode": mode, "fusion": fusion, "rotation": cfg.rotation_mode, "batch": REG_B,
           "num_sample": cfg.num_sample, "image_branch": {"mkpts": None, "mkpts+imgs": "ConvNeXtV2-large",
                                                          "mkpts+vim": "Vim-small (frozen)"}[mode],
           "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "steps_wall_ms": wall,
           "ms_per_step": med("total"),
           "parts_ms": {"forward": med("forward"), "optimizer": med("optimizer"),
                        "backward": statistics.median(p["total"] - p["forward"] - p["optimizer"] for p in parts)},
           "losses": losses, "launches": launches}
    with FlopCounterMode(display=False) as flops:
        train.train_step(state, batch, gen)
    row["tflop_per_step"] = flops.get_total_flops() / 1e12
    row["tflop_per_s"] = row["tflop_per_step"] / (row["ms_per_step"] / 1e3)
    # FlopCounterMode counts a depthwise conv's backward as a dense conv's
    # (ConvNeXtV2's 7x7 depthwise convs: ~200x); a conv's backward is at
    # most twice its forward (the input's and the weights' gradients)
    by_op = {str(k): v for k, v in flops.get_flop_counts().get("Global", {}).items()}
    fixed = flops.get_total_flops() - by_op.get("aten.convolution_backward", 0) + 2 * by_op.get("aten.convolution", 0)
    row["tflop_per_step_conv_bwd_2x"] = fixed / 1e12
    row["tflop_per_s_conv_bwd_2x"] = row["tflop_per_step_conv_bwd_2x"] / (row["ms_per_step"] / 1e3)
    row["eval_loss"] = {"before": before, "after": eval_loss()}
    if not (np.isfinite(losses).all() and row["eval_loss"]["after"] < before) or any(launches.values()):
        raise AssertionError(f"regressor {mode}: losses not finite or not falling, or kernels launched: {row}")
    del state, model, batch
    torch.cuda.empty_cache()
    return row


def vim_scan_share() -> dict:
    """Vim-small's forward (frozen, B = 8 crops of 224) and the selective
    scan's share of it, the scan's calls fenced by syncs."""
    from pope_tpu_torch.models.regressor import vim as vim_module

    with torch.device(DEV):
        vim = vim_module.VisionMamba(vim_module.VimConfig(num_classes=0)).eval()
    x = torch.rand(REG_B, REG_CROP, REG_CROP, 3, device=DEV, generator=torch.Generator(device=DEV).manual_seed(4))
    with torch.no_grad():
        run = lambda: vim(x)
        run()
        ms = statistics.median(timed_runs(run, 5))
        acc = wall_ms_by_part([(vim_module, "selective_scan", "scan")], run)
    row = {"batch": REG_B, "ms": ms, "fenced_ms": acc["total"], "scan_ms": acc["scan"],
           "scan_share": acc["scan"] / acc["total"], "scan_calls": 2 * vim.config.depth}
    del vim
    torch.cuda.empty_cache()
    return row


def run_regressor_phase(counters) -> dict:
    """The pose-regressor extension on the card: a small model's step against
    the CPU; RegressorConfig() at B = 8 in three modes ('mkpts' 6d,
    'mkpts+imgs' with ConvNeXtV2-large and cross-attention, 'mkpts+vim' with
    the frozen Vim-small and the transformer fusion); Vim-small's forward and
    its selective scan's share; a DINOv2Poser forward (kernel 3's launches);
    `cli extract` on the bench's frames (its launches per pair), then `cli
    train-regressor` for 2 epochs and `cli test-regressor` on its checkpoint
    over synthetic dumps of the same dataset's known poses."""
    from pope_tpu_torch import bench, cli
    from pope_tpu_torch.eval.extract import write_dump
    from pope_tpu_torch.eval.manifest import DATASETS, iter_pairs, load_manifest
    from pope_tpu_torch.models.regressor.dinov2_poser import DINOv2Poser

    row = {"card_vs_cpu": reg_card_vs_cpu()}
    row["modes"] = [reg_mode_row(mode, fusion, counters) for mode, fusion in REG_MODES]
    row["vim_small_forward"] = vim_scan_share()

    with torch.device(DEV):
        poser = DINOv2Poser().eval()
    pair = torch.rand(2, 2, REG_CROP, REG_CROP, 3, device=DEV)
    with torch.no_grad():
        poser(pair[0], pair[1])
        (t, q), ms, launches, by_design = counted_run(counters, lambda: poser(pair[0], pair[1]))
    row["dinov2_poser"] = {"batch": 2, "ms": ms, "launches": launches, "launches_by_design": by_design,
                           "t": list(t.shape), "quat": list(q.shape)}
    if launches["flash_attention"] != 2 * poser.dino.config.depth or not torch.isfinite(t).all():
        raise AssertionError(f"DINOv2Poser forward: {row['dinov2_poser']}")
    del poser
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        n_pairs = 16
        data_root, pairs_dir = bench.make_dataset(tmp, n_pairs=n_pairs)
        out = str(Path(tmp) / "dumps")
        args = ["extract", "--dataset", "linemod", "--data-root", data_root, "--pairs-dir", pairs_dir,
                "--out-dir", out, "--max-pairs", "4"]
        _, ms, launches, _ = counted_run(counters, lambda: cli.main(args))
        written = len(list(Path(out).glob("*/mkpts0/*.txt")))
        row["cli_extract"] = {"pairs": 4, "written": written, "ms": ms, "launches": launches,
                              "launches_per_pair": {k: v / 4 for k, v in launches.items()},
                              "note": "seeded weights: 0 matches a pair, so no pair reaches the 5 it needs"}
        if launches != {k: 4 * n for k, n in EXTRACT_LAUNCHES_PER_PAIR.items()}:
            raise AssertionError(f"cli extract launches: {launches}")
        # synthetic dumps of the dataset's pairs: the box3d's cube seen under their known poses
        spec = DATASETS["linemod"]
        rng = np.random.default_rng(6)
        for p in iter_pairs(data_root, spec, load_manifest(pairs_dir, spec)):
            X = rng.uniform(-0.05, 0.05, (200, 3))
            pix = []
            for pose_file, k_file in ((p.pose0, p.k0), (p.pose1, p.k1)):
                pose, K = np.loadtxt(pose_file)[:3], np.loadtxt(k_file)
                cam = X @ pose[:, :3].T + pose[:, 3]
                pix.append((cam / cam[:, 2:]) @ K.T)
            crop = rng.integers(0, 255, (256, 256, 3), np.uint8)
            write_dump(out, p.pair_name, [200.0, 140.0, 440.0, 340.0], pix[0][:, :2], pix[1][:, :2],
                       np.loadtxt(p.k1), crop, crop)
        common = ["--dataset", "linemod", "--data-root", data_root, "--pairs-dir", pairs_dir, "--points-dir", out]
        ckpt = str(Path(tmp) / "ckpt")
        t0 = time.perf_counter()
        cli.main(["train-regressor", *common, "--epochs", "2", "--ckpt-dir", ckpt])
        train_s = time.perf_counter() - t0
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            cli.main(["test-regressor", *common, "--ckpt", str(Path(ckpt) / "step_2")])
        print(text.getvalue(), end="", flush=True)
        metrics = {k: float(v) for k, v in (line.split(": ") for line in text.getvalue().splitlines())}
        row["cli_regressor"] = {"pairs": n_pairs, "train_2_epochs_s": train_s, "checkpoints": sorted(os.listdir(ckpt)),
                                "test_s": time.perf_counter() - t0, "metrics": metrics}
        if (row["cli_regressor"]["checkpoints"] != ["step_1", "step_2"]
                or not np.isfinite(list(metrics.values())).all()):
            raise AssertionError(f"cli train-regressor / test-regressor: {row['cli_regressor']}")
    print(json.dumps({"regressor_phase": row}, default=str), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; it runs on a CUDA card")
    from pope_tpu_torch.bench import card_name
    from pope_tpu_torch.ops import cuda_kernels
    from pope_tpu_torch.ops.flash_attention import flash_attention, flash_attention_relpos
    from pope_tpu_torch.ops.window_attention import windowed_attention_relpos
    from pope_tpu_torch.utils.device import resolve_device

    resolve_device(None)  # full-f32 products and convs, as the port's entry points set
    smi = card_name()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"device": kind, "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    t0 = time.perf_counter()
    _, log = cuda_kernels.build()
    cuda_kernels.library()
    build_s = time.perf_counter() - t0
    ptxas = None
    if log is not None:  # freshly compiled: ptxas's registers and spills per kernel
        print("\n".join(line for line in log.splitlines()
                        if re.search(r"Compiling entry|registers|spill|error|warning", line)), flush=True)
        ptxas = ptxas_rows(log)
        print(json.dumps({"ptxas": ptxas}), flush=True)
        check_ptxas(ptxas)
    print(json.dumps({"build_s": build_s, "cached": log is None}), flush=True)

    kernels = run_kernel_phases()
    reference = run_reference_phase()
    reference2 = run_stage2_reference_phase()
    solver = run_solver_phase()
    counters = {"windowed_attention_relpos": windowed_attention_relpos,
                "flash_attention_relpos": flash_attention_relpos,
                "flash_attention": flash_attention}
    main_path, launches, models = run_main_path(counters)
    serve, serve_launches = run_serve_phase(counters, models)
    records, records_launches = run_records_phase(counters, models)
    del models
    torch.cuda.empty_cache()
    eval_phase = run_eval_phase(counters, launches)
    train = run_train_phase(counters)
    export_phase = run_export_phase(counters)
    regressor = run_regressor_phase(counters)

    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    listed = []
    for name in counters:
        row = kernels[name]
        entry = ({k: row[k] for k in ("name", "route", "source", "replaces")}
                 | {"launches": launches[name],
                    "eval_launches_per_batch": eval_phase["launches_per_batch"][0][name],
                    "serve_launches": {path: n[name] for path, n in serve_launches.items()}}
                 | {k: row[k] for k in timing + ("previous_ms",)})
        entry["records_launches"] = {path: n[name] for path, n in records_launches.items()}
        entry["train_launches"] = train["launches"][name]
        entry["export_launches"] = {r["program"]: r["launches"][name] for r in export_phase["programs"]}
        entry["regressor_launches"] = {
            "extract_per_pair": regressor["cli_extract"]["launches_per_pair"][name],
            "dinov2_poser_forward": regressor["dinov2_poser"]["launches"][name],
            **{f"train_step_{m['mode']}": m["launches"][name] // (REG_WARMUP + REG_STEPS) for m in regressor["modes"]}}
        square = kernels.get(f"{name}_square")
        if square is not None:  # the serving path's square 64x64 grid, B=1
            entry["square_64x64"] = {k: square[k] for k in timing}
        crop = kernels.get(f"{name}_crop")
        if crop is not None:  # the multi-crop sweep's 52x64 grid, B=1
            entry["crop_52x64"] = {k: crop[k] for k in timing} | {
                "source": crop["source"], "launches": records_launches["records_crop1"][name]}
        long_n = kernels.get(f"{name}_n1025")
        if long_n is not None:  # demo-dinov2's 1025 tokens through the long design, B=1
            entry["n1025"] = {k: long_n[k] for k in timing} | {
                "source": long_n["source"], "launches": records_launches["demo_dinov2"][name]}
        listed.append(entry | {"status": "ported"})
    summary = {"kernels": listed, "not_ported": []}

    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "build_s": build_s, "ptxas": ptxas, "kernels": kernels, "reference": reference,
        "stage2_reference": reference2, "solver": solver, "main_path": main_path, "serve": serve,
        "records": records,
        "eval": eval_phase,
        "train": train,
        "export": export_phase,
        "regressor": regressor,
        "summary": summary,
    }, indent=1))

    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
