#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: print the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from pope_tpu_torch/csrc with nvcc (one
     process per source, in parallel), print ptxas's registers, shared
     memory and spills for the short kernel's 12 instantiations, the long
     kernel's 9 and the f32 tf32x3 kernel's 8, none of which may spill;
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
     stages it picks at the three grids. Kernels 1 and 2 in float32 (the
     f32 SAM configs: 80 windows of 14x14, 4 frames of 48x64) through the
     tf32x3 design (csrc/attention_f32.cu: 3xTF32 on the tensor cores),
     beside the streaming design's f32 body, SDPA with the bias as a float
     mask and the bound at 495/3 TFLOP/s;
  4. reference: a small SAM (ViT-H width, 2 blocks, f32) encodes and decodes
     on the card and on the CPU, where the port runs its plain versions
     (which the CPU test suite holds against pope_tpu); the two must agree,
     and every kernel launch on the card goes through the tf32x3 design;
  5. stage-2 reference: a small DINOv2 (ViT-S width, 2 blocks), a small
     matcher (full widths, 2 coarse layers) and the solver, f32, on the card
     and on the CPU, the solver's noise drawn once on the CPU (DINOv2's
     launches all tf32x3);
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
     SAM's records on the card against the CPU (its launches all tf32x3);
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
 11. int8 and the rest of the slice (run_quant_phase), with the eval
     driver's bench models: the int8 encoder's four dense shapes at the
     bench batch (qkv, proj, mlp_lin1, mlp_lin2: M = 15680 tokens of 80
     windows) on the card against the CPU (x8, x_scale and the int32
     product bit for bit, the bf16 output within one bf16 step), each
     step's ms (quantize, weight quantize, int8 product, epilogue, the whole
     dense) beside bf16 F.linear and the product's bound at 1979 TOP/s;
     SAM ViT-H with SamEncoderConfig(quantize='int8') over 4 frames of
     640x480 beside the bf16 encoder (one forward each with the counts set
     to 0 just before and read just after: 28 + 4 launches and 128 int8
     products; ms in turns, peak memory, a profile, the int8 output's
     cosine and relative error against bf16); evaluate_dataset over 2
     batches with the bf16 SAM and its int8 twin (pairs/s, launches and int8
     products per batch, the share of equal ok / pre_bbox); depth-2
     encoders at ViT-H widths on the card against the CPU (int8 in f32 and
     bf16, and the bias-free bf16 encoder, use_rel_pos=False, whose kernel-3
     launches at d 80 go through the short and the long design); kernel 3
     at (80, 196, 16, 80) and (4, 3072, 16, 80) against its plain version,
     SDPA and the bound; Vim-small in bf16 at B = 8 (ms, card vs CPU at
     depth 2); `cli parse-lm` on a two-frame CDPN object with --device
     cuda and cpu (equal crops, intrinsics within 1e-6);
 12. matcher training (run_train_phase): a small matcher's two train steps
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
 13. export (run_export_phase): the four serving programs at full width,
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
 14. pose regressor (run_regressor_phase): a small 'mkpts+vim' step on the
     card against the CPU; RegressorConfig() at B=8 in three modes
     ('mkpts', 'mkpts+imgs' with ConvNeXtV2-large, 'mkpts+vim' with the
     frozen Vim-small and the transformer fusion), 2 warm-up and 10 timed
     steps each (forward, backward, optimizer; peak memory; FLOPs; the
     eval loss falls; no kernel launches); Vim-small's forward and the
     selective scan's share; a DINOv2Poser forward (24 launches of kernel
     3, f32: all tf32x3); `cli extract` on 4 of the bench's pairs (28 + 4 + 24 launches a
     pair; seeded weights write none), then `cli train-regressor` (2
     epochs) and `cli test-regressor` over synthetic dumps of known poses.
 15. SSL (run_ssl_phase), at `cli train-ssl`'s defaults (ViT-S/14 in f32,
     batch 8, 2 x 224 + 8 x 98 crops, 65,536 prototypes, bf16 head MLP,
     drop path 0.3): kernel 3 at the step's two f32 shapes, (16, 257, 6,
     64) and (64, 50, 6, 64), through the tf32x3 design, held against its
     plain version (f32 limits) and timed beside the streaming design's f32
     body (the previous one), SDPA and the bound (operations at 495/3
     TFLOP/s, 3xTF32; the SIMT yardstick at 67 TFLOP/s beside it); a small
     SSL step on the card against the CPU (all tf32x3); 2 warm-up + 10 timed
     steps on one batch (ms by part: teacher, student forward, backward,
     AdamW + EMA; FLOPs, peak memory, a profile), the counts set to 0 just
     before and read just after: 36 kernel-3 launches a step (24 at N =
     257, 12 at N = 50), all the tf32x3 design, no other kernel;
     extract_cls_features over 96 synthetic images (12 tf32x3 launches a
     batch of 64), kNN, the linear probe and log regression; `cli
     train-ssl` for 4 steps on 24 synthetic images, unbroken and killed at
     step 3 then resumed from its step-2 checkpoint (all tf32x3), ending in
     the unbroken run's state;
 16. novel views (run_nvs_phase): a small NeRF on the card against the CPU
     with the same draws; `cli render-novel-view` at NerfConfig() on a
     sphere sequence of six 120x160 views (500 steps on five, view 3 held
     out; PSNR above the mean-colour image's, SSIM, LPIPS from seeded
     parameters written as the released files), ms per train step (one
     profiled) and per view, and no kernel launches.
 17. parallel (run_parallel_phase, right after the eval driver, whose bench
     models it takes over): two ranks on the one card (parallel.spawn; both
     on cuda:0, so the backend is gloo and every collective is staged
     through pinned host memory). eval at dp 1 in this process and at
     dp 2 on 8 of make_dataset's pairs, global B = 4 at bench configs: the
     records of dp 2 (gathered to rank 0) against dp 1's within
     TOL_EVAL_DEG, each rank's launches per batch with the counts set to 0
     just before its run and read just after (28, 4 and 12, as one
     process's), pairs/s at dp 1 and dp 2, each rank's peak memory, the
     card's idle share over a batch; `cli eval` and `cli eval --dp 2` (its
     own ranks) give the same tables; the matcher's step (MatcherConfig()
     f32, global B = 4 at 480x640) at dp 2 on three batches and at tp 2
     and the SSL step (`cli train-ssl`'s defaults, shard_ssl_state) at dp
     2, each one step against this process's single step (losses,
     gradients, BatchNorm statistics or centers; 36 kernel-3 launches a
     rank), then timed; the dp matcher step again with each of two planted
     faults, which the same check must reject; GPipe at pp = 2 and ring
     attention at sp = 2 on SAM's global-layer shape against each rank's
     own serial / one-softmax result; then `cli train-matcher --dp 2` and
     `--tp 2` (an epoch, then --resume) and `cli train-ssl --dp 2` (killed
     after its first checkpoint, then resumed), each checkpoint held
     against the `--dp 1` run's, and `cli train-ssl --distributed` as two
     commands. Per part: ms, peak memory, collective ms and bytes staged a
     step, and the phase's wall seconds.
The last three lines are the `kernels` JSON line (each kernel's launches on
the main path, per eval batch, on the serving path, on the records path, on
the training path, per exported program, on the regressor's paths, per SSL
step and feature batch and on the novel-view path, its times and bound, and
the same at the square grid for kernels 1 and 2, in float32 for kernels 1
and 2, at the crop grid for kernel 2 and at N = 1025 and the SSL step's two
shapes for kernel 3, and each dp
rank's launches per eval batch; the int8 encoder's and the int8 eval's
launches and kernel 3 at d 80), the
nvidia-smi line and {"ok": true, "device": {...}}. A copy of the results, the full profiles
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
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (what the f32 stream kernel uses)
# float32 on the tensor cores in 3xTF32 (the tf32x3 kernel): three TF32
# products for each f32 one, at the 494.7 TFLOP/s dense TF32 peak
TF32X3_FLOP_PER_S = 494.7e12 / 3
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
F32_SOURCE = "pope_tpu_torch/csrc/attention_f32.cu"
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


def bound(bytes_moved: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, out, ref, tol=(TOL_MAX_REL, TOL_RMS_REL)):
    """Kernel output against its plain version, scaled to the output: tol is
    (max abs error / max |ref|, rms error / rms ref)."""
    ref = ref.float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    rms_err = diff.square().mean().sqrt().item()
    ref_max, ref_rms = ref.abs().max().item(), ref.square().mean().sqrt().item()
    if not (err <= tol[0] * ref_max and rms_err <= tol[1] * ref_rms):
        raise AssertionError(
            f"{name}: kernel vs plain max abs err {err} (limit {tol[0]} x {ref_max}), "
            f"rms err {rms_err} (limit {tol[1]} x {ref_rms})"
        )
    return {"max_abs_err": err, "rms_err": rms_err, "ref_max_abs": ref_max, "ref_rms": ref_rms}


def kernel_phase(name, replaces, source, kernel, plain, library, args, reps, nbytes, flops, exps,
                 ex2_rate, previous=None, flop_rate=BF16_FLOP_PER_S, tol=(TOL_MAX_REL, TOL_RMS_REL)):
    """Hold `kernel` (the design the main path takes at this shape) against
    its plain version and time it beside the plain version, one library call,
    the card's bound and the floor of its `exps` exponentials on the
    special-function units at `ex2_rate` a second (computed, not measured: it
    stays out of the `kernels` line). `previous`, the streaming design at
    the same shape, is held to the same limits and timed in turns with the
    kernel (previous, kernel, kernel, previous). The bound takes the
    operations at `flop_rate` (the bf16 tensor cores' unless given)."""
    ref = plain(*args)
    errs = check_close(name, kernel(*args), ref, tol)
    if previous is not None:
        errs["previous"] = check_close(f"{name} (previous design)", previous(*args), ref, tol)
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
    bound_ms, bound_by = bound(nbytes, flops, flop_rate)
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, **errs,
        "tol": {"max_rel": tol[0], "rms_rel": tol[1]}, "flop_rate": flop_rate,
        "ms": ms, "kernel_ms": ms, "previous_ms": previous_ms, "turns_ms": turns, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "exp_floor_ms": exps / ex2_rate * 1e3, "ex2_per_s": ex2_rate,
        "library_ms": library_ms, "bytes": nbytes, "flops": flops, "exps": exps, "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
    }
    print(json.dumps({"kernel_phase": row}), flush=True)
    return row


def run_kernel_phases():
    from pope_tpu_torch.ops.cuda_kernels import attention_design, launch_attention, launch_attention_relpos, long_layout
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

    def windowed_row(key, BW, previous, dtype=bf16):
        """Kernel 1 on BW windows of 14x14, 16 heads, d = 80."""
        nh, d, ws, N = SAM_H_HEADS, SAM_H_HEAD_DIM, SAM_WINDOW, SAM_WINDOW ** 2
        C, f32 = nh * d, dtype == torch.float32
        qkv = torch.randn(BW, N, 3 * C, device=dev, generator=g).to(dtype)
        rel_h = (0.5 * torch.randn(BW, nh, N, ws, device=dev, generator=g)).to(dtype)
        rel_w = (0.5 * torch.randn(BW, nh, N, ws, device=dev, generator=g)).to(dtype)
        q, k, v = (t.transpose(1, 2) for t in qkv.view(BW, N, 3, nh, d).unbind(2))
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(BW, nh, N, N)
        nbytes = qkv.element_size() * (qkv.numel() + rel_h.numel() + rel_w.numel() + BW * N * C)
        flops = 4.0 * BW * nh * N * N * d
        rows[key] = kernel_phase(
            "windowed_attention_relpos", "pope_tpu/ops/window_attention.py:80", F32_SOURCE if f32 else SHORT_SOURCE,
            windowed_attention_relpos, windowed_attention_relpos_plain,
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            (qkv, rel_h, rel_w, nh, d, ws, ws), reps=20, nbytes=nbytes, flops=flops,
            exps=BW * nh * N * N, ex2_rate=ex2_rate, previous=previous,
            **({"flop_rate": TF32X3_FLOP_PER_S, "tol": TOL_SSL_KERNEL} if f32 else {}),
        )
        rows[key]["design"] = attention_design(dtype, N, d, ws, ws)
        if f32:
            rows[key]["simt_bound_ms"] = bound(nbytes, flops, F32_FLOP_PER_S)[0]

    def global_row(key, B, H, W, reps, previous, dtype=bf16):
        """Kernel 2 on B frames of an H x W token grid, 16 heads, d = 80."""
        nh, d, N = SAM_H_HEADS, SAM_H_HEAD_DIM, H * W
        C, f32 = nh * d, dtype == torch.float32
        qkv = torch.randn(B, N, 3, nh, d, device=dev, generator=g).to(dtype)
        qn, kn, vn = qkv.unbind(2)
        rel_h = (0.5 * torch.randn(B, nh, N, H, device=dev, generator=g)).to(dtype)
        rel_w = (0.5 * torch.randn(B, nh, N, W, device=dev, generator=g)).to(dtype)
        mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, nh, N, N)
        q, k, v = (t.transpose(1, 2) for t in (qn, kn, vn))
        nbytes = qkv.element_size() * (qkv.numel() + rel_h.numel() + rel_w.numel() + B * N * C)
        flops = 4.0 * B * nh * N * N * d
        rows[key] = kernel_phase(
            "flash_attention_relpos", "pope_tpu/ops/flash_attention.py:140", F32_SOURCE if f32 else LONG_SOURCE,
            flash_attention_relpos, flash_attention_relpos_plain,
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            (qn, kn, vn, rel_h, rel_w, H, W), reps=reps, nbytes=nbytes, flops=flops,
            exps=B * nh * N * N, ex2_rate=ex2_rate, previous=previous,
            **({"flop_rate": TF32X3_FLOP_PER_S, "tol": TOL_SSL_KERNEL} if f32 else {}),
        )
        rows[key]["design"] = attention_design(dtype, N, d, H, W)
        if f32:
            rows[key]["simt_bound_ms"] = bound(nbytes, flops, F32_FLOP_PER_S)[0]
        else:
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
    # kernels 1 and 2 in float32 (the f32 SAM configs) through the tf32x3
    # design, the streaming design's f32 body timed beside them
    windowed_row("windowed_attention_relpos_f32", 80, windowed_stream, torch.float32)
    global_row("flash_attention_relpos_f32", 4, 48, 64, 5, lambda *a: launch_attention_relpos(*a, "stream"),
               torch.float32)
    for key in ("windowed_attention_relpos_f32", "flash_attention_relpos_f32"):
        if rows[key]["design"] != "tf32x3":
            raise AssertionError(f"{key} takes the {rows[key]['design']} design, not tf32x3")

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
    "attn_f32_kernel": (re.compile(r"attn_f32_kernelILi(\d+)ELb([01])ELi(\d+)ELb([01])E"), 18),
}


def ptxas_rows(log: str) -> list:
    """ptxas's registers, shared memory and spills for each instantiation of
    the short kernel (attn_short_kernel<D, HAS_BIAS, WIDE>), the long one
    (attn_long_kernel<D, BIAS>) and the f32 one (attn_f32_kernel<DP,
    HAS_BIAS, TQ, VEC>), from nvcc's -v log."""
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
    """Every instantiation of the three Hopper kernels built, none spilled."""
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
    before = kernel_designs()
    with torch.no_grad():
        emb_c, emb_g = cpu.encode_image(x), gpu.encode_image(x.cuda())
        errs["embedding"] = (emb_g.cpu() - emb_c).abs().max().item()
        for sub in (1, 4):
            m_c, i_c = cpu.decode(emb_c[:1], pts, labels, subsample=sub)
            m_g, i_g = gpu.decode(emb_c[:1].cuda(), pts.cuda(), labels.cuda(), subsample=sub)
            errs[f"masks_sub{sub}"] = (m_g.cpu() - m_c).abs().max().item()
            errs[f"iou_sub{sub}"] = (i_g.cpu() - i_c).abs().max().item()
    launches = check_tf32x3_only("f32 SAM on the card", before,
                                 ("windowed_attention_relpos", "flash_attention_relpos"))
    print(json.dumps({"reference_phase": {"max_abs_err": errs, "tol": TOL_F32, "tf32x3_launches": launches}}),
          flush=True)
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
    before = kernel_designs()
    with torch.no_grad():
        ref, out = cpu(x), gpu(x.to(DEV))
    launches = check_tf32x3_only("f32 DINOv2 on the card", before, ("flash_attention",))
    for key in ref:
        errs[f"dinov2_{key}"] = (out[key].cpu() - ref[key]).abs().max().item()
    bad += [k for k in errs if not errs[k] < TOL_F32]
    errs["dinov2_tf32x3_launches"] = launches["flash_attention"]

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
    """fn() with every kernel's launch counts (in all, per design and per
    token count) set to 0 just before it; returns (fn's result, wall ms, the
    counts read just after, the counts per design). The counts per token
    count stay on the wrappers (`launches_by_tokens`) until the next run."""
    for f in counters.values():
        f.launches = 0
        f.launches_by_design.update(dict.fromkeys(f.launches_by_design, 0))
        f.launches_by_tokens.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, ms, {name: f.launches for name, f in counters.items()},
            {name: dict(f.launches_by_design) for name, f in counters.items()})


def designs(short: int = 0, long: int = 0, tf32x3: int = 0, stream: int = 0) -> dict:
    return {"short": short, "long": long, "tf32x3": tf32x3, "stream": stream}


def kernel_designs() -> dict:
    """Each kernel wrapper's launches per design so far."""
    from pope_tpu_torch.ops.flash_attention import flash_attention, flash_attention_relpos
    from pope_tpu_torch.ops.window_attention import windowed_attention_relpos

    return {f.__name__: dict(f.launches_by_design)
            for f in (windowed_attention_relpos, flash_attention_relpos, flash_attention)}


def check_tf32x3_only(name: str, before: dict, wrappers) -> dict:
    """An f32 path's launches since `before` (kernel_designs()): each of
    `wrappers` launched, and every launch of every kernel went through the
    tf32x3 design. Returns the launches per wrapper."""
    now = kernel_designs()
    got = {w: {dn: n - before[w][dn] for dn, n in ds.items()} for w, ds in now.items()}
    if any(sum(ds.values()) != ds["tf32x3"] for ds in got.values()) or not all(got[w]["tf32x3"] for w in wrappers):
        raise AssertionError(f"{name}: launches by design {got}, want tf32x3 only, from each of {wrappers}")
    return {w: ds["tf32x3"] for w, ds in got.items()}


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
    before = kernel_designs()
    out = AutomaticMaskGenerator(gpu, amg_cfg, device=DEV).generate_records(frame)
    launches = check_tf32x3_only("f32 SAM records on the card", before,
                                 ("windowed_attention_relpos", "flash_attention_relpos"))
    check_records("card vs CPU", out, frame.shape[:2])
    row = {"records": len(out), "cpu_records": len(ref), "min_mask_iou": None, "bbox_max_abs_px": None,
           "score_max_abs": None, "same_rle": 0, "tf32x3_launches": launches}
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

        def spy(st, *args):
            grads.append({n: p.grad.detach().cpu().clone() for n, p in st.model.named_parameters()})
            apply(st, *args)

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
    whose JSON line it prints. Returns (the row, the bench models)."""
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
    return row, models


# the int8 encoder's four dense shapes at the bench batch (4 frames of
# 640x480, rect 48x64: 80 windows of 196 tokens in a windowed block):
# (name, M, K, N, the input's dtype). mlp_lin1 quantizes the f32 LayerNorm
# output; the others the bf16 activations
QUANT_SHAPES = (("qkv", 15680, 1280, 3840, "bfloat16"),
                ("proj", 15680, 1280, 1280, "bfloat16"),
                ("mlp_lin1", 15680, 1280, 5120, "float32"),
                ("mlp_lin2", 15680, 5120, 1280, "bfloat16"))
INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
INT8_PRODUCTS_PER_FORWARD = 128  # 4 a block x SAM ViT-H's 32 blocks
QUANT_EVAL_BATCHES = 2  # batches of EVAL_PAIRS_PER_BATCH in the int8 and bf16 eval runs
QUANT_REPS = 5  # timed encoder forwards of each kind
# card vs CPU, the int8 encoder at ViT-H widths, depth 2: relative L2 of the
# output, tests/test_torch_quant.py's whole-encoder limits (the port against
# pope_tpu): an attention or LayerNorm that rounds differently flips an
# int8 level of the entries within that rounding of a round-half point, and
# each flip moves its product by a step
TOL_QUANT_CARD_CPU = {"float32": 1.2e-2, "bfloat16": 3e-2}
# card vs CPU, the bias-free bf16 encoder at depth 2: relative L2 of the
# O(1) neck output; the kernels round the softmax weights to bf16 for the
# p . v product where the plain version keeps them f32, and every bf16
# activation carries a 2^-9 rounding (test_torch_encoder.py's bf16 mean limit
# is 1.5% of values in [1, 2))
TOL_NOREL_BF16_REL = 1.5e-2
VIM_B = 8  # RegressorConfig().batch_size
VIM_CPU_DEPTH = 2  # Vim-small's blocks in the card-vs-CPU check (the CPU's chunked scan is slow)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors (their bit
    patterns mapped onto one ordered integer line)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def quant_op_rows() -> list:
    """Each dense shape of the int8 encoder on the card against the port's
    CPU path: x8, x_scale and the int32 product bit for bit (the CPU's
    `_int_mm` is exact: tests/test_torch_quant.py holds it to the int64
    product), the bf16 output within 1 bf16 step; the ms of the quantize
    step, the weight's quantization, the int8 product, the epilogue and the
    whole dense, beside bf16 `F.linear` at the shape and the product's
    bound."""
    from pope_tpu_torch.ops.quant import dense_w8a8, int8_matmul, quantize_rows, quantize_weight_cols, rescale_int32

    F = torch.nn.functional
    dev, bf16 = DEV, torch.bfloat16
    rows = []
    for i, (name, M, K, N, x_dtype) in enumerate(QUANT_SHAPES):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(M, K, device=dev, generator=g).to(getattr(torch, x_dtype))
        w = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
        b = 0.1 * torch.randn(N, device=dev, generator=g)
        x8, xs = quantize_rows(x)
        w8, ws = quantize_weight_cols(w)
        y = int8_matmul(x8, w8)
        out = rescale_int32(y, xs, ws, b, bf16)
        torch.cuda.synchronize()
        x8_c, xs_c = quantize_rows(x.cpu())
        w8_c, ws_c = quantize_weight_cols(w.cpu())
        y_c = int8_matmul(x8_c, w8_c)
        out_c = rescale_int32(y_c, xs_c, ws_c, b.cpu(), bf16)
        row = {
            "name": name, "M": M, "K": K, "N": N, "x_dtype": x_dtype, "out_dtype": "bfloat16",
            "x8_equal": torch.equal(x8.cpu(), x8_c), "x_scale_equal": torch.equal(xs.cpu(), xs_c),
            "w8_equal": torch.equal(w8.cpu(), w8_c), "w_scale_equal": torch.equal(ws.cpu(), ws_c),
            "int32_equal": torch.equal(y.cpu(), y_c), "out_max_bf16_steps": bf16_ulps(out.cpu(), out_c),
            "out_equal_share": (out.cpu() == out_c).float().mean().item(),
        }
        xb, wb, bb = x.to(bf16), w.to(bf16), b.to(bf16)
        row.update({
            "quantize_ms": cuda_ms(lambda: quantize_rows(x), 10),
            "weight_quantize_ms": cuda_ms(lambda: quantize_weight_cols(w), 10),
            "product_ms": cuda_ms(lambda: int8_matmul(x8, w8), 10),
            "epilogue_ms": cuda_ms(lambda: rescale_int32(y, xs, ws, b, bf16), 10),
            "dense_ms": cuda_ms(lambda: dense_w8a8(x, w8, ws, b, bf16), 10),
            "bf16_linear_ms": cuda_ms(lambda: F.linear(xb, wb, bb), 10),
        })
        ops = 2.0 * M * K * N
        row["product_bound_ms"], row["product_bound_by"] = bound(M * K + N * K + 4 * M * N, ops, INT8_OP_PER_S)
        row["dense_bound_ms"], row["dense_bound_by"] = bound(
            x.element_size() * M * K + N * K + 4 * N + 2 * M * N, ops, INT8_OP_PER_S)
        row["bf16_linear_bound_ms"], _ = bound(2 * (M * K + N * K + N + M * N), ops)
        print(json.dumps({"quant_op": row}), flush=True)
        bad = [k for k in ("x8_equal", "x_scale_equal", "w8_equal", "w_scale_equal", "int32_equal") if not row[k]]
        if bad or row["out_max_bf16_steps"] > 1:
            raise AssertionError(f"int8 dense {name}: card vs CPU {bad}, output {row['out_max_bf16_steps']} bf16 steps")
        rows.append(row)
        del x, w, x8, w8, y, out, xb, wb
        torch.cuda.empty_cache()
    return rows


def int8_twin(sam, seed: int = 0):
    """The bench SAM's int8 twin: SamEncoderConfig(quantize='int8') with the
    same seeded f32 weights as load_models draws (seed 0), kept f32 (the
    int8 path quantizes from them), on the card. Its bf16-cast weights must
    be the bench SAM's bf16 storage."""
    from pope_tpu_torch.models.sam import Sam
    from pope_tpu_torch.pipeline.api import init_sam_weights
    from pope_tpu_torch.utils.bf16_storage import cast_sam_storage

    cfg = dataclasses.replace(sam.config, encoder=dataclasses.replace(sam.config.encoder, quantize="int8"))
    with torch.device(DEV):
        sam8 = Sam(cfg)
    init_sam_weights(sam8, torch.Generator(device=DEV).manual_seed(seed))
    cast_sam_storage(sam8, cfg.encoder)  # leaves a quantized encoder f32
    enc, enc8 = sam.image_encoder, sam8.image_encoder
    if enc8.block_0.qkv.weight.dtype != torch.float32 or not torch.equal(
            enc8.block_31.mlp_lin2.weight.to(torch.bfloat16), enc.block_31.mlp_lin2.weight):
        raise AssertionError("int8 twin: weights are not the bench SAM's f32 masters")
    return sam8.eval()


def sam_encoder_input(sam, imgs):
    """(B, 480, 640, 3) uint8 -> the rect 768x1024 encoder input the AMG
    driver feeds (48x64 tokens)."""
    from pope_tpu_torch.models.sam.sam import rect_frame
    from pope_tpu_torch.ops.resize import resize_bilinear_antialias

    hw = (768, 1024)
    return sam.preprocess(resize_bilinear_antialias(imgs.float(), hw), hw, rect_frame(hw, 16))


def quant_encoder_row(counters, sam, sam8) -> dict:
    """SAM ViT-H over 4 frames, bf16 against int8: launches of one forward
    each (the counts set to 0 just before and read just after), ms per
    forward in turns (bf16, int8, int8, bf16), peak memory, a profile of the
    int8 forward, and the int8 output's per-position cosine and relative
    error against the bf16 output (reported: the weights are seeded)."""
    from pope_tpu_torch.ops.quant import dense_w8a8

    pre = sam_encoder_input(sam, torch.from_numpy(frames(3)).to(DEV))
    row = {"frames": list(pre.shape)}
    with torch.no_grad():
        outs = {}
        for key, model in (("bf16", sam), ("int8", sam8)):
            dense_w8a8.launches = 0
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs[key], ms, launches, by_design = counted_run(counters, lambda: model.encode_image(pre))
            row[key] = {"launches": launches, "by_design": by_design, "int8_products": dense_w8a8.launches,
                        "first_ms": ms, "peak_transient_bytes": torch.cuda.max_memory_allocated() - base}
        want = {"windowed_attention_relpos": 28, "flash_attention_relpos": 4, "flash_attention": 0}
        for key, products in (("bf16", 0), ("int8", INT8_PRODUCTS_PER_FORWARD)):
            if row[key]["launches"] != want or row[key]["int8_products"] != products:
                raise AssertionError(f"{key} encoder: launches {row[key]['launches']}, int8 products "
                                     f"{row[key]['int8_products']}; want {want} and {products}")
        turns = [cuda_ms(lambda m=m: m.encode_image(pre), QUANT_REPS, warmup=1) for m in (sam, sam8, sam8, sam)]
        row["bf16"]["ms"], row["int8"]["ms"] = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        row["turns_ms"] = turns
        row["int8"]["profile"] = profile_call(lambda: sam8.encode_image(pre), row["int8"]["ms"])
        a, b = outs["bf16"].double().flatten(0, 2), outs["int8"].double().flatten(0, 2)
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-12)
        row["int8_vs_bf16"] = {"cos_min": cos.min().item(), "cos_mean": cos.mean().item(),
                               "rel_l2": ((a - b).norm() / a.norm()).item()}
        if not (torch.isfinite(outs["int8"]).all() and outs["int8"].shape == outs["bf16"].shape):
            raise AssertionError("int8 encoder: non-finite or misshapen output")
    return row


def quant_eval_rows(counters, models, models8) -> dict:
    """evaluate_dataset over QUANT_EVAL_BATCHES batches of make_dataset's
    pairs with the bf16 SAM and with its int8 twin, each run warmed and then
    counted (the counts set to 0 just before and read just after): pairs/s,
    launches (28, 4, 12 a batch; the int8 run 128 int8 products a batch),
    records whole and finite, and the share of records whose ok and
    pre_bbox equal the bf16 run's."""
    from pope_tpu_torch import bench
    from pope_tpu_torch.eval import evaluate_dataset
    from pope_tpu_torch.ops.quant import dense_w8a8
    from pope_tpu_torch.pipeline import runner

    B, n = EVAL_PAIRS_PER_BATCH, EVAL_PAIRS_PER_BATCH * QUANT_EVAL_BATCHES
    finish, records = runner.finish_pairs, []

    def recording_finish(pending):
        recs = finish(pending)
        records.extend(recs)
        return recs

    out = {}
    runner.finish_pairs = recording_finish
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data_root, pairs_dir = bench.make_dataset(tmp, n_pairs=n)
            for key, m in (("bf16", models), ("int8", models8)):
                run = lambda m=m: evaluate_dataset(m, "linemod", data_root, pairs_dir, batch_size=B, max_pairs=n,
                                                   progress=False)
                run()
                records.clear()
                dense_w8a8.launches = 0
                _, ms, launches, _ = counted_run(counters, run)
                out[key] = {"ms": ms, "pairs_per_s": n / ms * 1e3, "launches": launches,
                            "int8_products": dense_w8a8.launches, "records": list(records)}
    finally:
        runner.finish_pairs = finish
    for key, products in (("bf16", 0), ("int8", INT8_PRODUCTS_PER_FORWARD)):
        recs, nb = out[key].pop("records"), QUANT_EVAL_BATCHES
        want = {"windowed_attention_relpos": 28 * nb, "flash_attention_relpos": 4 * nb, "flash_attention": 12 * nb}
        if out[key]["launches"] != want or out[key]["int8_products"] != products * nb:
            raise AssertionError(f"{key} eval: launches {out[key]['launches']}, int8 products "
                                 f"{out[key]['int8_products']}; want {want} and {products * nb}")
        if len(recs) != n or len({r["identifier"] for r in recs}) != n or any(
                r["ok"] and not (np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all()) for r in recs):
            raise AssertionError(f"{key} eval: {len(recs)} records for {n} pairs, or non-finite R/t where solved")
        out[key]["ok"] = [bool(r["ok"]) for r in recs]
        out[key]["pre_bbox"] = [np.asarray(r["pre_bbox"]).tolist() for r in recs]
        out[key]["by_identifier"] = {r["identifier"]: r for r in recs}
    same = [out["bf16"]["by_identifier"][i]["ok"] == r["ok"]
            and np.array_equal(out["bf16"]["by_identifier"][i]["pre_bbox"], r["pre_bbox"])
            for i, r in out["int8"]["by_identifier"].items()]
    for key in out:
        del out[key]["by_identifier"]
    out["same_ok_and_pre_bbox_share"] = sum(same) / len(same)
    return out


def small_encoder(dtype: str, **enc) -> "torch.nn.Module":
    """SAM's encoder at ViT-H widths and depth 2 (one windowed block, one
    global), seeded weights, on the CPU."""
    from pope_tpu_torch.config import SamConfig, SamEncoderConfig
    from pope_tpu_torch.models.sam import Sam
    from pope_tpu_torch.pipeline.api import init_sam_weights

    cfg = SamConfig(encoder=SamEncoderConfig(depth=2, global_attn_indexes=(1,), dtype=dtype,
                                             gelu="erf" if dtype == "float32" else "tanh", **enc))
    sam = Sam(cfg)
    init_sam_weights(sam, torch.Generator().manual_seed(7))
    return sam.image_encoder.eval()


def quant_card_vs_cpu(counters) -> dict:
    """Depth-2 encoders at ViT-H widths on one 768x1024 frame (a windowed
    block of 20 windows, a global block of 3072 tokens), on the card and on
    the CPU (the plain versions; `_int_mm` on both): int8 in f32 and bf16,
    and the bias-free bf16 encoder (use_rel_pos=False), whose two kernel-3
    launches at d 80 go through the short and the long design."""
    from pope_tpu_torch.ops.quant import dense_w8a8

    x = torch.from_numpy(np.random.default_rng(8).uniform(-2, 2, (1, 768, 1024, 3)).astype(np.float32))
    out = {}
    for key, dtype, enc, tol in (("int8_f32", "float32", {"quantize": "int8"}, TOL_QUANT_CARD_CPU["float32"]),
                                 ("int8_bf16", "bfloat16", {"quantize": "int8"}, TOL_QUANT_CARD_CPU["bfloat16"]),
                                 ("no_rel_pos_bf16", "bfloat16", {"use_rel_pos": False}, TOL_NOREL_BF16_REL)):
        cpu = small_encoder(dtype, **enc)
        gpu = copy.deepcopy(cpu).to(DEV)
        with torch.no_grad():
            ref = cpu(x)
            dense_w8a8.launches = 0
            got, _, launches, by_design = counted_run(counters, lambda: gpu(x.to(DEV)))
        rel = ((got.cpu() - ref).norm() / ref.norm()).item()
        out[key] = {"rel_l2": rel, "max_abs_err": (got.cpu() - ref).abs().max().item(), "tol_rel_l2": tol,
                    "launches": launches, "by_design": by_design, "int8_products": dense_w8a8.launches}
        if not rel <= tol:
            raise AssertionError(f"{key} encoder, card vs CPU: rel L2 {rel} > {tol}")
    want_norel = {"flash_attention": designs(short=1, long=1)}
    if out["no_rel_pos_bf16"]["by_design"]["flash_attention"] != want_norel["flash_attention"] or any(
            out["no_rel_pos_bf16"]["launches"][k] for k in ("windowed_attention_relpos", "flash_attention_relpos")):
        raise AssertionError(f"bias-free encoder: launches {out['no_rel_pos_bf16']['by_design']}, want kernel 3 "
                             "once through each of the short and the long design, no other kernel")
    for key in ("int8_f32", "int8_bf16"):
        if out[key]["int8_products"] != 8:
            raise AssertionError(f"{key}: {out[key]['int8_products']} int8 products, want 8")
    return out


def d80_kernel_rows(ex2_rate) -> dict:
    """Kernel 3 at SAM's widths (16 heads, d 80), the bias-free encoder's two
    shapes: 80 windows of 196 tokens (the short design) and 4 frames of
    3072 (the long one), against the plain version, SDPA and the bound."""
    from pope_tpu_torch.ops.cuda_kernels import attention_design
    from pope_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    F = torch.nn.functional
    g = torch.Generator(device=DEV).manual_seed(9)
    rows = {}
    for key, B, N, source, reps in (("n196", 80, 196, SHORT_SOURCE, 20), ("n3072", 4, 3072, LONG_SOURCE, 10)):
        nh, d = SAM_H_HEADS, SAM_H_HEAD_DIM
        qkv = torch.randn(B, N, 3, nh, d, device=DEV, generator=g).to(torch.bfloat16)
        qn, kn, vn = qkv.unbind(2)
        q, k, v = (t.transpose(1, 2) for t in (qn, kn, vn))
        rows[key] = kernel_phase(
            "flash_attention", "pope_tpu/ops/flash_attention.py:114", source, flash_attention, flash_attention_plain,
            lambda: F.scaled_dot_product_attention(q, k, v), (qn, kn, vn), reps=reps,
            nbytes=2 * (qkv.numel() + B * N * nh * d), flops=4.0 * B * nh * N * N * d, exps=B * nh * N * N,
            ex2_rate=ex2_rate)
        rows[key]["design"] = attention_design(torch.bfloat16, N, d)
        if rows[key]["design"] != ("short" if N <= 256 else "long"):
            raise AssertionError(f"kernel 3 at N = {N}, d 80 takes the {rows[key]['design']} design")
        del qkv, q, k, v
    return rows


def vim_bf16_row() -> dict:
    """Vim-small in bf16 (the dtype MkptsRegModel passes it) at B = 8 on
    224 crops: forward ms beside the f32 Vim's on the same weights (in
    turns) and peak memory; then card against the CPU at
    Vim-small widths and VIM_CPU_DEPTH blocks, within test_torch_vim_bf16's
    limits (bf16 features of O(1))."""
    from pope_tpu_torch.models.regressor.vim import VimConfig, VisionMamba

    x = torch.from_numpy(np.random.default_rng(10).uniform(0, 1, (VIM_B, 224, 224, 3)).astype(np.float32))
    torch.manual_seed(11)
    with torch.device(DEV):
        vim = VisionMamba(VimConfig(embed_dim=384, depth=24, num_classes=0, dtype="bfloat16")).eval()
        vim32 = VisionMamba(VimConfig(embed_dim=384, depth=24, num_classes=0)).eval()
    vim32.load_state_dict(vim.state_dict())
    xd = x.to(DEV)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        feat = vim(xd)
        row = {"B": VIM_B, "peak_bytes": torch.cuda.max_memory_allocated(), "dtype": str(feat.dtype)}
        turns = [cuda_ms(lambda m=m: m(xd), 2, warmup=1) for m in (vim32, vim, vim, vim32)]
        row.update({"forward_ms": (turns[1] + turns[2]) / 2, "f32_forward_ms": (turns[0] + turns[3]) / 2,
                    "turns_ms": turns})
        del vim32
        if feat.dtype != torch.bfloat16 or feat.shape != (VIM_B, 384) or not torch.isfinite(feat).all():
            raise AssertionError(f"Vim-small bf16: {feat.dtype} {tuple(feat.shape)} or non-finite features")
        torch.manual_seed(12)
        cpu = VisionMamba(VimConfig(embed_dim=384, depth=VIM_CPU_DEPTH, num_classes=0, dtype="bfloat16")).eval()
        gpu = copy.deepcopy(cpu).to(DEV)
        err = (gpu(xd).float().cpu() - cpu(x).float()).abs()
    row["card_vs_cpu"] = {"depth": VIM_CPU_DEPTH, "max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                          "tol": [0.06, 0.01]}
    if not (err.max() < 0.06 and err.mean() < 0.01):
        raise AssertionError(f"Vim bf16 card vs CPU: {row['card_vs_cpu']}")
    return row


def parse_lm_row(tmp: Path) -> dict:
    """`cli parse-lm` on a two-frame CDPN-format object (the fixture of
    tests/test_manifest_cli.py) with --device cuda and --device cpu: the
    256x256 crops and their intrinsics against the CPU run's."""
    import cv2

    from pope_tpu_torch.cli import main as cli_main

    base = tmp / "cdpn"
    seq = base / "real_train" / "ape"
    seq.mkdir(parents=True)
    (base / "models").mkdir()
    (base / "models" / "models_info.txt").write_text(
        "1 diameter 102.099 min_x -37.93 min_y -38.79 min_z -45.88 size_x 75.86 size_y 77.59 size_z 91.76\n")
    rng = np.random.default_rng(3)
    pose = np.hstack([np.eye(3), np.array([[0.0], [0.0], [0.6]])])
    for i in (0, 1):
        cv2.imwrite(str(seq / f"{i}-color.png"), rng.uniform(0, 255, (480, 640, 3)).astype(np.uint8))
        np.savetxt(str(seq / f"{i}-pose.txt"), pose)
        np.savetxt(str(seq / f"{i}-box.txt"), np.array([200, 150, 120, 100]))
    t0 = time.perf_counter()
    for out, dev in (("card", DEV), ("cpu", "cpu")):
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main(["parse-lm", "--data-base-dir", str(base), "--output-dir", str(tmp / out), "--obj-id", "1",
                      "--splits", "train", "--device", dev])
    row = {"s": time.perf_counter() - t0, "crop_differing_bytes": 0, "crop_max_abs_diff": 0, "K_max_rel_diff": 0.0}
    sd = Path("0801-lm1-others") / "lm1-1"
    for i in (0, 1):
        a, b = (cv2.imread(str(tmp / out / sd / "color" / f"{i}.png")) for out in ("card", "cpu"))
        if a.shape != (256, 256, 3) or b.shape != a.shape:
            raise AssertionError(f"parse-lm crops {a.shape} {b.shape}")
        diff = np.abs(a.astype(int) - b.astype(int))
        row["crop_differing_bytes"] += int((diff > 0).sum())
        row["crop_max_abs_diff"] = max(row["crop_max_abs_diff"], int(diff.max()))
        Ka, Kb = (np.loadtxt(str(tmp / out / sd / "intrin_ba" / f"{i}.txt")) for out in ("card", "cpu"))
        row["K_max_rel_diff"] = max(row["K_max_rel_diff"], float(np.abs(Ka - Kb).max() / np.abs(Kb).max()))
    if row["crop_differing_bytes"] or row["K_max_rel_diff"] > 1e-6:
        raise AssertionError(f"parse-lm on the card vs the CPU: {row}")
    return row


def run_quant_phase(counters, models) -> dict:
    """The int8 SAM encoder (w8a8, SamEncoderConfig(quantize='int8')) and
    the rest of this slice on the card, with the eval phase's bench models:
    quant_op_rows, quant_encoder_row, quant_eval_rows (the int8 main path),
    quant_card_vs_cpu, kernel 3 at d 80 (d80_kernel_rows), Vim-small in
    bf16 (vim_bf16_row) and `cli parse-lm` (parse_lm_row). Returns the row;
    any check that fails raises."""
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator

    t0 = time.perf_counter()
    row = {"ops": quant_op_rows()}
    sam8 = int8_twin(models.sam)
    models8 = dataclasses.replace(models, sam=sam8, amg=AutomaticMaskGenerator(sam8, models.config.amg, device=DEV))
    row["encoder"] = quant_encoder_row(counters, models.sam, sam8)
    print(json.dumps({"quant_encoder": row["encoder"]}), flush=True)
    row["eval"] = quant_eval_rows(counters, models, models8)
    print(json.dumps({"quant_eval": row["eval"]}), flush=True)
    del models8, sam8
    torch.cuda.empty_cache()
    row["card_vs_cpu"] = quant_card_vs_cpu(counters)
    print(json.dumps({"quant_card_vs_cpu": row["card_vs_cpu"]}), flush=True)
    row["d80"] = d80_kernel_rows(ex2_per_s())
    row["vim_bf16"] = vim_bf16_row()
    print(json.dumps({"vim_bf16": row["vim_bf16"]}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        row["parse_lm"] = parse_lm_row(Path(tmp))
    print(json.dumps({"parse_lm": row["parse_lm"]}), flush=True)
    row["s"] = time.perf_counter() - t0
    print(json.dumps({"quant_phase_s": row["s"]}), flush=True)
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
    from pope_tpu_torch.ops.cuda_kernels import attention_design
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
    dcfg = models.config.dinov2
    depth = dcfg.depth
    want = {r["program"]: {"windowed_attention_relpos": 0, "flash_attention_relpos": 0,
                           "flash_attention": depth if r["program"] == "dinov2" else 0} for r in rows}
    got = {r["program"]: r["launches"] for r in rows}
    # the program launches the design eager code takes for its dtype (f32: tf32x3)
    design = attention_design(getattr(torch, dcfg.dtype), 197, dcfg.embed_dim // dcfg.num_heads)
    if (got != want or by_name["dinov2"]["pope_op_nodes"] != {"pope.flash_attention.default": depth}
            or by_name["dinov2"]["launches_by_design"]["flash_attention"][design] != depth):
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
    want = 2 * poser.dino.config.depth
    if (launches["flash_attention"] != want or by_design["flash_attention"]["tf32x3"] != want
            or not torch.isfinite(t).all()):
        raise AssertionError(f"DINOv2Poser forward (f32: all tf32x3): {row['dinov2_poser']}")
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


SSL_WARMUP, SSL_STEPS = 2, 10
SSL_B = 8  # cli train-ssl's default batch
# kernel 3 in f32 (the tf32x3 design: three TF32 products for each f32 one)
# against its plain version on the card, both to f32's accuracy without
# TF32: the same sums in another order, outputs of size about 1 (softmax
# averages of v ~ N(0, 1))
TOL_SSL_KERNEL = (2e-4, 2e-5)
# an SSL step of a small config (ViT-S width, 2 blocks, f32 heads) on the
# card against the CPU from the same state, batch and drop-path draws: the
# losses and centers to 1e-4 relative (measured 2e-7); the first step's
# moments (lr 0 in warmup: the gradients) to 2e-3 of each tensor's largest
# (measured 6.7e-4: the two devices' f32 sums); after the second step the
# weights within 5e-2 lr where the first moment is above 5e-2 of its
# tensor's largest (there the gradients agree to about 1%, and so does
# Adam's ratio) and within 2 lr elsewhere (a gradient that is 0 in exact
# arithmetic, as the key bias's, is rounding noise that Adam normalises to
# +-lr on either device)
TOL_SSL_LOSS, TOL_SSL_MOMENTS, TOL_SSL_WEIGHTS_LR, SSL_CONDITIONED = 1e-4, 2e-3, 5e-2, 5e-2
# resumed against unbroken on the card (below): elements above 1e-3 of their
# tensor's largest first moment within this
TOL_SSL_WEIGHTS = 1e-5
# a killed `cli train-ssl` run resumed from its checkpoint against the
# unbroken run, on the card (cuDNN held to deterministic algorithms):
# bit for bit, or, should a sum on the card round otherwise from run to run,
# the weights within 10 TOL_SSL_WEIGHTS where the first moment is above 1e-3
# of its tensor's largest and within 2 lr a step elsewhere
SSL_CLI_STEPS, SSL_CLI_KILL_AT, SSL_CLI_CKPT_EVERY = 4, 3, 2
SSL_EVAL_IMAGES, SSL_EVAL_CLASSES, SSL_EVAL_BATCH = 96, 3, 64


def ssl_cli_args(*extra):
    from pope_tpu_torch import cli

    return cli.build_parser().parse_args(["train-ssl", "--image-root", "-", *extra])


def ssl_batch(cfg, B: int, dev, seed: int) -> dict:
    """A collated-shape batch: 2B global and n_local * B local crops of
    N(0, 1) pixels, iBOT block masks on half the global crops."""
    from pope_tpu_torch.data.ssl_crops import MaskingGenerator

    g = torch.Generator(device=dev).manual_seed(seed)
    side = cfg.global_crop_size // 14
    gen = MaskingGenerator(side, seed=seed)
    rng = np.random.default_rng(seed)
    masks = np.zeros((2 * B, side * side), bool)
    for i in rng.permutation(2 * B)[:B]:
        masks[i] = gen(int(side * side * rng.uniform(cfg.mask_ratio_min, cfg.mask_ratio_max))).reshape(-1)
    gs, ls = cfg.global_crop_size, cfg.local_crop_size
    return {"global_crops": torch.randn(2 * B, gs, gs, 3, device=dev, generator=g),
            "local_crops": torch.randn(cfg.n_local_crops * B, ls, ls, 3, device=dev, generator=g),
            "masks": torch.from_numpy(masks).to(dev)}


def _named_np(sd) -> dict:
    """Copies (a CPU tensor's numpy view would follow its in-place updates)."""
    return {k: v.detach().float().cpu().numpy().copy() for k, v in sd.items()}


def conditioned_diff(got: dict, want: dict, mu: dict, above: float = 1e-3) -> dict:
    """Largest |got - want| over the elements whose first moment is above
    `above` of its tensor's largest, and over all elements."""
    cond, worst = 0.0, 0.0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        ok = np.abs(mu[k]) > above * np.abs(mu[k]).max()
        worst = max(worst, float(d.max()))
        if ok.any():
            cond = max(cond, float(d[ok].max()))
    return {"conditioned": cond, "all": worst}


def ssl_card_vs_cpu() -> dict:
    """Two SSL steps of a small config (ViT-S width and heads, 2 blocks,
    56 / 28 px crops, 256 prototypes in f32, drop path 0.2) on the card and
    on the CPU from the same state, batch and drop-path draws."""
    from pope_tpu_torch.config import DinoV2Config
    from pope_tpu_torch.ops.flash_attention import flash_attention
    from pope_tpu_torch.train.ssl import SSLConfig, SSLMetaArch

    cfg = SSLConfig(global_crop_size=56, local_crop_size=28, n_local_crops=2, dino_out_dim=256, ibot_out_dim=256,
                    head_hidden_dim=128, head_bottleneck_dim=64, head_dtype="float32", warmup_iters=1,
                    total_iters=20, warmup_teacher_temp_iters=4, freeze_last_layer_iters=1, lr=1e-3)
    bcfg = DinoV2Config(embed_dim=384, depth=2, num_heads=6, img_size=56, drop_path_rate=0.2)
    arch = SSLMetaArch(cfg, bcfg)
    batch = ssl_batch(cfg, 2, "cpu", seed=3)
    runs = {}
    for dev in ("cpu", DEV):
        state = arch.init_state(0, dev)
        mults = arch.multipliers(state)
        b = {k: v.to(dev) for k, v in batch.items()}
        before = flash_attention.launches, flash_attention.launches_by_design["tf32x3"]
        steps = []
        for _ in range(2):
            state, m = arch.train_step(state, b, mults=mults)
            sd = state.state_dict()
            steps.append(({k: v.item() for k, v in m.items()},
                          {key: _named_np(sd[key]) for key in ("student", "teacher", "mu")},
                          np.concatenate([state.dino_center.cpu().numpy(), state.ibot_center.cpu().numpy()])))
        runs[dev] = (steps, (flash_attention.launches - before[0],
                             flash_attention.launches_by_design["tf32x3"] - before[1]))
    (cpu, _), (card, launches) = runs["cpu"], runs[DEV]
    lr = cpu[1][0]["lr"]
    errs = {
        "loss_rel": max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12) for (a, *_), (b, *_) in zip(cpu, card) for k in a),
        "center_rel": max(float(np.abs(c[2] - g[2]).max() / np.abs(c[2]).max()) for c, g in zip(cpu, card)),
        "moments_rel": max(float(np.abs(card[0][1]["mu"][k] - w).max() / max(np.abs(w).max(), 1e-30))
                           for k, w in cpu[0][1]["mu"].items()),
        "weights": conditioned_diff(card[1][1]["student"], cpu[1][1]["student"], cpu[1][1]["mu"], SSL_CONDITIONED),
        "teacher": conditioned_diff(card[1][1]["teacher"], cpu[1][1]["teacher"], cpu[1][1]["mu"], SSL_CONDITIONED),
        "lr": lr, "card_launches": launches, "losses_cpu": [s[0] for s in cpu], "losses_card": [s[0] for s in card],
    }
    expect_launches = (2 * 3 * bcfg.depth,) * 2  # in all and through tf32x3
    if not (errs["loss_rel"] < TOL_SSL_LOSS and errs["center_rel"] < TOL_SSL_LOSS
            and errs["moments_rel"] < TOL_SSL_MOMENTS and launches == expect_launches
            and errs["weights"]["conditioned"] <= TOL_SSL_WEIGHTS_LR * lr and errs["weights"]["all"] <= 2 * lr + 1e-6
            and errs["teacher"]["conditioned"] <= TOL_SSL_WEIGHTS_LR * lr):
        raise AssertionError(f"SSL steps, card vs CPU disagree (launches {launches}, want {expect_launches}): {errs}")
    return errs


def ssl_kernel_rows(ex2_rate) -> dict:
    """Kernel 3 at the SSL step's two f32 shapes (the tf32x3 design, the
    stream design's f32 body timed beside it as the previous one): the
    global crops (2B = 16 images, 16x16 patches + cls = 257 tokens) and the
    local crops (8B = 64 images, 7x7 + cls = 50), 6 heads, d 64. The bound
    takes the operations at 3xTF32's rate; `simt_bound_ms` at the CUDA
    cores' f32 rate, the stream design's yardstick."""
    from pope_tpu_torch.ops.cuda_kernels import attention_design, launch_attention
    from pope_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    F = torch.nn.functional
    g = torch.Generator(device=DEV).manual_seed(5)
    rows = {}
    nh, d = 6, 64
    for key, B, N in (("ssl_n257", 2 * SSL_B, 257), ("ssl_n50", 8 * SSL_B, 50)):
        design = attention_design(torch.float32, N, d)
        if design != "tf32x3":
            raise AssertionError(f"kernel 3 at f32 N = {N} takes the {design} design, not tf32x3")
        qkv = torch.randn(B, N, 3, nh, d, device=DEV, generator=g)
        qn, kn, vn = qkv.unbind(2)
        q, k, v = (t.transpose(1, 2) for t in (qn, kn, vn))
        nbytes, flops = 4 * (qkv.numel() + B * N * nh * d), 4.0 * B * nh * N * N * d
        rows[key] = kernel_phase(
            "flash_attention", "pope_tpu/ops/flash_attention.py:114", F32_SOURCE, flash_attention,
            flash_attention_plain, lambda: F.scaled_dot_product_attention(q, k, v), (qn, kn, vn), reps=20,
            nbytes=nbytes, flops=flops, exps=B * nh * N * N, ex2_rate=ex2_rate, flop_rate=TF32X3_FLOP_PER_S,
            tol=TOL_SSL_KERNEL, previous=lambda q, k, v: launch_attention(q, k, v, "stream"),
        )
        rows[key]["design"] = design
        rows[key]["simt_bound_ms"] = bound(nbytes, flops, F32_FLOP_PER_S)[0]
    return rows


def ssl_step_flops(cfg, bcfg, B: int) -> float:
    """Kernel 3's forward FLOPs in one step (FlopCounterMode does not see the
    registered op; its backward is the plain version's products, which it
    counts): teacher and student global crops, student local crops."""
    nh, d = bcfg.num_heads, bcfg.embed_dim // bcfg.num_heads
    ng, nl = (cfg.global_crop_size // 14) ** 2 + 1, (cfg.local_crop_size // 14) ** 2 + 1
    per_layer = 2 * (4.0 * 2 * B * nh * ng * ng * d) + 4.0 * cfg.n_local_crops * B * nh * nl * nl * d
    return bcfg.depth * per_layer


def write_ssl_images(root: Path, n: int, seed: int = 0) -> None:
    """n PNG images of 240x320 textures (cv2), for the CLI's image folder."""
    import cv2

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = np.stack([texture(rng, 240, 320, n_blobs=30) for _ in range(3)], -1)
        cv2.imwrite(str(root / f"{i:03d}.png"), (img * 255).astype(np.uint8))


class _Killed(Exception):
    pass


def ssl_cli_resume(counters, tmp: Path) -> dict:
    """`cli train-ssl` at its defaults (vit_small, 224 / 98, 8 local crops,
    batch 8, 65,536 prototypes, drop path 0.3) for SSL_CLI_STEPS steps with
    a checkpoint every SSL_CLI_CKPT_EVERY: unbroken, and killed at step
    SSL_CLI_KILL_AT then resumed from its last checkpoint."""
    from pope_tpu_torch import cli
    from pope_tpu_torch.utils.checkpoint import load_payload

    images = tmp / "images"
    write_ssl_images(images, 24)
    base = ["train-ssl", "--image-root", str(images), "--total-steps", str(SSL_CLI_STEPS),
            "--ckpt-every", str(SSL_CLI_CKPT_EVERY)]
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the patch embed's conv backward: the same sums each run
    try:
        _, out["unbroken_ms"], out["unbroken_launches"], out["unbroken_by_design"] = counted_run(
            counters, lambda: cli.main(base + ["--ckpt-dir", str(tmp / "a")]))
        killed_and_resumed(base, tmp, counters, out)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    last = f"step_{SSL_CLI_STEPS:08d}"
    a, b = load_payload(str(tmp / "a" / last), "cpu"), load_payload(str(tmp / "b" / last), "cpu")
    mu = _named_np(a["mu"])
    out["weights"] = conditioned_diff(_named_np(b["student"]), _named_np(a["student"]), mu)
    out["teacher"] = conditioned_diff(_named_np(b["teacher"]), _named_np(a["teacher"]), mu)
    out["bitwise_equal"] = all(torch.equal(a[key][k], b[key][k]) for key in ("student", "teacher", "mu", "nu")
                               for k in a[key])
    out["steps"] = (a["step"], b["step"])
    out["sampler"] = json.loads((tmp / "b" / "sampler.json").read_text())
    lr = ssl_cli_args().lr
    close = out["weights"]["conditioned"] <= 10 * TOL_SSL_WEIGHTS and out["weights"]["all"] <= 2 * lr * SSL_CLI_STEPS
    all_tf32x3 = all(out[f"{run}_launches"]["flash_attention"] == out[f"{run}_by_design"]["flash_attention"]["tf32x3"]
                     > 0 for run in ("unbroken", "resumed"))
    if not (out["steps"] == (SSL_CLI_STEPS, SSL_CLI_STEPS) and out["sampler"]["consumed_batches"] == SSL_CLI_STEPS
            and out["dirs_after_kill"] == ["sampler.json", f"step_{SSL_CLI_CKPT_EVERY:08d}"]
            and (out["bitwise_equal"] or close) and all_tf32x3):
        raise AssertionError(f"cli train-ssl resume: {out}")
    return out


def killed_and_resumed(base, tmp: Path, counters, out: dict) -> None:
    """The CLI killed at step SSL_CLI_KILL_AT (an exception out of the step),
    then run again on the same checkpoint directory."""
    from pope_tpu_torch import cli
    from pope_tpu_torch.train import ssl as ssl_module

    step = ssl_module.SSLMetaArch.train_step

    def dies(self, state, batch, **kw):
        if state.step == SSL_CLI_KILL_AT:
            raise _Killed
        return step(self, state, batch, **kw)

    ssl_module.SSLMetaArch.train_step = dies
    try:
        cli.main(base + ["--ckpt-dir", str(tmp / "b")])
        raise AssertionError("the killed run was not killed")
    except _Killed:
        pass
    finally:
        ssl_module.SSLMetaArch.train_step = step
    out["dirs_after_kill"] = sorted(os.listdir(tmp / "b"))
    _, out["resumed_ms"], out["resumed_launches"], out["resumed_by_design"] = counted_run(
        counters, lambda: cli.main(base + ["--ckpt-dir", str(tmp / "b")]))


def ssl_eval_row(counters, backbone, depth: int) -> dict:
    """extract_cls_features over SSL_EVAL_IMAGES synthetic 224 px images of
    SSL_EVAL_CLASSES stripe frequencies, in batches of 64, then kNN, the
    linear probe and the log-regression sweep on the features."""
    from pope_tpu_torch.train import ssl_eval

    rng = np.random.default_rng(9)
    labels = np.arange(SSL_EVAL_IMAGES) % SSL_EVAL_CLASSES
    xx = np.arange(224, dtype=np.float32)
    images = np.stack([np.broadcast_to(np.sin(xx * (0.05 + 0.1 * c))[None, :, None], (224, 224, 3))
                       + rng.normal(0, 0.5, (224, 224, 3)) for c in labels]).astype(np.float32)
    feats, ms, launches, by_design = counted_run(
        counters, lambda: ssl_eval.extract_cls_features(backbone, images, batch_size=SSL_EVAL_BATCH))
    n_batches = -(-SSL_EVAL_IMAGES // SSL_EVAL_BATCH)
    y = torch.from_numpy(labels).to(DEV)
    n_train = 2 * SSL_EVAL_IMAGES // 3
    tr, te, ytr, yte = feats[:n_train], feats[n_train:], y[:n_train], y[n_train:]
    row = {"images": SSL_EVAL_IMAGES, "batches": n_batches, "extract_ms": ms, "launches": launches,
           "launches_per_batch": {k: n / n_batches for k, n in launches.items()}, "by_design": by_design,
           "feature_shape": list(feats.shape)}
    t0 = time.perf_counter()
    row["knn_accuracy"] = ssl_eval.knn_accuracy(tr, ytr, te, yte, nb_knn=(10, 20))
    params, losses = ssl_eval.train_linear_probe(tr, ytr, steps=100, batch_size=64)
    row["linear_probe_accuracy"] = ssl_eval.linear_probe_accuracy(params, te, yte)
    row["log_regression"] = ssl_eval.log_regression_accuracy(tr, ytr, te, yte, steps=100)[:2]
    torch.cuda.synchronize()
    row["protocols_ms"] = (time.perf_counter() - t0) * 1e3
    if not (torch.isfinite(feats).all() and np.isfinite(losses).all()
            and launches["flash_attention"] == depth * n_batches
            and by_design["flash_attention"]["tf32x3"] == depth * n_batches):
        raise AssertionError(f"ssl eval: {row}")
    return row


def run_ssl_phase(counters, ex2_rate) -> dict:
    """DINOv2 SSL at `cli train-ssl`'s defaults on the card: kernel 3 at the
    step's two f32 shapes; SSL_WARMUP + SSL_STEPS steps on one batch (ms by
    part, FLOPs, peak memory, a profile), with the kernels' counts set to 0
    just before and read just after (36 kernel-3 launches a step, all the
    tf32x3 design, 24 at the global crops' tokens and 12 at the local
    crops', no other kernel); a small
    step against the CPU; the CLI killed and resumed; the features, kNN and
    the probes. ViT-S/14 has 12 blocks: 36 launches a step, 12 a feature
    batch."""
    from torch.utils.flop_counter import FlopCounterMode

    from pope_tpu_torch.train.ssl import SSLMetaArch
    from pope_tpu_torch.train.ssl_driver import ssl_configs

    cfg, bcfg = ssl_configs(ssl_cli_args())
    row = {"config": {"ssl": dataclasses.asdict(cfg), "backbone": dataclasses.asdict(bcfg)}, "batch": SSL_B}
    row["kernel_rows"] = ssl_kernel_rows(ex2_rate)
    row["card_vs_cpu"] = ssl_card_vs_cpu()

    arch = SSLMetaArch(cfg, bcfg)
    state = arch.init_state(0, DEV)
    mults = arch.multipliers(state)
    batch = ssl_batch(cfg, SSL_B, DEV, seed=1)
    losses, parts = [], []

    def steps():
        for k in range(SSL_WARMUP + SSL_STEPS):
            box = {}
            acc = wall_ms_by_part([(arch, "_teacher_targets", "teacher"), (arch, "_student_losses", "student_forward"),
                                   (arch, "_apply_update", "adamw_ema")],
                                  lambda: box.update(arch.train_step(state, batch, mults=mults)[1]))
            losses.append({k2: v.item() for k2, v in box.items()})
            if k >= SSL_WARMUP:
                parts.append(acc)

    torch.cuda.reset_peak_memory_stats()
    _, row["steps_wall_ms"], launches, by_design = counted_run(counters, steps)
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    n = SSL_WARMUP + SSL_STEPS
    row["launches_per_step"] = {k: v / n for k, v in launches.items()}
    row["by_design_per_step"] = {k: {d: v / n for d, v in ds.items()} for k, ds in by_design.items()}
    row["flash_attention_by_tokens_per_step"] = {
        n_tok: v / n for n_tok, v in counters["flash_attention"].launches_by_tokens.items()}
    med = lambda key: statistics.median(p[key] for p in parts)
    row["parts_ms"] = {"teacher": med("teacher"), "student_forward": med("student_forward"),
                       "adamw_ema": med("adamw_ema"),
                       "backward": statistics.median(p["total"] - p["teacher"] - p["student_forward"] - p["adamw_ema"]
                                                     for p in parts)}
    row["ms_per_step_fenced"] = med("total")
    row["ms_per_step"] = statistics.median(timed_runs(lambda: arch.train_step(state, batch, mults=mults), 5))
    row["losses"] = losses
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"SSL losses not finite: {losses}")
    want = {"flash_attention": 3 * bcfg.depth, "flash_attention_relpos": 0, "windowed_attention_relpos": 0}
    # the teacher's and the student's global crops, then the student's local crops
    tokens = lambda crop: (crop // bcfg.patch_size) ** 2 + 1
    want_tokens = {tokens(cfg.global_crop_size): 2 * bcfg.depth, tokens(cfg.local_crop_size): bcfg.depth}
    if (row["launches_per_step"] != want or row["by_design_per_step"]["flash_attention"]["tf32x3"] != want["flash_attention"]
            or row["flash_attention_by_tokens_per_step"] != want_tokens):
        raise AssertionError(f"SSL step launches {row['launches_per_step']} {row['by_design_per_step']} "
                             f"{row['flash_attention_by_tokens_per_step']}, want {want} {want_tokens}")
    with FlopCounterMode(display=False) as flops:
        arch.train_step(state, batch, mults=mults)
    row["tflop_per_step_counted"] = flops.get_total_flops() / 1e12
    row["tflop_attention_forward"] = ssl_step_flops(cfg, bcfg, SSL_B) / 1e12
    row["tflop_per_step"] = row["tflop_per_step_counted"] + row["tflop_attention_forward"]
    row["tflop_per_s"] = row["tflop_per_step"] / (row["ms_per_step"] / 1e3)
    row["profile"] = profile_call(lambda: arch.train_step(state, batch, mults=mults), row["ms_per_step"])
    row["eval"] = ssl_eval_row(counters, state.student["backbone"], bcfg.depth)
    del state, arch, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        row["cli"] = ssl_cli_resume(counters, Path(tmp))
    print(json.dumps({"ssl_phase": row}, default=str), flush=True)
    return row

NVS_HW = (120, 160)  # the sphere views (LINEMOD's 480x640 at a quarter)
NVS_K = ((150.0, 0.0, 80.0), (0.0, 150.0, 60.0), (0.0, 0.0, 1.0))
NVS_VIEWS, NVS_TARGET = 6, 3
NVS_CLI_STEPS = 500
NVS_TIMED_STEPS = 20
# the NeRF on the card against the CPU (small f32 config, the same draws):
# the coarse pass's colours to 1e-5 (measured 2e-7); the fine pass's colours
# and depths for 99% of the rays to 1e-3 and for all to 1e-2 (measured: p99
# 1.8e-4, max 6.3e-4 in 7 of 512 rays: where one coarse bin dominates, the
# others' CDF steps sit at the inverse CDF's 1e-5 threshold, and a fine
# sample's place moves with the two devices' cumsums), the same for the
# rendered image; the loss to 1e-4 relative; the gradients (the first
# step's moments) to 1e-2 of each tensor's largest (measured 4e-3); the
# weights after that first Adam step (+-lr by the gradient's sign) within
# 1e-6 where the first moment is above 5e-2 of its tensor's largest, within
# 2 lr elsewhere
TOL_NVS_COARSE, TOL_NVS_P99, TOL_NVS_MAX, TOL_NVS_LOSS, TOL_NVS_GRAD = 1e-5, 1e-3, 1e-2, 1e-4, 1e-2


def look_at_pose(cam_pos, target=np.zeros(3)):
    """world->camera [R|t], opencv axes, +z toward `target`."""
    z = target - cam_pos
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return np.hstack([R, (-R @ cam_pos)[:, None]])


def sphere_view(K, pose, hw, radius=0.5, color=(0.9, 0.3, 0.2)):
    """A shaded sphere at the origin on a gray background, ray traced."""
    from pope_tpu_torch.nvs.nerf import make_rays

    o, d = make_rays(K, pose, hw)
    b = np.sum(o * d, -1)
    disc = b * b - (np.sum(o * o, -1) - radius ** 2)
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0)
    pt = o + d * t[..., None]
    img = np.full(hw + (3,), 0.55, np.float32)
    img[hit] = np.asarray(color) * np.clip(-np.sum(pt / radius * d, -1), 0, 1)[hit][:, None]
    return img


def write_sphere_seq(root: Path) -> list:
    """A LINEMOD-layout sequence (color/, poses_ba/, intrin_ba/) of NVS_VIEWS
    views around the sphere; returns the poses."""
    import cv2

    for sub in ("color", "poses_ba", "intrin_ba"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    K = np.array(NVS_K)
    poses = []
    for i, a in enumerate(np.linspace(0, 2 * np.pi, NVS_VIEWS, endpoint=False)):
        pose = look_at_pose(np.array([1.6 * np.sin(a), 0.25, -1.6 * np.cos(a)]))
        cv2.imwrite(str(root / "color" / f"{i}.png"), (sphere_view(K, pose, NVS_HW)[..., ::-1] * 255).astype(np.uint8))
        np.savetxt(root / "poses_ba" / f"{i}.txt", pose)
        np.savetxt(root / "intrin_ba" / f"{i}.txt", K)
        poses.append(pose)
    return poses


def sphere_rays(views, hw, dev):
    from pope_tpu_torch.nvs.nerf import make_rays

    K = np.array(NVS_K) * np.array([[hw[1] / NVS_HW[1]], [hw[0] / NVS_HW[0]], [1.0]])
    o, d, c = [], [], []
    for a in np.linspace(0, 2 * np.pi, views, endpoint=False):
        pose = look_at_pose(np.array([1.6 * np.sin(a), 0.25, -1.6 * np.cos(a)]))
        oo, dd = make_rays(K, pose, hw)
        o.append(oo.reshape(-1, 3))
        d.append(dd.reshape(-1, 3))
        c.append(sphere_view(K, pose, hw).reshape(-1, 3))
    return tuple(torch.from_numpy(np.concatenate(x)).to(dev) for x in (o, d, c))


def nerf_card_vs_cpu() -> dict:
    """A small f32 NeRF (hidden 64, depth 4, 32 + 32 samples, 512 rays) on
    the card and on the CPU from the same weights with the same draws:
    render_rays, one train step and render_image."""
    from pope_tpu_torch.nvs.nerf import NerfConfig, init_nerf, nerf_train_step, render_image, render_rays

    cfg = NerfConfig(hidden=64, depth=4, skip_at=2, n_coarse=32, n_fine=32, ray_batch=512, lr=1e-3, dtype="float32")
    rng = np.random.default_rng(4)
    uc = torch.from_numpy(rng.uniform(size=(cfg.ray_batch, cfg.n_coarse)).astype(np.float32))
    uf = torch.from_numpy(rng.uniform(size=(cfg.ray_batch, cfg.n_fine)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 3 * 32 * 40, cfg.ray_batch))
    pose = look_at_pose(np.array([0.5, 0.3, -1.7]))
    runs = {}
    for dev in ("cpu", DEV):
        model, state = init_nerf(cfg, 3, dev)
        o, d, c = sphere_rays(3, (32, 40), dev)
        near, far = torch.full((cfg.ray_batch,), 0.9, device=dev), torch.full((cfg.ray_batch,), 2.4, device=dev)
        with torch.no_grad():
            out = render_rays(model, o[idx.to(dev)], d[idx.to(dev)], near, far, uc.to(dev), uf.to(dev))
        loss = nerf_train_step(model, state, o, d, c, 0.9, 2.4, idx.to(dev), uc.to(dev), uf.to(dev)).item()
        img = render_image(model, np.array(NVS_K) / 4 * np.array([[1], [1], [4]]), pose, (30, 40), 0.9, 2.4,
                           chunk=512, u_fine=uf.numpy())
        runs[dev] = ({k: v.cpu().numpy() for k, v in out.items()}, loss, _named_np(model.state_dict()),
                     _named_np(state.mu), img)
    (r_c, l_c, w_c, mu_c, i_c), (r_g, l_g, w_g, mu_g, i_g) = runs["cpu"], runs[DEV]

    def per_ray(a, b):
        d = np.abs(a - b).reshape(a.shape[0], -1).max(1)
        return {"max": float(d.max()), "p99": float(np.percentile(d, 99))}

    errs = {"rgb_coarse": float(np.abs(r_g["rgb_coarse"] - r_c["rgb_coarse"]).max()),
            "rgb": per_ray(r_g["rgb"], r_c["rgb"]), "depth": per_ray(r_g["depth"], r_c["depth"]),
            "image": per_ray(i_g.reshape(-1, 3), i_c.reshape(-1, 3)), "loss_rel": abs(l_g - l_c) / l_c,
            "grad_rel": max(float(np.abs(mu_g[k] - m).max() / max(np.abs(m).max(), 1e-30)) for k, m in mu_c.items()),
            "weights": conditioned_diff(w_g, w_c, mu_c, 5e-2), "lr": cfg.lr}
    fine_ok = all(errs[k]["p99"] <= TOL_NVS_P99 and errs[k]["max"] <= TOL_NVS_MAX for k in ("rgb", "depth", "image"))
    if not (fine_ok and errs["rgb_coarse"] <= TOL_NVS_COARSE and errs["loss_rel"] <= TOL_NVS_LOSS
            and errs["grad_rel"] <= TOL_NVS_GRAD and errs["weights"]["conditioned"] <= 1e-6
            and errs["weights"]["all"] <= 2 * cfg.lr + 1e-6):
        raise AssertionError(f"NeRF, card vs CPU disagree: {errs}")
    return errs


def run_nvs_phase(counters) -> dict:
    """Novel views at NerfConfig() on the card: the small NeRF against the
    CPU; `cli render-novel-view` on a sphere sequence of NVS_VIEWS 120x160
    views (NVS_CLI_STEPS steps on 5, view 3 held out, LPIPS with seeded
    parameters written as the two released files) with the counts set to 0
    just before and read just after (no kernel launches); ms per train step
    (and one profiled step) and per rendered view; PSNR against the
    mean-colour image."""
    from pope_tpu_torch import cli
    from pope_tpu_torch.nvs import driver as nvs_driver
    from pope_tpu_torch.nvs.nerf import NerfConfig, init_nerf, render_image, train_nerf
    from pope_tpu_torch.utils import lpips
    from pope_tpu_torch.utils.image_metrics import psnr

    row = {"config": dataclasses.asdict(NerfConfig()), "views": NVS_VIEWS, "hw": list(NVS_HW)}
    row["card_vs_cpu"] = nerf_card_vs_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        poses = write_sphere_seq(tmp / "seq")
        params = lpips.init_random_params(0)
        alex = {}
        for i, (name, *_r) in zip((0, 3, 6, 8, 10), lpips._STAGES):
            alex[f"features.{i}.weight"] = params["features"][name]["weight"]
            alex[f"features.{i}.bias"] = params["features"][name]["bias"]
        torch.save(alex, tmp / "alexnet.pth")
        torch.save({f"lin{i}.model.1.weight": params["lins"][f"lin{i}"].reshape(1, -1, 1, 1) for i in range(5)},
                   tmp / "alex.pth")
        got, run = [], nvs_driver.render_novel_views
        nvs_driver.render_novel_views = lambda *a, **k: got.append(run(*a, **k)) or got[-1]
        sources = ",".join(str(i) for i in range(NVS_VIEWS) if i != NVS_TARGET)
        try:
            _, row["cli_ms"], launches, _ = counted_run(counters, lambda: cli.main([
                "render-novel-view", "--seq-root", str(tmp / "seq"), "--source-ids", sources,
                "--target-ids", str(NVS_TARGET), "--out-dir", str(tmp / "out"), "--label", "sphere",
                "--train-steps", str(NVS_CLI_STEPS), "--lpips-alexnet", str(tmp / "alexnet.pth"),
                "--lpips-lins", str(tmp / "alex.pth")]))
        finally:
            nvs_driver.render_novel_views = run
        (idx, p, s, lp), = got[0]
        gt = sphere_view(np.array(NVS_K), poses[NVS_TARGET], NVS_HW)
        row |= {"target": idx, "psnr": p, "ssim": s, "lpips_seeded": lp,
                "psnr_mean_image": psnr(np.broadcast_to(gt.mean((0, 1)), gt.shape), gt),
                "written": sorted(os.listdir(tmp / "out")), "cli_launches": launches}
    model, state = init_nerf(NerfConfig(), 0, DEV)
    o, d, c = sphere_rays(NVS_VIEWS - 1, NVS_HW, DEV)
    g = torch.Generator(device=DEV).manual_seed(1)
    step = lambda: train_nerf(model, state, o, d, c, 0.9, 2.4, 1, generator=g)
    _, _, step_launches, _ = counted_run(counters, lambda: [step() for _ in range(3)])
    row["ms_per_train_step"] = statistics.median(timed_runs(step, NVS_TIMED_STEPS))
    row["profile"] = profile_call(step, row["ms_per_train_step"])
    render = lambda: render_image(model, np.array(NVS_K), poses[NVS_TARGET], NVS_HW, 0.9, 2.4)
    row["ms_per_view"] = statistics.median(timed_runs(render, 3))
    row["launches"] = {k: launches[k] + step_launches[k] for k in launches}
    if not (row["psnr"] > row["psnr_mean_image"] + 3.0 and np.isfinite([row["ssim"], row["lpips_seeded"]]).all()
            and row["written"] == [f"sphere_gt_{NVS_TARGET}.jpg", f"sphere_gt_pose_{NVS_TARGET}.jpg"]
            and not any(row["launches"].values())):
        raise AssertionError(f"novel views: {row}")
    del model, state
    torch.cuda.empty_cache()
    print(json.dumps({"nvs_phase": row}, default=str), flush=True)
    return row


PAR_RANKS = 2  # ranks of the parallel phase, both on the one card (gloo, staged through pinned host memory)
PAR_EVAL_PAIRS = 8  # 2 global batches of EVAL_PAIRS_PER_BATCH; each rank runs 2 pairs of each
PAR_TIMED_STEPS = 2  # timed train steps after the compared one, in each part
PAR_SEEDS = (21, 22, 23)  # planar_items batches of the compared dp steps; the tp step takes the first
# dp / tp matcher steps against the single-process step on the card, f32,
# TF32 off: the losses to TOL_TRAIN_LOSS, the BatchNorm running statistics to
# TOL_PAR_STATS of each tensor's largest (the same sums in another order;
# measured 4.4e-7 at dp 2, 1.8e-7 at tp 2). The gradients: the dp ranks sum
# the BatchNorm moments in another order, and a ReLU input within rounding
# of 0 then takes the other side; at full width some always do (116 at dp,
# 71 at tp, counted on each side). The step counts each ReLU's positive
# inputs on both sides: with equal counts the gradients are held to
# TOL_PAR_GRAD of each tensor's largest (the sums' rounding), with a flip to
# TOL_PAR_GRAD_FLIP of each tensor's norm. The phase plants two faults in
# the dp step, its gradients left unsummed over dp and BatchNorm on each
# rank's own batch, and fails unless the same check rejects both. On the
# H100 the sound steps read 1.6e-2, 1.4e-2 and 2.0e-3 of a norm at dp 2
# (PAR_SEEDS) and 1.6e-3 at tp 2, the faults 2.18 and 0.67 (statistics
# 4.3e-2 against at most 7.6e-7 sound); the bounds sit between.
# SSL has GELUs only: its gradients (the first step's moments, lr 0) to
# TOL_SSL_MOMENTS of each tensor's largest, losses and centers to
# TOL_SSL_LOSS; but the heads' MLPs run in bf16 (cli train-ssl's
# head_dtype), whose products round their weight gradients to 2^-8: the
# sum of two ranks' rounded halves against one rounded whole, TOL_PAR_BF16.
TOL_PAR_GRAD, TOL_PAR_GRAD_FLIP, TOL_PAR_STATS, TOL_PAR_BF16 = 1e-3, 5e-2, 1e-5, 1e-2
PAR_FAULTS = ("unsummed_grads", "per_rank_batch_norm")
# The CLI's runs at dp 2 and tp 2 against its run at dp 1 (train-matcher:
# one step an epoch, an epoch then a resume to two; train-ssl: killed after
# its first checkpoint, then resumed): tests/test_torch_parallel_train.py's
# bounds on the train loss, the Adam moments (of each tensor's norm) and
# the BatchNorm statistics (here of each tensor's largest), set there
# between a sound run's drift after ReLU flips and planted faults'
TOL_PAR_RUN_LOSS, TOL_PAR_RUN_MOMENTS, TOL_PAR_RUN_STATS = 1e-3, 0.5, 3e-3
# train-ssl's four steps at --dp 2 against --dp 1: the first moments to
# TOL_PAR_RUN_SSL_MU of each tensor's largest, the weights within Adam's
# bound (2 lr a step). Rehearsed on the CPU with a 2-block ViT: 5.5e-3 sound;
# 1.7 with every rank on the same half of the batch, 64 with the dp
# gradients left unsummed.
TOL_PAR_RUN_SSL_MU = 0.1
PAR_CLI_MATCHER = ("--batch-size", "2", "--n-samples-per-subset", "2", "--warmup-steps", "0")
# GPipe (pp = 2) against the serial composition on one rank: the same f32
# products, in the same order; ring attention (sp = 2, SAM's global-layer
# shape in f32) against one softmax over all keys: sums in another order,
# held as kernel 3's f32 rows are (TOL_SSL_KERNEL)
TOL_PP = 1e-5  # of each tensor's largest
PP_D, PP_MICRO, PP_MB = 1024, 4, 16  # GPipe's stage width, microbatches, microbatch rows
RING_TOKENS = 3072  # SAM ViT-H's rect 48x64 global layers: 16 heads of d = 80


def _par_matcher(seed: int = 66):
    from pope_tpu_torch.config import MatcherConfig
    from pope_tpu_torch.models.matcher import Matcher
    from pope_tpu_torch.pipeline.api import init_matcher_weights
    from pope_tpu_torch.train import trainer
    from pope_tpu_torch.train.optim import OptimConfig

    matcher = Matcher(MatcherConfig())
    init_matcher_weights(matcher, torch.Generator().manual_seed(seed))
    return trainer.init_matcher_train_state(matcher.to(DEV), OptimConfig(lr=TRAIN_LR, warmup_steps=0), grad_clip=0.5)


@contextlib.contextmanager
def relu_positive_counts():
    """Count each matcher ReLU's positive inputs (backbone and LoFTR
    layers), call by call: a run whose counts differ from another's took
    another side at an input within rounding of 0."""
    from pope_tpu_torch.models.matcher import backbone, transformer

    F, counts = torch.nn.functional, []

    class Counting:
        def __getattr__(self, name):
            return getattr(F, name)

        def relu(self, x, *a, **kw):
            counts.append((x.detach() > 0).sum())
            return F.relu(x, *a, **kw)

        def leaky_relu(self, x, *a, **kw):
            counts.append((x.detach() > 0).sum())
            return F.leaky_relu(x, *a, **kw)

    saved = backbone.F, transformer.F
    backbone.F = transformer.F = Counting()
    try:
        yield counts
    finally:
        backbone.F, transformer.F = saved


def _par_ssl():
    from pope_tpu_torch.train.ssl import SSLMetaArch
    from pope_tpu_torch.train.ssl_driver import ssl_configs

    cfg, bcfg = ssl_configs(ssl_cli_args())
    arch = SSLMetaArch(cfg, bcfg)
    return arch, arch.init_state(0, DEV), ssl_batch(cfg, SSL_B, DEV, seed=1)


def _full_grads(module) -> dict:
    """{name: gradient on the CPU}, tp shards gathered."""
    from pope_tpu_torch.parallel.collectives import all_gather

    out = {}
    for mod_name, mod in module.named_modules():
        for pn, p in mod.named_parameters(recurse=False):
            g = p.grad
            if g is not None and getattr(p, "tp_sharded", False):
                g = all_gather(g, mod.tp_shard.group)
            out[f"{mod_name}.{pn}" if mod_name else pn] = None if g is None else g.detach().cpu().clone()
    return out


def _steps_ms(step, n: int) -> float:
    """Median wall ms of n more calls of step(), each ending in a sync."""
    return statistics.median(timed_runs(step, n))


def _ssl_step_capture(arch, state, batch, step):
    """(metrics, {name: gradient on the CPU}) of one SSL step, the
    gradients taken as the update reads them (FSDP shards gathered)."""
    from pope_tpu_torch.parallel.collectives import all_gather

    grads, update = {}, arch._apply_update

    def spy(st, sched, mults):
        for n, p in st.student.named_parameters():
            g = p.grad
            if g is not None and st.fsdp is not None and n in st.fsdp.names:
                g = all_gather(g, st.fsdp.group)
            grads[n] = None if g is None else g.detach().cpu().clone()
        update(st, sched, mults)

    arch._apply_update = spy
    try:
        _, metrics = step(state, batch)
    finally:
        arch._apply_update = update
    return {k: v.item() for k, v in metrics.items()}, grads


def _pp_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    stages = [{"w": torch.randn(PP_D, PP_D, device=dev, generator=g) / PP_D ** 0.5,
               "b": torch.randn(PP_D, device=dev, generator=g) * 0.1} for _ in range(PAR_RANKS)]
    x = torch.randn(PP_MICRO, PP_MB, PP_D, device=dev, generator=g)
    return stages, x, torch.randn(x.shape, device=dev, generator=g)


def _ring_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    return [torch.randn(SAM_H_HEADS, RING_TOKENS, SAM_H_HEAD_DIM, device=dev, generator=g) for _ in range(3)]


def par_rank(mesh, tmp):
    """One rank of the parallel phase (spawned; both ranks on cuda:0)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from pope_tpu_torch import bench
    from pope_tpu_torch.eval import evaluate_dataset
    from pope_tpu_torch.ops.flash_attention import flash_attention, flash_attention_relpos
    from pope_tpu_torch.ops.ring_attention import ring_attention
    from pope_tpu_torch.ops.window_attention import windowed_attention_relpos
    from pope_tpu_torch.parallel.collectives import STATS
    from pope_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params_tp
    from pope_tpu_torch.parallel.pipeline import pipeline_loss_and_grad, shard_stage_params, stack_stage_params
    from pope_tpu_torch.pipeline import runner
    from pope_tpu_torch.train import trainer
    from pope_tpu_torch.train.ssl import make_sharded_ssl_step, shard_ssl_batch, shard_ssl_state, ssl_state_bytes
    from pope_tpu_torch.utils.device import resolve_device

    resolve_device(DEV)
    rank = dist.get_rank()
    tmp = Path(tmp)
    counters = {"windowed_attention_relpos": windowed_attention_relpos,
                "flash_attention_relpos": flash_attention_relpos, "flash_attention": flash_attention}
    out = {"backend": dist.get_backend(), "device": str(torch.cuda.current_device()), "mesh": str(mesh)}

    def part(name, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        STATS.reset()
        dist.barrier()
        t0 = time.perf_counter()
        row = fn()
        torch.cuda.synchronize()
        dist.barrier()
        row.update(wall_s=time.perf_counter() - t0, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   comm=STATS.snapshot())
        out[name] = row

    def eval_part():
        row = {}
        t0 = time.perf_counter()
        models = bench.build_models()
        torch.cuda.synchronize()
        row["load_s"] = time.perf_counter() - t0
        data_root, pairs_dir = str(tmp / "data"), str(tmp / "data" / "pairs")
        dispatch, finish = runner.dispatch_pairs, runner.finish_pairs
        batches, records = [], []

        def counting_dispatch(*args, **kwargs):
            before = {name: f.launches for name, f in counters.items()}
            p = dispatch(*args, **kwargs)
            batches.append({name: f.launches - before[name] for name, f in counters.items()})
            return p

        def recording_finish(pending):
            recs = finish(pending)
            records.extend(recs)
            return recs

        runner.dispatch_pairs, runner.finish_pairs = counting_dispatch, recording_finish
        try:
            evaluate_dataset(models, "linemod", data_root, pairs_dir, batch_size=EVAL_PAIRS_PER_BATCH,
                             max_pairs=EVAL_PAIRS_PER_BATCH, progress=False, mesh=mesh)  # warm
            records.clear()
            batches.clear()
            dist.barrier()
            _, ms, launches, _ = counted_run(counters, lambda: evaluate_dataset(
                models, "linemod", data_root, pairs_dir, batch_size=EVAL_PAIRS_PER_BATCH, progress=False,
                mesh=mesh))
        finally:
            runner.dispatch_pairs, runner.finish_pairs = dispatch, finish
        row.update(ms=ms, launches=launches, launches_per_batch=list(batches))
        if rank == 0:
            torch.save(list(records), tmp / "dp_records.pt")
        from pope_tpu_torch.eval import DATASETS, iter_pairs, load_manifest

        spec = DATASETS["linemod"]
        paths = list(iter_pairs(data_root, spec, load_manifest(pairs_dir, spec)))[:EVAL_PAIRS_PER_BATCH]
        one = lambda: runner.run_pairs(models, paths, spec, mesh=mesh)
        dist.barrier()
        row["batch_ms"] = statistics.median(timed_runs(one, 3))
        dist.barrier()
        prof = profile_call(one, row["batch_ms"])
        row["profile"] = {k: prof[k] for k in ("device_busy_ms", "kernel_launches", "idle_share")}
        del models
        return row

    def matcher_run(key, tp, seed, fault=None):
        """One sharded step from the seeded state on batch `seed`, with one
        of PAR_FAULTS planted or none; rank 0 writes its full gradients,
        statistics, metrics and ReLU counts to matcher_<key>.pt."""
        from pope_tpu_torch.models.matcher import backbone
        from pope_tpu_torch.parallel import collectives

        m = make_mesh(PAR_RANKS, tp=tp)
        state = _par_matcher()
        shard_params_tp(m, state.model, optimizer=state.optimizer)
        batch = shard_batch(m, train_batch(planar_items(seed, TRAIN_B), DEV))
        saved = backbone.batch_statistics_over, collectives.all_reduce_grads_
        if fault == "per_rank_batch_norm":
            backbone.batch_statistics_over = lambda total, parts: contextlib.nullcontext()
        elif fault == "unsummed_grads":
            collectives.all_reduce_grads_ = lambda params, group=None, average=False: None
        elif fault is not None:
            raise ValueError(fault)
        try:
            step = trainer.make_sharded_train_step(m)
            STATS.reset()
            t0 = time.perf_counter()
            with relu_positive_counts() as counts:
                metrics = {k: v.item() for k, v in step(state, batch).items()}
            first = {"ms": (time.perf_counter() - t0) * 1e3, "comm": STATS.snapshot()}
        finally:
            backbone.batch_statistics_over, collectives.all_reduce_grads_ = saved
        counts = torch.stack(counts).cpu()
        if tp == 1:
            counts = collectives.all_reduce(counts, m.get_group("dp"))
        grads = _full_grads(state.model)
        stats = {k: v.cpu().clone() for k, v in state.model.state_dict().items() if "running" in k}
        if rank == 0:
            torch.save({"grads": grads, "stats": stats, "metrics": metrics, "relu_positive": counts.tolist()},
                       tmp / f"matcher_{key}.pt")
        first["sharded_params"] = sum(getattr(p, "tp_sharded", False) for p in state.model.parameters())
        return state, step, batch, first

    def matcher_dp():
        row = {}
        for seed in PAR_SEEDS:
            state, step, batch, first = matcher_run(f"dp_{seed}", 1, seed)
            if seed == PAR_SEEDS[0]:
                STATS.reset()
                row["ms_per_step"] = _steps_ms(lambda: step(state, batch), PAR_TIMED_STEPS)
                row["comm_per_step"] = {k: v / PAR_TIMED_STEPS for k, v in STATS.snapshot().items()}
                row["sharded_params"] = first["sharded_params"]
            del state, step, batch
        for fault in PAR_FAULTS:
            matcher_run(f"fault_{fault}", 1, PAR_SEEDS[0], fault)
        return row

    def matcher_tp():
        # a tp step stages tens of GB through host memory: the compared
        # step's own wall time stands for the step's
        _, _, _, first = matcher_run(f"tp_{PAR_SEEDS[0]}", PAR_RANKS, PAR_SEEDS[0])
        return {"ms_per_step": first["ms"], "comm_per_step": first["comm"], "sharded_params": first["sharded_params"]}

    def ssl_part():
        m = make_mesh(PAR_RANKS, tp=1)
        arch, state, batch = _par_ssl()
        row = {"state_bytes_replicated": ssl_state_bytes(state)}
        shard_ssl_state(state, m)
        row["state_bytes_sharded"] = ssl_state_bytes(state)
        row["fsdp_leaves"] = len(state.fsdp.names)
        local = shard_ssl_batch(m, batch)
        step = make_sharded_ssl_step(arch, m, mults=arch.multipliers(state))
        (metrics, grads), _, launches, by_design = counted_run(
            counters, lambda: _ssl_step_capture(arch, state, local, step))
        row.update(metrics=metrics, launches=launches, by_design=by_design,
                   centers=[state.dino_center.cpu().clone(), state.ibot_center.cpu().clone()])
        if rank == 0:
            torch.save({"grads": grads, "centers": row.pop("centers")}, tmp / "ssl_dp.pt")
        else:
            row.pop("centers")
        STATS.reset()
        row["ms_per_step"] = _steps_ms(lambda: step(state, local), PAR_TIMED_STEPS)
        row["comm_per_step"] = {k: v / PAR_TIMED_STEPS for k, v in STATS.snapshot().items()}
        return row

    def pp_part():
        m = DeviceMesh("cpu", torch.arange(PAR_RANKS), mesh_dim_names=("pp",))
        stages, x, y = _pp_inputs(DEV)
        stacked = stack_stage_params(stages)
        mse = lambda o, t: ((o - t) ** 2).mean()
        fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
        run = pipeline_loss_and_grad(fn, mse, m, "pp")
        local = shard_stage_params(stacked, m, "pp")
        loss, grads = run(local, x, y)
        ref = {k: v.clone().requires_grad_(True) for k, v in stacked.items()}
        h = x
        for s in range(PAR_RANKS):
            h = fn({k: v[s] for k, v in ref.items()}, h)
        ref_loss = mse(h, y)
        ref_loss.backward()
        errs = {k: ((g[0] - ref[k].grad[rank]).abs().max() / ref[k].grad[rank].abs().max()).item()
                for k, g in grads.items()}
        row = {"loss": loss.item(), "serial_loss": ref_loss.item(), "grad_rel_err": errs}
        row["ms"] = _steps_ms(lambda: run(local, x, y), 3)
        return row

    def ring_part():
        m = DeviceMesh("cpu", torch.arange(PAR_RANKS), mesh_dim_names=("sp",))
        q, k, v = _ring_inputs(DEV)
        n = RING_TOKENS // PAR_RANKS
        rows = slice(rank * n, (rank + 1) * n)
        ql, kl, vl = (t[:, rows].clone().requires_grad_(True) for t in (q, k, v))
        attn = ring_attention(m, "sp")
        o = attn(ql, kl, vl)
        (o ** 2).sum().backward()
        qf, kf, vf = (t.clone().requires_grad_(True) for t in (q, k, v))
        ref = torch.softmax(qf @ kf.transpose(-1, -2) / SAM_H_HEAD_DIM ** 0.5, dim=-1) @ vf
        (ref ** 2).sum().backward()
        row = {"out": check_close("ring attention", o.detach(), ref.detach()[:, rows], TOL_SSL_KERNEL)}
        for name, a, b in (("dq", ql, qf), ("dk", kl, kf), ("dv", vl, vf)):
            row[name] = check_close(f"ring attention {name}", a.grad, b.grad[:, rows], TOL_SSL_KERNEL)
        with torch.no_grad():
            row["ms"] = _steps_ms(lambda: attn(ql, kl, vl), 3)
            row["plain_ms"] = _steps_ms(lambda: torch.softmax(q @ k.transpose(-1, -2) / SAM_H_HEAD_DIM ** 0.5, -1) @ v, 3)
        return row

    part("eval", eval_part)
    part("matcher_dp", matcher_dp)
    part("matcher_tp", matcher_tp)
    part("ssl_dp", ssl_part)
    part("gpipe", pp_part)
    part("ring", ring_part)
    torch.save(out, tmp / f"rank{rank}.pt")


def _worst(errs: dict, i: int = 0, n: int = 5) -> list:
    return sorted(([k, e[i]] for k, e in errs.items()), key=lambda kv: -kv[1])[:n]


def _rel_to_norm(got: dict, want: dict) -> dict:
    """Per parameter: the largest gradient error over the tensor's largest
    |gradient|, and the error's norm over the gradient's norm."""
    out = {}
    for k, w in want.items():
        if w is None:
            continue
        d = got[k] - w
        out[k] = ((d.abs().max() / w.abs().max().clamp(min=1e-30)).item(),
                  (d.norm() / w.norm().clamp(min=1e-30)).item())
    return out


def matcher_step_readings(got: dict, ref: dict) -> dict:
    """A sharded matcher step's readings against the single step's, and
    whether they pass: the loss terms, the ReLU flips (at least), the
    gradients (of each tensor's largest and norm) and the BatchNorm
    running statistics (of each tensor's largest)."""
    errs = _rel_to_norm(got["grads"], ref["grads"])
    flips = (sum(abs(a - b) for a, b in zip(got["relu_positive"], ref["relu_positive"]))
             if len(got["relu_positive"]) == len(ref["relu_positive"]) else None)
    r = {"loss_rel_err": max(abs(got["metrics"][k] - v) / abs(v) for k, v in ref["metrics"].items()),
         "relu_flips_at_least": flips,
         "grad_max_rel_to_largest": max(e[0] for e in errs.values()), "grad_worst_rel_to_largest": _worst(errs),
         "grad_max_rel_to_norm": max(e[1] for e in errs.values()),
         "bn_stats_rel_err": max(((got["stats"][k] - v).abs().max() / v.abs().max()).item()
                                 for k, v in ref["stats"].items())}
    grads_ok = (r["grad_max_rel_to_largest"] <= TOL_PAR_GRAD if flips == 0
                else r["grad_max_rel_to_norm"] <= TOL_PAR_GRAD_FLIP)
    r["ok"] = (flips is not None and grads_ok and r["loss_rel_err"] <= TOL_TRAIN_LOSS
               and r["bn_stats_rel_err"] <= TOL_PAR_STATS)
    return r


def _run_drift(got: dict, want: dict, lr: float, steps: int) -> dict:
    """A matcher checkpoint payload against another: the largest weight
    difference over the Adam bound (2 lr a step), the BatchNorm statistics'
    largest difference of each tensor's largest, the moments' difference of
    each tensor's norm."""
    weights = max((got["model"][k] - v).abs().max().item() for k, v in want["model"].items() if "running" not in k)
    stats = max(((got["model"][k] - v).abs().max() / v.abs().max().clamp(min=1e-30)).item()
                for k, v in want["model"].items() if "running" in k)
    moments = max(((got["optimizer"]["state"][i][m] - st[m]).norm() / st[m].norm()).item()
                  for i, st in want["optimizer"]["state"].items() for m in ("exp_avg", "exp_avg_sq"))
    return {"weights_over_adam_bound": weights / (2 * lr * steps), "stats_rel": stats, "moments_rel_to_norm": moments,
            "shapes_equal": all(got["model"][k].shape == v.shape for k, v in want["model"].items())}


def matcher_cli_runs(tmp: Path):
    """`cli train-matcher` at --dp 1 (this process), --dp 2 and --tp 2 (two
    ranks each) on a ScanNet-layout scene: one step an epoch, one epoch with
    checkpoints, then --resume to two. Each parallel run's history and last
    checkpoint are held against the --dp 1 run's. Returns (row, failures)."""
    from pope_tpu_torch import cli
    from pope_tpu_torch.utils.checkpoint import load_payload

    paths = write_scannet_scene(tmp / "scans", n_frames=4, shift_px=40)
    runs = {}
    for name, extra in (("dp1", []), ("dp2", ["--dp", "2"]), ("tp2", ["--tp", "2"])):
        ckpt, hist = tmp / f"matcher_ckpt_{name}", tmp / f"matcher_history_{name}.json"
        base = ["train-matcher", "--data-source", "scannet", "--data-root", paths["data_root"],
                "--train-npz", paths["train_npz"], "--val-npz", paths["val_npz"],
                "--intrinsic-path", paths["intrinsic_path"], *PAR_CLI_MATCHER, "--ckpt-dir", str(ckpt),
                "--history-out", str(hist), *extra]
        r = {}
        for part, more in (("epoch_1", ["--epochs", "1"]), ("resume_2", ["--epochs", "2", "--resume"])):
            t0 = time.perf_counter()
            cli.main(base + more)
            r[part] = {"wall_s": time.perf_counter() - t0, "history": json.loads(hist.read_text())}
        r["index"] = json.loads((ckpt / "index.json").read_text())
        r["dirs"] = sorted(os.listdir(ckpt))
        r["last"] = load_payload(str(ckpt / "last"), "cpu")
        torch.cuda.empty_cache()
        runs[name] = r
    lr = 6e-3 * 2 / 64  # TrainMatcherConfig's canonical lr at the global batch of 2
    row, failures = {}, []
    want = runs["dp1"]
    for name, r in runs.items():
        out = {part: {"wall_s": r[part]["wall_s"], "epochs": [h["epoch"] for h in r[part]["history"]],
                      "train_loss": [h["train_loss"] for h in r[part]["history"]]}
               for part in ("epoch_1", "resume_2")}
        out["index_epoch"], out["dirs"], out["step"] = r["index"]["epoch"], r["dirs"], r["last"]["step"]
        best = {b["name"] for b in r["index"]["best"]}
        ok = (out["epoch_1"]["epochs"] == [0] and out["resume_2"]["epochs"] == [1] and out["index_epoch"] == 2
              and out["step"] == 2 and set(r["dirs"]) == best | {"index.json", "last"})
        if name != "dp1":
            out["train_loss_rel_err"] = max(abs(a - b) / abs(b) for part in ("epoch_1", "resume_2") for a, b in
                                            zip(out[part]["train_loss"], row["dp1"][part]["train_loss"]))
            out["against_dp1"] = _run_drift(r["last"], want["last"], lr, 2)
            d = out["against_dp1"]
            # Adam's bias-corrected ratio reaches 1.0013 at step 2: 1% of slack
            ok = ok and (out["train_loss_rel_err"] <= TOL_PAR_RUN_LOSS and d["shapes_equal"]
                         and d["weights_over_adam_bound"] <= 1.01 and d["stats_rel"] <= TOL_PAR_RUN_STATS
                         and d["moments_rel_to_norm"] <= TOL_PAR_RUN_MOMENTS)
        out["ok"] = ok
        row[name] = out
        if not ok:
            failures.append(f"cli train-matcher {name}: {out}")
    print(json.dumps({"parallel_cli_train_matcher": row}), flush=True)
    return row, failures


def _ssl_cli_process(args: list, log: Path) -> subprocess.Popen:
    """`python -m pope_tpu_torch.cli <args>` from the checkout, in a session
    of its own (its ranks die with it), output to `log`."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "pope_tpu_torch.cli", *args], stdout=f,
                                stderr=subprocess.STDOUT, cwd=Path(__file__).resolve().parent, start_new_session=True)


def _kill(proc: subprocess.Popen) -> None:
    import signal

    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def ssl_cli_runs(tmp: Path):
    """`cli train-ssl` at its defaults for SSL_CLI_STEPS steps, a checkpoint
    every SSL_CLI_CKPT_EVERY: at --dp 1 in this process; at --dp 2 started
    as a command, killed once its first checkpoint is written, then resumed
    (two ranks), its last checkpoint held against --dp 1's; and at
    --distributed, two commands of one rank each (a coordinator on
    localhost, each rank its own batch stream) for SSL_CLI_CKPT_EVERY
    steps. Returns (row, failures)."""
    from pope_tpu_torch import cli
    from pope_tpu_torch.parallel.launch import free_port
    from pope_tpu_torch.utils.checkpoint import load_payload

    images = tmp / "ssl_images"
    write_ssl_images(images, 24)
    base = ["train-ssl", "--image-root", str(images), "--total-steps", str(SSL_CLI_STEPS),
            "--ckpt-every", str(SSL_CLI_CKPT_EVERY)]
    row, failures = {}, []
    a, b, c = tmp / "ssl_dp1", tmp / "ssl_dp2", tmp / "ssl_distributed"
    t0 = time.perf_counter()
    cli.main(base + ["--ckpt-dir", str(a)])
    row["dp1_wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = _ssl_cli_process(base + ["--dp", "2", "--ckpt-dir", str(b)], tmp / "ssl_dp2_killed.log")
    sidecar, deadline, seen = b / "sampler.json", time.monotonic() + 300, None
    while proc.poll() is None and time.monotonic() < deadline:
        with contextlib.suppress(OSError, ValueError):
            seen = json.loads(sidecar.read_text()).get("consumed_batches")
        if seen == SSL_CLI_CKPT_EVERY:
            break
        time.sleep(0.05)
    _kill(proc)
    row["dp2_killed"] = {"wall_s": time.perf_counter() - t0, "returncode": proc.returncode,
                         "dirs": sorted(os.listdir(b)) if b.exists() else []}
    t0 = time.perf_counter()
    cli.main(base + ["--dp", "2", "--ckpt-dir", str(b)])
    row["dp2_resumed_wall_s"] = time.perf_counter() - t0
    last = f"step_{SSL_CLI_STEPS:08d}"
    one, two = load_payload(str(a / last), "cpu"), load_payload(str(b / last), "cpu")
    mu = _named_np(one["mu"])
    row["dp2_against_dp1"] = {
        "steps": [one["step"], two["step"]],
        "student": conditioned_diff(_named_np(two["student"]), _named_np(one["student"]), mu),
        "teacher": conditioned_diff(_named_np(two["teacher"]), _named_np(one["teacher"]), mu),
        "mu_rel_to_largest": max(float(np.abs(v - mu[k]).max() / max(np.abs(mu[k]).max(), 1e-30))
                                 for k, v in _named_np(two["mu"]).items()),
        "sampler": [json.loads((d / "sampler.json").read_text()) for d in (a, b)]}
    lr = ssl_cli_args().lr
    d = row["dp2_against_dp1"]
    if not (row["dp2_killed"]["returncode"] == -9
            and row["dp2_killed"]["dirs"] == ["sampler.json", f"step_{SSL_CLI_CKPT_EVERY:08d}"]
            and d["steps"] == [SSL_CLI_STEPS, SSL_CLI_STEPS] and d["sampler"][0] == d["sampler"][1]
            and d["mu_rel_to_largest"] <= TOL_PAR_RUN_SSL_MU
            and all(d[k]["all"] <= 2 * lr * SSL_CLI_STEPS for k in ("student", "teacher"))):
        failures.append(f"cli train-ssl --dp 2, killed and resumed, against --dp 1: {row}")

    t0 = time.perf_counter()
    port = free_port()
    dist_args = ["train-ssl", "--image-root", str(images), "--total-steps", str(SSL_CLI_CKPT_EVERY),
                 "--ckpt-every", str(SSL_CLI_CKPT_EVERY), "--ckpt-dir", str(c), "--distributed",
                 "--coordinator", f"localhost:{port}", "--num-processes", "2"]
    procs = [_ssl_cli_process(dist_args + ["--process-id", str(r)], tmp / f"ssl_distributed_{r}.log")
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            _kill(p)
    logs = [(tmp / f"ssl_distributed_{r}.log").read_text() for r in range(2)]
    dist_row = {"wall_s": time.perf_counter() - t0, "returncodes": rcs,
                "launch": [line for line in logs[0].splitlines() if "[pope_tpu_torch.parallel]" in line],
                "dirs": sorted(os.listdir(c)) if c.exists() else []}
    if rcs == [0, 0]:
        payload = load_payload(str(c / f"step_{SSL_CLI_CKPT_EVERY:08d}"), "cpu")
        dist_row["step"] = payload["step"]
        dist_row["finite"] = all(torch.isfinite(v).all().item() for v in payload["student"].values())
        dist_row["sampler"] = json.loads((c / "sampler.json").read_text())
    row["distributed"] = dist_row
    if not (rcs == [0, 0] and dist_row["step"] == SSL_CLI_CKPT_EVERY and dist_row["finite"]
            and dist_row["sampler"]["world"] == 2 and dist_row["sampler"]["per_host_batch"] == SSL_B // 2):
        failures.append(f"cli train-ssl --distributed: {dist_row}; logs: {[log[-2000:] for log in logs]}")
    print(json.dumps({"parallel_cli_train_ssl": row}, default=str), flush=True)
    return row, failures


def run_parallel_phase(counters, per_batch_counts, held: list) -> dict:
    """The parallel layer on the one card: two ranks (gloo, every collective
    staged through pinned host memory) against the single-process results:
    eval --dp 2 at full width (bench configs, PAR_EVAL_PAIRS pairs, global
    B = 4), the matcher's step at dp 2 and at tp 2 and the SSL step at dp 2
    with an FSDP-cut state (each one step against the single step, then
    timed), GPipe at pp = 2 and ring attention at sp = 2 (each rank against
    its own serial / one-softmax result). Every rank's eval batch must launch
    each kernel per_batch_counts times. `held` holds the eval phase's bench
    models, which are taken out and dropped before the ranks start."""
    from pope_tpu_torch import bench
    from pope_tpu_torch.eval import evaluate_dataset
    from pope_tpu_torch.parallel.launch import spawn
    from pope_tpu_torch.pipeline import runner
    from pope_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    models = held.pop()
    row = {"ranks": PAR_RANKS, "card_count": torch.cuda.device_count()}
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        data_root, pairs_dir = bench.make_dataset(str(tmp / "data"), n_pairs=PAR_EVAL_PAIRS)
        records, finish = [], runner.finish_pairs

        def recording_finish(pending):
            recs = finish(pending)
            records.extend(recs)
            return recs

        evaluate = lambda n: evaluate_dataset(models, "linemod", data_root, pairs_dir,
                                              batch_size=EVAL_PAIRS_PER_BATCH, max_pairs=n, progress=False)
        evaluate(EVAL_PAIRS_PER_BATCH)  # warm
        runner.finish_pairs = recording_finish
        try:
            _, dp1_ms, _, _ = counted_run(counters, lambda: evaluate(PAR_EVAL_PAIRS))
        finally:
            runner.finish_pairs = finish
        single_records = list(records)
        del models
        torch.cuda.empty_cache()

        # the command itself (PipelineConfig()'s models): `cli eval` in this
        # process, then `cli eval --dp 2`, which starts its own two ranks
        from pope_tpu_torch import cli

        cli_row, cli_tables = {}, {}
        for dp in (1, PAR_RANKS):
            t0 = time.perf_counter()
            out_json = tmp / f"cli_dp{dp}.json"
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["eval", "--dataset", "linemod", "--data-root", data_root, "--pairs-dir", pairs_dir,
                          "--batch-size", str(EVAL_PAIRS_PER_BATCH), "--dp", str(dp), "--json-out", str(out_json)])
            cli_row[f"dp{dp}_wall_s"] = time.perf_counter() - t0
            cli_tables[dp] = json.loads(out_json.read_text())
        torch.cuda.empty_cache()

        # the single-process steps the ranks' steps are held against
        matcher_refs = {}
        for seed in PAR_SEEDS:
            state = _par_matcher()
            batch = train_batch(planar_items(seed, TRAIN_B), DEV)
            with relu_positive_counts() as counts:
                metrics = {k: v.item() for k, v in trainer.matcher_train_step(state, batch).items()}
            matcher_refs[seed] = {
                "metrics": metrics, "grads": _full_grads(state.model), "relu_positive": torch.stack(counts).cpu().tolist(),
                "stats": {k: v.cpu().clone() for k, v in state.model.state_dict().items() if "running" in k}}
            if seed == PAR_SEEDS[0]:
                single_ms = _steps_ms(lambda: trainer.matcher_train_step(state, batch), PAR_TIMED_STEPS)
            del state, batch
        torch.cuda.empty_cache()
        arch, sstate, sbatch = _par_ssl()
        step = lambda st, b: arch.train_step(st, b, mults=arch.multipliers(st))
        metrics, grads = _ssl_step_capture(arch, sstate, sbatch, step)
        ssl_ref = {"metrics": metrics, "grads": grads, "launches_per_step": 3 * arch.backbone_cfg.depth,
                   "centers": [sstate.dino_center.cpu().clone(), sstate.ibot_center.cpu().clone()],
                   "ms_per_step": _steps_ms(lambda: step(sstate, sbatch), PAR_TIMED_STEPS)}
        del arch, sstate, sbatch
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        spawn(par_rank, PAR_RANKS, argv=(str(tmp),), tp=1, device=DEV, timeout=900)
        row["ranks_wall_s"] = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(PAR_RANKS)]
        dp_records = torch.load(tmp / "dp_records.pt", weights_only=False)
        matcher_got = {k: torch.load(tmp / f"matcher_{k}.pt", weights_only=False)
                       for k in [f"dp_{s}" for s in PAR_SEEDS] + [f"tp_{PAR_SEEDS[0]}"]
                       + [f"fault_{f}" for f in PAR_FAULTS]}
        ssl_got = torch.load(tmp / "ssl_dp.pt", weights_only=False)
        cli_matcher, cli_matcher_failures = matcher_cli_runs(tmp)
        cli_ssl, cli_ssl_failures = ssl_cli_runs(tmp)
    row["backend"] = ranks[0]["backend"]

    failures = []
    # eval --dp 2
    ev = [r["eval"] for r in ranks]
    diffs = record_diffs(dp_records, single_records, TOL_EVAL_DEG)
    per_batch = dict(per_batch_counts)
    eval_row = {
        "pairs": PAR_EVAL_PAIRS, "global_batch": EVAL_PAIRS_PER_BATCH,
        "pairs_per_s_dp1": PAR_EVAL_PAIRS / dp1_ms * 1e3,
        "pairs_per_s_dp2": PAR_EVAL_PAIRS / max(e["ms"] for e in ev) * 1e3,
        "launches_per_batch_per_rank": [e["launches_per_batch"] for e in ev],
        "peak_memory_gb_per_rank": [e["peak_memory_gb"] for e in ev], "load_s_per_rank": [e["load_s"] for e in ev],
        "batch_ms_per_rank": [e["batch_ms"] for e in ev],
        "device_busy_ms_per_rank": [e["profile"]["device_busy_ms"] for e in ev],
        # kernels of two processes on one card take turns: the card's idle
        # share over one batch is what neither rank's kernels fill
        "card_idle_share": 1.0 - sum(e["profile"]["device_busy_ms"] for e in ev) / max(e["batch_ms"] for e in ev),
        "collective_ms_per_rank": [e["comm"]["ms"] for e in ev],
        "staged_bytes_per_rank": [e["comm"]["staged_bytes"] for e in ev],
        "records": len(dp_records), "record_diffs": diffs,
        "ok": [r["ok"] for r in dp_records], "pre_bbox": [r["pre_bbox"] for r in dp_records],
    }
    table_diffs = [(obj, k) for obj, t in cli_tables[1].items() for k, v in t.items()
                   if not abs(cli_tables[PAR_RANKS].get(obj, {}).get(k, float("nan")) - v)
                   <= (TOL_EVAL_DEG if k.endswith("Err") else 1e-3)]
    eval_row["cli"] = cli_row | {"table_diffs": table_diffs}
    print(json.dumps({"parallel_eval": eval_row}, default=str), flush=True)
    if diffs or len(dp_records) != PAR_EVAL_PAIRS:
        failures.append(f"eval --dp 2 records differ from the single run's: {diffs}")
    if table_diffs or list(cli_tables[PAR_RANKS]) != list(cli_tables[1]):
        failures.append(f"cli eval --dp 2: its tables differ from cli eval's at {table_diffs}")
    for e in ev:
        if e["launches_per_batch"] != [per_batch] * (PAR_EVAL_PAIRS // EVAL_PAIRS_PER_BATCH):
            failures.append(f"eval --dp 2 launches per batch {e['launches_per_batch']}, want {per_batch} each")

    # the matcher at dp 2 (PAR_SEEDS) and tp 2, and the planted faults
    readings = {k: matcher_step_readings(g, matcher_refs[int(k.split("_")[1]) if not k.startswith("fault")
                                                         else PAR_SEEDS[0]])
                for k, g in matcher_got.items()}
    matcher_rows = {}
    for key in ("dp", "tp"):
        got = [r[f"matcher_{key}"] for r in ranks]
        mrow = {"steps": {k: v for k, v in readings.items() if k.startswith(key)},
                "ms_per_step": [g["ms_per_step"] for g in got], "ms_per_step_single": single_ms,
                "peak_memory_gb_per_rank": [g["peak_memory_gb"] for g in got],
                "collective_ms_per_step": [g["comm_per_step"]["ms"] for g in got],
                "staged_bytes_per_step": [g["comm_per_step"]["staged_bytes"] for g in got],
                "tp_sharded_params": [g["sharded_params"] for g in got]}
        if key == "dp":
            mrow["planted_faults"] = {k: v for k, v in readings.items() if k.startswith("fault")}
        matcher_rows[key] = mrow
        print(json.dumps({f"parallel_matcher_{key}": mrow}), flush=True)
    for k, r in readings.items():
        if k.startswith("fault") == r["ok"]:
            failures.append(f"matcher step {k}: " + ("the check missed the planted fault" if r["ok"] else
                                                     "against the single step") + f": {r}")
    matcher_rows["cli"] = cli_matcher
    failures += cli_matcher_failures

    # SSL at dp 2, FSDP state
    got = [r["ssl_dp"] for r in ranks]
    errs = _rel_to_norm(ssl_got["grads"], ssl_ref["grads"])
    loss_err = max(abs(g["metrics"][k] - v) / max(abs(v), 1e-6) for g in got for k, v in ssl_ref["metrics"].items())
    center_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                     for a, b in zip(ssl_got["centers"], ssl_ref["centers"]))
    want_launches = {"flash_attention": ssl_ref["launches_per_step"], "flash_attention_relpos": 0,
                     "windowed_attention_relpos": 0}
    bf16 = lambda k: k.startswith(("dino_head.mlp_", "ibot_head.mlp_"))  # the heads' MLPs (head_dtype bfloat16)
    srow = {"loss_rel_err": loss_err, "center_rel_err": center_err,
            "grad_max_rel_to_largest": max(e[0] for k, e in errs.items() if not bf16(k)),
            "grad_max_rel_to_largest_bf16_heads": max(e[0] for k, e in errs.items() if bf16(k)),
            "grad_worst_rel_to_largest": _worst(errs),
            "ms_per_step": [g["ms_per_step"] for g in got], "ms_per_step_single": ssl_ref["ms_per_step"],
            "peak_memory_gb_per_rank": [g["peak_memory_gb"] for g in got],
            "state_bytes_per_rank": [g["state_bytes_sharded"] for g in got],
            "state_bytes_replicated": got[0]["state_bytes_replicated"], "fsdp_leaves": got[0]["fsdp_leaves"],
            "launches_per_rank": [g["launches"] for g in got], "by_design_per_rank": [g["by_design"] for g in got],
            "collective_ms_per_step": [g["comm_per_step"]["ms"] for g in got],
            "staged_bytes_per_step": [g["comm_per_step"]["staged_bytes"] for g in got]}
    print(json.dumps({"parallel_ssl_dp": srow}), flush=True)
    if (loss_err > TOL_SSL_LOSS or center_err > TOL_SSL_LOSS or srow["grad_max_rel_to_largest"] > TOL_SSL_MOMENTS
            or srow["grad_max_rel_to_largest_bf16_heads"] > TOL_PAR_BF16):
        failures.append(f"SSL dp step against the single step: {srow}")
    if any(g["launches"] != want_launches for g in got):
        failures.append(f"SSL dp launches per rank {srow['launches_per_rank']}, want {want_launches}")

    # GPipe and ring attention
    pp = [r["gpipe"] for r in ranks]
    pp_row = {"loss": [p["loss"] for p in pp], "serial_loss": pp[0]["serial_loss"],
              "grad_rel_err": [p["grad_rel_err"] for p in pp], "ms": [p["ms"] for p in pp],
              "shape": {"stages": PAR_RANKS, "micro": PP_MICRO, "rows": PP_MB, "width": PP_D}}
    print(json.dumps({"parallel_gpipe": pp_row}), flush=True)
    if any(abs(p["loss"] - p["serial_loss"]) > TOL_PP * abs(p["serial_loss"]) or
           max(p["grad_rel_err"].values()) > TOL_PP for p in pp):
        failures.append(f"GPipe against the serial composition: {pp_row}")
    ring_row = {"per_rank": [r["ring"] for r in ranks],
                "shape": [SAM_H_HEADS, RING_TOKENS, SAM_H_HEAD_DIM], "dtype": "float32"}
    print(json.dumps({"parallel_ring": ring_row}, default=str), flush=True)

    srow["cli"] = cli_ssl
    failures += cli_ssl_failures
    row.update(eval=eval_row, matcher=matcher_rows, ssl=srow, gpipe=pp_row, ring=ring_row,
               wall_s=time.perf_counter() - t_phase)
    print(json.dumps({"parallel_phase": {k: row[k] for k in ("ranks", "card_count", "backend", "ranks_wall_s",
                                                              "wall_s")}}), flush=True)
    if failures:
        raise AssertionError("parallel phase: " + "; ".join(failures))
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
    eval_phase, *held = run_eval_phase(counters, launches)
    quant = run_quant_phase(counters, held[0])
    parallel = run_parallel_phase(counters, launches, held)
    train = run_train_phase(counters)
    export_phase = run_export_phase(counters)
    regressor = run_regressor_phase(counters)
    ssl = run_ssl_phase(counters, ex2_per_s())
    nvs = run_nvs_phase(counters)

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
        entry["ssl_launches"] = {"train_step": ssl["launches_per_step"][name],
                                 "extract_cls_features_batch": ssl["eval"]["launches_per_batch"][name]}
        entry["nvs_launches"] = nvs["launches"][name]
        entry["int8_launches"] = {
            "encoder_forward": quant["encoder"]["int8"]["launches"][name],
            "eval_per_batch": quant["eval"]["int8"]["launches"][name] // QUANT_EVAL_BATCHES,
            "no_rel_pos_depth2_forward": quant["card_vs_cpu"]["no_rel_pos_bf16"]["launches"][name]}
        entry["dp2_eval_launches_per_batch_per_rank"] = [
            [b[name] for b in rank] for rank in parallel["eval"]["launches_per_batch_per_rank"]]
        if name == "flash_attention":  # the SSL step's f32 shapes, the tf32x3 design
            for key, n_tokens in (("ssl_n257", 257), ("ssl_n50", 50)):
                r = ssl["kernel_rows"][key]
                entry[key] = {k: r[k] for k in timing + ("previous_ms", "design")} | {
                    "source": r["source"], "launches_per_step": ssl["flash_attention_by_tokens_per_step"][n_tokens]}
        f32 = kernels.get(f"{name}_f32")
        if f32 is not None:  # kernels 1 and 2 in float32 (the f32 SAM configs), the tf32x3 design
            entry["f32"] = {k: f32[k] for k in timing + ("previous_ms", "design", "source")}
        if name == "flash_attention":  # SAM's widths, d 80: the bias-free encoder's two shapes
            for key in ("n196", "n3072"):
                r = quant["d80"][key]
                entry[f"d80_{key}"] = {k: r[k] for k in timing} | {"source": r["source"], "design": r["design"]}
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
        "quant": quant,
        "train": train,
        "export": export_phase,
        "regressor": regressor,
        "ssl": ssl,
        "nvs": nvs,
        "parallel": parallel,
        "summary": summary,
    }, indent=1))

    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
