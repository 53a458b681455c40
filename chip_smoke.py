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
     sleep on the card, so the host's time per call does not enter it;
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
  8. eval driver: bench.py's configs at full width (pope_tpu_torch/bench.py:
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
The last three lines are the `kernels` JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}. A copy of the results, the full profiles
included, goes to build/chip_smoke.json (gitignored).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
    from pope_tpu_torch.ops.cuda_kernels import launch_attention, launch_attention_relpos
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

    # kernel 1: 28 windowed layers; 4 frames x 20 windows of 14x14, 16 heads, d=80
    BW, nh, d, ws = 80, 16, 80, 14
    N, C = ws * ws, nh * d
    qkv = torch.randn(BW, N, 3 * C, device=dev, generator=g).to(bf16)
    rel_h = (0.5 * torch.randn(BW, nh, N, ws, device=dev, generator=g)).to(bf16)
    rel_w = (0.5 * torch.randn(BW, nh, N, ws, device=dev, generator=g)).to(bf16)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(BW, N, 3, nh, d).unbind(2))
    mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(BW, nh, N, N)
    args = (qkv, rel_h, rel_w, nh, d, ws, ws)

    def windowed_stream(qkv, rel_h, rel_w, nh, d, hk, wk):
        return launch_attention_relpos(*_split_qkv(qkv, nh, d), rel_h, rel_w, hk, wk, "stream")

    rows["windowed_attention_relpos"] = kernel_phase(
        "windowed_attention_relpos", "pope_tpu/ops/window_attention.py:80", SHORT_SOURCE,
        windowed_attention_relpos, windowed_attention_relpos_plain,
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        args, reps=20,
        nbytes=2 * (qkv.numel() + rel_h.numel() + rel_w.numel() + BW * N * C),
        flops=4.0 * BW * nh * N * N * d, exps=BW * nh * N * N, ex2_rate=ex2_rate,
        previous=windowed_stream,
    )
    del qkv, rel_h, rel_w, q, k, v, mask

    # kernel 2: 4 global layers; 4 frames x 48x64 tokens, 16 heads, d=80
    B, H, W = 4, 48, 64
    N = H * W
    qkv = torch.randn(B, N, 3, nh, d, device=dev, generator=g).to(bf16)
    qn, kn, vn = qkv.unbind(2)
    rel_h = (0.5 * torch.randn(B, nh, N, H, device=dev, generator=g)).to(bf16)
    rel_w = (0.5 * torch.randn(B, nh, N, W, device=dev, generator=g)).to(bf16)
    mask = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, nh, N, N)
    q, k, v = (t.transpose(1, 2) for t in (qn, kn, vn))
    args = (qn, kn, vn, rel_h, rel_w, H, W)
    rows["flash_attention_relpos"] = kernel_phase(
        "flash_attention_relpos", "pope_tpu/ops/flash_attention.py:140", LONG_SOURCE,
        flash_attention_relpos, flash_attention_relpos_plain,
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        args, reps=10,
        nbytes=2 * (qkv.numel() + rel_h.numel() + rel_w.numel() + B * N * C),
        flops=4.0 * B * nh * N * N * d, exps=B * nh * N * N, ex2_rate=ex2_rate,
        previous=lambda *a: launch_attention_relpos(*a, "stream"),
    )
    del qkv, rel_h, rel_w, q, k, v, mask

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


def matcher_backbone_ms(matcher, prompts) -> dict:
    """Wall ms of the matcher backbone on the gray prompt frames as the port
    runs it (convs outside cuDNN) and with cuDNN's own algorithm choice, one
    call each after a warm-up call."""
    from pope_tpu_torch.pipeline.pose_pipeline import _rgb01_to_gray, _to_rgb01

    gray = _rgb01_to_gray(_to_rgb01(prompts))[..., None]
    out = {}
    with torch.no_grad():
        for name, fn in (("port", matcher.backbone), ("cudnn", matcher.backbone._forward)):
            fn(gray)
            out[name] = timed_runs(lambda: fn(gray), 1)[0]
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
                 "flash_attention": launches2["flash_attention"]}


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
    main_path, launches = run_main_path(counters)
    eval_phase = run_eval_phase(counters, launches)

    listed = []
    for name, row in kernels.items():
        listed.append({k: row[k] for k in ("name", "route", "source", "replaces")}
                      | {"launches": launches[name],
                         "eval_launches_per_batch": eval_phase["launches_per_batch"][0][name]}
                      | {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "previous_ms")}
                      | {"status": "ported"})
    summary = {"kernels": listed, "not_ported": []}

    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "build_s": build_s, "ptxas": ptxas, "kernels": kernels, "reference": reference,
        "stage2_reference": reference2, "solver": solver, "main_path": main_path, "eval": eval_phase,
        "summary": summary,
    }, indent=1))

    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
