#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: print the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from pope_tpu_torch/csrc with nvcc;
  3. kernels: each ported kernel at the shapes SAM ViT-H's AMG program gives
     it (B=4 640x480 frames, rect 48x64 token grid), held against its plain
     PyTorch version, and timed beside the plain version, the bound of the
     card and one library call (SDPA with a materialised bias mask);
  4. reference: a small SAM (ViT-H width, 2 blocks, f32) encodes and decodes
     on the card and on the CPU, where the port runs its plain versions
     (which the CPU test suite holds against pope_tpu); the two must agree;
  5. main path: load_models(sam_type="h") with seeded weights and
     AutomaticMaskGenerator.generate_boxes_batch on four 640x480 frames,
     with the kernels' launch counts read around the first run; then once
     more with the filters open.
The last three lines are the `kernels` JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}. A copy of the results, the full profile
included, goes to build/chip_smoke.json (gitignored).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
# kernel vs plain in bf16, scaled to the output: the outputs are softmax
# averages of v ~ N(0, 1) over N keys, so their size falls with N (rms about
# 0.15 at N = 196, 0.04 at N = 3072). The largest error may be a few bf16 ulps
# of the largest output (the windowed body rounds its softmax weights before
# normalising, the plain version after); the rms error is rounding noise, well
# under 1% of the rms output. A kernel that dropped one 64-key tile of 3072
# would miss both by several times.
TOL_MAX_REL = 2.5e-2  # max |out - ref| / max |ref|
TOL_RMS_REL = 1e-2  # rms(out - ref) / rms(ref)
TOL_F32 = 1e-3  # small SAM on the card vs on the CPU, f32, outputs O(1)

SOURCE = "pope_tpu_torch/csrc/attention_relpos.cu"


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(name, replaces, kernel, plain, library, args, reps, nbytes, flops):
    out = kernel(*args)
    ref = plain(*args).float()
    diff = out.float() - ref
    err = diff.abs().max().item()
    rms_err = diff.square().mean().sqrt().item()
    ref_max, ref_rms = ref.abs().max().item(), ref.square().mean().sqrt().item()
    torch.cuda.synchronize()
    del out, ref, diff
    if not (err <= TOL_MAX_REL * ref_max and rms_err <= TOL_RMS_REL * ref_rms):
        raise AssertionError(
            f"{name}: kernel vs plain max abs err {err} (limit {TOL_MAX_REL} x {ref_max}), "
            f"rms err {rms_err} (limit {TOL_RMS_REL} x {ref_rms})"
        )
    ms = cuda_ms(lambda: kernel(*args), reps)
    plain_ms = cuda_ms(lambda: plain(*args), max(2, reps // 5), warmup=1)
    library_ms = cuda_ms(library, reps)
    bound_ms, bound_by = bound(nbytes, flops)
    row = {
        "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
        "max_abs_err": err, "rms_err": rms_err, "ref_max_abs": ref_max, "ref_rms": ref_rms,
        "tol": {"max_rel": TOL_MAX_REL, "rms_rel": TOL_RMS_REL},
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "bytes": nbytes, "flops": flops, "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
    }
    print(json.dumps({"kernel_phase": row}), flush=True)
    return row


def run_kernel_phases():
    from pope_tpu_torch.ops.flash_attention import flash_attention_relpos, flash_attention_relpos_plain
    from pope_tpu_torch.ops.window_attention import (
        windowed_attention_relpos,
        windowed_attention_relpos_plain,
    )

    F = torch.nn.functional
    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
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
    rows["windowed_attention_relpos"] = kernel_phase(
        "windowed_attention_relpos", "pope_tpu/ops/window_attention.py:80",
        windowed_attention_relpos, windowed_attention_relpos_plain,
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        args, reps=20,
        nbytes=2 * (qkv.numel() + rel_h.numel() + rel_w.numel() + BW * N * C),
        flops=4.0 * BW * nh * N * N * d,
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
        "flash_attention_relpos", "pope_tpu/ops/flash_attention.py:140",
        flash_attention_relpos, flash_attention_relpos_plain,
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
        args, reps=5,
        nbytes=2 * (qkv.numel() + rel_h.numel() + rel_w.numel() + B * N * C),
        flops=4.0 * B * nh * N * N * d,
    )
    del qkv, rel_h, rel_w, q, k, v, mask
    torch.cuda.empty_cache()
    return rows


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
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "magma")):
        return "gemm"
    if "conv" in n or "cudnn" in n:
        return "conv"
    if "layer_norm" in n:
        return "layer_norm"
    if "copy" in n or "catarray" in n:
        return "copy/cast/cat"
    if "reduce" in n or "sort" in n or "scan" in n:
        return "reduce/sort/scan"
    return "other elementwise"


def stage_times(amg, imgs) -> dict:
    """Wall ms of each stage of one generate_boxes_batch call, with a device
    sync around each: the encoder (resize, preprocess, ViT), the decoder (all
    prompt chunks), the filters + NMS + capacity cut (the rest of
    _generate_impl) and the small-region cleanup."""
    from pope_tpu_torch.models.sam import amg as amg_module

    acc = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    cleanup = amg_module.postprocess_small_regions_device
    amg._encode = timed("encode", amg._encode)
    amg._generate_impl = timed("generate", amg._generate_impl)
    amg.sam.decode = timed("decode", amg.sam.decode)
    amg_module.postprocess_small_regions_device = timed("cleanup", cleanup)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amg.generate_boxes_batch(imgs)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        del amg._encode, amg._generate_impl, amg.sam.decode
        amg_module.postprocess_small_regions_device = cleanup
    return {"encode": acc["encode"], "decode": acc["decode"],
            "filters_nms_cut": acc["generate"] - acc["decode"],
            "cleanup": acc.get("cleanup", 0.0), "total": total}


def run_main_path(counters):
    from pope_tpu_torch.models.sam import AutomaticMaskGenerator
    from pope_tpu_torch.pipeline import load_models

    t0 = time.perf_counter()
    models = load_models(components=("sam",), sam_type="h", seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imgs = frames(3)
    amg = models.amg
    enc = models.sam.config.encoder
    n_global = len(enc.global_attn_indexes)
    per_forward = {"windowed_attention_relpos": enc.depth - n_global, "flash_attention_relpos": n_global}

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    boxes, valid, n_dropped = amg.generate_boxes_batch(imgs)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != per_forward:
        raise AssertionError(f"launches {launches} != {per_forward} for one encoder forward")
    B, cap = imgs.shape[0], amg.cfg.mask_capacity
    if (tuple(boxes.shape), tuple(valid.shape), tuple(n_dropped.shape)) != ((B, cap, 4), (B, cap), (B,)):
        raise AssertionError(f"shapes {boxes.shape} {valid.shape} {n_dropped.shape}")
    if not torch.isfinite(boxes).all():
        raise AssertionError("non-finite boxes")

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        amg.generate_boxes_batch(imgs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    total = {name: fn.launches for name, fn in counters.items()}
    if total != {k: 4 * v for k, v in per_forward.items()}:
        raise AssertionError(f"launch counts over 4 runs: {total}")
    peak = torch.cuda.max_memory_allocated()

    # the same weights with the filters open: NMS, the top-64 cut and the
    # small-region cleanup see full candidate sets
    open_cfg = dataclasses.replace(amg.cfg, pred_iou_thresh=float("-inf"), stability_score_thresh=0.0)
    amg_open = AutomaticMaskGenerator(models.sam, open_cfg)
    t0 = time.perf_counter()
    ob, ov, od = amg_open.generate_boxes_batch(imgs)
    torch.cuda.synchronize()
    open_ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(ob).all():
        raise AssertionError("non-finite boxes (filters open)")

    # where the time goes in one batch, by CUDA kernel
    from torch.profiler import ProfilerActivity, profile

    # (the profiler's own cost inflates the traced run's wall time, so the
    # idle share is taken against the untraced median)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        amg.generate_boxes_batch(imgs)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    # the PyTorch ops that launched those kernels (self device time: kernels
    # launched by the op itself, not by the ops it calls)
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    top_ops = [
        {"op": e.key, "device_ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]
    ]

    row = {
        "model": "sam_vit_h (seeded random weights)", "frames": list(imgs.shape),
        "load_s": load_s, "first_ms": first_ms, "ms_per_batch": times,
        "median_ms_per_batch": statistics.median(times), "peak_bytes": peak,
        "launches_per_forward": launches, "valid": valid.sum(1).tolist(),
        "n_dropped": n_dropped.tolist(), "open_filters": {
            "ms": open_ms, "valid": ov.sum(1).tolist(), "n_dropped": od.tolist(),
        },
        "stages_ms": stage_times(amg, imgs),
        "profile": {"device_busy_ms": busy_ms, "kernel_launches": sum(e.count for e in kernels),
                    "idle_share": 1.0 - busy_ms / statistics.median(times),
                    "by_category": by_category, "top_kernels": top, "top_ops": top_ops},
    }
    print(json.dumps({"main_path": row}), flush=True)
    return row, launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; it runs on a CUDA card")
    from pope_tpu_torch.ops import cuda_kernels
    from pope_tpu_torch.ops.flash_attention import flash_attention_relpos
    from pope_tpu_torch.ops.window_attention import windowed_attention_relpos
    from pope_tpu_torch.utils.device import resolve_device

    resolve_device(None)  # full-f32 products and convs, as the port's entry points set
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"device": kind, "count": torch.cuda.device_count(),
                      "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)

    t0 = time.perf_counter()
    _, log = cuda_kernels.build()
    cuda_kernels.library()
    build_s = time.perf_counter() - t0
    if log is not None:  # freshly compiled: ptxas's registers and spills per kernel
        print(log, flush=True)
    print(json.dumps({"build_s": build_s, "cached": log is None}), flush=True)

    kernels = run_kernel_phases()
    reference = run_reference_phase()
    counters = {"windowed_attention_relpos": windowed_attention_relpos,
                "flash_attention_relpos": flash_attention_relpos}
    main_path, launches = run_main_path(counters)

    listed = []
    for name, row in kernels.items():
        listed.append({k: row[k] for k in ("name", "route", "source", "replaces")}
                      | {"launches": launches[name]}
                      | {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
                      | {"status": "ported"})
    not_ported = [{"name": "flash_attention", "replaces": "pope_tpu/ops/flash_attention.py:114",
                   "status": "not yet ported (off the main path)"}]
    summary = {"kernels": listed, "not_ported": not_ported}

    out = Path(__file__).resolve().parent / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "build_s": build_s, "kernels": kernels, "reference": reference,
        "main_path": main_path, "summary": summary,
    }, indent=1))

    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
