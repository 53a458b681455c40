#!/usr/bin/env python3
"""What paces an SSL training step and a NeRF step on one NVIDIA GPU: the
card, the host's launches or the host's waits for the card.

    PYTHONPATH=. python3 pope_tpu_torch/tools/step_pace.py [--steps 10]

The SSL step runs at `cli train-ssl`'s defaults (ViT-S/14 in f32, batch 8,
2 x 224 + 8 x 98 crops, 65,536 prototypes, drop path 0.3) on one batch, the
NeRF step at `NerfConfig()` (2048 rays, 64 + 64 samples) on chip_smoke.py's
sphere views, its draws from a generator on the card and from one on the
CPU. For each, after two warm-up steps:
- step_ms: the median over --steps of one step's wall time, the card
  synchronized at its end only;
- parts_ms (SSL): the median of each part's wall time, fenced by device
  syncs (teacher, student forward, backward, AdamW + EMA), as chip_smoke.py
  times them;
- syncs: the stream syncs one step makes (each one a point where the host
  waits until the card has drained its queue), counted by
  torch.cuda.set_sync_debug_mode("warn");
- profile: one step under torch.profiler (device busy ms, kernel launches,
  idle share against step_ms).

It imports `pope_tpu_torch` and chip_smoke.py from wherever Python finds
them first, so another checkout is timed with `PYTHONPATH=<checkout>
python3 <this file>`; its kernels are built under that checkout. Prints the
card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import warnings

import torch


def count_syncs(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def summary(profile: dict) -> dict:
    return {k: profile[k] for k in ("device_busy_ms", "kernel_launches", "idle_share", "by_category")}


def ssl_pace(cs, steps: int) -> dict:
    from pope_tpu_torch.train.ssl import SSLMetaArch
    from pope_tpu_torch.train.ssl_driver import ssl_configs

    cfg, bcfg = ssl_configs(cs.ssl_cli_args())
    arch = SSLMetaArch(cfg, bcfg)
    state = arch.init_state(0, cs.DEV)
    mults = arch.multipliers(state)
    batch = cs.ssl_batch(cfg, cs.SSL_B, cs.DEV, seed=1)
    step = lambda: arch.train_step(state, batch, mults=mults)
    for _ in range(2):
        step()
    parts = [cs.wall_ms_by_part([(arch, "_teacher_targets", "teacher"), (arch, "_student_losses", "student_forward"),
                                 (arch, "_apply_update", "adamw_ema")], step) for _ in range(steps)]
    med = lambda key: statistics.median(p[key] for p in parts)
    row = {"parts_ms": {"teacher": med("teacher"), "student_forward": med("student_forward"),
                        "adamw_ema": med("adamw_ema"),
                        "backward": statistics.median(p["total"] - p["teacher"] - p["student_forward"] - p["adamw_ema"]
                                                      for p in parts)},
           "fenced_ms": med("total"), "step_ms": statistics.median(cs.timed_runs(step, steps)), "syncs": count_syncs(step)}
    row["profile"] = summary(cs.profile_call(step, row["step_ms"]))
    return row


def nerf_pace(cs, steps: int) -> dict:
    from pope_tpu_torch.nvs.nerf import NerfConfig, init_nerf, train_nerf

    model, state = init_nerf(NerfConfig(), 0, cs.DEV)
    o, d, c = cs.sphere_rays(cs.NVS_VIEWS - 1, cs.NVS_HW, cs.DEV)
    rows = {}
    for label, where in (("card", cs.DEV), ("cpu", "cpu")):
        g = torch.Generator(device=where).manual_seed(1)
        step = lambda: train_nerf(model, state, o, d, c, 0.9, 2.4, 1, generator=g)
        for _ in range(3):
            step()
        row = {"step_ms": statistics.median(cs.timed_runs(step, 2 * steps)), "syncs": count_syncs(step)}
        row["profile"] = summary(cs.profile_call(step, row["step_ms"]))
        rows[f"generator_{label}"] = row
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_pace.py: torch.cuda.is_available() is false; it runs on a CUDA card")
    import chip_smoke as cs
    import pope_tpu_torch
    from pope_tpu_torch.bench import card_name
    from pope_tpu_torch.ops import cuda_kernels
    from pope_tpu_torch.utils.device import resolve_device

    resolve_device(None)
    card = card_name()
    print(card, flush=True)
    cuda_kernels.build()
    cuda_kernels.library()
    out = {"card": card, "package": pope_tpu_torch.__file__, "ssl": ssl_pace(cs, args.steps)}
    torch.cuda.empty_cache()
    out["nvs"] = nerf_pace(cs, args.steps)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
