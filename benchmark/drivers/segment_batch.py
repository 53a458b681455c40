"""Driver of batched segmentation, a labelling job over a folder of
same-size frames: `AutomaticMaskGenerator.generate_batch(frames,
keep_logits=False)` on B frames at a time in a closed loop, the pool of
frames made from the seed and cycled until the window closes.

The records path: SAM's encode, the full-resolution decode of every grid
prompt, the filters, NMS and the capacity cut on the device, one download,
then each image's small-region cleanup on the host. The window opens at
the first batch completed after warm-up and closes at the first completion
at or after the run's seconds; the rate is every image returned in between
over the time in between."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import frames, harness
from benchmark.counts.flops import image_flops
from benchmark.reference import amg as ref_amg
from benchmark.reference import compare
from benchmark.spans import Hooks


def frame_pool(traffic: dict, seed: int) -> np.ndarray:
    """The traffic's pool of frames (drawn from its pool_seed) in the order
    the run's seed draws."""
    _, pool = frames.frame_pairs(int(traffic["pool_seed"]), int(traffic["frames"]))
    return pool[frames.order(seed, len(pool))]


def sample(traffic: dict, seed: int) -> list:
    """The (batch, slot) of each image that the seed draws for the comparison."""
    B = int(traffic["batch_size"])
    cand = [(b, s) for b in traffic["sample_batches"] for s in range(B)]
    return harness.sample(np.random.default_rng([int(seed) % (2 ** 63), 2]), cand, int(traffic["sample_images"]))


def sampled_frames(traffic: dict, seed: int) -> list:
    """The frames that a run with this seed compares with the reference."""
    pool, B = frame_pool(traffic, seed), int(traffic["batch_size"])
    return [pool[(b * B + s) % len(pool)] for b, s in sample(traffic, seed)]


def run(ctx: harness.Context) -> dict:
    tr = ctx.cell.traffic
    B = int(tr["batch_size"])
    components = ("sam",)
    amg_mod = ctx.module("models.sam.amg")
    ctx.step("imports")
    models = harness.build_program(ctx, components)
    ctx.step("models")
    amg = models.amg
    pool = frame_pool(tr, ctx.seed)
    chunks = harness.n_chunks(models.config)
    picked = sample(tr, ctx.seed)
    hooks = Hooks(ctx.trace)
    state = {"timed": False, "batch": -1, "call": 0}
    raw = {}

    def on_decode(args, kwargs, out):
        if state["timed"]:
            key = (state["batch"], state["call"] // chunks)
            if key in picked:
                raw.setdefault(key, []).append(out)
            state["call"] += 1
        return out

    hooks.wrap(amg, "generate_batch", "generate_batch")
    hooks.wrap(amg, "_amg_full", "amg_program")
    hooks.wrap(models.sam, "decode", after=on_decode)
    hooks.wrap(amg_mod, "nms", "nms")
    harness.wrap_attention(ctx, hooks)

    def batch_frames(b: int) -> np.ndarray:
        idx = [(b * B + j) % len(pool) for j in range(B)]
        return pool[idx]

    results = {}
    with torch.no_grad():
        for w in range(int(tr["warmup_batches"])):
            amg.generate_batch(batch_frames(w), keep_logits=False)
        ctx.step("warm-up")
        win = harness.Window(ctx, hooks)
        prof = None
        if ctx.trace:
            from benchmark.spans import start_profiler

            win.sync()
            prof = start_profiler()
        state["timed"] = True
        b = 0
        while True:
            state["batch"], state["call"] = b, 0
            out = amg.generate_batch(batch_frames(b), keep_logits=False)
            if any(key[0] == b for key in picked):
                results[b] = out
            b += 1
            if win.stamp(b * B, b):
                break
        state["timed"] = False
        win.sync()
    peak = harness.memory_peak(ctx)
    hooks.restore()

    out = {"attempted": win.items, "failed": 0, "items": win.items, "seconds": win.seconds,
           "setup_s": win.setup_s, "memory_peak_bytes": peak, "t0": win.t0, "stamps": win.stamps,
           "e2e": {"images_per_s": win.items / win.seconds}}
    if prof is not None:
        from benchmark.spans import Trace, host_times, read_trace

        prof.__exit__(None, None, None)
        fields = {**read_trace(prof, hooks),
                  **host_times(hooks, win.t0, win.t1, nested=(("generate_batch", "amg_program"),))}
        del prof
        out["trace"] = Trace(units=win.batches, items=win.items, flops=image_flops(models.config)["total"] * win.items,
                             attention_bound_s=hooks.attention_bound_s, **fields)
    del models, amg
    harness.free()
    # a batch counts in the window once it has returned after the opening stamp
    kept = [(b, s) for b, s in picked if win.units0 <= b < win.units and b in results]
    out["numbers"] = compare_images(ctx, raw, results, kept, batch_frames)
    out["compared"] = len(kept)
    if not kept:
        out["failed"] = out["attempted"]
    return out


def compare_images(ctx, raw, results, kept, batch_frames) -> dict:
    """The largest of each number over the sampled images: the reference's
    float32 decode of the frame against the program's, and the reference's
    exact steps on the program's decode against the program's result."""
    harness.reference_precision(ctx.device)
    ref = harness.build_reference(ctx.cell, ctx.device)
    worst, counts = {}, []
    for b, s in kept:
        frame = batch_frames(b)[s]
        prog_raw = compare.raw_of(raw[(b, s)])
        for k, v in compare.sam_gaps(prog_raw, ref_amg.grid_decode(ref.sam, ref.config.amg, frame, ref.device)).items():
            worst[k] = max(worst.get(k, 0.0), v)
        r = ref_amg.records(*prog_raw, ref.config.amg, frame.shape[:2], ref.config.sam.encoder)
        worst["stage_mismatch"] = max(worst.get("stage_mismatch", 0), compare.records_mismatch(results[b][s], r))
        counts.append((r["n_filtered"], int(r["valid"].sum())))
    ctx.log(f"candidates into NMS and masks kept, by sampled image: {counts}")
    del ref
    harness.free()
    return worst
