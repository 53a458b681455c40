"""What every driver shares: the run's context, the program (the port)
built with the benchmark's weights, the attention spans, the window's clock
and the reference's turn after the window."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import weights
from benchmark.cells import Cell, pipeline_config
from benchmark.counts import attention as attention_counts
from benchmark.reference import build as ref_build
from benchmark.spans import WINDOW_END, WINDOW_START, Hooks

PORT = "pope_tpu_torch"


class WindowClosed(Exception):
    """Raised from the driver's completion hook once the window has ended."""


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: Path
    process_start: float  # time.time() at the process's start
    log: object = print
    setup_steps: dict = dataclasses.field(default_factory=dict)

    def step(self, name: str) -> None:
        """Note the seconds since the process started at the end of a set-up step."""
        self.setup_steps[name] = round(time.time() - self.process_start, 3)

    def module(self, name: str):
        return importlib.import_module(f"{PORT}.{name}")


def build_program(ctx: Context, components, plans: dict = None):
    """The program's models with the benchmark's weights (the configuration's
    weights_seed; the run's seed draws the inputs and the sample): the
    port's `load_models`, then each tower's parameters overwritten through
    load_state_dict semantics. `plans`: each tower's weight plan, by default
    those of the reference's towers (SAM); every loaded component needs one."""
    cfg_file, traffic = ctx.cell.config, ctx.cell.traffic
    from pope_tpu_torch import config as port_config
    from pope_tpu_torch.pipeline.api import load_models

    cfg = pipeline_config(port_config, cfg_file, traffic)
    models = load_models(cfg, sam_type=cfg_file["sam"]["type"], seed=0, components=tuple(components),
                         device=ctx.device)
    if models.sam is not None and models.sam.config.encoder != cfg.sam.encoder:
        raise ValueError(f"load_models(sam_type={cfg_file['sam']['type']!r}) builds another encoder than "
                         f"{cfg_file['name']}.json states")
    plans = ref_build.plans(cfg_file, traffic) if plans is None else plans
    if set(components) - set(plans):
        raise ValueError(f"no weight plan for {sorted(set(components) - set(plans))}")
    for tower, plan in plans.items():
        weights.load_into(getattr(models, tower), weights.make_state(plan, cfg_file["weights_seed"], tower, ctx.device))
    return models


def build_reference(cell: Cell, device) -> "ref_build.Models":
    """The reference in float32 with the cell's weights, SAM's encoder
    weights rounded to bf16 where its configuration stores them so."""
    stored = cell.config["sam"]["encoder"].get("dtype") == "bfloat16"
    return ref_build.build(cell.config, cell.traffic, cell.config["weights_seed"], device, stored_bf16=stored)


def wrap_attention(ctx: Context, hooks: Hooks) -> None:
    """The span "attention" around every call into the three attention
    entries, and each call's roofline bound summed while the window is
    open (counts/attention.py)."""
    hooks.attention_bound_s = 0.0
    hooks.in_window = False
    for mod_name in ("models.sam.encoder", "models.dinov2.model"):
        mod = ctx.module(mod_name)
        for entry, count in attention_counts.ENTRIES.items():
            if not hasattr(mod, entry):
                continue

            def before(args, kwargs, count=count):
                if hooks.in_window:
                    nbytes, flops, dtype = count(*args, **kwargs)
                    hooks.attention_bound_s += attention_counts.bound_s(nbytes, flops, dtype)

            hooks.wrap(mod, entry, "attention", before=before)


class Window:
    """The measured window: it opens at a completion stamp after warm-up
    and closes at the first stamp at or after `seconds` past its opening."""

    def __init__(self, ctx: Context, hooks: Hooks):
        self.ctx, self.hooks = ctx, hooks
        self.t0 = self.t1 = None
        self.n0 = self.n1 = 0
        self.units0 = self.units = 0
        self.stamps = []

    def stamp(self, n_done: int, units_done: int) -> bool:
        """Record a completion (n_done items, units_done batches so far);
        True once the window has closed."""
        now = time.perf_counter()
        self.stamps.append(now)
        if self.t0 is None:
            self.t0, self.n0, self.units0 = now, n_done, units_done
            self.setup_s = time.time() - self.ctx.process_start
            self.hooks.mark(WINDOW_START)
            self.hooks.in_window = True
            return False
        if now - self.t0 >= self.ctx.seconds:
            self.t1, self.n1, self.units = now, n_done, units_done
            self.hooks.in_window = False
            self.hooks.mark(WINDOW_END)
            return True
        return False

    def sync(self):
        if self.ctx.device != "cpu":
            torch.cuda.synchronize()

    @property
    def items(self) -> int:
        return self.n1 - self.n0

    @property
    def batches(self) -> int:
        return self.units - self.units0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def memory_peak(ctx: Context) -> int:
    return int(torch.cuda.max_memory_allocated()) if ctx.device != "cpu" else 0


def free() -> None:
    """Return what the program or the reference left to the allocator."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(rng: np.random.Generator, population: list, k: int) -> list:
    """k members of population drawn by rng (all if fewer), in their order."""
    if len(population) <= k:
        return list(population)
    idx = rng.choice(len(population), size=k, replace=False)
    return [population[i] for i in sorted(idx)]


def reference_precision(device: str):
    """Float32 products with TF32 off for the reference."""
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def n_chunks(cfg) -> int:
    n_points = cfg.amg.points_per_side ** 2
    chunk = cfg.amg.points_per_chunk if 0 < cfg.amg.points_per_chunk < n_points else n_points
    return -(-n_points // chunk)

