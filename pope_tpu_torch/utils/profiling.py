"""Region timing and tracing (port of pope_tpu/utils/profiling.py, the
reference's InferenceProfiler).

Reference behavior: src/utils/profiler.py:7-35 — a profiler wrapper with
labelled regions synchronized around device work, and a build_profiler
factory (inference / trace / passthrough). Regions are
`torch.profiler.record_function` scopes; a region's time waits for the
card's queue (`torch.cuda.synchronize` on the device of `sync_on`'s
tensors) where pope_tpu calls `jax.block_until_ready`.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _synchronize(sync_on) -> None:
    """Wait for the CUDA streams of the devices `sync_on`'s tensors (a
    tensor, or a list / tuple / dict of them) lie on."""
    if torch.is_tensor(sync_on):
        if sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
    elif isinstance(sync_on, dict):
        for v in sync_on.values():
            _synchronize(v)
    elif isinstance(sync_on, (list, tuple)):
        for v in sync_on:
            _synchronize(v)


class InferenceProfiler:
    """Accumulating region timer with device synchronization."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def profile(self, name: str, sync_on=None):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync_on is not None:
                    _synchronize(sync_on)
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        lines = ["region                          total_s   calls   mean_ms"]
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<30}  {total:7.3f}  {n:6d}  {1000*total/max(n,1):8.2f}")
        return "\n".join(lines)


class PassThroughProfiler:
    @contextlib.contextmanager
    def profile(self, name: str, sync_on=None):
        yield

    def summary(self) -> str:
        return "(passthrough profiler)"


class TraceProfiler(PassThroughProfiler):
    """Each region traced by torch.profiler (CPU and, where there is a card,
    CUDA activity) into a Chrome trace under `log_dir`."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    @contextlib.contextmanager
    def profile(self, name: str, sync_on=None):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts,
                                    on_trace_ready=torch.profiler.tensorboard_trace_handler(self.log_dir)):
            with torch.profiler.record_function(name):
                yield
                if sync_on is not None:
                    _synchronize(sync_on)


def build_profiler(name: Optional[str] = None):
    """'inference' -> region timer; 'trace:<dir>' -> torch.profiler traces
    under <dir>; None / other -> passthrough (profiler.py:30-35)."""
    if name == "inference":
        return InferenceProfiler()
    if name and name.startswith("trace:"):
        return TraceProfiler(name.split(":", 1)[1])
    return PassThroughProfiler()
