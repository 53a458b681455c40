"""Spans around the program's layers, put there from outside, and the
reading of the profiler's trace.

`Hooks` replaces a function or method of the program with a wrapper that
may call a hook before and after it and, in the traced run, opens a
`torch.profiler.record_function("bench::<span>")` range around it. The
wrappers never synchronise. `read_trace` reduces the finished trace to a
`Trace`: for each span, the host wall time inside it and the device time of
the kernels launched inside it (on the thread that opened it, its nested
spans included), the device's busy time (the union of every device
operation's interval) within the measured window, the device operations
that took most time, and the idle gaps by the span the main thread was in.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional

PREFIX = "bench::"
WINDOW_START, WINDOW_END = "window_start", "window_end"


class Hooks:
    """Wrappers installed on the program's functions, removed by
    `restore()`. traced=False: no profiler range, only the hooks."""

    def __init__(self, traced: bool):
        self.traced = traced
        self._undo = []
        self.main_thread = threading.get_ident()
        self.host = defaultdict(list)  # span -> [(start, end)] of time.perf_counter, traced runs

    def wrap(self, owner, attr: str, span: Optional[str] = None, before: Optional[Callable] = None,
             after: Optional[Callable] = None):
        """Wrap owner.attr: before(args, kwargs), the call (inside the span's
        range when traced), after(args, kwargs, out) -> out."""
        fn = getattr(owner, attr)
        traced = self.traced and span is not None

        def wrapper(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            if traced:
                from torch.profiler import record_function

                t0 = time.perf_counter()
                with record_function(PREFIX + span):
                    out = fn(*args, **kwargs)
                self.host[span].append((t0, time.perf_counter()))
            else:
                out = fn(*args, **kwargs)
            return out if after is None else after(args, kwargs, out)

        wrapper.__wrapped__ = fn
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, fn))
        return fn

    def mark(self, name: str) -> None:
        """A zero-length range in the traced run (the window's ends)."""
        if self.traced:
            from torch.profiler import record_function

            with record_function(PREFIX + name):
                pass

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


@dataclass
class Trace:
    """A traced window reduced to what the per-layer readers take."""

    window_s: float
    busy_s: float
    units: int  # batches completed in the window
    items: int  # pairs or images completed in the window
    span_host_s: dict = field(default_factory=dict)  # span -> host seconds inside it
    span_device_s: dict = field(default_factory=dict)  # span -> device seconds launched inside it
    span_calls: dict = field(default_factory=dict)
    span_end_gap_s: dict = field(default_factory=dict)  # (outer, inner) -> seconds from inner's end to outer's
    attention_bound_s: float = 0.0  # the roofline bound of every attention call in the window
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    flops: float = 0.0  # model FLOPs of the window's completed work
    extra: dict = field(default_factory=dict)


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def host_times(hooks: Hooks, t0: float, t1: float, nested: tuple = ()) -> dict:
    """Host seconds and calls of each span inside the window [t0, t1] of
    time.perf_counter (on whatever thread ran it), and for each (outer,
    inner) pair of `nested` the seconds from each inner call's end to its
    outer call's end."""
    rows = {k: [(s, e) for s, e in v if s >= t0 and e <= t1] for k, v in hooks.host.items()}
    gaps = {}
    for outer, inner in nested:
        total = 0.0
        for s, e in rows.get(outer, []):
            ends = [ie for is_, ie in rows.get(inner, []) if is_ >= s and ie <= e]
            if ends:
                total += e - max(ends)
        gaps[(outer, inner)] = total
    return {"span_host_s": {k: sum(e - s for s, e in v) for k, v in rows.items()},
            "span_calls": {k: len(v) for k, v in rows.items()},
            "span_end_gap_s": gaps}


def _timeline(spans) -> tuple:
    """Change points of the innermost open span on one thread, whose spans
    nest: (times, labels), label None where none is open."""
    times, labels, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end = stack.pop()[0]
            times.append(end)
            labels.append(stack[-1][1] if stack else None)

    for s, e, key in sorted(spans):
        close_until(s)
        stack.append((e, key))
        times.append(s)
        labels.append(key)
    close_until(float("inf"))
    return times, labels


def read_trace(prof, hooks: Hooks) -> dict:
    """Reduce the profiler's events (read straight from the tracer's
    results: key_averages() builds an event tree and takes tens of seconds
    on such a window): the device time launched inside each span, the busy
    time, the top device operations and the idle gaps."""
    from torch.autograd import DeviceType

    spans = defaultdict(list)  # name -> [(tid, start, end)]
    launches = {}  # correlation id -> (tid, ns)
    device = []  # (start, end, name, correlation)
    marks = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(PREFIX):  # a range's image on the device timeline, not an operation
                device.append((e.start_ns(), e.end_ns(), name, e.correlation_id()))
        elif name.startswith(PREFIX):
            key = name[len(PREFIX):]
            if key in (WINDOW_START, WINDOW_END):
                marks[key] = (e.start_thread_id(), e.start_ns())
            else:
                spans[key].append((e.start_thread_id(), e.start_ns(), e.end_ns()))
        elif e.correlation_id() > 0 and name.startswith(("cuda", "cu")):
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
    if WINDOW_START not in marks or WINDOW_END not in marks:
        raise RuntimeError("the trace lacks the window's marks")
    (main_tid, w0), (_, w1) = marks[WINDOW_START], marks[WINDOW_END]
    inside = lambda s, e: s >= w0 and e <= w1

    # spans of the window, per thread, for the launch lookups
    per_tid = {}
    for key, rows in spans.items():
        rows = [r for r in rows if inside(r[1], r[2])]
        by_tid = defaultdict(list)
        for tid, s, e in rows:
            by_tid[tid].append((s, e))
        per_tid[key] = {tid: (sorted(v), [s for s, _ in sorted(v)]) for tid, v in by_tid.items()}

    def within(key, tid, t):
        found = per_tid[key].get(tid)
        if not found:
            return False
        iv, starts = found
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and iv[i][1] >= t

    # a launch counts toward a span opened on its thread; where the tracer's
    # thread ids of launches and ranges share nothing, toward any span open
    # at its time
    span_tids = {tid for rows in per_tid.values() for tid in rows}
    by_thread = bool(span_tids & {tid for tid, _ in launches.values()})
    if not by_thread:
        for key in per_tid:
            merged = sorted(iv for iv, _ in per_tid[key].values() for iv in iv)
            per_tid[key] = {None: (merged, [s for s, _ in merged])}
    device_s = dict.fromkeys(spans, 0.0)
    op_s = defaultdict(float)
    busy_iv = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        busy_iv.append((s, e))
        op_s[name] += (e - s) / 1e9
        launch = launches.get(corr)
        if launch is None:
            continue
        tid, t = launch
        tid = tid if by_thread else None
        for key in spans:
            if within(key, tid, t):
                device_s[key] += (e - s) / 1e9
    busy = _union(busy_iv)
    busy_s = sum(e - s for s, e in busy) / 1e9

    # idle gaps inside the window, by the innermost span the main thread was in
    times, labels = _timeline([(s, e, key) for key, rows in spans.items() for tid, s, e in rows if tid == main_tid])
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            i = bisect.bisect_right(times, (g0 + g1) / 2) - 1
            gaps[labels[i] if i >= 0 and labels[i] else "outside the wrapped layers"] += (g1 - g0) / 1e9

    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "span_device_s": device_s,
        "extra": {"launches_by_thread": by_thread, "device_events": len(device),
                  "linked_to_a_launch": sum(1 for *_, c in device if c in launches)},
        "device_ops": sorted(([n, s] for n, s in op_s.items()), key=lambda r: -r[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda r: -r[1])[:10],
    }
