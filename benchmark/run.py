"""Run one cell of the benchmark once, on the machine it is started on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 a `breakdown`, and last `compared`: each number that
decides `correct` beside its limit. The same numbers end standard error.
Without CUDA, or with fewer cards than the cell asks for, it exits with a
non-zero code and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "pope_tpu")


def process_start() -> float:
    """The epoch second this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


START = process_start()


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def caches(checkout: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout: the
    port's kernels (build/kernels) and host library (build/native) build
    there already; Triton's and torch's extension caches beside them."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(checkout / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(checkout / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def device_info(device: str, chips: int) -> dict:
    import subprocess

    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    name = torch.cuda.get_device_name(0)
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        limit = q.stdout.strip().splitlines()[0] if q.returncode == 0 and q.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"platform": "gpu", "kind": name, "count": chips, "power_limit": limit}


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = None) -> dict:
    """One run of a cell; returns the result object (without printing it)."""
    import torch

    from benchmark import harness
    from benchmark.cells import HERE, Cell

    cell = Cell(spec, workload, root or HERE)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, tmp=Path(tmp),
                              process_start=START,
                              log=lambda *a: print(*a, file=sys.stderr, flush=True))
        out = cell.driver().run(ctx)
    ctx.log(f"setup steps (s since the process started): {json.dumps(ctx.setup_steps)}")
    ctx.log(f"completions (s after the window opened): {[round(t - out['t0'], 3) for t in out['stamps']]}")
    numbers, limits = out["numbers"], cell.limits
    compared = {k: {"value": numbers.get(k), "limit": limits[k]} for k in sorted(limits)}
    correct = out["compared"] > 0 and all(
        v["value"] is not None and v["value"] <= v["limit"] for v in compared.values())
    dev = device_info(device, cell.chips)
    dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    if trace:
        t = out["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"]).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": units[m["name"]]}
                   for m in cell.metrics("end_to_end")}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"] if correct else max(out["failed"], 1),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": out["trace"].device_ops, "idle_gaps": out["trace"].idle_gaps}
        print(f"trace: {json.dumps(out['trace'].extra)}", file=sys.stderr)
    result["compared"] = {"samples": out["compared"], **compared}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.cells import find_spec, load_json

    spec_path = find_spec()
    spec = load_json(spec_path)
    chips = next((int(w["chips"]) for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        fail(f"no workload {args.workload!r} in {spec_path}")
    caches(spec_path.parent)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark runs on CUDA cards")
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} visible")
    try:
        import pope_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        fail(f"the program is not in this checkout ({e})")
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        fail(f"modules that the run may not load were loaded: {found}")
    for name, row in result["compared"].items():
        if name != "samples":
            print(f"compared {name}: {row['value']} (limit {row['limit']})", file=sys.stderr)
    print(f"compared samples: {result['compared']['samples']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
