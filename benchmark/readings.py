"""The readings that a cell's limits are set from, in one process on the
card: the numbers that decide `correct` for the program over many seeds
(the lower readings; each run a short window at the cell's own load that
reaches the sampled batches), then the control's on other seeds (the
upper readings; `reference/control.py`).

    python3 -m benchmark.readings --workload <cell> --seconds 10 \
        --seeds 11,12,13 --control-seeds 21,22,23

Prints one JSON line a run and, last, the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import run as bench_run
from benchmark.cells import Cell, find_spec, load_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    spec_path = find_spec()
    spec = load_json(spec_path)
    bench_run.caches(spec_path.parent)
    import torch

    if not torch.cuda.is_available():
        bench_run.fail("torch.cuda.is_available() is false")
    seeds = lambda s: [int(x) for x in s.split(",") if x]
    lower, upper = {}, {}
    for seed in seeds(args.seeds):
        res = bench_run.run_cell(spec, args.workload, seed, args.seconds, False)
        numbers = {k: v["value"] for k, v in res["compared"].items() if k != "samples"}
        print(json.dumps({"seed": seed, "correct": res["correct"], "compared": res["compared"]["samples"],
                          "numbers": numbers, "metrics": res["metrics"]}), flush=True)
        for k, v in numbers.items():
            lower[k] = max(lower.get(k, 0.0), v if v is not None else float("inf"))
    if args.control_seeds:
        from benchmark.harness import build_reference
        from benchmark.reference import control

        cell = Cell(spec, args.workload)
        ref = build_reference(cell, "cuda")
        for seed in seeds(args.control_seeds):
            numbers = control.readings(cell, seed, "cuda", ref)
            print(json.dumps({"seed": seed, "control": numbers}), flush=True)
            for k, v in numbers.items():
                upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    found = bench_run.forbidden_modules()
    if found:
        bench_run.fail(f"modules that the run may not load were loaded: {found}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
