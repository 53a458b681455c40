"""Command-line entry points of the port (pope_tpu/cli.py's counterpart; the
other subcommands come with their slices).

Usage:
  python -m pope_tpu_torch.cli eval --dataset linemod --data-root data --pairs-dir data/pairs

Runs on the CUDA card unless `--device cpu` is given; without a GPU the
default raises.
"""

from __future__ import annotations

import argparse
import json


def _add_model_args(p):
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--sam-type", default="h", choices=["b", "l", "h"])
    p.add_argument("--dinov2-checkpoint", default=None)
    p.add_argument("--matcher-checkpoint", default=None)
    p.add_argument("--device", default=None, help="torch device, default cuda")


def cmd_eval(args):
    from pope_tpu_torch import pipeline
    from pope_tpu_torch.eval import evaluate_dataset, results_to_xlsx
    from pope_tpu_torch.eval.evaluate import results_table

    if args.serial and args.batch_size is not None:
        raise SystemExit("--serial runs one pair at a time; it contradicts --batch-size (drop one)")
    models = pipeline.load_models(
        sam_checkpoint=args.sam_checkpoint,
        sam_type=args.sam_type,
        dinov2_checkpoint=args.dinov2_checkpoint,
        matcher_checkpoint=args.matcher_checkpoint,
        device=args.device,
    )
    if args.serial:
        # the reference's per-pair loop shape (eval_linemod_json.py:51);
        # produces the same records as the batched default
        from pope_tpu_torch.pipeline.runner import run_pair

        per_obj = evaluate_dataset(
            models, args.dataset, args.data_root, args.pairs_dir, run_pair, max_pairs=args.max_pairs,
        )
    else:
        per_obj = evaluate_dataset(
            models, args.dataset, args.data_root, args.pairs_dir, max_pairs=args.max_pairs,
            batch_size=args.batch_size if args.batch_size is not None else 4,
        )
    print(results_table(per_obj))
    if args.xlsx:
        results_to_xlsx(per_obj, args.xlsx)
        print(f"wrote {args.xlsx}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(per_obj, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pope_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("eval", help="manifest-driven dataset evaluation")
    pe.add_argument("--dataset", required=True, choices=["linemod", "onepose", "onepose_plusplus", "ycbv"])
    pe.add_argument("--data-root", default="data")
    pe.add_argument("--pairs-dir", default="data/pairs")
    pe.add_argument("--max-pairs", type=int, default=None)
    pe.add_argument(
        "--batch-size", type=int, default=None,
        help="pairs per device batch, default 4 (the batched production path is the default)",
    )
    pe.add_argument(
        "--serial", action="store_true",
        help="reference-shaped per-pair loop instead of the batched driver",
    )
    pe.add_argument("--xlsx", default=None)
    pe.add_argument("--json-out", default=None)
    _add_model_args(pe)
    pe.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
