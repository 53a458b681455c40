"""Command-line entry points of the port (pope_tpu/cli.py's counterpart; the
other subcommands come with their slices).

Usage:
  python -m pope_tpu_torch.cli eval --dataset linemod --data-root data --pairs-dir data/pairs
  python -m pope_tpu_torch.cli demo-web --image frame.png --port 8081
  python -m pope_tpu_torch.cli serve-pose --batch-size 4 --port 8082

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


def cmd_demo_web(args):
    """Interactive click -> mask segmentation in the browser: the encoder runs
    once at startup, every click runs the prompt head on the cached
    embedding."""
    import cv2

    from pope_tpu_torch.pipeline import load_models
    from pope_tpu_torch.serve import WebDemo, run_demo_server

    image = cv2.imread(args.image)
    if image is None:
        raise SystemExit(f"cannot read image {args.image}")
    models = load_models(sam_checkpoint=args.sam_checkpoint, sam_type=args.sam_type, components=("sam",),
                         device=args.device)
    demo = WebDemo(models.sam, image[:, :, ::-1], max_points=args.max_points, device=models.device)
    try:
        run_demo_server(demo, host=args.host, port=args.port)
    finally:
        demo.close()


def cmd_serve_pose(args):
    """Online pose service: POST /pose coalesces concurrent requests into
    device batches (the eval runner's batched path, behind a queue)."""
    from pope_tpu_torch.pipeline import load_models
    from pope_tpu_torch.serve import PoseService, make_pose_server

    models = load_models(
        sam_checkpoint=args.sam_checkpoint,
        sam_type=args.sam_type,
        dinov2_checkpoint=args.dinov2_checkpoint,
        matcher_checkpoint=args.matcher_checkpoint,
        device=args.device,
    )
    service = PoseService(models, crop_size=args.crop_size, batch_size=args.batch_size,
                          max_wait_ms=args.max_wait_ms)
    server = make_pose_server(service, host=args.host, port=args.port)
    print(f"serving pose estimation on http://{args.host}:{server.server_address[1]}/pose")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.shutdown(drain=False)


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

    pw = sub.add_parser("demo-web", help="interactive segmentation web demo (browser)")
    pw.add_argument("--image", required=True)
    pw.add_argument("--host", default="127.0.0.1")
    pw.add_argument("--port", type=int, default=8081)
    pw.add_argument("--max-points", type=int, default=8)
    _add_model_args(pw)
    pw.set_defaults(fn=cmd_demo_web)

    pv = sub.add_parser("serve-pose", help="online pose-estimation HTTP service (continuous batching)")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8082)
    pv.add_argument("--batch-size", type=int, default=4)
    pv.add_argument(
        "--max-wait-ms", type=float, default=8.0,
        help="how long the batcher waits for a batch to fill after the first request arrives",
    )
    pv.add_argument("--crop-size", type=int, default=256)
    _add_model_args(pv)
    pv.set_defaults(fn=cmd_serve_pose)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
