"""Command-line entry points of the port (pope_tpu/cli.py's counterpart; the
other subcommands come with their slices).

Usage:
  python -m pope_tpu_torch.cli eval --dataset linemod --data-root data --pairs-dir data/pairs
  python -m pope_tpu_torch.cli amg --input images/ --output masks/ [--convert-to-rle]
  python -m pope_tpu_torch.cli demo-sam --image target.png
  python -m pope_tpu_torch.cli demo-dinov2 --image target.png
  python -m pope_tpu_torch.cli demo-3dbbox --prompt prompt.png --target target.png
  python -m pope_tpu_torch.cli demo-web --image frame.png --port 8081
  python -m pope_tpu_torch.cli serve-pose --batch-size 4 --port 8082
  python -m pope_tpu_torch.cli train-matcher --data-source scannet --data-root scans \
      --train-npz train.npz --val-npz val.npz --intrinsic-path intrinsics.npz --ckpt-dir ckpt
  python -m pope_tpu_torch.cli export --target dinov2 --output dinov2.pt2
  python -m pope_tpu_torch.cli extract --dataset linemod --out-dir dumps
  python -m pope_tpu_torch.cli train-regressor --dataset linemod --points-dir dumps --ckpt-dir ckpt
  python -m pope_tpu_torch.cli test-regressor --dataset linemod --points-dir dumps --ckpt ckpt/step_100.pt
  python -m pope_tpu_torch.cli train-ssl --image-root images/ --ckpt-dir ckpt
  python -m pope_tpu_torch.cli render-novel-view --seq-root data/lm/ape/seq --out-dir renders

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
    if args.serial and (args.dp or args.batch_size is not None):
        raise SystemExit("--serial runs one pair at a time on one device; it contradicts --dp/--batch-size "
                         "(drop one)")
    if args.dp and args.dp > 1:
        # one rank per device, started here (parallel.launch.spawn); rank 0
        # prints and writes
        from pope_tpu_torch.parallel import spawn

        spawn(_eval, args.dp, argv=(args,), tp=1, device=args.device)
    else:
        _eval(None, args)


def _eval(mesh, args):
    from pope_tpu_torch import pipeline
    from pope_tpu_torch.eval import evaluate_dataset, results_to_xlsx
    from pope_tpu_torch.eval.evaluate import results_table

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
            batch_size=args.batch_size if args.batch_size is not None else 4, mesh=mesh,
        )
    if mesh is not None and mesh.get_rank() != 0:
        return
    print(results_table(per_obj))
    if args.xlsx:
        results_to_xlsx(per_obj, args.xlsx)
        print(f"wrote {args.xlsx}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(per_obj, f, indent=2)


def cmd_demo_dinov2(args):
    """visual_dinov2.py: DINOv2's patch-PCA heatmap of one image."""
    from pope_tpu_torch.pipeline import load_models
    from pope_tpu_torch.pipeline.demos import demo_dinov2_heatmap

    models = load_models(dinov2_checkpoint=args.dinov2_checkpoint, components=("dinov2",), device=args.device)
    demo_dinov2_heatmap(models, args.image, args.out)
    print(f"wrote {args.out}")


def cmd_demo_sam(args):
    """visual_sam.py: the automatic masks of one image, rendered."""
    from pope_tpu_torch.pipeline import load_models
    from pope_tpu_torch.pipeline.demos import demo_sam_masks

    models = load_models(sam_checkpoint=args.sam_checkpoint, sam_type=args.sam_type, components=("sam",),
                         device=args.device)
    demo_sam_masks(models, args.image, args.out)
    print(f"wrote {args.out}")


AMG_FLAGS = ("points_per_side", "pred_iou_thresh", "stability_score_thresh", "box_nms_thresh",
             "min_mask_region_area", "mask_capacity", "crop_n_layers", "crop_nms_thresh")


def cmd_amg(args):
    """scripts/amg.py: mask generation over an image or a directory, writing
    a PNG folder + metadata.csv or a COCO-RLE json per image."""
    import dataclasses

    from pope_tpu_torch.config import PipelineConfig
    from pope_tpu_torch.pipeline import load_models
    from pope_tpu_torch.pipeline.amg_cli import run_amg

    cfg = PipelineConfig()
    overrides = {k: getattr(args, k) for k in AMG_FLAGS if getattr(args, k) is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, amg=dataclasses.replace(cfg.amg, **overrides))
    models = load_models(config=cfg, sam_checkpoint=args.sam_checkpoint, sam_type=args.sam_type,
                         components=("sam",), device=args.device)
    done = run_amg(models, args.input, args.output, convert_to_rle=args.convert_to_rle)
    print(f"processed {len(done)} image(s) -> {args.output}")


# visual_3dbbox.py:19-41's demo intrinsics and object extents
DEMO_K0 = ((2442.28864, 0.0, 449.114027), (0.0, 2447.23383, -110.724309), (0.0, 0.0, 1.0))
DEMO_K1 = ((572.4114, 0.0, 325.2611), (0.0, 573.57043, 242.04899), (0.0, 0.0, 1.0))
DEMO_EXTENTS = (0.03793430, 0.03879960, 0.04588450)


def cmd_demo_3dbbox(args):
    """visual_3dbbox.py: one (prompt, target) pair -> query_result.png and
    3D_BBox.png. K0 / K1 / the box default to the reference demo's values;
    the poses load from prompt.txt / target.txt beside the prompt image."""
    import os

    import numpy as np

    from pope_tpu_torch.pipeline import load_models
    from pope_tpu_torch.pipeline.demos import demo_3dbbox

    K0 = np.loadtxt(args.k0) if args.k0 else np.array(DEMO_K0)
    K1 = np.loadtxt(args.k1) if args.k1 else np.array(DEMO_K1)
    if args.box3d:
        corners = np.loadtxt(args.box3d)
    else:
        x, y, z = DEMO_EXTENTS
        corners = np.array([[-x, -y, -z], [-x, -y, z], [-x, y, z], [-x, y, -z],
                            [x, -y, -z], [x, -y, z], [x, y, z], [x, y, -z]])
    d = os.path.dirname(args.prompt)
    prompt_pose = np.loadtxt(args.prompt_pose or os.path.join(d, "prompt.txt"))
    tgt_path = args.target_pose or os.path.join(d, "target.txt")
    target_pose = np.loadtxt(tgt_path) if os.path.exists(tgt_path) else None

    models = load_models(
        sam_checkpoint=args.sam_checkpoint,
        sam_type=args.sam_type,
        dinov2_checkpoint=args.dinov2_checkpoint,
        matcher_checkpoint=args.matcher_checkpoint,
        device=args.device,
    )
    demo_3dbbox(models, args.prompt, args.target, K0, K1, prompt_pose, corners,
                target_pose=target_pose, out_query=args.out_query, out_bbox=args.out_bbox)
    print(f"wrote {args.out_query} and {args.out_bbox}")


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


def cmd_train_matcher(args):
    """The LoFTR matcher's training on multi-scene data with auc@10-monitored
    top-k checkpoints (scripts/train.py)."""
    from pope_tpu_torch.train.matcher_driver import train_main

    train_main(args)


def cmd_export(args):
    """scripts/export_onnx_model.py: serialize a serving head as a
    torch.export program (`.pt2`)."""
    from pope_tpu_torch import pipeline
    from pope_tpu_torch.export import export_dinov2, export_matcher, export_sam_decoder, export_sam_prompt_head

    component = {"sam-prompt-head": "sam", "sam-decoder": "sam", "matcher": "matcher", "dinov2": "dinov2"}[args.target]
    models = pipeline.load_models(
        sam_checkpoint=args.sam_checkpoint, sam_type=args.sam_type, dinov2_checkpoint=args.dinov2_checkpoint,
        matcher_checkpoint=args.matcher_checkpoint, components=(component,), device=args.device,
    )
    if args.target == "sam-prompt-head":
        export_sam_prompt_head(models.sam, (args.orig_h, args.orig_w), num_points=args.num_points,
                               return_single_mask=args.return_single_mask,
                               use_stability_score=args.use_stability_score, path=args.output)
    elif args.target == "sam-decoder":
        export_sam_decoder(models.sam, num_points=args.num_points, path=args.output)
    elif args.target == "matcher":
        export_matcher(models.matcher, (args.orig_h, args.orig_w), (args.crop_size, args.crop_size), path=args.output)
    else:  # the pipeline's serving crop (196), not the pretraining resolution
        export_dinov2(models.dinov2, img_size=args.img_size, path=args.output)
    print(f"wrote {args.output}")


def cmd_extract(args):
    from pope_tpu_torch.eval.extract import extract_dataset

    extract_dataset(args)


def cmd_train_regressor(args):
    from pope_tpu_torch.models.regressor.driver import train_main

    train_main(args)


def cmd_test_regressor(args):
    from pope_tpu_torch.models.regressor.driver import test_main

    test_main(args)


def cmd_train_ssl(args):
    """DINOv2 self-supervised pretraining (DINO + iBOT + KoLeo) on an image
    folder, with checkpoints and auto-resume."""
    from pope_tpu_torch.train.ssl_driver import train_main

    train_main(args)


def cmd_render_novel_view(args):
    """Fit a per-scene NeRF on a posed LINEMOD sequence and render its
    target views."""
    from pope_tpu_torch.nvs.driver import render_main

    render_main(args)


def build_parser() -> argparse.ArgumentParser:
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
        "--dp", type=int, default=None,
        help="data-parallel size: run every batch over N ranks on this host, one device each "
        "(batch-size must be divisible by it)",
    )
    pe.add_argument(
        "--serial", action="store_true",
        help="reference-shaped per-pair loop instead of the batched driver",
    )
    pe.add_argument("--xlsx", default=None)
    pe.add_argument("--json-out", default=None)
    _add_model_args(pe)
    pe.set_defaults(fn=cmd_eval)

    pd = sub.add_parser("demo-dinov2", help="patch-PCA heatmap demo")
    pd.add_argument("--image", required=True)
    pd.add_argument("--out", default="headmap.jpg")
    pd.add_argument("--dinov2-checkpoint", default=None)
    pd.add_argument("--device", default=None, help="torch device, default cuda")
    pd.set_defaults(fn=cmd_demo_dinov2)

    ps = sub.add_parser("demo-sam", help="automatic mask generation demo")
    ps.add_argument("--image", required=True)
    ps.add_argument("--out", default="LINEMOD_mask.png")
    _add_model_args(ps)
    ps.set_defaults(fn=cmd_demo_sam)

    pa = sub.add_parser(
        "amg",
        help="batch automatic mask generation (scripts/amg.py: PNG folder + metadata.csv per image, "
        "or COCO-RLE json with --convert-to-rle)",
    )
    pa.add_argument("--input", required=True, help="image file or directory")
    pa.add_argument("--output", required=True, help="output directory")
    pa.add_argument("--convert-to-rle", action="store_true")
    pa.add_argument("--points-per-side", type=int, default=None)
    pa.add_argument("--pred-iou-thresh", type=float, default=None)
    pa.add_argument("--stability-score-thresh", type=float, default=None)
    pa.add_argument("--box-nms-thresh", type=float, default=None)
    pa.add_argument("--min-mask-region-area", type=int, default=None)
    pa.add_argument("--mask-capacity", type=int, default=None)
    pa.add_argument("--crop-n-layers", type=int, default=None)
    pa.add_argument("--crop-nms-thresh", type=float, default=None)
    _add_model_args(pa)
    pa.set_defaults(fn=cmd_amg)

    pb = sub.add_parser("demo-3dbbox", help="single-pair pipeline + 3-D bbox render")
    pb.add_argument("--prompt", required=True, help="prompt image path")
    pb.add_argument("--target", required=True, help="target image path")
    pb.add_argument("--k0", default=None, help="prompt intrinsics txt (default: reference demo K0)")
    pb.add_argument("--k1", default=None, help="target intrinsics txt (default: reference demo K1)")
    pb.add_argument("--box3d", default=None, help="8x3 bbox corners txt (default: reference demo extents)")
    pb.add_argument("--prompt-pose", default=None, help="prompt pose txt (default: prompt.txt beside --prompt)")
    pb.add_argument("--target-pose", default=None, help="target pose txt (default: target.txt beside --prompt)")
    pb.add_argument("--out-query", default="query_result.png")
    pb.add_argument("--out-bbox", default="3D_BBox.png")
    _add_model_args(pb)
    pb.set_defaults(fn=cmd_demo_3dbbox)

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

    ptm = sub.add_parser(
        "train-matcher",
        help="train the LoFTR matcher on multi-scene data with auc@10-monitored checkpointing "
        "(scripts/train.py equivalent)",
    )
    ptm.add_argument("--data-source", default="megadepth", choices=["megadepth", "scannet"])
    ptm.add_argument("--data-root", required=True)
    ptm.add_argument("--train-npz", nargs="+", required=True, help="one npz scene index per training scene")
    ptm.add_argument("--val-npz", nargs="+", required=True)
    ptm.add_argument("--intrinsic-path", default=None, help="scannet per-scene intrinsics npz")
    ptm.add_argument("--min-overlap-score", type=float, default=0.4)
    ptm.add_argument("--img-resize", type=int, default=840, help="megadepth longest-side resize (IMG_RESIZE)")
    ptm.add_argument("--depth-max-size", type=int, default=2000)
    ptm.add_argument("--batch-size", type=int, default=4, help="global batch per step (lr scales with it)")
    ptm.add_argument("--epochs", type=int, default=30)
    ptm.add_argument("--n-samples-per-subset", type=int, default=200)
    ptm.add_argument("--canonical-lr", type=float, default=6e-3)
    ptm.add_argument("--warmup-steps", type=int, default=4800)
    ptm.add_argument("--epi-err-thr", type=float, default=5e-4, help="5e-4 for ScanNet, 1e-4 for MegaDepth")
    ptm.add_argument("--dp", type=int, default=1, help="data-parallel size (ranks on this host)")
    ptm.add_argument("--tp", type=int, default=1, help="tensor-parallel size (ranks on this host)")
    ptm.add_argument("--ckpt-dir", default=None)
    ptm.add_argument("--resume", action="store_true", help="continue from <ckpt-dir>/last at the saved epoch")
    ptm.add_argument("--history-out", default=None, help="write the per-epoch train/val metric history json")
    ptm.add_argument("--seed", type=int, default=66)
    ptm.add_argument("--device", default=None, help="torch device, default cuda")
    ptm.set_defaults(fn=cmd_train_matcher)

    pex = sub.add_parser("export", help="serialize a serving head as a torch.export program "
                         "(scripts/export_onnx_model.py equivalent)")
    pex.add_argument("--target", required=True, choices=["sam-prompt-head", "sam-decoder", "matcher", "dinov2"])
    pex.add_argument("--output", required=True)
    pex.add_argument("--orig-h", type=int, default=480)
    pex.add_argument("--orig-w", type=int, default=640)
    pex.add_argument("--crop-size", type=int, default=256)
    pex.add_argument("--num-points", type=int, default=8)
    pex.add_argument("--img-size", type=int, default=196,
                     help="dinov2 export input resolution (196 = the pipeline's serving crop)")
    pex.add_argument("--return-single-mask", action="store_true")
    pex.add_argument("--use-stability-score", action="store_true")
    _add_model_args(pex)
    pex.set_defaults(fn=cmd_export)

    px = sub.add_parser("extract", help="dump mkpts/crops for regressor training")
    px.add_argument("--dataset", required=True, choices=["linemod", "onepose", "onepose_plusplus", "ycbv"])
    px.add_argument("--data-root", default="data")
    px.add_argument("--pairs-dir", default="data/pairs")
    px.add_argument("--out-dir", required=True)
    px.add_argument("--max-pairs", type=int, default=None)
    _add_model_args(px)
    px.set_defaults(fn=cmd_extract)

    pt = sub.add_parser("train-regressor", help="train the pose regressor")
    pt.add_argument("--dataset", required=True)
    pt.add_argument("--points-dir", required=True)
    pt.add_argument("--data-root", default="data")
    pt.add_argument("--pairs-dir", default="data/pairs")
    pt.add_argument("--net-mode", default="mkpts", choices=["mkpts", "imgs", "mkpts+imgs", "mkpts+vim", "vim"])
    pt.add_argument("--rotation-mode", default="6d", choices=["6d", "quat", "matrix"])
    pt.add_argument("--fusion", default="cross_attn", choices=["cross_attn", "transformer"],
                    help="branch fusion: model0429 cross-attn or model0604 transformer pair")
    pt.add_argument("--vim-size", default="small", choices=["tiny", "small"])
    pt.add_argument("--epochs", type=int, default=100)
    pt.add_argument("--num-sample", type=int, default=500)
    pt.add_argument("--ckpt-dir", default="checkpoints")
    pt.add_argument("--device", default=None, help="torch device, default cuda")
    pt.set_defaults(fn=cmd_train_regressor)

    pr = sub.add_parser("test-regressor", help="evaluate a trained regressor")
    pr.add_argument("--dataset", required=True)
    pr.add_argument("--points-dir", required=True)
    pr.add_argument("--data-root", default="data")
    pr.add_argument("--pairs-dir", default="data/pairs")
    pr.add_argument("--ckpt", required=True)
    pr.add_argument("--num-sample", type=int, default=500)
    pr.add_argument("--device", default=None, help="torch device, default cuda")
    pr.set_defaults(fn=cmd_test_regressor)

    pssl = sub.add_parser("train-ssl", help="DINOv2 self-supervised pretraining (DINO+iBOT+KoLeo)")
    pssl.add_argument("--image-root", required=True)
    pssl.add_argument("--arch", default="vit_small", choices=["vit_small", "vit_base", "vit_large", "vit_giant"])
    pssl.add_argument("--drop-path-rate", type=float, default=0.3, help="student stochastic depth")
    pssl.add_argument("--global-crop-size", type=int, default=224)
    pssl.add_argument("--local-crop-size", type=int, default=98)
    pssl.add_argument("--n-local-crops", type=int, default=8)
    pssl.add_argument("--batch-size", type=int, default=8)
    pssl.add_argument("--total-steps", type=int, default=125000)
    pssl.add_argument("--lr", type=float, default=4e-3)
    pssl.add_argument("--dp", type=int, default=1, help="data-parallel size (ranks on this host)")
    pssl.add_argument("--ckpt-dir", default=None)
    pssl.add_argument("--ckpt-every", type=int, default=1000)
    pssl.add_argument("--seed", type=int, default=0)
    pssl.add_argument(
        "--distributed", action="store_true",
        help="this process is one rank of a multi-process run: the topology comes from --coordinator / "
        "--num-processes / --process-id, else POPE_* or SLURM variables (parallel/launch.py); every rank "
        "runs the same command",
    )
    pssl.add_argument("--coordinator", default=None, help="host:port of process 0 (overrides env)")
    pssl.add_argument("--num-processes", type=int, default=None)
    pssl.add_argument("--process-id", type=int, default=None)
    pssl.add_argument("--device", default=None, help="torch device, default cuda")
    pssl.set_defaults(fn=cmd_train_ssl)

    pnv = sub.add_parser("render-novel-view",
                         help="novel-view synthesis from a posed LINEMOD sequence (per-scene NeRF)")
    pnv.add_argument("--seq-root", required=True, help="sequence dir containing color/ poses_ba/ intrin_ba/")
    pnv.add_argument("--source-ids", default="100,101,102,103,104,105,106,107,108,109,110")
    pnv.add_argument("--target-ids", default=None)
    pnv.add_argument("--out-dir", default=".")
    pnv.add_argument("--label", default=None)
    pnv.add_argument("--train-steps", type=int, default=2000)
    pnv.add_argument("--downscale", type=int, default=1)
    pnv.add_argument("--seed", type=int, default=0)
    pnv.add_argument("--lpips-alexnet", default=None, help="torchvision alexnet-*.pth (backbone) for LPIPS")
    pnv.add_argument("--lpips-lins", default=None, help="lpips-package weights/v0.1/alex.pth (calibrated heads)")
    pnv.add_argument("--device", default=None, help="torch device, default cuda")
    pnv.set_defaults(fn=cmd_render_novel_view)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
