"""The control: the reference computed one precision step below what the
configuration states, in the program's place. SAM's encoder and decoder,
stated in bfloat16, take fp8 (e4m3) operands in every dense layer,
convolution and the upscaling's transposed convolutions: the input and the
weight each rounded to float8_e4m3fn under a per-tensor scale
(amax / 448), the product accumulated in float32, as an fp8 GEMM does;
what the configuration states in float32 (attention logits) runs with TF32
on. Its numbers, against the float32 reference on the frames that a run of
the same seed compares, are the limits' upper readings:

    python3 -m benchmark.reference.control --workload <cell> --seeds 21,22,23

prints one JSON line a seed and, last, the smallest reading of each number.
The benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark.reference.popref.models.sam import decoder, encoder, prompt

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn under a per-tensor scale, back in x's dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class _W:
    """A layer seen through fp8 weights."""

    def __init__(self, layer):
        self._layer = layer
        self.weight = fp8(layer.weight)

    def __getattr__(self, name):
        return getattr(self._layer, name)


@contextlib.contextmanager
def lower_precision():
    """Patch the reference's dense, conv and TF32 settings for the control;
    restore them on exit."""
    dense0, conv0 = encoder.dense, encoder.conv_nhwc

    def dense(layer, x, dtype):
        return dense0(_W(layer), fp8(x), dtype)

    def conv_nhwc(layer, x, dtype):
        return conv0(_W(layer), fp8(x), dtype)

    patches = [(m, "dense", dense) for m in (encoder, decoder) if hasattr(m, "dense")]
    patches += [(m, "conv_nhwc", conv_nhwc) for m in (encoder, prompt) if hasattr(m, "conv_nhwc")]
    up0 = decoder.UpConvT.forward

    def upconv(self, x, subsample: bool = False):
        kernel = self.kernel
        try:
            self.kernel = torch.nn.Parameter(fp8(kernel.detach()), requires_grad=False)
            return up0(self, fp8(x), subsample)
        finally:
            self.kernel = kernel

    patches += [(decoder.UpConvT, "forward", upconv)]
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for m, a, f in patches:
            setattr(m, a, f)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def readings(cell, seed: int, device, ref=None) -> dict:
    """The largest gap of each of the cell's network numbers between the
    control and the float32 reference over the frames that a run of this
    seed compares (the cell's driver names them). `ref`: the reference's
    models, built once for many seeds."""
    from benchmark.harness import build_reference, reference_precision
    from benchmark.reference import amg, compare

    reference_precision(str(device))
    if ref is None:
        ref = build_reference(cell, device)
    worst = {}
    for frame in cell.driver().sampled_frames(cell.traffic, seed):
        reference_precision(str(device))
        want = amg.grid_decode(ref.sam, ref.config.amg, frame, ref.device)
        with lower_precision():
            got = amg.grid_decode(ref.sam, ref.config.amg, frame, ref.device)
        for k, v in compare.sam_gaps(got, want).items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want, got
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    from benchmark.cells import Cell, find_spec, load_json
    from benchmark.harness import build_reference

    if not torch.cuda.is_available():
        print("benchmark: the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(load_json(find_spec()), args.workload)
    ref = build_reference(cell, "cuda")
    upper = {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        numbers = readings(cell, seed, "cuda", ref)
        print(json.dumps({"seed": seed, "control": numbers}), flush=True)
        for k, v in numbers.items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"upper": upper, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
