"""The whole step's share of the H100's bf16 peak: SAM's encode and full-
resolution decode FLOPs of an image (counts/flops.py) times the images
completed in the traced window, over the window times 989 TFLOP/s, in %."""


def read(t):
    from benchmark.counts.peaks import BF16_FLOP_PER_S

    return 100.0 * t.flops / (t.window_s * BF16_FLOP_PER_S) if t.window_s > 0 and t.flops > 0 else None
