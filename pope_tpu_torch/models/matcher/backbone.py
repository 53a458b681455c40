"""ResNet-FPN local-feature CNN (port of pope_tpu/models/matcher/backbone.py).

7x7/2 stem -> three residual stages at 1/2, 1/4, 1/8 -> top-down FPN with
align-corners 2x upsampling; outputs the 1/8 coarse and 1/2 fine features.
Bias-free convs with BatchNorm (eps 1e-5; running statistics in eval
mode, batch statistics in train mode), computed in f32 as flax's
BatchNorm(dtype=float32) is. The JAX package is
NHWC; here the backbone runs NCHW inside and takes and returns NHWC, with
its convs outside cuDNN on the card (`native_conv2d`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.models.sam.encoder import tp_shard
from pope_tpu_torch.ops.resize import upsample2x_align_corners


def native_conv2d(x, weight, stride, padding):
    """A bias-free conv2d. On a CUDA tensor it is PyTorch's own convolution
    (im2col and a cuBLAS product: what F.conv2d runs with cuDNN off), called
    by its op name so that its backward and an exported graph keep it too:
    cuDNN 9's heuristics pick FFT algorithms for this network's float32 3x3
    convs with 196 output channels at 1/4 resolution, which take hundreds of
    times longer and tens of GB of workspace (chip_smoke.py times the
    backbone both ways). On the CPU, F.conv2d."""
    if x.is_cuda:
        return torch.ops.aten._slow_conv2d_forward(x, weight, tuple(weight.shape[2:]), None, stride, padding)
    return F.conv2d(x, weight, None, stride, padding)


def conv(layer: nn.Conv2d, x, dtype):
    """flax nn.Conv(dtype=dtype, use_bias=False) on an NCHW tensor (a
    tp-sharded layer's output gathered over tp)."""
    tp = tp_shard(layer)
    return tp.gather(native_conv2d(tp.enter(x).to(dtype), layer.weight.to(dtype), layer.stride, layer.padding), 1)


_BATCH_PARTS = contextvars.ContextVar("batch_parts", default=(lambda t: t, 1))


@contextlib.contextmanager
def batch_statistics_over(total: Callable, parts: int):
    """Inside the block, train-mode BatchNorm normalises over a global batch
    of `parts` equal batches, one of them this process's: total(t) sums t
    over the parts, with a gradient that flows back to each (SyncBatchNorm
    semantics; flax's train-mode BatchNorm under SPMD normalises over the
    global batch)."""
    token = _BATCH_PARTS.set((total, parts))
    try:
        yield
    finally:
        _BATCH_PARTS.reset(token)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax's arithmetic, in f32:
    (x - mean) * (rsqrt(var + eps) * scale) + bias.

    Eval mode uses the running statistics. Train mode uses the batch's over
    (N, H, W), as flax computes them: var = E[x^2] - E[x]^2 clipped at 0
    (biased), and updates the running statistics with flax's momentum 0.9,
    running = 0.9 * running + 0.1 * batch, with that biased variance
    (F.batch_norm keeps the unbiased one, and its momentum is the other
    side's weight). Inside `batch_statistics_over`, the batch is one of
    equal parts of a global batch, whose statistics it takes."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        c = lambda t: t.float()[None, :, None, None]
        x = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            total, parts = _BATCH_PARTS.get()
            n = x.numel() // x.shape[1] * parts
            sums = total(torch.stack([x.sum(dim=(0, 2, 3)), x.square().sum(dim=(0, 2, 3))]))
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean.square(), min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        mul = torch.rsqrt(c(var) + self.eps) * c(self.weight)
        return (x - c(mean)) * mul + c(self.bias)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x, dtype):
        return self.bn(conv(self.conv, x, dtype))


class BasicBlock(nn.Module):
    """Two 3x3 conv-bn with an identity or 1x1 downsample skip."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.cb1 = ConvBN(cin, cout, 3, stride)
        self.cb2 = ConvBN(cout, cout, 3, 1)
        self.down = ConvBN(cin, cout, 1, stride) if stride != 1 else None

    def forward(self, x, dtype):
        y = self.cb2(F.relu(self.cb1(x, dtype)), dtype)
        if self.down is not None:
            x = self.down(x, dtype)
        return F.relu(x + y)


class FPNOutBlock(nn.Module):
    """conv3x3 -> BN -> LeakyReLU(0.01) -> conv3x3."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.cb = ConvBN(cin, mid, 3, 1)
        self.conv_out = nn.Conv2d(mid, out, 3, padding=1, bias=False)

    def forward(self, x, dtype):
        return conv(self.conv_out, F.leaky_relu(self.cb(x, dtype), 0.01), dtype)


class ResNetFPN(nn.Module):
    """(B, H, W, 1) grayscale in [0, 1], H and W divisible by 8 -> (coarse
    (B, H/8, W/8, d3), fine (B, H/2, W/2, d1)), NHWC."""

    def __init__(self, initial_dim: int = 128, block_dims=(128, 196, 256), dtype=torch.float32):
        super().__init__()
        d1, d2, d3 = block_dims
        self.dtype = dtype
        self.stem_conv = nn.Conv2d(1, initial_dim, 7, 2, padding=3, bias=False)
        self.stem_bn = BatchNorm(initial_dim)
        self.layer1_0 = BasicBlock(initial_dim, d1, 1)
        self.layer1_1 = BasicBlock(d1, d1, 1)
        self.layer2_0 = BasicBlock(d1, d2, 2)
        self.layer2_1 = BasicBlock(d2, d2, 1)
        self.layer3_0 = BasicBlock(d2, d3, 2)
        self.layer3_1 = BasicBlock(d3, d3, 1)
        self.l3_out = nn.Conv2d(d3, d3, 1, bias=False)
        self.l2_lat = nn.Conv2d(d2, d3, 1, bias=False)
        self.l2_out = FPNOutBlock(d3, d3, d2)
        self.l1_lat = nn.Conv2d(d1, d2, 1, bias=False)
        self.l1_out = FPNOutBlock(d2, d2, d1)

    def forward(self, x):
        dt = self.dtype
        # a (B, H, W, 1) frame permuted to (B, 1, H, W) also passes for
        # channels-last, and the convs would carry that layout through the
        # network: a fresh NCHW copy keeps every conv on NCHW
        x = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        x0 = F.relu(self.stem_bn(conv(self.stem_conv, x, dt)))
        x1 = self.layer1_1(self.layer1_0(x0, dt), dt)  # 1/2
        x2 = self.layer2_1(self.layer2_0(x1, dt), dt)  # 1/4
        x3 = self.layer3_1(self.layer3_0(x2, dt), dt)  # 1/8
        x3_out = conv(self.l3_out, x3, dt)
        x3_up = upsample2x_align_corners(x3_out, hw_axes=(2, 3))
        x2_out = self.l2_out(conv(self.l2_lat, x2, dt) + x3_up, dt)
        x2_up = upsample2x_align_corners(x2_out, hw_axes=(2, 3))
        x1_out = self.l1_out(conv(self.l1_lat, x1, dt) + x2_up, dt)
        return x3_out.permute(0, 2, 3, 1), x1_out.permute(0, 2, 3, 1)
