"""Ops of the port: the CUDA attention kernels' wrappers and plain versions,
the w8a8 int8 dense, the matcher's attention variants, ring attention, NMS,
connected components, mask ops and resampling."""

from pope_tpu_torch.ops.attention import full_attention, linear_attention
from pope_tpu_torch.ops.quant import QuantDense, dense_w8a8, quantize_rows, quantize_weight_cols
from pope_tpu_torch.ops.resize import resize_bilinear_torch, upsample2x_align_corners
from pope_tpu_torch.ops.ring_attention import ring_attention
