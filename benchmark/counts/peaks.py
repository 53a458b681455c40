"""Published peaks of one NVIDIA H100 SXM (dense, without sparsity)."""

BF16_FLOP_PER_S = 989e12  # bf16 / fp16 tensor cores
TF32X3_FLOP_PER_S = 989e12 / 6  # 164.9e12: a float32 product as three TF32 products at 495e12
HBM_BYTES_PER_S = 3.35e12
