"""bf16 storage for the SAM encoder weights that are consumed at bf16
(port of pope_tpu/utils/bf16_storage.py).

When the encoder computes in bf16, every Dense and conv casts its f32
weights to bf16 at use; storing them in bf16 gives the same values and
halves the weight reads. The f32-consumed LayerNorm parameters stay f32.
"""

from __future__ import annotations

import torch

# module names whose parameters the encoder consumes at f32
_SAM_ENCODER_KEEP_F32 = ("norm1", "norm2", "neck_ln1", "neck_ln2")


def cast_sam_storage(sam, encoder_cfg):
    """Cast the image encoder's parameters of `sam` to bf16 in place when the
    encoder computes in bf16 and is not quantized; returns `sam`."""
    if encoder_cfg.dtype != "bfloat16" or encoder_cfg.quantize != "none":
        return sam
    with torch.no_grad():
        for name, p in sam.image_encoder.named_parameters():
            if set(name.split(".")) & set(_SAM_ENCODER_KEEP_F32):
                continue
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return sam
