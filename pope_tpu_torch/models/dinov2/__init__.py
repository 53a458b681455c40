"""DINOv2 ViT: the vision transformer (with its self-supervised training
pieces), its preprocessing, cls-token cosine scoring and the checkpoint
converter (port of pope_tpu/models/dinov2)."""

from pope_tpu_torch.models.dinov2.model import DinoVisionTransformer, vit_base, vit_giant2, vit_large, vit_small
from pope_tpu_torch.models.dinov2.preprocess import cls_token_cosine, preprocess_image
from pope_tpu_torch.models.dinov2.convert import convert_torch_dinov2_state
