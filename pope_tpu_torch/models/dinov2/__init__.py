"""DINOv2 ViT for retrieval: the vision transformer (inference), its
preprocessing, cls-token cosine scoring and the checkpoint converter (port
of pope_tpu/models/dinov2)."""

from pope_tpu_torch.models.dinov2.model import DinoVisionTransformer
from pope_tpu_torch.models.dinov2.preprocess import cls_token_cosine, preprocess_image
from pope_tpu_torch.models.dinov2.convert import convert_torch_dinov2_state
