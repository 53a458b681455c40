"""SAM: image encoder, prompt encoder, two-way mask decoder and the eval
path of automatic mask generation (port of pope_tpu/models/sam)."""

from pope_tpu_torch.models.sam.encoder import ImageEncoderViT
from pope_tpu_torch.models.sam.prompt import PromptEncoder, random_position_embedding
from pope_tpu_torch.models.sam.decoder import MaskDecoder, TwoWayTransformer
from pope_tpu_torch.models.sam.sam import Sam
from pope_tpu_torch.models.sam.convert import convert_torch_sam_state
from pope_tpu_torch.models.sam.amg import AutomaticMaskGenerator, AMGResult
