"""LoFTR-style coarse-to-fine matcher: ResNet-FPN backbone, linear-attention
transformer, dual-softmax or sinkhorn coarse matching (GT-padded in
training) and sub-pixel fine matching (port of pope_tpu/models/matcher)."""

from pope_tpu_torch.models.matcher.model import Matcher, MatchResult
from pope_tpu_torch.models.matcher.backbone import ResNetFPN
from pope_tpu_torch.models.matcher.convert import convert_torch_matcher_state
