"""Single dataclass-based config system for the whole framework.

The dataclasses of pope_tpu/config.py, field for field with the same
defaults (tests/test_torch_weights.py checks it), so that one config drives
either package. The port keeps its own copy because it imports nothing of
the JAX package. Comments that reported TPU measurements are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """ResNet-FPN (src/matcher/backbone/resnet_fpn.py; dims from
    cvpr_ds_config.py:16-18)."""

    initial_dim: int = 128
    block_dims: Tuple[int, ...] = (128, 196, 256)
    resolution: Tuple[int, int] = (8, 2)  # (coarse, fine) strides


@dataclasses.dataclass(frozen=True)
class LoFTRStageConfig:
    """One LocalFeatureTransformer stage (cvpr_ds_config.py:21-27,41-46)."""

    d_model: int = 256
    d_ffn: int = 256
    nhead: int = 8
    layer_names: Tuple[str, ...] = ("self", "cross") * 4
    attention: str = "linear"  # 'linear' | 'full'


@dataclasses.dataclass(frozen=True)
class CoarseMatchConfig:
    """Dual-softmax coarse matching (cvpr_ds_config.py:30-39)."""

    thr: float = 0.2
    border_rm: int = 2
    dsmax_temperature: float = 0.1
    match_capacity: int = 1024  # static cap on kept matches
    # train-time GT padding of the fine-stage sample set
    # (cvpr_ds_config.py:39-40; match_capacity plays num_matches_train)
    train_coarse_percent: float = 0.4
    train_pad_num_gt_min: int = 200
    # coarse assignment: 'dual_softmax' (default) | 'sinkhorn'
    match_type: str = "dual_softmax"
    skh_iters: int = 3  # sinkhorn iterations (default.py:30-33)
    skh_init_bin_score: float = 1.0


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Full LoFTR-style matcher (cvpr_ds_config.py defaults)."""

    backbone: BackboneConfig = BackboneConfig()
    coarse: LoFTRStageConfig = LoFTRStageConfig()
    fine: LoFTRStageConfig = LoFTRStageConfig(
        d_model=128, d_ffn=128, nhead=8, layer_names=("self", "cross")
    )
    match_coarse: CoarseMatchConfig = CoarseMatchConfig()
    fine_window_size: int = 5  # must be odd (cvpr_ds_config.py:12)
    fine_concat_coarse_feat: bool = True
    temp_bug_fix: bool = False  # released indoor weights use the buggy pos-enc
    mconf_strong_thr: float = 0.9  # retrieval vote threshold (eval_*.py:118-119)
    dtype: str = "float32"  # compute dtype for the NN body

    @property
    def coarse_stride(self) -> int:
        return self.backbone.resolution[0]

    @property
    def fine_stride(self) -> int:
        return self.backbone.resolution[1]


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    """DINOv2 ViT-S/14 (dinov2/models/vision_transformer.py:306 vit_small +
    configs/eval/vits14_pretrain.yaml)."""

    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    init_values: float = 1e-5  # layer scale (ssl_default_config.yaml:75)
    num_register_tokens: int = 0
    interpolate_offset: float = 0.1
    dtype: str = "float32"
    # stochastic depth for SSL training (ssl_default_config.yaml:74 uses 0.3;
    # inference checkpoints need none) — vision_transformer.py:58-59,104-107
    drop_path_rate: float = 0.0
    drop_path_uniform: bool = False  # else linspace(0, rate, depth) decay
    ffn_layer: str = "mlp"  # 'mlp' | 'swiglufused' (vit_giant2 uses swiglu)
    # 'erf' is the reference-exact gelu, 'tanh' the cheaper approximation
    # (see SamEncoderConfig.gelu); the eval pipeline's retrieval tower opts
    # into tanh next to its bf16 dtype.
    gelu: str = "erf"  # 'erf' | 'tanh'


@dataclasses.dataclass(frozen=True)
class SamEncoderConfig:
    """SAM ViT image encoder (segment_anything/modeling/image_encoder.py:17;
    per-size params build_sam.py:13-50)."""

    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    use_rel_pos: bool = True
    # The JAX package's switches for its two Pallas attention kernels (global
    # and 14x14 windowed layers). The port does not read them: on the card
    # its encoder always launches its CUDA kernels, on the CPU their plain
    # versions.
    use_flash_attention: bool = True
    fused_window_attention: bool = True
    dtype: str = "bfloat16"
    # 'int8': the experimental w8a8 encoder path (ops/quant.py::QuantDense on
    # every block's qkv / proj / MLP; no accuracy gate), as in the JAX package.
    quantize: str = "none"
    # gelu flavor for the MLP halves: the reference uses exact erf gelu
    # (image_encoder.py's nn.GELU default); 'tanh' ships as the default, next
    # to the bf16 activations; the parity tests pin gelu='erf' alongside
    # dtype='float32'.
    gelu: str = "tanh"  # 'erf' | 'tanh'

    @classmethod
    def vit_b(cls):
        return cls(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11))

    @classmethod
    def vit_l(cls):
        return cls(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23))

    @classmethod
    def vit_h(cls):
        return cls()


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """Full SAM: encoder + prompt encoder + mask decoder
    (segment_anything/modeling/sam.py:18)."""

    encoder: SamEncoderConfig = SamEncoderConfig()
    prompt_embed_dim: int = 256
    image_embedding_size: int = 64  # img_size // patch_size
    mask_in_chans: int = 16
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    iou_head_hidden_dim: int = 256
    # decoder compute dtype: bf16 for the per-prompt ConvTranspose upscaling;
    # logits/filters compare at thresholds (0.0 / 0.9 / 0.95) far above bf16
    # resolution
    decoder_dtype: str = "bfloat16"
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class AMGConfig:
    """Automatic mask generation, POPE-tuned defaults
    (automatic_mask_generator.py:36-52)."""

    points_per_side: int = 16
    points_per_batch: int = 2048
    pred_iou_thresh: float = 0.9
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.35
    min_mask_region_area: int = 250
    mask_capacity: int = 64  # static cap on surviving masks
    # multi-scale crop layers (automatic_mask_generator.py:45-48): layer i
    # re-runs the grid on (2^i)^2 overlapping crops. POPE runs 0 (the fused
    # single-crop device path); >0 switches generate_records to a
    # host-orchestrated per-crop loop (one encoder program per distinct
    # patch-quantized crop shape)
    crop_n_layers: int = 0
    crop_nms_thresh: float = 0.35
    crop_overlap_ratio: float = 512 / 1500
    crop_n_points_downscale_factor: int = 1
    # prompts decoded per chunk: bounds the decoder's upscaling
    # intermediates (~chunk x 32ch x 256^2 f32); 0 disables chunking
    points_per_chunk: int = 128
    # on-device small-region cleanup: max connected components processed per
    # mask (raster-first, like cv2 label order); components beyond the cap
    # are conservatively kept untouched
    cc_max_components: int = 64
    # eval-path (generate_boxes_batch) mask resolution: 4 decodes EXACT
    # stride-4-subsampled logits at 64x64 (decoder.UpConvT), skipping 15/16
    # of the upscale/filter/CC work. Boxes quantize from +-2px to +-8px in
    # the 1024 frame (+-5px at VGA); stability/area become 4096-sample
    # estimates of the 256-res values. Solid masks (what the small-region
    # cleanup guarantees) move each box edge inward by at most 3 full-res
    # pixels, and the pipeline expands every box by compact_percent=0.3
    # before cropping, so retrieval/matching are insensitive to the shift.
    # The records path (generate/generate_batch) always stays at full 256
    # resolution.
    eval_decode_subsample: int = 4
    # rect-encode: pad non-square frames only to patch multiples instead of
    # the full square — a 640x480 frame encodes a 48x64 token grid (25% fewer
    # encoder tokens; windowed layers drop whole pure-padding windows, the
    # global layers attend over 3072 instead of 4096 tokens). Content tokens
    # see the identical pos-embed / rel-pos / dense-PE parameters (sliced,
    # not interpolated); the only difference vs the reference's square frame
    # is that zero-padding tokens no longer participate in attention / the
    # neck convs — which the reference itself discards downstream. Square
    # images are unaffected (frame == square), so oracle parity holds there;
    # set False for square-frame-exact compute on non-square images too.
    rect_encode: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Composed POPE pipeline (eval_*_json.py driver constants)."""

    matcher: MatcherConfig = MatcherConfig()
    # bf16 retrieval tower; parity tests pin float32 via their own
    # DinoV2Config. Set dtype="float32" here for bit-conservative scoring.
    dinov2: DinoV2Config = DinoV2Config(dtype="bfloat16", gelu="tanh")
    sam: SamConfig = SamConfig()
    amg: AMGConfig = AMGConfig()
    top_k: int = 3  # retrieval candidates (eval_linemod_json.py:71)
    compact_percent: float = 0.3
    crop_size: int = 256  # 512 for OnePose (eval_onepose_json.py:88)
    ransac_thresh_px: float = 0.5
    ransac_conf: float = 0.99
    # guided-resampling rounds (see the JAX package's solver/ransac.py)
    ransac_rounds: int = 3
    failure_penalty_deg: float = 90.0  # eval_linemod_json.py:166-168


@dataclasses.dataclass(frozen=True)
class RegressorConfig:
    """Pose-regression extension (pose/model0429_mkpts.py, train0429*.py)."""

    num_sample: int = 500  # mkpts per pair (train0429_mkpts.py:85)
    n_freqs: int = 9  # NeRF-style positional embedding (model0429_mkpts.py:11)
    d_model: int = 256
    nhead: int = 8
    num_layers: int = 6
    rotation_mode: str = "6d"  # '6d' | 'quat' | 'matrix'
    # 'mkpts' | 'imgs' | 'mkpts+imgs' (model0429/model0604) |
    # 'mkpts+vim' (model0606: frozen VisionMamba image branch) | 'vim'
    net_mode: str = "mkpts"
    # branch fusion: 'cross_attn' (model0429_mkpts.py:330-337) |
    # 'transformer' (model0604.py MoCoPE's nn.Transformer pair)
    fusion: str = "cross_attn"
    fusion_layers: int = 2  # encoder/decoder depth of the transformer fusion
    vim_size: str = "small"  # 'tiny' | 'small' (model0606.py:88-96)
    freeze_vim: bool = True  # the reference trains MoCoPE with Vim frozen
    lr: float = 1e-5
    weight_decay: float = 1e-5
    batch_size: int = 8
    seed: int = 20231223
