"""Top-level LoFTR-style matcher, static shapes end to end (port of
pope_tpu/models/matcher/model.py).

backbone -> + position encoding -> coarse transformer -> dual-softmax (or
sinkhorn) coarse matching [-> GT padding in training] -> fine windows (+
projected coarse context) -> fine transformer -> sub-pixel refinement.
Every output is a fixed-capacity (B, M, ...) tensor with a validity mask.
`.train()` mode is the JAX package's train=True: batch statistics in the
backbone's BatchNorms and no sinkhorn prefilter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pope_tpu_torch.config import MatcherConfig
from pope_tpu_torch.models.matcher.backbone import ResNetFPN
from pope_tpu_torch.models.matcher.matching import (
    coarse_matching,
    dual_softmax_confidence,
    extract_fine_windows,
    fine_matching,
    gt_pad_matches,
    matches_to_coords,
    sinkhorn_confidence,
)
from pope_tpu_torch.models.matcher.transformer import LocalFeatureTransformer, sine_position_encoding


class MatchResult(NamedTuple):
    mkpts0: torch.Tensor  # (B, M, 2) pixel coords in image0
    mkpts1: torch.Tensor  # (B, M, 2) pixel coords in image1 (sub-pixel refined)
    mconf: torch.Tensor  # (B, M) confidence; 0 on padded slots
    valid: torch.Tensor  # (B, M) bool
    expec_f: torch.Tensor  # (B, M, 3) normalized fine coords + heatmap std
    n_dropped: torch.Tensor  # (B,) true matches the match capacity cut
    conf_matrix: Optional[torch.Tensor] = None  # (B, L, S) when return_aux
    i_ids: Optional[torch.Tensor] = None  # (B, M) when return_aux
    j_ids: Optional[torch.Tensor] = None

    @property
    def num_matches(self):
        return self.valid.sum(-1)

    def strong_match_count(self, thr: float = 0.9):
        """Retrieval vote: matches with mconf > thr."""
        return ((self.mconf > thr) & self.valid).sum(-1)


class Matcher(nn.Module):
    """Coarse-to-fine matcher over two grayscale image batches.

    image0 (B0, H0, W0, 1), image1 (B1, H1, W1, 1), float in [0, 1], sides
    divisible by 8. Equal shapes and batches share one backbone call. When
    B1 = k * B0 with other shapes, each image0 is the prompt of k consecutive
    image1 rows: its backbone runs once and its features are shared, as the
    JAX package does for B0 = 1 (one prompt against its top-k crops), so a
    batch of pairs runs as one call.
    """

    def __init__(self, config: MatcherConfig = MatcherConfig()):
        super().__init__()
        cfg = config
        if cfg.match_coarse.match_type not in ("dual_softmax", "sinkhorn"):
            raise ValueError(f"unknown match_type {cfg.match_coarse.match_type!r}")
        self.config = cfg
        dtype = getattr(torch, cfg.dtype)
        d1, _, d3 = cfg.backbone.block_dims
        d_f = cfg.fine.d_model
        self.backbone = ResNetFPN(cfg.backbone.initial_dim, tuple(cfg.backbone.block_dims), dtype)
        self.loftr_coarse = LocalFeatureTransformer(
            cfg.coarse.d_model, cfg.coarse.nhead, cfg.coarse.layer_names, cfg.coarse.attention, dtype
        )
        if cfg.fine_concat_coarse_feat:
            self.fine_down_proj = nn.Linear(d3, d_f)
            self.fine_merge_feat = nn.Linear(d1 + d_f, d_f)
        # the fine stage stays f32 whatever cfg.dtype: its feature noise lands
        # directly in the sub-pixel expectation
        self.loftr_fine = LocalFeatureTransformer(
            d_f, cfg.fine.nhead, cfg.fine.layer_names, cfg.fine.attention, torch.float32
        )
        if cfg.match_coarse.match_type == "sinkhorn":
            self.bin_score = nn.Parameter(torch.tensor(float(cfg.match_coarse.skh_init_bin_score)))

    def _features(self, image0, image1):
        """Backbone features (coarse, fine) of both sides and the number of
        image1 rows that share each image0 row (1: no sharing)."""
        B0, B1 = image0.shape[0], image1.shape[0]
        if image0.shape == image1.shape:
            feats_c, feats_f = self.backbone(torch.cat([image0, image1], dim=0))
            return feats_c[:B0], feats_f[:B0], feats_c[B0:], feats_f[B0:], 1
        if B1 % B0:
            raise ValueError(f"image1 batch {B1} is not a multiple of image0 batch {B0}")
        c0, f0 = self.backbone(image0)
        c1, f1 = self.backbone(image1)
        return c0, f0, c1, f1, B1 // B0

    def forward(self, image0, image1, return_aux: bool = False, gt_valid=None, gt_j_of_i=None,
                gt_pad_noise=None) -> MatchResult:
        """gt_valid (B, L) bool / gt_j_of_i (B, L): the GT coarse matches of
        train/supervision.spvs_coarse; when given, they pad the fine stage's
        samples (gt_pad_matches, with gt_pad_noise (B, L) U[0, 1) draws or
        its fixed hash)."""
        cfg = self.config
        feat_c0, feat_f0, feat_c1, feat_f1, group = self._features(image0, image1)
        B0, h0c, w0c, C = feat_c0.shape
        B, h1c, w1c, _ = feat_c1.shape
        L, S = h0c * w0c, h1c * w1c
        dev = feat_c0.device

        pe0 = sine_position_encoding(h0c, w0c, C, cfg.temp_bug_fix, dev)
        pe1 = sine_position_encoding(h1c, w1c, C, cfg.temp_bug_fix, dev)
        f0 = (feat_c0 + pe0[None].to(feat_c0.dtype)).reshape(B0, L, C)
        f1 = (feat_c1 + pe1[None].to(feat_c1.dtype)).reshape(B, S, C)
        f0 = f0.repeat_interleave(group, dim=0)  # the layers make them differ
        f0, f1 = self.loftr_coarse(f0, f1)

        mc = cfg.match_coarse
        if mc.match_type == "sinkhorn":
            conf = sinkhorn_confidence(f0.float(), f1.float(), self.bin_score, iters=mc.skh_iters,
                                       prefilter=not self.training)
        else:
            conf = dual_softmax_confidence(f0.float(), f1.float(), mc.dsmax_temperature)
        cm = coarse_matching(conf, (h0c, w0c), (h1c, w1c), thr=mc.thr, border_rm=mc.border_rm,
                             capacity=mc.match_capacity)
        if gt_valid is not None:
            gt_min = min(mc.train_pad_num_gt_min, mc.match_capacity // 2)
            cm = gt_pad_matches(cm, gt_valid, gt_j_of_i, gt_min, noise=gt_pad_noise)

        # fine stage, f32
        W = cfg.fine_window_size
        WW = W * W
        stride = cfg.coarse_stride // cfg.fine_stride
        d_f = cfg.fine.d_model
        M = cm.i_ids.shape[1]
        # image0's windows straight from its shared fine features: no copy of
        # the (B0, Hf, Wf, C) maps per image1 row
        win0 = extract_fine_windows(
            feat_f0.float(), cm.i_ids.reshape(B0, group * M), (h0c, w0c), W, stride
        ).reshape(B, M, WW, -1)
        win1 = extract_fine_windows(feat_f1.float(), cm.j_ids, (h1c, w1c), W, stride)
        if cfg.fine_concat_coarse_feat:
            c0_sel = f0.gather(1, cm.i_ids[..., None].expand(B, M, C)).float()
            c1_sel = f1.gather(1, cm.j_ids[..., None].expand(B, M, C)).float()
            c0_d = self.fine_down_proj(c0_sel)
            c1_d = self.fine_down_proj(c1_sel)
            win0 = self.fine_merge_feat(torch.cat([win0, c0_d[..., None, :].expand(B, M, WW, d_f)], -1))
            win1 = self.fine_merge_feat(torch.cat([win1, c1_d[..., None, :].expand(B, M, WW, d_f)], -1))
        win0_t, win1_t = self.loftr_fine(win0.reshape(B * M, WW, d_f), win1.reshape(B * M, WW, d_f))
        coords, std = fine_matching(
            win0_t.reshape(B, M, WW, d_f).float(), win1_t.reshape(B, M, WW, d_f).float(), W
        )

        mkpts0 = matches_to_coords(cm.i_ids, w0c, float(cfg.coarse_stride))
        mkpts1 = matches_to_coords(cm.j_ids, w1c, float(cfg.coarse_stride))
        mkpts1 = mkpts1 + coords * (W // 2) * float(cfg.fine_stride)
        keep = cm.valid[..., None]
        mkpts0 = torch.where(keep, mkpts0, torch.zeros_like(mkpts0))
        mkpts1 = torch.where(keep, mkpts1, torch.zeros_like(mkpts1))
        return MatchResult(
            mkpts0=mkpts0, mkpts1=mkpts1, mconf=cm.mconf, valid=cm.valid,
            expec_f=torch.cat([coords, std[..., None]], dim=-1), n_dropped=cm.n_dropped,
            conf_matrix=conf if return_aux else None,
            i_ids=cm.i_ids if return_aux else None,
            j_ids=cm.j_ids if return_aux else None,
        )
