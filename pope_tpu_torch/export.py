"""SAM's prompt head for serving (port of pope_tpu/export.py's
`export_sam_prompt_head`, the SamOnnxModel surface: prompt encoder + mask
decoder + postprocess, taking a cached image embedding).

The JAX package serializes this head as a StableHLO artifact; here it is an
`nn.Module` with the same inputs and outputs. Serializing it
(`torch.export`) and the package's other exports (`export_sam_decoder`,
`export_matcher`, `export_dinov2`) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from pope_tpu_torch.models.sam.sam import postprocess_masks, resize_longest_side
from pope_tpu_torch.ops.masks import calculate_stability_score


class SamPromptHead(nn.Module):
    """(image_embeddings (1, E, E, C), point_coords (1, P, 2) in the resized
    frame, point_labels (1, P), mask_input (1, 4E, 4E, 1), has_mask_input
    (1,)[, click_count (1,): return_single_mask only]) -> (upscaled masks
    (1, K, H0, W0) at `orig_hw`, scores (1, K), low-res masks (1, K, 4E, 4E)).

    K = 4: every mask token, unsliced. With return_single_mask, token 0's
    score is moved by (click_count - 2.5) * 1000 and the best token is kept
    (K = 1): a prompt of one click and its pad point takes the best multimask
    token, more clicks take token 0. Label -1 slots are no-ops, so a fixed
    capacity P with the true point count in `click_count` gives the reference
    head's result. use_stability_score replaces the IoU scores by the masks'
    stability scores. Outputs are f32."""

    def __init__(self, sam, orig_hw: Tuple[int, int], num_points: int = 8,
                 return_single_mask: bool = False, use_stability_score: bool = False):
        super().__init__()
        self.sam = sam
        self.orig_hw = tuple(orig_hw)
        self.num_points = int(num_points)
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score
        self.input_hw = resize_longest_side(*self.orig_hw, sam.config.encoder.img_size)

    def forward(self, image_embeddings, point_coords, point_labels, mask_input, has_mask_input,
                click_count=None):
        if point_coords.shape[1] != self.num_points or point_labels.shape[1] != self.num_points:
            raise ValueError(f"the head takes {self.num_points} prompt slots, got {tuple(point_coords.shape)} "
                             f"points and {tuple(point_labels.shape)} labels")
        pe = self.sam.prompt_encoder
        sparse, dense_m = pe(point_coords, point_labels, mask_input)
        _, dense_nm = pe(point_coords, point_labels, None)
        w = has_mask_input.reshape(-1, 1, 1, 1)
        dense = w * dense_m + (1.0 - w) * dense_nm
        masks, scores = self.sam.mask_decoder(
            image_embeddings, pe.get_dense_pe(), sparse, dense, multimask_output=True, return_all_tokens=True,
        )
        masks, scores = masks.float(), scores.float()
        if self.use_stability_score:
            scores = calculate_stability_score(masks, 0.0, 1.0)
        if self.return_single_mask:
            reweight = torch.tensor([[1000.0, 0.0, 0.0, 0.0]], device=scores.device)
            best = torch.argmax(scores + (click_count.reshape(-1, 1) - 2.5) * reweight, dim=1)
            masks = torch.take_along_dim(masks, best[:, None, None, None], dim=1)
            scores = torch.take_along_dim(scores, best[:, None], dim=1)
        return postprocess_masks(masks, self.input_hw, self.orig_hw), scores, masks


def export_sam_prompt_head(sam, orig_hw: Tuple[int, int], num_points: int = 8,
                           return_single_mask: bool = False, use_stability_score: bool = False) -> SamPromptHead:
    """The prompt head of `sam` for `orig_hw` frames at a fixed capacity of
    `num_points` prompt slots, in eval mode on the module's device."""
    return SamPromptHead(sam, orig_hw, num_points, return_single_mask, use_stability_score).eval()
