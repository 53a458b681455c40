"""Model export for serving (port of pope_tpu/export.py).

The JAX package serializes its serving heads as StableHLO artifacts
(`jax.export`); here each one is an `nn.Module` traced by `torch.export`
and saved as a `.pt2` program: `export_sam_decoder` (the prompt -> mask
decode head), `export_sam_prompt_head` (the SamOnnxModel surface: prompt
encoder + mask decoder + postprocess on a cached image embedding),
`export_matcher` (the coarse-to-fine matcher at fixed image shapes) and
`export_dinov2` (the retrieval tower's cls token). Each returns the
program's bytes and writes them to `path` when given; `load_exported` reads
them back as an `ExportedProgram` (`.module()(*inputs)` runs it).

Shapes are static, as in JAX: one program per serving resolution. The
programs hold their weights and run on the device of the module they were
exported from. The attention kernels are registered ops
(`torch.ops.pope.*`, ops/flash_attention.py, ops/window_attention.py), so a
program exported on the card keeps them as graph nodes and launches them;
the matcher backbone's convs are named ops outside cuDNN
(models/matcher/backbone.py::native_conv2d), so the program keeps that too.
"""

from __future__ import annotations

import io
from typing import Tuple

import torch
import torch.nn as nn

from pope_tpu_torch.models.sam.sam import Sam, postprocess_masks, resize_longest_side
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
        # the prompt encoder and mask decoder only: an exported program holds
        # its module's every parameter, and the image encoder's are 2.4 GB at ViT-H
        self.prompt_encoder, self.mask_decoder = sam.prompt_encoder, sam.mask_decoder
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
        pe = self.prompt_encoder
        sparse, dense_m = pe(point_coords, point_labels, mask_input)
        _, dense_nm = pe(point_coords, point_labels, None)
        w = has_mask_input.reshape(-1, 1, 1, 1)
        dense = w * dense_m + (1.0 - w) * dense_nm
        masks, scores = self.mask_decoder(
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


def sam_prompt_head(sam, orig_hw: Tuple[int, int], num_points: int = 8,
                    return_single_mask: bool = False, use_stability_score: bool = False) -> SamPromptHead:
    """The prompt head of `sam` for `orig_hw` frames at a fixed capacity of
    `num_points` prompt slots, in eval mode on the module's device."""
    return SamPromptHead(sam, orig_hw, num_points, return_single_mask, use_stability_score).eval()


class SamDecoderHead(nn.Module):
    """(embeddings (1, E, E, C), point_coords (1, P, 2) in the 1024 frame,
    point_labels (1, P)) -> (low-res masks (1, 3, 4E, 4E), iou (1, 3)):
    `Sam.decode` with multimask output, on the prompt encoder and mask
    decoder alone."""

    def __init__(self, sam):
        super().__init__()
        self.prompt_encoder, self.mask_decoder = sam.prompt_encoder, sam.mask_decoder

    def forward(self, embeddings, point_coords, point_labels):
        return Sam.decode(self, embeddings, point_coords, point_labels, multimask_output=True)


class MatcherHead(nn.Module):
    """(image0 (1, H0, W0, 1), image1 (1, H1, W1, 1)) -> (mkpts0, mkpts1,
    mconf, valid)."""

    def __init__(self, matcher):
        super().__init__()
        self.matcher = matcher

    def forward(self, image0, image1):
        res = self.matcher(image0, image1)
        return res.mkpts0, res.mkpts1, res.mconf, res.valid


class Dinov2Head(nn.Module):
    """(1, S, S, 3) normalized image -> (1, D) cls token."""

    def __init__(self, dinov2):
        super().__init__()
        self.dinov2 = dinov2

    def forward(self, image):
        return self.dinov2(image)["x_norm_clstoken"]


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _export(module: nn.Module, args, path: str | None) -> bytes:
    """torch.export of `module` (in eval mode) at the example `args`, saved
    as bytes (and to `path`)."""
    module.eval()
    with torch.no_grad():
        program = torch.export.export(module, tuple(args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def export_sam_decoder(sam, num_points: int = 8, path: str | None = None) -> bytes:
    """Serialize the prompt -> mask decode head at a fixed prompt capacity:
    (embeddings (1, E, E, C) f32, point_coords (1, P, 2) f32, point_labels
    (1, P) int32) -> (masks, iou). Reload with `load_exported`."""
    E, C = sam.config.image_embedding_size, sam.config.prompt_embed_dim
    dev = _device(sam)
    args = (torch.zeros(1, E, E, C, device=dev), torch.zeros(1, num_points, 2, device=dev),
            torch.zeros(1, num_points, dtype=torch.int32, device=dev))
    return _export(SamDecoderHead(sam), args, path)


def export_sam_prompt_head(sam, orig_hw: Tuple[int, int], num_points: int = 8, return_single_mask: bool = False,
                           use_stability_score: bool = False, path: str | None = None) -> bytes:
    """Serialize SamPromptHead (the SamOnnxModel surface) for `orig_hw`
    frames: inputs image_embeddings (1, E, E, C), point_coords (1, P, 2),
    point_labels (1, P) int32, mask_input (1, 4E, 4E, 1), has_mask_input
    (1,) and, with return_single_mask, click_count (1,); all float32 but the
    labels. `orig_hw` is static, as in the JAX export."""
    E, C = sam.config.image_embedding_size, sam.config.prompt_embed_dim
    dev = _device(sam)
    args = [torch.zeros(1, E, E, C, device=dev), torch.zeros(1, num_points, 2, device=dev),
            torch.zeros(1, num_points, dtype=torch.int32, device=dev), torch.zeros(1, 4 * E, 4 * E, 1, device=dev),
            torch.zeros(1, device=dev)]
    if return_single_mask:
        args.append(torch.ones(1, device=dev))
    return _export(sam_prompt_head(sam, orig_hw, num_points, return_single_mask, use_stability_score), args, path)


def export_matcher(matcher, hw0: Tuple[int, int], hw1: Tuple[int, int], path: str | None = None) -> bytes:
    """Serialize the coarse-to-fine matcher at fixed image shapes:
    (image0 (1, H0, W0, 1), image1 (1, H1, W1, 1)) f32 in [0, 1] ->
    (mkpts0, mkpts1, mconf, valid)."""
    dev = _device(matcher)
    args = (torch.zeros(1, *hw0, 1, device=dev), torch.zeros(1, *hw1, 1, device=dev))
    return _export(MatcherHead(matcher), args, path)


def export_dinov2(dinov2, img_size: int = 196, path: str | None = None) -> bytes:
    """Serialize the retrieval tower: (1, S, S, 3) normalized image -> (1, D)
    cls token. 196 is the pipeline's serving crop (not the pretraining
    resolution of the config)."""
    args = (torch.zeros(1, img_size, img_size, 3, device=_device(dinov2)),)
    return _export(Dinov2Head(dinov2), args, path)


def load_exported(path_or_blob) -> torch.export.ExportedProgram:
    """The ExportedProgram of a path or of the bytes an export_* returned.
    The attention ops are registered first, so that a fresh process can run
    the program."""
    import pope_tpu_torch.ops.flash_attention  # noqa: F401  (pope::flash_attention*)
    import pope_tpu_torch.ops.window_attention  # noqa: F401  (pope::windowed_attention_relpos)

    src = path_or_blob if isinstance(path_or_blob, str) else io.BytesIO(path_or_blob)
    return torch.export.load(src)
