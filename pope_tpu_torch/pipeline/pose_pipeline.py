"""The retrieve -> match -> solve stage of each pair (port of
pope_tpu/pipeline/pose_pipeline.py: `retrieve_top_k`, `match_and_score`,
`PairResult` and `PipelineExecutor` with `batched()` /
`build_batched(fold_prompt=True)` and `estimate_pair`).

The pair axis is a real batch dimension (the JAX package vmaps it): all
B x (C + 1) crops of a batch, the prompts folded in, go through one DINOv2
forward; the B x top-k prompt-crop pairs through one matcher call, each
prompt's backbone run once; the B solves through one batched RANSAC.

The JAX package's mesh / dp-sharded path (`build_batched(mesh=...)`) is not
ported yet. Its per-pair PRNG keys become the solver's Gumbel noise: a
(B, n_rounds, n_hyps, M) tensor or a torch.Generator (solver/ransac.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pope_tpu_torch.geometry.affine import crop_resize_bilinear, get_K_crop_resize
from pope_tpu_torch.models.dinov2.preprocess import cls_token_cosine, normalize, preprocess_image
from pope_tpu_torch.solver import estimate_pose_ransac

DINO_CROP = 196  # DINOv2's input side on the center_crop path


class PairResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3) relative rotation
    t: torch.Tensor  # (B, 3) unit translation
    ok: torch.Tensor  # (B,) solver success
    pre_bbox: torch.Tensor  # (B, 4) selected xyxy box in image1 coords
    pre_K: torch.Tensor  # (B, 3, 3) intrinsics of the selected crop
    mkpts0: torch.Tensor  # (B, M, 2) matches in image0
    mkpts1: torch.Tensor  # (B, M, 2) matches in the selected crop
    mconf: torch.Tensor  # (B, M)
    match_valid: torch.Tensor  # (B, M) bool
    n_strong: torch.Tensor  # (B,) the winning crop's strong-match count
    sim_scores: torch.Tensor  # (B, top_k) retrieval cosine scores
    n_dropped_masks: Optional[torch.Tensor] = None  # (B,)
    n_dropped_matches: Optional[torch.Tensor] = None  # (B,)


def _dino_box_window(box_xyxy):
    """The sub-box whose direct warp to 196x196 equals crop(box -> 256) ->
    CenterCrop(196): the box shrunk to its [30/256, 226/256] span."""
    x0, y0, x1, y1 = box_xyxy.unbind(-1)
    w, h = x1 - x0, y1 - y0
    lo, hi = 30.0 / 256.0, 226.0 / 256.0
    return torch.stack([x0 + lo * w, y0 + lo * h, x0 + hi * w, y0 + hi * h], dim=-1)


def _rgb01_to_gray(img_rgb01):
    """ITU-R 601 luma, the coefficients of cv2.cvtColor BGR2GRAY."""
    return 0.299 * img_rgb01[..., 0] + 0.587 * img_rgb01[..., 1] + 0.114 * img_rgb01[..., 2]


def _to_rgb01(img):
    """uint8 [0, 255] or float [0, 1] images -> float [0, 1]."""
    if not torch.is_floating_point(img):
        return img.float() / 255.0
    return img


def _rows(x, idx):
    """x (B, n, ...) at idx (B, k) along n -> (B, k, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def retrieve_top_k(models, image1_rgb01, boxes_xywh, valid, K1, ref_cls=None, top_k: int = 3,
                   crop_size: int = 256, ref_img=None):
    """Crop every AMG candidate of every pair, score it against the prompt's
    cls token and keep the top k, with all candidates in ONE DINOv2 forward.

    image1_rgb01 (B, H, W, 3) in [0, 1]; boxes_xywh (B, C, 4); valid (B, C);
    K1 (B, 3, 3); ref_cls (B, D) prompt cls tokens, or None when ref_img
    (B, 196, 196, 3), the preprocessed prompts, rides in the same forward as
    each pair's C + 1'th crop.
    Returns (top_idx (B, k), scores (B, k), crops (B, k, S, S, 3),
    crop_Ks (B, k, 3, 3), boxes_xyxy (B, C, 4) the expanded boxes).
    """
    B, C, _ = boxes_xywh.shape
    compact = models.config.compact_percent
    x0, y0, w, h = boxes_xywh.float().unbind(-1)
    dx, dy = torch.floor(w * compact), torch.floor(h * compact)
    boxes = torch.stack([x0 - dx, y0 - dy, x0 + w + dx, y0 + h + dy], dim=-1)

    # every candidate straight at DINOv2's input size: one 196x196 warp of
    # the shrunk box equals crop(256) -> CenterCrop(196)
    dino_in = normalize(crop_resize_bilinear(image1_rgb01, _dino_box_window(boxes), (DINO_CROP, DINO_CROP)))
    if ref_img is not None:
        dino_in = torch.cat([dino_in, ref_img[:, None]], dim=1)  # (B, C + 1, ...)
    n = dino_in.shape[1]
    cls = models.dinov2(dino_in.reshape(B * n, DINO_CROP, DINO_CROP, 3))["x_norm_clstoken"]
    cls = cls.reshape(B, n, -1)
    if ref_img is not None:
        ref_cls, cls = cls[:, -1], cls[:, :-1]
    scores = cls_token_cosine(ref_cls[:, None], cls)  # (B, C)
    scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    # ties (every invalid slot scores -inf) keep the lower index, as
    # jax.lax.top_k does
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :top_k], top_idx[:, :top_k]

    sel = _rows(boxes, top_idx)  # (B, k, 4)
    crops = crop_resize_bilinear(image1_rgb01, sel, (crop_size, crop_size))
    crop_Ks, _ = get_K_crop_resize(sel, K1[:, None], (crop_size, crop_size))
    return top_idx, top_scores, crops, crop_Ks, boxes


def match_and_score(models, ref_gray, crop_grays, strong_thr: float = 0.9):
    """The matcher between each prompt (B, H, W) and its k crops (B, k, S, S)
    in one call (each prompt's backbone once); each crop scored by its count
    of matches with mconf > strong_thr. Returns (MatchResult over B * k,
    strong (B, k))."""
    B, k = crop_grays.shape[:2]
    res = models.matcher(ref_gray[..., None], crop_grays.reshape(B * k, *crop_grays.shape[2:], 1))
    return res, res.strong_match_count(strong_thr).reshape(B, k)


class PipelineExecutor:
    """Stage 2 of each pair over a batch: retrieve -> match -> select ->
    solve. `batched()` is the production shape (the prompt folded into the
    retrieval forward)."""

    def __init__(self, models, crop_size: int = 256):
        self.models = models
        self.crop_size = crop_size

    @torch.no_grad()
    def prompt_cls_raw(self, imgs):
        """(B, H, W, 3) uint8 or [0, 1] prompt frames -> (B, D) cls tokens."""
        ref_in = preprocess_image(_to_rgb01(imgs.to(self.models.device)) * 255.0, center_crop=True)
        return self.models.dinov2(ref_in)["x_norm_clstoken"]

    def batched(self, mesh=None):
        """The multi-pair runner of the production path: prompt folded in.
        mesh: optional dp mesh (build_batched)."""
        return self.build_batched(fold_prompt=True, mesh=mesh)

    def build_batched(self, fold_prompt: bool = False, mesh=None):
        """The multi-pair retrieve -> match -> select -> solve.

        run(image0_b, image1_b, K0_b, K1_b, amg_boxes_b, amg_valid_b,
            ref_cls_b, noise, amg_dropped_b=None, packed=False)
        image0_b / image1_b: (B, H, W, 3) uint8 or [0, 1] prompt / target
        frames; amg_boxes_b (B, C, 4) xywh, amg_valid_b (B, C); ref_cls_b
        (B, D) prompt cls tokens, or None with fold_prompt (computed in the
        retrieval forward); noise: the solver's Gumbel noise
        (B, n_rounds, n_hyps, M) or a torch.Generator.
        Returns a PairResult, or with packed=True the (B, 29) record array
        [R(9) t(3) ok pre_bbox(4) pre_K(9) n_strong n_dropped_masks
        n_dropped_matches] and the (B, M, 6) matches [mkpts0 mkpts1 mconf
        valid]. The JAX entry's static `n_pairs` has no counterpart: the
        batch size is the inputs'.

        mesh: optional DeviceMesh with a 'dp' axis. Every rank passes the
        global batch, runs its contiguous B / dp pairs (B must divide by
        dp; the noise must be a tensor) and gets the global outputs back,
        gathered in pair order: the unsharded program's result.
        """
        models = self.models
        cfg = models.config
        dev = models.device
        S = self.crop_size

        @torch.no_grad()
        def run(image0_b, image1_b, K0_b, K1_b, amg_boxes_b, amg_valid_b, ref_cls_b, noise,
                amg_dropped_b=None, packed: bool = False):
            to = lambda x: None if x is None else torch.as_tensor(x, device=dev)
            image0_b, image1_b, K0_b, K1_b, amg_boxes_b, amg_valid_b, ref_cls_b, amg_dropped_b = map(
                to, (image0_b, image1_b, K0_b, K1_b, amg_boxes_b, amg_valid_b, ref_cls_b, amg_dropped_b)
            )
            if torch.is_tensor(noise):
                noise = noise.to(dev)
            image0 = _to_rgb01(image0_b)
            image1 = _to_rgb01(image1_b)
            ref_img = preprocess_image(image0 * 255.0, center_crop=True) if fold_prompt else None
            top_idx, sim, crops, crop_Ks, boxes = retrieve_top_k(
                models, image1, amg_boxes_b, amg_valid_b.bool(), K1_b.float(),
                None if fold_prompt else ref_cls_b, top_k=cfg.top_k, crop_size=S, ref_img=ref_img,
            )
            res, strong = match_and_score(
                models, _rgb01_to_gray(image0), _rgb01_to_gray(crops), cfg.matcher.mconf_strong_thr
            )
            B, k = strong.shape
            best = strong.argmax(-1)  # first maximum, as jnp.argmax
            at_best = lambda x: x.reshape(B, k, *x.shape[1:])[torch.arange(B, device=dev), best]
            mkpts0, mkpts1, mconf, mvalid, match_dropped = (
                at_best(x) for x in (res.mkpts0, res.mkpts1, res.mconf, res.valid, res.n_dropped)
            )
            n_strong = at_best(strong.reshape(B * k))
            pre_K = at_best(crop_Ks.reshape(B * k, 3, 3))
            pre_bbox = _rows(boxes, _rows(top_idx, best[:, None]))[:, 0]
            sol = estimate_pose_ransac(
                mkpts0, mkpts1, K0_b.float(), pre_K, mvalid, noise,
                thresh_px=cfg.ransac_thresh_px, n_rounds=cfg.ransac_rounds,
            )
            if amg_dropped_b is None:
                amg_dropped_b = torch.zeros(B, dtype=torch.int32, device=dev)
            if packed:
                small = torch.cat([
                    sol.R.reshape(B, 9), sol.t, sol.ok.float()[:, None], pre_bbox,
                    pre_K.reshape(B, 9), n_strong.float()[:, None],
                    amg_dropped_b.float()[:, None], match_dropped.float()[:, None],
                ], dim=-1)  # (B, 29)
                matches = torch.cat(
                    [mkpts0, mkpts1, mconf[..., None], mvalid.float()[..., None]], dim=-1
                )  # (B, M, 6)
                return small, matches
            return PairResult(
                R=sol.R, t=sol.t, ok=sol.ok, pre_bbox=pre_bbox, pre_K=pre_K,
                mkpts0=mkpts0, mkpts1=mkpts1, mconf=mconf, match_valid=mvalid,
                n_strong=n_strong, sim_scores=sim,
                n_dropped_masks=amg_dropped_b, n_dropped_matches=match_dropped,
            )

        if mesh is None:
            return run
        from pope_tpu_torch.parallel.collectives import all_gather
        from pope_tpu_torch.parallel.mesh import shard_batch

        group = mesh.get_group("dp")

        def run_dp(*args, packed: bool = False):
            if isinstance(args[7], torch.Generator):
                raise ValueError("a dp-sharded batch needs the solver noise as a (B, ...) tensor")
            local = [None if a is None else shard_batch(mesh, torch.as_tensor(a)) for a in args]
            out = run(*local, packed=packed)
            gathered = [None if x is None else all_gather(x, group) for x in out]
            return tuple(gathered) if packed else PairResult(*gathered)

        return run_dp

    def estimate_pair(self, image0_rgb01, image1_rgb01, K0, K1, amg_result, ref_cls, noise) -> PairResult:
        """One (prompt, target) pair given its AMG candidates (boxes_xywh,
        valid[, n_dropped]: the eval path's device tensors or a records-path
        host result of numpy arrays) and the prompt's cls token; noise
        (n_rounds, n_hyps, M) or a torch.Generator on the models' device.
        Every input moves to the models' device. Fields without the pair
        dimension."""
        dev = self.models.device
        one = lambda x: None if x is None else torch.as_tensor(x, device=dev)[None]
        if torch.is_tensor(noise):
            noise = noise.to(dev)[None]
        res = self.build_batched()(
            one(image0_rgb01), one(image1_rgb01), one(K0), one(K1), one(amg_result.boxes_xywh),
            one(amg_result.valid), one(ref_cls), noise, one(getattr(amg_result, "n_dropped", None)),
        )
        return PairResult(*(None if x is None else x[0] for x in res))


def estimate_pair(models, image0_rgb01, image1_rgb01, K0, K1, amg_result, ref_cls, noise,
                  crop_size: int = 256) -> PairResult:
    """Retrieve -> match -> solve for one (prompt, target) pair, given its
    AMG candidates and the prompt's cls token: PipelineExecutor.estimate_pair
    at `crop_size`. Where pope_tpu takes a PRNG key, the port takes the
    solver's noise (n_rounds, n_hyps, M) or a torch.Generator."""
    return PipelineExecutor(models, crop_size).estimate_pair(
        image0_rgb01, image1_rgb01, K0, K1, amg_result, ref_cls, noise)
