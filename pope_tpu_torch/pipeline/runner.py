"""Host-side per-pair runner: file IO + GT handling around the two device
stages (port of pope_tpu/pipeline/runner.py; the body of the reference eval
loop, eval_linemod_json.py:51-168).

`run_pair` mirrors the reference's serial loop; `run_pairs` is the
production path: it batches the pair axis through both stages (one AMG call,
one retrieve/match/solve call per batch of B pairs).

On the card a batch moves like this:
  - `prepare_batch` (the loader thread) decodes the files, copies the frames
    and intrinsics into pinned host memory and issues the uploads on a copy
    stream of their own, then records an event there;
  - `dispatch_pairs` (the main thread) makes the compute stream wait on that
    event, queues both stages and the non-blocking downloads of the two
    packed outputs into pinned buffers, and records a second event;
  - `finish_pairs` waits on that event before it reads the buffers.
The device stages run on the main thread: `torch.no_grad` is thread-local.

The solver's Gumbel noise is drawn per pair from a generator seeded with the
crc32 of the pair's name, as the JAX runner keys it (`pair_key`), so a
pair's records do not depend on its batch or its place in it. The JAX
package's `mesh=` (dp-sharded batches) is not ported.
"""

from __future__ import annotations

import os
import zlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pope_tpu_torch.data.image_io import read_rgb
from pope_tpu_torch.pipeline.pose_pipeline import PipelineExecutor
from pope_tpu_torch.solver import N_HYPS, draw_gumbel
from pope_tpu_torch.utils.device import resolve_device


def get_executor(models, crop_size: int) -> PipelineExecutor:
    """The stage-2 executor for (models, crop_size). The JAX runner caches a
    stage-jitted one per pair; here nothing is compiled, so it is built per
    call."""
    return PipelineExecutor(models, crop_size)


def pair_seed(pair_name: str) -> int:
    """Stable per-pair seed: crc32 digest, NOT Python's salted hash()
    (reproducible across processes without pinning PYTHONHASHSEED); the JAX
    runner's PRNGKey for the pair is PRNGKey(pair_seed)."""
    return zlib.crc32(pair_name.encode()) & 0x7FFFFFFF


def pair_noise(paths_list, n_matches: int, n_rounds: int, device) -> torch.Tensor:
    """(B, n_rounds, N_HYPS, n_matches) solver noise, each pair's drawn from
    its own generator on `device` seeded with pair_seed(pair_name)."""
    return torch.stack([
        draw_gumbel(
            (n_rounds, N_HYPS, n_matches),
            torch.Generator(device=device).manual_seed(pair_seed(p.pair_name)),
            device=device,
        )
        for p in paths_list
    ])


def load_pose_4x4(path: str) -> np.ndarray:
    pose = np.loadtxt(path)
    if pose.shape == (3, 4):
        pose = np.vstack([pose, [0, 0, 0, 1]])
    return pose.astype(np.float32)


def relative_pose_np(pose0: np.ndarray, pose1: np.ndarray) -> np.ndarray:
    """T_0to1 = pose1 @ inv(pose0) on 4x4 homogeneous poses, host numpy
    (eval_linemod_json.py:143)."""
    return (pose1 @ np.linalg.inv(pose0)).astype(np.float32)


def pose_errors_np(T_0to1: np.ndarray, R: np.ndarray, t: np.ndarray):
    """(t_err_deg, R_err_deg) vs the GT relative pose — numpy twin of
    geometry.pose.relative_pose_error (metrics.py:10-24) for the host edge."""
    t_gt = T_0to1[:3, 3]
    n = np.linalg.norm(t) * np.linalg.norm(t_gt)
    cos_t = float(np.dot(t, t_gt) / max(n, 1e-12))
    t_err = np.rad2deg(np.arccos(np.clip(cos_t, -1.0, 1.0)))
    t_err = min(t_err, 180.0 - t_err)
    cos_r = (np.trace(R.T @ T_0to1[:3, :3]) - 1.0) / 2.0
    r_err = np.rad2deg(np.abs(np.arccos(np.clip(cos_r, -1.0, 1.0))))
    return float(t_err), float(r_err)


def epipolar_errors_np(T_0to1, mkpts0, mkpts1, K0, K1):
    """Per-match squared symmetric epipolar error vs the GT relative pose —
    host numpy twin of geometry.epipolar.compute_symmetric_epipolar_errors
    (src/utils/metrics.py:27-66). mkpts1/K1 live in the selected crop frame."""
    R, t = T_0to1[:3, :3], T_0to1[:3, 3]
    E = np.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float64
    ) @ R.astype(np.float64)
    p0 = (mkpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    p1 = (mkpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    h0 = np.concatenate([p0, np.ones_like(p0[:, :1])], -1)
    h1 = np.concatenate([p1, np.ones_like(p1[:, :1])], -1)
    Ep0 = h0 @ E.T
    Etp1 = h1 @ E
    num = np.sum(h1 * Ep0, -1) ** 2
    return num * (
        1.0 / np.maximum(Ep0[:, 0] ** 2 + Ep0[:, 1] ** 2, 1e-18)
        + 1.0 / np.maximum(Etp1[:, 0] ** 2 + Etp1[:, 1] ** 2, 1e-18)
    )


def gt_bbox_from_box3d(box3d_path: str, pose1: np.ndarray, K1: np.ndarray) -> Optional[np.ndarray]:
    """Project the object's 3-D bbox corners and take the bounding rect
    (eval_linemod_json.py:152-158)."""
    if not os.path.exists(box3d_path):
        return None
    corners = np.loadtxt(box3d_path)
    cam = corners @ pose1[:3, :3].T + pose1[:3, 3]
    pix = cam @ K1.T
    dpt = pix[:, 2]
    dpt = np.where(np.abs(dpt) < 1e-4, np.where(dpt < 0, -1e-4, 1e-4), dpt)
    pts2d = (pix[:, :2] / dpt[:, None]).astype(np.int32)
    x0, y0 = pts2d.min(0)
    x1, y1 = pts2d.max(0)
    return np.array([x0, y0, x1, y1])


def _load_pair_host(paths):
    """Decode one manifest pair's files on host."""
    img0 = read_rgb(paths.image0)
    img1 = read_rgb(paths.image1)
    K0 = np.loadtxt(paths.k0, delimiter=" ").astype(np.float32)
    K1 = np.loadtxt(paths.k1, delimiter=" ").astype(np.float32)
    pose0 = load_pose_4x4(paths.pose0)
    pose1 = load_pose_4x4(paths.pose1)
    return img0, img1, K0, K1, pose0, pose1


def _record(paths, host, result_np):
    """Build the eval record for one pair from host-side arrays."""
    img0, img1, K0, K1, pose0, pose1 = host
    T_0to1 = relative_pose_np(pose0, pose1)
    R = np.asarray(result_np["R"], np.float32)
    t = np.asarray(result_np["t"], np.float32)
    ok = bool(result_np["ok"])
    if ok:
        t_err, R_err = pose_errors_np(T_0to1, R, t)
    else:
        t_err = R_err = None
    gt_bbox = gt_bbox_from_box3d(paths.box3d, pose1, K1)
    # matching-precision axis (prec@5e-4, src/utils/metrics.py:167-178):
    # epipolar error of each kept match vs the GT relative pose
    if "mkpts0" in result_np:
        mv = np.asarray(result_np["match_valid"], bool)
        epi_errs = epipolar_errors_np(
            T_0to1,
            np.asarray(result_np["mkpts0"], np.float64)[mv],
            np.asarray(result_np["mkpts1"], np.float64)[mv],
            K0, np.asarray(result_np["pre_K"], np.float64),
        )
    else:
        epi_errs = np.zeros((0,))
    return {
        "object": paths.object_label,
        "identifier": paths.pair_name,
        "ok": ok,
        "R_err": R_err,
        "t_err": t_err,
        "pre_bbox": np.asarray(result_np["pre_bbox"]).astype(int).tolist(),
        "gt_bbox": gt_bbox.tolist() if gt_bbox is not None else None,
        "n_strong": int(result_np["n_strong"]),
        # capacity-saturation telemetry ("no silent caps")
        "n_dropped_masks": int(result_np.get("n_dropped_masks", 0)),
        "n_dropped_matches": int(result_np.get("n_dropped_matches", 0)),
        "epi_errs": epi_errs,
        "T_0to1": T_0to1,
        "R": R,
        "t": t,
    }


class Uploaded(NamedTuple):
    """One batch's inputs on the device. `ready` (on CUDA) is the event
    recorded on the copy stream after the uploads; None on the CPU."""

    img0_u8: torch.Tensor  # (B, H, W, 3) uint8 prompt frames
    img1_u8: torch.Tensor  # (B, H, W, 3) uint8 target frames
    K0: torch.Tensor  # (B, 3, 3)
    K1: torch.Tensor  # (B, 3, 3)
    ready: Optional[torch.cuda.Event]

    def wait(self) -> "Uploaded":
        """Make the current stream wait for the uploads, and tell the
        caching allocator that it uses the tensors (they were allocated on
        the copy stream), so that their memory is not reused while it
        reads them."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.img0_u8.device)
            stream.wait_event(self.ready)
            for t in self[:4]:
                t.record_stream(stream)
        return self


class Pending(NamedTuple):
    """A dispatched batch: its pairs, host arrays, the packed (B, 29) records
    and (B, M, 6) matches (pinned host buffers on CUDA, filled by
    non-blocking copies) and the event after those copies (None on the
    CPU)."""

    paths_list: list
    hosts: list
    small: torch.Tensor
    matches: torch.Tensor
    done: Optional[torch.cuda.Event]


def prepare_batch(paths_list, device=None):
    """Host side of one batch: decode the files and START the uploads.

    Runs in the loader's prefetch thread so that disk IO and the host-to-
    device copies overlap the previous batch's device compute. On CUDA the
    frames and intrinsics go through pinned memory and upload on a copy
    stream of their own (a copy issued on the default stream would queue
    behind the compute); `Uploaded.ready` marks their end. device=None means
    CUDA (raises without a GPU). Returns (hosts, Uploaded)."""
    dev = resolve_device(device)
    hosts = [_load_pair_host(p) for p in paths_list]
    arrays = (
        np.stack([h[0] for h in hosts]).astype(np.uint8),
        np.stack([h[1] for h in hosts]).astype(np.uint8),
        np.stack([h[2] for h in hosts]),
        np.stack([h[3] for h in hosts]),
    )
    if dev.type != "cuda":
        return hosts, Uploaded(*(torch.from_numpy(a).to(dev) for a in arrays), None)
    copy_stream = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(copy_stream):
        tensors = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True) for a in arrays]
        ready = torch.cuda.Event()
        ready.record(copy_stream)
    return hosts, Uploaded(*tensors, ready)


def dispatch_pairs(models, paths_list, spec, noise=None, hosts=None, dev=None) -> Pending:
    """Queue the whole device side of one batch WITHOUT syncing: returns a
    Pending handle for finish_pairs. Both stages are queued asynchronously,
    so a caller can keep batch N+1's work in the device queue while it
    builds batch N's records.

    noise: the solver's (B, n_rounds, N_HYPS, M) Gumbel noise; default
    pair_noise (per pair, seeded by the pair's name)."""
    if hosts is None or dev is None:
        hosts, dev = prepare_batch(paths_list, models.device)
    dev = dev.wait()
    cfg = models.config
    if noise is None:
        noise = pair_noise(paths_list, cfg.matcher.match_coarse.match_capacity, cfg.ransac_rounds,
                           models.device)

    # stage 1: AMG (encode, decode, filters, NMS, small-region cleanup); its
    # boxes stay on the device
    boxes_b, valid_b, dropped_b = models.amg.generate_boxes_batch(dev.img1_u8)
    # stage 2: retrieve -> match -> solve, the prompt folded into the
    # retrieval forward
    run = get_executor(models, spec.crop_size).batched()
    small, matches = run(
        dev.img0_u8, dev.img1_u8, dev.K0, dev.K1, boxes_b, valid_b, None, noise, dropped_b, packed=True,
    )
    if not small.is_cuda:
        return Pending(paths_list, hosts, small, matches, None)
    # start the downloads now, behind the work that produces them
    out = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in (small, matches)]
    for o, x in zip(out, (small, matches)):
        o.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return Pending(paths_list, hosts, *out, done)


def finish_pairs(pending: Pending) -> List[dict]:
    """Wait for one dispatched batch's downloads and build its records."""
    if pending.done is not None:
        pending.done.synchronize()  # the pinned buffers hold stale bytes until then
    small_b, matches_b = pending.small.numpy(), pending.matches.numpy()
    return [
        _record(pending.paths_list[i], pending.hosts[i], _unpack_record(small_b[i], matches_b[i]))
        for i in range(len(pending.paths_list))
    ]


def run_pairs(models, paths_list, spec, noise=None, hosts=None, dev=None) -> List[dict]:
    """Batched production path over B manifest pairs (same image shapes):
    one AMG call, then one retrieve/match/solve call (prompt cls folded into
    the retrieval crop batch).

    Each frame uploads once as uint8; all derived tensors (SAM resize,
    DINOv2 prompt crop, grayscale) are computed on the device. A pair's
    record does not depend on the batch it rides in (per-pair noise).

    hosts/dev: optional preloaded host arrays + started uploads from
    prepare_batch (lets a prefetch thread overlap IO + upload with device
    compute).
    """
    return finish_pairs(dispatch_pairs(models, paths_list, spec, noise=noise, hosts=hosts, dev=dev))


def run_pair(models, paths, spec, noise=None):
    """Execute the full pipeline for one manifest pair; returns the record
    consumed by eval.evaluate_pairs. Delegates to the batched production
    path with B=1 (the reference's serial loop shape,
    eval_linemod_json.py:51). noise: (n_rounds, N_HYPS, M), default the
    pair's own draw."""
    return run_pairs(models, [paths], spec, noise=None if noise is None else noise[None])[0]


def _unpack_record(small: np.ndarray, matches: np.ndarray) -> dict:
    """Inverse of the stage-2 record packing (pose_pipeline build_batched):
    small (29,) = R(9) t(3) ok(1) pre_bbox(4) pre_K(9) n_strong(1)
    n_dropped_masks(1) n_dropped_matches(1); matches (M, 6) = mkpts0(2)
    mkpts1(2) mconf(1) valid(1)."""
    return {
        "R": small[0:9].reshape(3, 3),
        "t": small[9:12],
        "ok": small[12] > 0.5,
        "pre_bbox": small[13:17],
        "pre_K": small[17:26].reshape(3, 3),
        "n_strong": small[26],
        "n_dropped_masks": small[27] if small.shape[0] > 27 else 0.0,
        "n_dropped_matches": small[28] if small.shape[0] > 28 else 0.0,
        "mkpts0": matches[:, 0:2],
        "mkpts1": matches[:, 2:4],
        "mconf": matches[:, 4],
        "match_valid": matches[:, 5] > 0.5,
    }
