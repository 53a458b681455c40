"""Online pose-estimation service: continuous batching over the eval
runner's device path (port of pope_tpu/serve/pose_service.py).

Concurrent requests coalesce into device batches of a fixed size B; a short
batch is padded by repeating its last request, and the padded results are
discarded, so the device always sees the same shapes. One batch stays in
flight: the worker dispatches batch N+1 before it finishes batch N. Each
request's solver noise is `runner.pair_noise` on its name (the crc32 seed of
the eval runner's pairs), so a request's result equals `runner.run_pairs`
on a pair of that name, whatever else shares its batch.

All model work runs on the worker thread (`torch.no_grad` is thread-local,
so the worker enters it): the HTTP handler threads only decode images and
submit. The solver syncs with the device inside dispatch (few-match
check), so the worker's dispatch of batch N+1 waits for part of its device
work before batch N's results are read.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pope_tpu_torch.pipeline import runner


class _Req:
    __slots__ = ("img0", "img1", "K0", "K1", "name", "future", "t_submit")

    def __init__(self, img0, img1, K0, K1, name):
        self.img0 = img0
        self.img1 = img1
        self.K0 = K0
        self.K1 = K1
        self.name = name
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class _Named(NamedTuple):
    """What runner.pair_noise reads of a pair."""

    pair_name: str


class _Spec(NamedTuple):
    """What runner.dispatch_pairs reads of a dataset spec."""

    crop_size: int


class PoseService:
    """Continuous-batching pose service over a PopeModels bundle.

    `submit` enqueues a request; the worker thread packs up to `batch_size`
    of them (waiting at most `max_wait_ms` after the first arrival for the
    batch to fill), pads short batches, and drives the eval runner's two
    device stages (AMG, then retrieve/match/solve) on the models' device.

    All requests share one frame shape (`frame_hw`, fixed at construction or
    pinned by the first request): a fixed camera stream, one set of shapes.
    """

    def __init__(self, models, crop_size: int = 256, batch_size: int = 4, max_wait_ms: float = 8.0,
                 frame_hw: Optional[Tuple[int, int]] = None):
        self.models = models
        self.crop_size = crop_size
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.frame_hw = tuple(frame_hw) if frame_hw else None
        self._spec = _Spec(crop_size)
        self._q: "queue.Queue[_Req]" = queue.Queue()
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0, "latency_ms_sum": 0.0}
        self._stats_lock = threading.Lock()
        self._accept = threading.Lock()  # submit's check-and-put against shutdown
        self._stop = threading.Event()
        self._drain = True
        self._n = 0
        self._worker = threading.Thread(target=self._loop, name="pose-service", daemon=True)
        self._worker.start()

    # ---- client surface ----

    def submit(self, img0, img1, K0, K1, name: Optional[str] = None) -> Future:
        """Queue one pose request; resolves to the result dict (name, ok, R,
        t, pre_bbox, n_strong, n_dropped_masks, n_dropped_matches and the
        kept matches mkpts0, mkpts1, mconf)."""
        img0 = np.asarray(img0, np.uint8)
        img1 = np.asarray(img1, np.uint8)
        if img0.shape != img1.shape or img0.ndim != 3:
            raise ValueError(f"frames must share (H, W, 3): {img0.shape} vs {img1.shape}")
        K0 = np.asarray(K0, np.float32).reshape(3, 3)
        K1 = np.asarray(K1, np.float32).reshape(3, 3)
        with self._accept:
            if self._stop.is_set():
                raise RuntimeError("service is shut down")
            if self.frame_hw is None:
                self.frame_hw = img0.shape[:2]
            if tuple(img0.shape[:2]) != self.frame_hw:
                raise ValueError(f"service is pinned to {self.frame_hw} frames, got {img0.shape[:2]} "
                                 "(one frame shape per service; start another for a second stream)")
            self._n += 1
            req = _Req(img0, img1, K0, K1, name or f"req-{self._n}")
            self._q.put(req)
        return req.future

    def estimate(self, img0, img1, K0, K1, timeout: Optional[float] = None) -> dict:
        """Blocking convenience wrapper around submit()."""
        return self.submit(img0, img1, K0, K1).result(timeout=timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        if s["requests"]:
            s["mean_latency_ms"] = s["latency_ms_sum"] / s["requests"]
        s.pop("latency_ms_sum")
        s["batch_fill"] = s["requests"] / (s["requests"] + s["padded_slots"]) if s["requests"] else 0.0
        return s

    def shutdown(self, drain: bool = True):
        """Stop accepting requests. The worker finishes the batch in flight
        and, with drain, every queued request; without, queued requests fail."""
        with self._accept:
            self._drain = drain
            self._stop.set()
        self._worker.join()
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.future.set_exception(RuntimeError("service shut down"))

    # ---- worker ----

    def _collect(self) -> List[_Req]:
        """Block briefly for the first request, then wait up to max_wait_ms
        for the batch to fill."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.batch_size:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                batch.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _dispatch(self, batch: List[_Req]):
        """Upload one (padded) batch and queue its device work without
        waiting for it (runner.dispatch_pairs)."""
        padded = batch + [batch[-1]] * (self.batch_size - len(batch))
        dev = runner.upload_frames(*(np.stack([getattr(r, f) for r in padded]) for f in ("img0", "img1", "K0", "K1")),
                                   self.models.device)
        pending = runner.dispatch_pairs(self.models, [_Named(r.name) for r in padded], self._spec,
                                        hosts=[None] * len(padded), dev=dev)
        return batch, pending

    def _finish(self, dispatched) -> list:
        """Wait for one batch's downloads; the results of its real requests."""
        batch, pending = dispatched
        if pending.done is not None:
            pending.done.synchronize()
        small_b, matches_b = pending.small.numpy(), pending.matches.numpy()
        now = time.perf_counter()
        results = []
        for i, req in enumerate(batch):
            rec = runner._unpack_record(small_b[i], matches_b[i])
            mv = rec["match_valid"]
            results.append({
                "name": req.name,
                "ok": bool(rec["ok"]),
                "R": np.asarray(rec["R"], np.float32),
                "t": np.asarray(rec["t"], np.float32),
                "pre_bbox": np.asarray(rec["pre_bbox"]).astype(int),
                "n_strong": int(rec["n_strong"]),
                "n_dropped_masks": int(rec["n_dropped_masks"]),
                "n_dropped_matches": int(rec["n_dropped_matches"]),
                "mkpts0": rec["mkpts0"][mv],
                "mkpts1": rec["mkpts1"][mv],
                "mconf": rec["mconf"][mv],
            })
        with self._stats_lock:
            self._stats["requests"] += len(batch)
            self._stats["latency_ms_sum"] += sum((now - r.t_submit) * 1e3 for r in batch)
            self._stats["batches"] += 1
            self._stats["padded_slots"] += self.batch_size - len(batch)
        return results

    def _loop(self):
        with torch.no_grad():
            pending = None
            while True:
                stopping = self._stop.is_set()
                batch = self._collect() if not stopping or self._drain else []
                if stopping and not batch and pending is None:
                    return
                nxt = None
                if batch:
                    try:
                        # batch N+1's work queues on the device before batch
                        # N's results are read below
                        nxt = self._dispatch(batch)
                    except Exception as e:  # the worker keeps serving; the error goes to the futures
                        for req in batch:
                            req.future.set_exception(e)
                if pending is not None:
                    try:
                        for req, res in zip(pending[0], self._finish(pending)):
                            req.future.set_result(res)
                    except Exception as e:  # the worker keeps serving; the error goes to the futures
                        for req in pending[0]:
                            if not req.future.done():
                                req.future.set_exception(e)
                pending = nxt


# ---- HTTP surface ----


def _result_json(res: dict) -> dict:
    return {
        "name": res["name"],
        "ok": res["ok"],
        "R": res["R"].tolist(),
        "t": res["t"].tolist(),
        "pre_bbox": res["pre_bbox"].tolist(),
        "n_strong": res["n_strong"],
        "n_matches": int(res["mkpts0"].shape[0]),
        "n_dropped_masks": res["n_dropped_masks"],
        "n_dropped_matches": res["n_dropped_matches"],
        "mkpts0": res["mkpts0"].tolist(),
        "mkpts1": res["mkpts1"].tolist(),
        "mconf": res["mconf"].tolist(),
    }


def _decode_image_b64(data: str) -> np.ndarray:
    import cv2

    buf = np.frombuffer(base64.b64decode(data), np.uint8)
    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("image field is not a decodable image")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def make_pose_server(service: PoseService, host: str = "127.0.0.1", port: int = 0):
    """Threaded HTTP server over a PoseService (built, not started).

    POST /pose  {"image0": <b64 png/jpg>, "image1": <b64>, "K0": 3x3,
                 "K1": 3x3, ["name": str]}  ->  the pose result as JSON
    GET  /stats ->  {"requests", "batches", "padded_slots", "batch_fill",
                     "mean_latency_ms"}

    Each request gets a thread, which decodes its images and submits them;
    concurrent requests batch together on the service's worker.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/health", "/stats"):
                self._send(200, service.stats())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path.rstrip("/") != "/pose":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n))
                img0 = _decode_image_b64(payload["image0"])
                img1 = _decode_image_b64(payload["image1"])
                fut = service.submit(img0, img1, payload["K0"], payload["K1"], name=payload.get("name"))
                self._send(200, _result_json(fut.result(timeout=600)))
            except (KeyError, ValueError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover
                self._send(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)
