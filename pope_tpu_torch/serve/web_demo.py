"""Interactive segmentation web demo (port of pope_tpu/serve/web_demo.py).

The encoder runs once per image (`SamPredictor.set_image`, on the card), and
every click runs the small prompt head (`export.SamPromptHead` with
`return_single_mask`) against the cached embedding. The client is one
dependency-free HTML page: hover for a live mask, left-click to pin a
foreground point, right-click for a background point, 'r' to reset.

The head takes a fixed capacity of `max_points` prompt slots; the server
pads to capacity with label -1 slots (no-ops in the prompt encoder), keeps
the newest points when a prompt has more, and sends the true point count
(clicks + the one pad point the browser client counts) as `click_count`.

Model work runs on one worker thread of the demo's own: the HTTP server
gives each request a thread, and those threads only parse the request, hand
the prompt to the worker and encode its answer.
"""

from __future__ import annotations

import base64
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np
import torch


class WebDemo:
    """One image's cached embedding and the prompt head that answers clicks."""

    def __init__(self, sam, image_rgb: np.ndarray, max_points: int = 8, device=None):
        """sam: the port's Sam; image_rgb: (H, W, 3) uint8. device=None runs
        on CUDA and raises without a GPU."""
        from pope_tpu_torch.export import sam_prompt_head
        from pope_tpu_torch.models.sam.predictor import SamPredictor

        self.max_points = int(max_points)
        self.image_rgb = np.ascontiguousarray(image_rgb)
        self.orig_hw: Tuple[int, int] = tuple(image_rgb.shape[:2])
        self.img_size = sam.config.encoder.img_size
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="web-demo")

        predictor = SamPredictor(sam, device=device)
        predictor.set_image(self.image_rgb)
        self.device = predictor.device
        self.embedding = predictor.features

        self._head = sam_prompt_head(
            sam, self.orig_hw, num_points=self.max_points, return_single_mask=True,
        )
        low = 4 * sam.config.image_embedding_size
        self._empty_mask = torch.zeros((1, low, low, 1), device=self.device)
        self._no_mask = torch.zeros((1,), device=self.device)

    def predict(self, points, labels):
        """points: (N, 2) in ORIGINAL image coords (x, y); labels: (N,) in
        {1 foreground, 0 background}. Returns (mask bool (H, W), score),
        computed on the demo's worker thread."""
        return self._worker.submit(self._predict, points, labels).result()

    def _predict(self, points, labels):
        from pope_tpu_torch.models.sam.sam import apply_coords

        pts = np.asarray(points, np.float32).reshape(-1, 2)
        lbl = np.asarray(labels, np.float32).reshape(-1)
        # one slot stays for the pad point; past capacity the newest points
        # are kept (the client sends the live hover point last)
        n = min(len(pts), self.max_points - 1)
        coords = np.zeros((1, self.max_points, 2), np.float32)
        lab = np.full((1, self.max_points), -1, np.int64)
        coords[0, :n] = pts[len(pts) - n:]
        lab[0, :n] = lbl[len(pts) - n:].astype(np.int64)
        coords = apply_coords(coords, self.orig_hw, self.img_size)
        with torch.no_grad():
            masks, scores, _ = self._head(
                self.embedding, coords.to(self.device), torch.from_numpy(lab).to(self.device),
                self._empty_mask, self._no_mask, torch.tensor([n + 1.0], device=self.device),
            )
            mask = (masks[0, 0] > 0.0).cpu().numpy()
            score = float(scores[0, 0])
        return mask, score

    def close(self):
        """Stop the worker thread (after the clicks already handed to it)."""
        self._worker.shutdown()

    def mask_png(self, mask: np.ndarray) -> bytes:
        """Blue-overlay RGBA PNG of a boolean mask."""
        import cv2

        h, w = mask.shape
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[mask] = (189, 114, 0, 160)  # BGR(A) for cv2 == RGB (0, 114, 189)
        ok, buf = cv2.imencode(".png", rgba)
        assert ok
        return buf.tobytes()

    def image_png(self) -> bytes:
        import cv2

        ok, buf = cv2.imencode(".png", self.image_rgb[:, :, ::-1])
        assert ok
        return buf.tobytes()


INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>POPE — interactive segmentation</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem; background: #111; color: #eee; }
 #stage { position: relative; display: inline-block; cursor: crosshair; }
 #stage img, #stage canvas { display: block; max-width: 90vw; }
 #mask { position: absolute; left: 0; top: 0; pointer-events: none; }
 .hint { color: #9aa; font-size: 0.9rem; }
</style></head><body>
<h2>POPE interactive segmentation</h2>
<p class="hint">hover: live mask &middot; left-click: pin foreground point &middot;
right-click: background point &middot; <b>r</b>: reset &middot;
score: <span id="score">&ndash;</span></p>
<div id="stage"><img id="im" src="image"><img id="mask"></div>
<script>
const im = document.getElementById('im'), mask = document.getElementById('mask');
const score = document.getElementById('score');
let clicks = [], busy = false, pendingHover = null;
function scalePt(ev) {
  const r = im.getBoundingClientRect();
  return [ (ev.clientX - r.left) * im.naturalWidth / r.width,
           (ev.clientY - r.top) * im.naturalHeight / r.height ];
}
async function predict(points, labels) {
  if (busy) { pendingHover = [points, labels]; return; }
  busy = true;
  try {
    const res = await fetch('predict', { method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({points: points, labels: labels}) });
    const out = await res.json();
    mask.src = 'data:image/png;base64,' + out.mask_png;
    mask.style.width = im.getBoundingClientRect().width + 'px';
    score.textContent = out.score.toFixed(3);
  } finally {
    busy = false;
    if (pendingHover) { const [p, l] = pendingHover; pendingHover = null; predict(p, l); }
  }
}
im.addEventListener('mousemove', ev => {
  const p = scalePt(ev);
  predict(clicks.map(c => c.p).concat([p]), clicks.map(c => c.l).concat([1]));
});
im.addEventListener('click', ev => { clicks.push({p: scalePt(ev), l: 1}); });
im.addEventListener('contextmenu', ev => {
  ev.preventDefault(); clicks.push({p: scalePt(ev), l: 0});
});
document.addEventListener('keydown', ev => {
  if (ev.key === 'r') { clicks = []; mask.removeAttribute('src'); score.textContent = '\\u2013'; }
});
</script></body></html>
"""


def make_demo_server(demo: WebDemo, host: str = "127.0.0.1", port: int = 0):
    """Build (but do not start) the HTTP server. Routes: GET / (the client
    page), GET /image (the frame), GET /meta, POST /predict ({points, labels}
    -> {score, area, mask_png (base64)})."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, "text/html; charset=utf-8", INDEX_HTML.encode())
            elif self.path == "/image":
                self._send(200, "image/png", demo.image_png())
            elif self.path == "/meta":
                meta = {"hw": list(demo.orig_hw), "max_points": demo.max_points}
                self._send(200, "application/json", json.dumps(meta).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, "text/plain", b"not found")
                return
            n = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                pts = req.get("points", [])
                lbl = req.get("labels", [1] * len(pts))
                if not pts:
                    self._send(400, "text/plain", b"no points")
                    return
                mask, s = demo.predict(pts, lbl)
                body = json.dumps({
                    "score": s,
                    "area": int(mask.sum()),
                    "mask_png": base64.b64encode(demo.mask_png(mask)).decode(),
                }).encode()
                self._send(200, "application/json", body)
            except Exception as e:  # surface errors to the client, keep serving
                self._send(500, "application/json", json.dumps({"error": str(e)}).encode())

    return ThreadingHTTPServer((host, port), Handler)


def run_demo_server(demo: WebDemo, host: str = "127.0.0.1", port: int = 8081, background: bool = False):
    """Start serving; with background=True in a daemon thread, returning the
    server (stop it with shutdown() and server_close())."""
    srv = make_demo_server(demo, host, port)
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
    print(f"serving interactive demo on http://{host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return srv
