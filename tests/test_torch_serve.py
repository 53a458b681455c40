"""The port's serving surfaces on the CPU: the web demo (against the port's
SamPredictor and pope_tpu's WebDemo), the continuous-batching pose service
(against the port's `runner.run_pairs` on the same frames and names, and
pope_tpu's `_result_json`), their HTTP routes and the `demo-web` /
`serve-pose` commands. Tiny seeded models: the SAM of
tests/test_torch_predictor.py, the DINOv2 and matcher of
tests/test_torch_eval.py."""

import base64
import json
import threading
import urllib.error
import urllib.request
from typing import NamedTuple

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pope_tpu.config import AMGConfig as JaxAMGConfig
from pope_tpu.config import PipelineConfig as JaxPipelineConfig
from pope_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
from pope_tpu.models.matcher import Matcher as JaxMatcher
from pope_tpu.models.sam import Sam as JaxSam
from pope_tpu_torch.models.dinov2 import DinoVisionTransformer
from pope_tpu_torch.models.matcher import Matcher
from pope_tpu_torch.models.sam import AutomaticMaskGenerator
from pope_tpu_torch.models.sam.predictor import SamPredictor
from pope_tpu_torch.pipeline import PopeModels, runner
from pope_tpu_torch.serve import PoseService, WebDemo, make_demo_server, make_pose_server
from pope_tpu_torch.weights import dinov2_state_from_jax, matcher_state_from_jax
from tests.test_torch_common import jax_params, port_config, port_sam, seeded_variables, structure_decoder
from tests.test_torch_common import tiny_cfg, to_jax
from tests.test_torch_eval import AMG_KW, _scene
from tests.test_torch_pipeline import DINO, MATCHER, _bn, _gamma
from tests.test_torch_predictor import image, with_mask_convs

H, W, CROP = 96, 128, 64
K = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]], np.float32)
# web demo: f32 outputs of the same computation in another order (scores),
# binary masks agreeing on MIN_AGREE of the pixels
TOL_SCORE = 2e-5
MIN_AGREE = 0.99


def demo_params():
    """The structured decoder (tests/test_torch_common.py), each mask token
    reading its own upscaled channel (tokens 1-2 then have foregrounds on
    this image) and the IoU head preferring token 2, so that the demo's
    chosen mask is not empty; the mask convs seeded."""
    params = with_mask_convs(structure_decoder(jax_params(tiny_cfg(False), seed=3)))
    md = params["params"]["mask_decoder"]
    for i in range(4):
        bias = md[f"hyper_{i}"]["lin2"]["bias"]
        bias[:] = 0.0
        bias[i] = 1.0
    md["iou_head"]["lin2"]["bias"][2] += 1.0
    return params


@pytest.fixture(scope="module")
def demo_sam():
    params = demo_params()
    return params, port_sam(tiny_cfg(False), params)


@pytest.fixture(scope="module")
def demo(demo_sam):
    d = WebDemo(demo_sam[1], image(), max_points=6, device="cpu")
    yield d
    d.close()


def test_demo_predict_matches_predictor(demo_sam):
    """At a capacity of 2 (one click and the pad point, the browser client's
    prompt), a click's mask and score are the predictor's best multimask
    slot."""
    sam = demo_sam[1]
    demo2 = WebDemo(sam, image(), max_points=2, device="cpu")
    pred = SamPredictor(sam, device="cpu")
    pred.set_image(image())
    try:
        for pt in ([60.0, 45.0], [100.0, 70.0]):
            masks, iou, _ = pred.predict(point_coords=np.array([pt]), point_labels=np.array([1]))
            best = int(np.argmax(iou))
            mask, score = demo2.predict([pt], [1])
            assert mask.shape == (H, W) and mask.dtype == bool and 0.05 < mask.mean() < 0.95
            assert (mask == masks[best]).mean() >= MIN_AGREE
            assert abs(score - float(iou[best])) < TOL_SCORE
    finally:
        demo2.close()


def test_demo_matches_jax_demo(demo, demo_sam):
    """The port's WebDemo against pope_tpu's at the same capacity (6): one
    click (pad slots up to capacity), two clicks, and more points than the
    capacity holds (the newest 5 are kept)."""
    from pope_tpu.serve import WebDemo as JaxWebDemo

    params = demo_sam[0]
    jax_demo = JaxWebDemo(JaxSam(tiny_cfg(False)), to_jax(params), image(), max_points=6)
    rng = np.random.default_rng(4)
    many = rng.uniform([0, 0], [W, H], (8, 2)).tolist()
    for pts, lbl in (([[60.0, 45.0]], [1]), ([[60.0, 45.0], [20.0, 70.0]], [1, 0]), (many, [1, 0] * 4)):
        mask, score = demo.predict(pts, lbl)
        mask_j, score_j = jax_demo.predict(pts, lbl)
        assert (mask == mask_j).mean() >= MIN_AGREE
        assert abs(score - score_j) < TOL_SCORE
    assert demo.predict(many, [1, 0] * 4)[1] == demo.predict(many[3:], ([1, 0] * 4)[3:])[1]


def test_demo_is_deterministic(demo):
    m1, s1 = demo.predict([[80.0, 60.0]], [1])
    m2, s2 = demo.predict([[80.0, 60.0]], [1])
    assert np.array_equal(m1, m2) and s1 == s2


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address
    return f"http://{host}:{port}"


def _post(url, payload: bytes, timeout=120):
    req = urllib.request.Request(url, data=payload, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_demo_http_roundtrip(demo):
    srv = make_demo_server(demo, port=0)
    base = _serve(srv)
    try:
        assert "interactive segmentation" in urllib.request.urlopen(base + "/").read().decode()
        assert urllib.request.urlopen(base + "/image").read()[:8] == b"\x89PNG\r\n\x1a\n"
        meta = json.loads(urllib.request.urlopen(base + "/meta").read())
        assert meta == {"hw": [H, W], "max_points": 6}
        out = _post(base + "/predict", json.dumps({"points": [[60, 45], [100, 80]], "labels": [1, 0]}).encode())
        mask, score = demo.predict([[60, 45], [100, 80]], [1, 0])
        assert out["score"] == score and out["area"] == int(mask.sum())
        png = base64.b64decode(out["mask_png"])
        assert (cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED)[..., 3] > 0).sum() == out["area"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/predict", b"{}")
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


# --- the pose service ----------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """The port's tiny bundle of tests/test_torch_eval.py (a 4 px RANSAC band,
    so that pairs solve)."""
    sam_cfg = tiny_cfg(False)
    cfg = port_config(JaxPipelineConfig(matcher=MATCHER, dinov2=DINO, sam=sam_cfg, amg=JaxAMGConfig(**AMG_KW),
                                        ransac_thresh_px=4.0))
    sam = port_sam(sam_cfg, structure_decoder(jax_params(sam_cfg, seed=0)))
    dino = DinoVisionTransformer(cfg.dinov2)
    dino.load_state_dict(dinov2_state_from_jax(
        seeded_variables(JaxDino(DINO), jnp.zeros((1, 196, 196, 3)), seed=0, fill=_gamma)), strict=True)
    matcher = Matcher(cfg.matcher)
    z = jnp.zeros((1, 64, 64, 1))
    matcher.load_state_dict(matcher_state_from_jax(
        seeded_variables(JaxMatcher(MATCHER), z, z, seed=1, fill=_bn)), strict=True)
    return PopeModels(sam=sam, amg=AutomaticMaskGenerator(sam, cfg.amg, device="cpu"), dinov2=dino.eval(),
                      matcher=matcher.eval(), config=cfg, device=torch.device("cpu"))


def pair(seed):
    """A prompt frame and a shifted, brightened target of the same scene."""
    rng = np.random.default_rng(seed)
    scene = _scene(rng, H + 24, W + 24)
    dy, dx = rng.integers(0, 24, 2)
    return (scene[:H, :W].astype(np.uint8),
            np.clip(scene[dy : dy + H, dx : dx + W] * 1.1, 0, 255).astype(np.uint8))


class _Pair(NamedTuple):
    """What runner.run_pairs reads of a manifest pair besides its files."""

    pair_name: str
    object_label: str = "obj"
    box3d: str = "/nonexistent/box3d_corners.txt"


def run_pairs(models, frames, names):
    """runner.run_pairs on in-memory frames (upload_frames; identity poses)."""
    eye = np.eye(4, dtype=np.float32)
    hosts = [(f0, f1, K, K, eye, eye) for f0, f1 in frames]
    dev = runner.upload_frames(np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
                               np.stack([K] * len(frames)), np.stack([K] * len(frames)), "cpu")
    return runner.run_pairs(models, [_Pair(n) for n in names], _Spec(CROP), hosts=hosts, dev=dev)


class _Spec(NamedTuple):
    crop_size: int


def assert_result_is_record(res, rec):
    """A service result against run_pairs's record of the same pair: the
    same pose, flags, box, counts and match-set size, exactly."""
    assert res["name"] == rec["identifier"]
    assert res["ok"] == rec["ok"] and res["pre_bbox"].tolist() == rec["pre_bbox"]
    np.testing.assert_array_equal(res["R"], rec["R"])
    np.testing.assert_array_equal(res["t"], rec["t"])
    for k in ("n_strong", "n_dropped_masks", "n_dropped_matches"):
        assert res[k] == rec[k], k
    assert res["mkpts0"].shape[0] == res["mkpts1"].shape[0] == res["mconf"].shape[0] == rec["epi_errs"].size


@pytest.fixture(scope="module")
def service(models):
    svc = PoseService(models, crop_size=CROP, batch_size=2, max_wait_ms=300.0)
    yield svc
    svc.shutdown(drain=False)


@pytest.fixture(scope="module")
def first_results(service):
    """Three concurrent requests through the B=2 service: a full batch and a
    padded one."""
    frames = [pair(i) for i in range(3)]
    futs = [service.submit(*f, K, K, name=f"pair-{i}") for i, f in enumerate(frames)]
    return frames, [f.result(timeout=600) for f in futs], service.stats()


def test_service_results_equal_run_pairs(models, first_results):
    frames, results, _ = first_results
    recs = run_pairs(models, frames[:2], ["pair-0", "pair-1"]) + run_pairs(models, [frames[2]] * 2, ["pair-2"] * 2)[:1]
    for res, rec in zip(results, recs):
        assert_result_is_record(res, rec)
    assert any(r["ok"] for r in results) and all(r["mkpts0"].shape[0] > 0 for r in results)


def test_service_stats_count_padded_slots(first_results):
    _, _, st = first_results
    assert st["requests"] == 3 and st["batches"] == 2 and st["padded_slots"] == 1
    assert st["batch_fill"] == 0.75 and st["mean_latency_ms"] > 0


def test_batch_composition_invariance(service, first_results):
    """The same frames and name give the same result whatever shares the
    batch: the noise is the name's, the shapes are the service's."""
    frames, results, _ = first_results
    a = service.submit(*frames[0], K, K, name="pair-0")
    b = service.submit(*pair(7), K, K, name="other")
    ra = a.result(timeout=600)
    b.result(timeout=600)
    for k in ("R", "t", "pre_bbox", "mkpts0", "mkpts1", "mconf"):
        np.testing.assert_array_equal(ra[k], results[0][k])
    assert all(ra[k] == results[0][k] for k in ("ok", "n_strong", "n_dropped_masks", "n_dropped_matches"))


def test_frame_shape_pinning(service, first_results):
    assert service.frame_hw == (H, W)
    with pytest.raises(ValueError, match="pinned"):
        service.submit(np.zeros((64, 64, 3), np.uint8), np.zeros((64, 64, 3), np.uint8), K, K)
    with pytest.raises(ValueError, match="share"):
        service.submit(np.zeros((H, W, 3), np.uint8), np.zeros((64, 64, 3), np.uint8), K, K)


def test_result_json_matches_jax(first_results):
    """The result JSON has the keys and shapes of pope_tpu's _result_json on
    the same result."""
    from pope_tpu.serve.pose_service import _result_json as jax_result_json
    from pope_tpu_torch.serve.pose_service import _result_json

    res = first_results[1][0]
    out, ref = _result_json(res), jax_result_json(res)
    assert list(out) == list(ref)
    for k in ref:
        assert np.shape(out[k]) == np.shape(ref[k]) and out[k] == ref[k], k
    json.dumps(out)


def test_pose_http(models, service, first_results):
    """POST /pose, GET /stats and a bad request. The request arrives alone,
    so the service forms the batch [pair-1, pair-1 as padding]; its R is
    held to run_pairs's on that batch, bit for bit. (In first_results
    pair-1 shared a batch with pair-0, and across batch compositions the
    matcher's products round differently: results agree to f32 rounding
    only, ROADMAP Queue 3.)"""
    frames, _, _ = first_results
    srv = make_pose_server(service, port=0)
    base = _serve(srv)

    def b64png(img):
        ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        assert ok
        return base64.b64encode(buf.tobytes()).decode()

    try:
        payload = {"image0": b64png(frames[1][0]), "image1": b64png(frames[1][1]), "K0": K.tolist(),
                   "K1": K.tolist(), "name": "pair-1"}
        before = service.stats()
        out = _post(base + "/pose", json.dumps(payload).encode(), timeout=600)
        st = json.loads(urllib.request.urlopen(base + "/stats", timeout=60).read())
        assert (st["batches"] - before["batches"], st["padded_slots"] - before["padded_slots"]) == (1, 1)
        assert out["name"] == "pair-1" and out["n_matches"] == len(out["mkpts0"]) == len(out["mconf"])
        rec = run_pairs(models, [frames[1]] * 2, ["pair-1"] * 2)[0]
        np.testing.assert_array_equal(np.asarray(out["R"], np.float32), rec["R"])
        assert st["requests"] >= 4 and 0 < st["batch_fill"] <= 1.0
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/pose", b'{"image0": "not-an-image"}')
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


def test_shutdown_drains_then_rejects(models):
    svc = PoseService(models, crop_size=CROP, batch_size=2, max_wait_ms=1.0)
    fut = svc.submit(*pair(0), K, K, name="pair-0")
    svc.shutdown(drain=True)
    assert fut.result(timeout=0)["name"] == "pair-0"
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit(*pair(1), K, K)


def test_batcher_under_concurrent_submits(models, monkeypatch):
    """Eight threads submit 200 requests (half unnamed) to a B=3 service whose
    device work is a fake that writes each request's number into its
    n_strong, with a short switch interval: every future resolves to its own
    request, the names the service gives are unique, and the counts add up
    (requests + padded slots = B x batches)."""
    import sys

    def fake_dispatch(models, paths_list, spec, hosts=None, dev=None):
        small = torch.zeros(len(paths_list), 29)
        small[:, 26] = torch.tensor([float(p.pair_name.split("-")[-1]) for p in paths_list])
        return runner.Pending(paths_list, hosts, small, torch.zeros(len(paths_list), 4, 6), None)

    monkeypatch.setattr(runner, "upload_frames", lambda *a: None)
    monkeypatch.setattr(runner, "dispatch_pairs", fake_dispatch)
    svc = PoseService(models, crop_size=CROP, batch_size=3, max_wait_ms=0.5)
    frame = np.zeros((H, W, 3), np.uint8)
    futs, lock = [], threading.Lock()

    def client(t):
        for j in range(25):
            k = 25 * t + j
            name = f"s-{k}" if k % 2 else None  # unnamed: the service numbers it req-<n>
            f = svc.submit(frame, frame, K, K, name=name)
            with lock:
                futs.append((k, name, f))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        results = [(k, name, f.result(timeout=60)) for k, name, f in futs]
    finally:
        sys.setswitchinterval(interval)
        svc.shutdown(drain=False)
    assert len(results) == 200
    for k, name, res in results:
        if name is not None:
            assert res["name"] == name and res["n_strong"] == k
    given = [res["name"] for _, name, res in results if name is None]
    assert len(set(given)) == 100 and all(g.startswith("req-") for g in given)
    st = svc.stats()
    assert st["requests"] == 200 and st["requests"] + st["padded_slots"] == 3 * st["batches"]


# --- the commands -----------------------------------------------------------------------


def test_cli_serving_commands_default_to_cuda(tmp_path, monkeypatch):
    """demo-web and serve-pose parse; without --device they load on CUDA,
    which raises without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from pope_tpu_torch.cli import main

    frame = tmp_path / "frame.png"
    cv2.imwrite(str(frame), image())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["demo-web", "--image", str(frame)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve-pose", "--batch-size", "2"])


def test_cli_serving_commands_on_cpu(tmp_path, monkeypatch, demo_sam, models):
    """With --device cpu and load_models patched to the tiny models, each
    command builds its server and stops cleanly."""
    import pope_tpu_torch.pipeline as pipeline
    import pope_tpu_torch.serve as serve
    from pope_tpu_torch.cli import main

    frame = tmp_path / "frame.png"
    cv2.imwrite(str(frame), image()[:, :, ::-1])
    seen, demos, servers = [], [], []
    bundle = PopeModels(sam=demo_sam[1], amg=None, dinov2=None, matcher=None, config=models.config,
                        device=torch.device("cpu"))
    monkeypatch.setattr(pipeline, "load_models", lambda **kw: seen.append(kw) or (bundle if kw.get("components") == ("sam",) else models))
    monkeypatch.setattr(serve, "run_demo_server", lambda d, host, port: demos.append((d, host, port)))

    class Server:
        server_address = ("127.0.0.1", 0)

        def __init__(self, service):
            self.service = service
            servers.append(self)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            self.closed = True

    monkeypatch.setattr(serve, "make_pose_server", lambda svc, host, port: Server(svc))
    main(["demo-web", "--image", str(frame), "--device", "cpu", "--max-points", "4"])
    main(["serve-pose", "--device", "cpu", "--batch-size", "2", "--crop-size", str(CROP), "--port", "0"])
    assert [kw["device"] for kw in seen] == ["cpu", "cpu"] and seen[0]["components"] == ("sam",)
    (d, host, port), = demos
    assert d.max_points == 4 and port == 8081 and np.array_equal(d.image_rgb, image())
    svc = servers[0].service
    assert svc.batch_size == 2 and svc.crop_size == CROP and servers[0].closed
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit(*pair(0), K, K)
