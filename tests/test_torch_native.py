"""The port's ctypes binding of native/pope_native.cpp (pope_tpu_torch/native.py)
against pope_tpu's binding of the same source, and against the port's plain
versions: the numpy RLE codec (ops/masks.py), the BFS small-region removal
(native.remove_small_regions_plain), the device labelling
(ops/components.py) and the device NMS (ops/nms.py). Also how the library is
built: by source hash under build/native/, once under concurrent first use,
and with an error, never a fallback, when it cannot be built."""

import threading

import numpy as np
import pytest
import torch

from pope_tpu import native as jax_native
from pope_tpu_torch import native
from pope_tpu_torch.ops.components import label_components
from pope_tpu_torch.ops.masks import mask_to_rle, rle_to_mask
from pope_tpu_torch.ops.nms import nms


def _masks():
    """Blobs and speckle of several densities, and the edge cases of the
    codec: empty, full, a set first pixel, one row, one column."""
    rng = np.random.default_rng(0)
    out = [rng.random((37, 53)) < p for p in (0.05, 0.5, 0.9)]
    blobs = np.zeros((48, 64), bool)
    for _ in range(6):
        y, x = rng.integers(0, 40), rng.integers(0, 56)
        blobs[y : y + rng.integers(1, 12), x : x + rng.integers(1, 12)] = True
    out.append(blobs)
    out.append(~blobs)
    first = np.zeros((5, 7), bool)
    first[0, 0] = True
    out += [np.zeros((6, 9), bool), np.ones((6, 9), bool), first, rng.random((1, 31)) < 0.5,
            rng.random((29, 1)) < 0.5]
    return out


MASKS = _masks()


@pytest.mark.parametrize("i", range(len(MASKS)))
def test_rle_matches_pope_tpu_and_plain(i):
    mask = MASKS[i]
    rle = native.rle_encode(mask)
    assert rle == jax_native.rle_encode(mask) == mask_to_rle(mask)
    assert sum(rle["counts"]) == mask.size
    back = native.rle_decode(rle)
    assert back.dtype == bool and np.array_equal(back, mask)
    assert np.array_equal(rle_to_mask(rle), mask) and np.array_equal(jax_native.rle_decode(rle), mask)


def test_rle_decode_rejects_counts_that_do_not_cover_the_mask():
    with pytest.raises(ValueError, match="do not cover"):
        native.rle_decode({"size": [4, 4], "counts": [3, 4]})


@pytest.mark.parametrize("value", [0, 1])
@pytest.mark.parametrize("i", [0, 1, 3, 4])
def test_connected_components_match_pope_tpu_and_plain(i, value):
    """Labels and areas equal pope_tpu's library call; the partition equals
    the device labelling's (8-connected) on the same pixels."""
    import ctypes

    mask = MASKS[i]
    labels, areas = native.connected_components(mask, value)
    h, w = mask.shape
    m = np.ascontiguousarray(mask, np.uint8)
    ref_labels = np.empty((h, w), np.int32)
    ref_areas = np.empty(h * w, np.int64)
    n = jax_native._load().connected_components(
        m.ctypes.data_as(ctypes.c_void_p), h, w, value, ref_labels.ctypes.data_as(ctypes.c_void_p),
        ref_areas.ctypes.data_as(ctypes.c_void_p))
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_array_equal(areas, ref_areas[:n])
    target = mask == bool(value)
    plain = label_components(torch.from_numpy(target), max_iters=h * w).numpy()
    assert (labels >= 0).sum() == target.sum() == areas.sum()
    pairs = {(a, b) for a, b in zip(labels[target], plain[target])}
    assert len(pairs) == len(areas) == len(np.unique(plain[target]))


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("thresh", [1, 5, 40, 10_000])
@pytest.mark.parametrize("i", [0, 1, 3, 4, 5, 6])
def test_remove_small_regions_matches_pope_tpu_and_plain(i, thresh, mode):
    mask = MASKS[i]
    out, changed = native.remove_small_regions(mask, thresh, mode)
    ref, ref_changed = jax_native.remove_small_regions(mask, thresh, mode)
    plain, plain_changed = native.remove_small_regions_plain(mask, thresh, mode)
    assert out.dtype == bool and out.shape == mask.shape
    assert changed == ref_changed == plain_changed
    assert np.array_equal(out, ref) and np.array_equal(out, plain)


def test_remove_small_regions_keeps_the_largest_island_when_all_are_small():
    mask = np.zeros((10, 10), bool)
    mask[0, 0] = True
    mask[5:7, 5:7] = True
    out, changed = native.remove_small_regions(mask, 100, "islands")
    assert changed and out.sum() == 4 and out[5:7, 5:7].all()
    with pytest.raises(ValueError, match="unknown mode"):
        native.remove_small_regions(mask, 1, "edges")


@pytest.mark.parametrize("thresh", [0.0, 0.3, 0.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_cpu_matches_pope_tpu_and_plain(seed, thresh):
    """Random boxes with tied scores: the same keep flags as pope_tpu's
    library call and the port's device NMS (ties keep the lower index)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (60, 2))], 1).astype(np.float32)
    scores = rng.integers(0, 8, 60).astype(np.float32)
    keep = native.nms_cpu(boxes, scores, thresh)
    assert keep.dtype == bool and 0 < keep.sum() < 60
    np.testing.assert_array_equal(keep, jax_native.nms_cpu(boxes, scores, thresh))
    np.testing.assert_array_equal(keep, nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh).numpy())
    with pytest.raises(ValueError, match="do not pair up"):
        native.nms_cpu(boxes, scores[:-1], thresh)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The binding with nothing built or loaded, building under tmp_path."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "native"


def test_builds_once_by_source_hash_under_concurrent_first_use(fresh_build):
    paths, errors = [], []

    def first_use():
        try:
            paths.append(native.build())
            native.library()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(paths)) == 1 and paths[0].parent == fresh_build
    assert paths[0].name.startswith("libpope_native_") and paths[0].suffix == ".so"
    assert [p.name for p in fresh_build.iterdir()] == [paths[0].name]  # no temporaries left
    assert native.available() and native.rle_encode(MASKS[3]) == mask_to_rle(MASKS[3])


@pytest.mark.parametrize("cxx", ["no-such-compiler-xyz", "false"], ids=["missing", "failing"])
def test_raises_when_the_library_cannot_be_built(fresh_build, monkeypatch, cxx):
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="not found|failed"):
        native.rle_encode(MASKS[0])
    assert not native.available()
    assert not fresh_build.exists() or not any(fresh_build.glob("*.so"))
