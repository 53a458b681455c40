"""A run with the timed path broken underneath comes out not correct, and
the control's readings fail the limits, on the tiny cell (the harness's
look for a card is skipped: run_cell on the CPU). The faults an inference
cell on one card can have: half of the batch left out (the encoder's work
for it taken from the other half), and an answer altered where it is
produced: the network's IoU predictions, a box of the host cleanup, a
mask of the host cleanup, a candidate dropped by the cut."""

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny_cells

SEED = 2 ** 35 + 11


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    import pope_tpu_torch.pipeline.api as api

    monkeypatch.setitem(api.SAM_CHECKPOINTS, "h", (None, tiny_cells.tiny_encoder))
    return tiny_cells.make_root(tmp_path)


def half_batch(monkeypatch):
    from pope_tpu_torch.models.sam.amg import AutomaticMaskGenerator

    encode = AutomaticMaskGenerator._encode

    def first_half(self, images, in_h, in_w):
        half = (images.shape[0] + 1) // 2
        emb = encode(self, images[:half], in_h, in_w)
        return torch.cat([emb, emb], 0)[: images.shape[0]]

    monkeypatch.setattr(AutomaticMaskGenerator, "_encode", first_half)


def iou_altered(monkeypatch):
    from pope_tpu_torch.models.sam.sam import Sam

    decode = Sam.decode
    monkeypatch.setattr(Sam, "decode", lambda self, *a, **k: (lambda m, s: (m, s + 0.25))(*decode(self, *a, **k)))


def _host_result_altered(monkeypatch, change):
    from pope_tpu_torch.models.sam import amg

    post = amg.postprocess_small_regions_host
    monkeypatch.setattr(amg, "postprocess_small_regions_host", lambda *a, **k: change(post(*a, **k)))


def box_altered_host(monkeypatch):
    _host_result_altered(monkeypatch, lambda r: r._replace(boxes=r.boxes + 3.0))


def mask_altered_host(monkeypatch):
    def change(r):
        m = np.array(r.masks_low_res)
        m[:, 0, 0] = -m[:, 0, 0]
        return r._replace(masks_low_res=m)

    _host_result_altered(monkeypatch, change)


def candidate_dropped(monkeypatch):
    def change(r):
        v = np.array(r.valid)
        v[np.flatnonzero(v)[:1]] = False
        return r._replace(valid=v)

    _host_result_altered(monkeypatch, change)


FAULTS = [half_batch, iou_altered, box_altered_host, mask_altered_host, candidate_dropped]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_comes_out_not_correct(tiny, monkeypatch, fault):
    root, spec = tiny
    fault(monkeypatch)
    res = bench_run.run_cell(spec, tiny_cells.CELL, SEED, 2.0, False, device="cpu", root=root)
    assert not res["correct"], res["compared"]


def test_control_fails_the_limits(tiny):
    from benchmark.cells import Cell
    from benchmark.reference import control

    root, spec = tiny
    cell = Cell(spec, tiny_cells.CELL, root)
    numbers = control.readings(cell, SEED, "cpu")
    assert numbers and any(v > cell.limits[k] for k, v in numbers.items()), numbers
