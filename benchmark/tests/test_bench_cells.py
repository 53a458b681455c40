"""The harness finds each cell's parts by name; a cell added as files and
entries alone loads and runs; and the run's comparison with the reference
goes end to end on the CPU at a tiny size (the cells' own sizes run on
the card)."""

import json
import re

import pytest

from benchmark import run as bench_run
from benchmark.cells import HERE, Cell, load_json
from benchmark.tests import tiny_cells

SPEC = load_json(HERE.parent / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_parts_found_by_name(cell):
    c = Cell(SPEC, cell)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(c.driver(), "run")
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    e2e = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = c.metrics("per_layer")
    assert layers
    for m in layers:
        assert callable(c.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_spec_keeps_to_its_format():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for x in ("end_to_end", "per_layer") for n in (m["name"] for m in SPEC[x]))) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert load_json(HERE.parent / c["file"])["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "workloads" not in next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_config_files_hold_every_size_as_run():
    """The configuration files are bench_config()'s, with SAM's encoder of
    their type, and nothing is reduced."""
    from pope_tpu_torch import config
    from pope_tpu_torch.bench import bench_config

    from benchmark.cells import pipeline_config

    want = bench_config()
    for c in SPEC["configs"]:
        got = pipeline_config(config, load_json(HERE.parent / c["file"]), {})
        enc = getattr(config.SamEncoderConfig, f"vit_{load_json(HERE.parent / c['file'])['sam']['type']}")()
        assert got.sam.encoder == enc
        assert got.amg == want.amg and got.dinov2 == want.dinov2 and got.matcher == want.matcher
        assert c["reduced"] == []


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    import pope_tpu_torch.pipeline.api as api

    monkeypatch.setitem(api.SAM_CHECKPOINTS, "h", (None, tiny_cells.tiny_encoder))
    return tiny_cells.make_root(tmp_path)


@pytest.mark.parametrize("trace", [0, 1])
def test_added_cell_runs_and_compares_on_cpu(tiny, trace):
    root, spec = tiny
    res = bench_run.run_cell(spec, tiny_cells.CELL, 2 ** 40 + 7, 2.0, bool(trace), device="cpu", root=root)
    assert res["correct"], res["compared"]
    assert res["compared"]["samples"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    if trace:
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) >= {"setup_s"}
