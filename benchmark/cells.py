"""Where the harness finds a cell's parts: every one by the name that
`BENCHMARK.json` gives it.

- a configuration: `configs/<config>.json`, the model as it is run;
- a traffic mix: `traffic/<traffic>.json`, the parameters that one driver
  (`drivers/<driver>.py`, named in the mix) reads;
- a per-layer metric: `metrics/<metric>.py`, a reader with `read(trace)`;
- the limits of the comparison that decides `correct`: `limits/<cell>.json`.

A later cell, mix, configuration or metric is new files and new entries:
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import typing
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_spec(start: Path = Path.cwd()) -> Path:
    """BENCHMARK.json in the checkout: the working directory, else the one
    above this folder."""
    for root in (start, HERE.parent):
        if (root / "BENCHMARK.json").is_file():
            return root / "BENCHMARK.json"
    raise FileNotFoundError("no BENCHMARK.json in the working directory or beside benchmark/")


class Cell:
    """One workload of a BENCHMARK.json with its configuration, traffic,
    limits and metrics resolved by name. `root` is the folder that holds
    configs/, traffic/, drivers/, metrics/ and limits/ (this one by
    default)."""

    def __init__(self, spec: dict, name: str, root: Path = HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.spec = spec
        self.root = Path(root)
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.config = load_json(self.root / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(self.root / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.root / "limits" / f"{name}.json")

    def metrics(self, kind: str) -> list:
        """The `end_to_end` or `per_layer` entries this cell reports: those
        whose `workloads` list it, or that have none."""
        return [m for m in self.spec[kind] if name_in(self.name, m)]

    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['driver']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py")


def name_in(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(path: Path):
    """Import a file by path, under a name made from it (metric files carry
    dots in their names)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    name = "benchmark_file_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_dataclass(cls, values: dict):
    """A (frozen) config dataclass from a JSON object: nested dataclasses
    from nested objects, lists as tuples; keys the class lacks are an
    error, fields left out keep their defaults."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {}
    for key, value in values.items():
        hint = hints[key]
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            kw[key] = build_dataclass(hint, value)
        elif isinstance(value, list):
            kw[key] = tuple(value)
        elif isinstance(value, str) and value in ("-inf", "inf"):
            kw[key] = float(value)
        else:
            kw[key] = value
    return cls(**kw)


def pipeline_config(config_module, cfg: dict, traffic: dict, dtype: str = ""):
    """The PipelineConfig of a configuration file, with the traffic's
    `overrides` (dotted field paths) applied, from `config_module` (the
    port's or the reference's). dtype="float32" sets every compute dtype to
    float32 (the reference's)."""
    c = config_module
    sam = dict(cfg["sam"])
    encoder = build_dataclass(c.SamEncoderConfig, sam.pop("encoder"))
    sam.pop("type", None)
    values = {
        "sam": {**sam, "encoder": dataclasses.asdict(encoder)},
        "amg": cfg["amg"],
        "dinov2": cfg.get("dinov2", {}),
        "matcher": cfg.get("matcher", {}),
        **cfg.get("pipeline", {}),
    }
    for path, value in traffic.get("overrides", {}).items():
        node = values
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    if dtype:
        values["sam"]["encoder"]["dtype"] = dtype
        values["sam"]["decoder_dtype"] = dtype
        values["dinov2"] = {**values["dinov2"], "dtype": dtype}
        values["matcher"] = {**values["matcher"], "dtype": dtype}
    return build_dataclass(c.PipelineConfig, values)
