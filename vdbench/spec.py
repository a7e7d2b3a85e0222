"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names its configuration and its traffic
mix; the configuration's file is configs/<config>.json, the mix's
traffic/<traffic>.json, the cell's limits limits/<cell>.json, and each
metric's reader metrics/<metric>.py.  A later cell, mix or metric is a new
file and a new entry, never an edit of one here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything its files say."""
    name: str
    chips: int
    config_name: str
    config: dict           # the configuration file, as run
    traffic_name: str
    traffic: dict          # the traffic file
    limits: dict           # {number: {"limit": x, ...}}
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: str = SPEC) -> Cell:
    """The cell `name` of the spec at spec_path, its data files read from
    the benchmark's directory beside that spec (a test's own spec brings
    its own)."""
    spec = _load_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the spec has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    root = os.path.dirname(os.path.abspath(spec_path))
    files = os.path.join(root, os.path.basename(HERE))
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=_load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=_load_json(os.path.join(files, "traffic", w["traffic"] + ".json")),
        limits=_load_json(os.path.join(files, "limits", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The `read` function of metrics/<metric>.py (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "vdbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, readings) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds something
    to read in `readings`; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in entries:
        value = reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
