"""BENCHMARK.json and the files it names, found by name."""

import json
import os

import pytest

from vdbench import spec

SPEC = json.load(open(spec.SPEC))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["encoder"] == "mn-ques-im-hist"
    assert c.traffic["kind"] in ("train", "eval")
    assert os.path.exists(os.path.join(spec.HERE, "drivers", c.traffic["kind"] + ".py"))
    assert c.limits and all("limit" in v for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:         # every per-layer metric's end-to-end one
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["vdbench"]
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert c["file"].startswith("vdbench/")
    fours = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(SPEC["workloads"]) // 4)
    for m in SPEC["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"input", "dispatch", "model step", "kernels",
                      "collectives", "device"}


def test_readers_leave_out_what_a_run_lacks():
    r = {"kind": "eval", "setup_s": 3.0, "window_s": 2.0, "rounds": 10,
         "peak_reserved_bytes": 0, "spans": {}, "trace": None, "work": None}
    got = spec.read_metrics(SPEC["end_to_end"] + SPEC["per_layer"], r)
    assert set(got) == {"setup_s", "eval_rounds_per_s"}
