"""BENCHMARK.json and the files it names, found by name; and a cell of a new
encoder family that joins as new files and new entries alone."""

import json
import os
import shutil

import pytest

from vdbench import encoders, spec
from vdbench.drivers import port_config
from vdbench.tests import tiny

SPEC = json.load(open(spec.SPEC))
CELLS = [w["name"] for w in SPEC["workloads"]]
LAYERS = {"input", "dispatch", "model step", "kernels", "collectives",
          "device", "set-up"}


def check_cell(name: str, spec_path: str = spec.SPEC) -> spec.Cell:
    """What holds for any cell: its configuration is one the port runs, its
    encoder's family module has every function the harness calls, and its
    traffic, limits and metrics are found."""
    c = spec.load_cell(name, spec_path)
    port_config(c.config)
    family = c.config["encoder"].split("-")[0]
    assert os.path.basename(c.family.__file__) == family + ".py"
    assert all(callable(getattr(c.family, f)) for f in encoders.FUNCTIONS)
    assert c.family.weight_shapes(c.config)
    assert c.traffic["kind"] in ("train", "eval")
    assert os.path.exists(os.path.join(spec.HERE, "drivers", c.traffic["kind"] + ".py"))
    assert c.limits and all("limit" in v for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:         # every per-layer metric's end-to-end one
        assert m["moves"] in e2e
    return c


def check_contract(bench: dict) -> None:
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["vdbench"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert c["file"].startswith("vdbench/")
    fours = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    assert {m["layer"] for m in bench["per_layer"]} <= LAYERS


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    check_cell(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_contract_shapes():
    check_contract(SPEC)


def test_readers_leave_out_what_a_run_lacks():
    r = {"kind": "eval", "setup_s": 3.0, "window_s": 2.0, "rounds": 10,
         "peak_reserved_bytes": 0, "spans": {}, "trace": None, "work": None}
    got = set(spec.read_metrics(SPEC["end_to_end"] + SPEC["per_layer"], r))
    assert {"setup_s", "eval_rounds_per_s"} <= got
    lacking = {m["name"] for m in SPEC["per_layer"]} | {"peak_reserved_gib",
                                                        "train_rounds_per_s"}
    assert not got & lacking


NEW_CELL = "hre-qih-disc-nodedup.train"
NEW_METRIC = "hre_dispatch_ms.train"


def _files(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_joins_as_files_alone(tmp_path):
    """A copy of the real spec takes a cell of another family (HRE, here
    MN's module under HRE's name) by new files and new entries alone: its
    family module, configuration, limits and a per-layer metric's reader;
    the spec loads it, every metric's reader reads it, the tiny spec's
    derivation and the contract's shapes take it, and no file that was
    there changes."""
    copy = tmp_path / "copy"
    copy.mkdir()
    shutil.copy(spec.SPEC, copy / "BENCHMARK.json")
    shutil.copytree(spec.HERE, copy / "vdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(copy)
    files = copy / "vdbench"
    shutil.copy(files / "encoders" / "mn.py", files / "encoders" / "hre.py")
    conf = json.loads((files / "configs" / "mn-qih-disc-nodedup.json").read_text())
    (files / "configs" / "hre-qih-disc-nodedup.json").write_text(
        json.dumps(dict(conf, encoder="hre-ques-im-hist")))
    shutil.copy(files / "limits" / "mn-qih-disc-nodedup.train.json",
                files / "limits" / f"{NEW_CELL}.json")
    (files / "metrics" / f"{NEW_METRIC}.py").write_text(
        "from vdbench import metrics as shared\n\n\n"
        "def read(r):\n"
        "    return shared.span_ms(r, 'train', 'train.dispatch')\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "hre-qih-disc-nodedup", "source": "https://arxiv.org/abs/1611.08669",
        "file": "vdbench/configs/hre-qih-disc-nodedup.json", "reduced": [],
        "why": "HRE-QIH-D"})
    bench["workloads"].append({
        "name": NEW_CELL, "config": "hre-qih-disc-nodedup",
        "traffic": "train-zipf", "chips": 1, "why": "a second family"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rounds_per_s":
            m["workloads"].append(NEW_CELL)
    bench["per_layer"].append({
        "name": NEW_METRIC, "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "dispatch",
        "moves": "train_rounds_per_s", "workloads": [NEW_CELL]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    path = str(copy / "BENCHMARK.json")

    c = check_cell(NEW_CELL, path)
    assert c.family.__file__ == str(files / "encoders" / "hre.py")
    for w in bench["workloads"]:
        check_cell(w["name"], path)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"], c.files))
    traced = {"kind": "train", "setup_s": 30.0, "window_s": 2.0, "rounds": 10,
              "peak_reserved_bytes": 2 ** 30, "spans": {}, "trace": None,
              "work": None, "window_units": 2,
              "program_spans": {"setup": {}, "window": {"train.dispatch": {
                  "count": 2, "seconds": 0.01, "self_seconds": 0.004}}},
              "program_counters": {"setup": {}, "window": {}}}
    got = spec.read_metrics(c.per_layer, traced, c.files)
    assert got[NEW_METRIC] == {"value": 5.0, "unit": "ms"}
    assert set(spec.read_metrics(c.end_to_end, traced, c.files)) == {
        "train_rounds_per_s", "peak_reserved_gib", "setup_s"}

    small = tiny.write(str(tmp_path / "tiny"), real=path)
    small_bench = json.loads(open(small).read())
    given = {m["name"]: m["workloads"] for m in small_bench["per_layer"]}
    assert given[NEW_METRIC] == ["tiny-disc.train"]       # train, disc, one card
    assert spec.load_cell("tiny-disc.train", small).per_layer[-1]["name"] == NEW_METRIC
    check_contract(bench)
    after = _files(copy)
    assert {k: v for k, v in after.items() if k in before
            and k != "BENCHMARK.json"} == {k: v for k, v in before.items()
                                          if k != "BENCHMARK.json"}
