"""The port's own spans and counters (visdial_tpu_torch/utils/trace.py) in
the benchmark's runs, on the CPU's tiny cells.  An untraced run leaves the
port's recorder off, and its readings are the benchmark's alone.  A traced
run records the port's spans and counters in two records, set-up and the
window's dispatches or passes before the traced stretch, and hands them
on in its readings, each span a finite time (no upload: on the CPU
nothing is shipped); then the recorder is off again.  The readers of the metrics that read them find a finite value
where the run holds what they read and None where it does not (on the
CPU: no upload, no graph, no kernel library)."""

import json
import math

import pytest

from vdbench import spec
from vdbench.drivers import RunArgs
from vdbench.run import driver
from vdbench.tests import tiny
from visdial_tpu_torch.utils import trace

SEED = 2 ** 31 + 977
CELLS = ["tiny-disc.train", "tiny-gen.train", "tiny-disc.eval"]
READINGS = {"kind", "setup_s", "window_s", "rounds", "peak_reserved_bytes",
            "spans", "trace", "work"}
PROGRAM = {"program_spans", "program_counters", "window_units"}
SPANS = {"train": {"setup": ("build.host", "loader.assemble", "train.dispatch"),
                   "window": ("loader.assemble", "train.dispatch")},
         "eval": {"setup": ("build.host",),
                  "window": ("eval.table", "eval.batches", "eval.readback",
                             "eval.metrics")}}
# each metric that reads the port's records: the kinds of tiny cell whose
# traced run on the CPU holds what it reads
ON_CPU = {"loader_assemble_ms.train": {"train"},
          "loader_empty_pct.train": {"train"},
          "upload_ms.train": set(),
          "graph_launch_ms.train": set(),
          "dispatch_self_ms.train": {"train"},
          "eval_enqueue_ms.eval": {"eval"},
          "eval_host_tail_ms.eval": {"eval"},
          "setup_capture_s": set(),
          "window_captures": {"train", "eval"},
          "setup_kernels_s": set(),
          "setup_host_build_s": {"train", "eval"}}


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def runs(spec_path):
    """A run of a cell, traced or not, made once a module (and worker)."""
    done = {}

    def run(cell, traced):
        if (cell, traced) not in done:
            c = spec.load_cell(cell, spec_path)
            done[cell, traced] = driver(c).run(RunArgs(
                cell=c, seed=SEED, seconds=0.5, trace=traced, device="cpu",
                t0=0.0, log=lambda m: None))
            assert trace.stop() is None          # the recorder is off again
        return done[cell, traced]
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_leaves_the_recorder_off(runs, cell):
    res = runs(cell, False)
    assert res["correct"], res["compared"]
    assert set(res["readings"]) == READINGS


@pytest.mark.parametrize("cell", CELLS)
def test_recorded_run_holds_the_port_spans(runs, cell):
    res = runs(cell, True)
    assert res["correct"], res["compared"]
    r = res["readings"]
    assert set(r) == READINGS | PROGRAM
    json.dumps(r)                             # a rank hands it on as JSON
    for record, names in SPANS[r["kind"]].items():
        got = r["program_spans"][record]
        for name in names:
            times = (got[name]["seconds"], got[name]["self_seconds"])
            assert got[name]["count"] > 0, (record, name)
            assert all(math.isfinite(s) and s > 0 for s in times), (record, name)
        assert not [n for n in got if n.startswith("graph.")]
        # the CPU's cells ship nothing to a device
        assert "upload" not in got
        assert "upload.bytes" not in r["program_counters"][record]
    c = r["program_counters"]["window"]
    if r["kind"] == "train":
        assert r["window_units"] >= 1        # the trace starts after one
        assert 0 <= c.get("loader.empty_gets", 0) <= c["loader.gets"]
    else:
        assert r["window_units"] == 1        # the trace starts after one


def test_program_metrics_name_their_source():
    source = {m["name"]: m["source"]
              for m in json.load(open(spec.SPEC))["per_layer"]}
    assert all(source[m].startswith("program_") for m in ON_CPU)
    # these two read the benchmark's own spans, on the host's clock
    assert source["loader_wait_ms.train"] == "host_clock"
    assert source["dispatch_host_ms.train"] == "host_clock"


@pytest.mark.parametrize("metric", sorted(ON_CPU))
def test_reader_finds_what_the_run_holds(runs, metric):
    read = spec.reader(metric)
    for cell in CELLS:
        kind = cell.split(".")[1]
        assert read(runs(cell, False)["readings"]) is None, cell
        got = read(runs(cell, True)["readings"])
        if kind in ON_CPU[metric]:
            assert got is not None and math.isfinite(got) and got >= 0, (cell, got)
        else:
            assert got is None, (cell, got)
    if metric == "window_captures":         # set-up captured all there is
        assert read(runs("tiny-disc.train", True)["readings"]) == 0
