"""The port's own spans and counters (visdial_tpu_torch/utils/trace.py) in
the benchmark's runs, on the CPU's tiny cells.  The drivers do not start
the port's recorder, so a traced run records nothing and its readings are
what they were; with the recorder started around a driver's run, the
spans and counters of the port's layers that the cells pass through are
there, each a finite time (no upload: on the CPU nothing is shipped)."""

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
SPANS = {"train": ("build.host", "loader.assemble", "train.dispatch"),
         "eval": ("build.host", "eval.table", "eval.batches",
                  "eval.readback", "eval.metrics")}


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")))


def _run(spec_path, cell):
    c = spec.load_cell(cell, spec_path)
    return driver(c).run(RunArgs(cell=c, seed=SEED, seconds=0.5, trace=True,
                                 device="cpu", t0=0.0, log=lambda m: None))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_leaves_the_recorder_off(spec_path, cell):
    res = _run(spec_path, cell)
    assert res["correct"], res["compared"]
    assert set(res["readings"]) == READINGS
    assert trace.stop() is None


@pytest.mark.parametrize("cell", CELLS)
def test_recorded_run_holds_the_port_spans(spec_path, cell):
    trace.start()
    try:
        res = _run(spec_path, cell)
    finally:
        record = trace.stop()
    assert res["correct"], res["compared"]
    kind = res["readings"]["kind"]
    for name in SPANS[kind]:
        got = (trace.seconds(record, name), trace.self_seconds(record, name))
        assert all(math.isfinite(s) and s > 0 for s in got), (name, got)
    assert not [n for n in record["names"] if n.startswith("graph.")]
    c = record["counters"]
    if kind == "train":
        assert 0 <= c.get("loader.empty_gets", 0) <= c["loader.gets"]
    # the CPU's cells ship nothing to a device
    assert "upload" not in record["names"] and "upload.bytes" not in c
