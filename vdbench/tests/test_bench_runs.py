"""Whole runs of the tiny cells on the CPU (the port's plain versions):
the reference against the port, the planted faults that `correct` has to
refuse, the float8 control, and the line a run prints."""

import json
import os
import subprocess
import sys

import pytest
import torch

from vdbench import calibrate, spec
from vdbench.drivers import RunArgs
from vdbench.run import driver
from vdbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")))


def _run(spec_path, cell, fault=None, seed=SEED):
    c = spec.load_cell(cell, spec_path)
    return driver(c).run(RunArgs(cell=c, seed=seed, seconds=0.5, trace=False,
                                 device="cpu", t0=0.0, fault=fault,
                                 log=lambda m: None))


@pytest.mark.parametrize("cell", ["tiny-disc.train", "tiny-gen.train",
                                  "tiny-disc.eval"])
def test_port_matches_reference(spec_path, cell):
    res = _run(spec_path, cell)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["readings"]["rounds"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny-disc.train", "frozen"), ("tiny-disc.train", "half"),
    ("tiny-gen.train", "frozen"), ("tiny-gen.train", "half"),
    ("tiny-disc.eval", "token"), ("tiny-disc.eval", "half")])
def test_planted_fault_is_not_correct(spec_path, cell, fault):
    res = _run(spec_path, cell, fault)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", ["tiny-disc.train", "tiny-gen.train",
                                  "tiny-disc.eval"])
def test_float8_control_is_not_correct(spec_path, cell):
    c = spec.load_cell(cell, spec_path)
    numbers, _ = calibrate.control(c, SEED, torch.device("cpu"))
    ok = all(numbers[k] <= v["limit"] for k, v in c.limits.items())
    assert not ok, numbers


def test_result_line(spec_path):
    r = subprocess.run(
        [sys.executable, "-m", "vdbench.run", "--workload", "tiny-gen.train",
         "--seed", str(SEED), "--seconds", "0.5", "--trace", "1",
         "--spec", spec_path, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["device"]["platform"] == "cpu"
    assert "loader_wait_ms.train" in line["metrics"]
    assert "train_rounds_per_s" not in line["metrics"]     # traced: per layer
    tail = r.stderr.strip().splitlines()[-len(line["compared"]):]
    assert [t.split()[0] for t in tail] == list(line["compared"])


def test_no_card_no_result(spec_path):
    r = subprocess.run(
        [sys.executable, "-m", "vdbench.run", "--workload", "tiny-gen.train",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--spec", spec_path],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_checkout_without_the_port(tmp_path):
    """A directory holding only BENCHMARK.json and vdbench/ fails."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "vdbench"), tmp_path / "vdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "-m", "vdbench.run", "--workload",
         "mn-qih-disc-nodedup.train", "--seed", "1", "--seconds", "1", "--trace", "0",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
