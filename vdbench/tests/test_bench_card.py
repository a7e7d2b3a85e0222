"""On the card (marked `cuda`; each skips without one): the float8 control
at the cells' widths over a smaller split must fail the cells' limits, and
one short run of each one-card cell must come out correct.

    python -m pytest vdbench/tests/test_bench_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from vdbench import calibrate, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ONE_CARD = [w["name"] for w in json.load(open(spec.SPEC))["workloads"]
            if w["chips"] == 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_float8_control_fails_the_limits(card, cell):
    c = spec.load_cell(cell)
    c.traffic = dict(c.traffic, dialogs=min(c.traffic["dialogs"], 4096))
    numbers, _ = calibrate.control(c, 2 ** 31 + 5, card)
    assert any(numbers[k] > v["limit"] for k, v in c.limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_short_run_is_correct(card, cell):
    r = subprocess.run(
        [sys.executable, "-m", "vdbench.run", "--workload", cell, "--seed",
         str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
