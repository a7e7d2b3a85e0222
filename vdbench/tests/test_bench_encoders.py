"""The encoder family seam (encoders/): MN's readings pinned, and the family
module alone deciding a cell's encoder.

mn_pins.json holds what the benchmark's code gave before the MN encoder
moved behind the seam: the weight layouts in draw order, digests of the
seed's weights, of the encoder's batch and of its dropout masks, the
operation counts, and the tiny cells' compared numbers at one seed.  The
move changes where the code lives, not one of them."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vdbench import encoders, spec, traffic, weights, work
from vdbench.drivers import RunArgs
from vdbench.run import driver
from vdbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mn_pins.json")) as _f:
    PINS = json.load(_f)
SEED = 2 ** 31 + 977
TRAIN = dict(tiny.TRAFFIC, kind="train")
EVAL = dict(tiny.TRAFFIC, kind="eval", dialogs=20)


def _config(name: str) -> dict:
    if name.startswith("tiny-"):
        return {"tiny-disc": tiny.CONFIG,
                "tiny-gen": dict(tiny.CONFIG, decoder="gen"),
                "tiny-disc-nodedup": dict(tiny.CONFIG,
                                          disc_dedup_options=False)}[name]
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.cpu().numpy() if torch.is_tensor(t) else t
        h.update(np.ascontiguousarray(t).tobytes())
    return h.hexdigest()


def _run(spec_path, cell):
    c = spec.load_cell(cell, spec_path)
    return c, driver(c).run(RunArgs(cell=c, seed=SEED, seconds=0.5,
                                    trace=False, device="cpu", t0=0.0,
                                    log=lambda m: None))


@pytest.mark.parametrize("name", list(PINS["shapes"]))
def test_mn_weight_layout_pinned(name):
    conf = _config(name)
    got = weights.shapes(conf, encoders.load(conf))
    assert [[p, list(s)] for p, s in got.items()] == PINS["shapes"][name]


@pytest.mark.parametrize("name", list(PINS["draws"]))
def test_mn_weights_batch_and_masks_pinned(name):
    conf = _config(name)
    fam = encoders.load(conf)
    arrays = traffic.make_split(TRAIN, conf, 5,
                                options=conf["decoder"] == "disc")
    got = {"weights": _digest(weights.make(conf, fam, 7, "cpu").values()),
           "encoder_batch": _digest(
               fam.encoder_batch(arrays, np.arange(3, 7), conf).values()),
           "encoder_masks": _digest(
               fam.encoder_masks(11, 16, conf, "cpu").values())}
    assert got == PINS["draws"][name]


@pytest.mark.parametrize("key", list(PINS["work"]))
def test_mn_work_pinned(key):
    name, what = key.split(".", 1)
    conf = _config(name)
    fam = encoders.load(conf)
    if what == "eval_pass":
        got = work.eval_pass(conf, fam, traffic.make_split(EVAL, conf, 5))
    else:
        arrays = traffic.make_split(TRAIN, conf, 5,
                                    options=conf["decoder"] == "disc")
        lo = int(what.rsplit(".", 1)[1])
        idx = np.arange(lo, lo + conf["batch_size"]) % TRAIN["dialogs"]
        got = work.train_step(conf, fam, arrays, idx)
    assert got.__dict__ == PINS["work"][key]


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", list(PINS["compared"]))
def test_mn_compared_numbers_pinned(spec_path, cell):
    _, res = _run(spec_path, cell)
    assert res["correct"]
    assert {k: v for k, (v, _) in res["compared"].items()} == PINS["compared"][cell]


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("cell", ["tiny-disc.train", "tiny-disc.eval"])
def test_the_family_file_alone_decides(tmp_path, cell, planted):
    """The tiny spec's own copy of mn.py is the encoder its cells run: as
    copied they are correct; with the copy's attention over every fact
    slot, later rounds' included, they are not.  (The fusion's tanh left
    out would not do: at the start weights its input is near 0, where tanh
    is near the identity, and the gaps stay within the limits.)"""
    path = tiny.write(str(tmp_path))
    mn = tmp_path / "vdbench" / "encoders" / "mn.py"
    if planted:
        src = mn.read_text()
        causal = "scores = torch.where(slot[None, :] <= slot[:, None], scores, NEG)"
        assert src.count(causal) == 1
        mn.write_text(src.replace(causal, "pass"))
    c, res = _run(path, cell)
    assert c.family.__file__ == str(mn)
    assert res["correct"] is not planted, res["compared"]


def test_an_encoder_without_a_family_module_fails_at_set_up(tmp_path):
    """With the tiny spec's own copy of its family module taken away, a
    cell fails before any work, naming the file it looked for."""
    path = tiny.write(str(tmp_path))
    mn = tmp_path / "vdbench" / "encoders" / "mn.py"
    mn.unlink()
    r = subprocess.run(
        [sys.executable, "-m", "vdbench.run", "--workload", "tiny-disc.train",
         "--seed", "5", "--seconds", "0.5", "--trace", "0", "--spec", path,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert str(mn) in r.stderr
    assert "[vdbench]" not in r.stderr        # no progress: no work began
