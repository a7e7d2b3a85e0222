"""The port's prepro CLI (visdial_tpu_torch/data/prepro.py) against the JAX
package's (visdial_tpu.data.prepro.main) on the same generated VisDial
JSON: every array of every visdial_data_<split>.npz equal (values and
dtypes; the arrays, not the zip bytes) and visdial_params.json equal, for
v0.9-style data, v1.0 val with short dialogs and unannotated rounds, a v1.0
test split with no gt_index, fc7 from npz and from h5, and the pool5 map
under --img_spatial.

The texts are single sentences, on which the port's nltk-free tokenizer
and the JAX one give the same tokens (ROADMAP.md §3; multi-sentence text
may split differently where nltk's punkt data is installed)."""

import json
import os

import h5py
import numpy as np
import pytest

from tests.test_prepro import K, R, make_visdial_json
from visdial_tpu.data.prepro import main as jax_prepro_main
from visdial_tpu_torch.data import prepro
from visdial_tpu_torch.data.dataset import load_split

ARGS = ["--min_count", "2", "--max_ques_len", "8", "--max_ans_len", "5",
        "--max_cap_len", "8", "--num_rounds", str(R), "--num_options", str(K)]


def _v10_val(path):
    """v1.0 val-style: dialog 0 has 2 rounds, dialog 1's round 1 has no
    candidate list, dialog 2's round 2 no answer."""
    with open(path) as f:
        raw = json.load(f)
    dialogs = raw["data"]["dialogs"]
    dialogs[0]["dialog"] = dialogs[0]["dialog"][:2]
    del dialogs[1]["dialog"][1]["answer_options"]
    del dialogs[1]["dialog"][1]["gt_index"]
    del dialogs[2]["dialog"][2]["answer"]
    del dialogs[2]["dialog"][2]["gt_index"]
    with open(path, "w") as f:
        json.dump(raw, f)


def _v10_test(path):
    """v1.0 test-style: dialog i asks 1 + i % R rounds, no round has an
    answer or a gt_index, and only the last asked round has candidates."""
    with open(path) as f:
        raw = json.load(f)
    for i, d in enumerate(raw["data"]["dialogs"]):
        d["dialog"] = d["dialog"][:1 + i % R]
        for r, turn in enumerate(d["dialog"]):
            del turn["answer"], turn["gt_index"]
            if r < len(d["dialog"]) - 1:
                del turn["answer_options"]
    raw["version"] = "1.0"
    with open(path, "w") as f:
        json.dump(raw, f)


def _write_feats(d, kind):
    """Feature flags for each split, written as `kind` (npz / h5 / pool5)."""
    rng = np.random.default_rng(7)
    flags = []
    for split, n in (("train", 12), ("val", 6)):
        if kind == "pool5":
            path = d / f"pool5_{split}.npz"
            np.savez(path, **{f"pool5_{split}": rng.random(
                (n, 2, 2, 3), dtype=np.float32)})
        elif kind == "h5":
            path = d / f"feats_{split}.h5"
            with h5py.File(path, "w") as h:
                h[f"images_{split}"] = rng.random((n, 16), dtype=np.float32)
        else:
            path = d / f"feats_{split}.npz"
            np.savez(path, **{f"images_{split}": rng.random(
                (n, 16), dtype=np.float32)})
        flags += [f"--img_feats_{split}", str(path)]
    return flags + (["--img_spatial"] if kind == "pool5" else [])


CASES = {
    "v09-npz-feats": dict(feats="npz"),
    "v10-val-short-dialogs": dict(val=_v10_val),
    "v10-test-no-gt": dict(test=_v10_test),
    "h5-feats": dict(feats="h5"),
    "img-spatial-pool5": dict(feats="pool5"),
}


def _assert_same_artifacts(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        got, want = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".json"):
            with open(got) as g, open(want) as w:
                assert json.load(g) == json.load(w), name
            continue
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files), name
            for k in w.files:
                assert g[k].dtype == w[k].dtype, (name, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")


@pytest.mark.parametrize("case", list(CASES))
def test_prepro_cli_writes_the_jax_clis_arrays(tmp_path, case):
    spec = CASES[case]
    make_visdial_json(tmp_path / "train.json", 12, 40, 30, seed=0)
    make_visdial_json(tmp_path / "val.json", 6, 40, 30, seed=1)
    if "val" in spec:
        spec["val"](tmp_path / "val.json")
    argv = ["--train_json", str(tmp_path / "train.json"),
            "--val_json", str(tmp_path / "val.json")] + ARGS
    if "test" in spec:
        make_visdial_json(tmp_path / "test.json", 5, 40, 30, seed=2)
        spec["test"](tmp_path / "test.json")
        argv += ["--test_json", str(tmp_path / "test.json")]
    if "feats" in spec:
        argv += _write_feats(tmp_path, spec["feats"])
    prepro.main(argv + ["--out_dir", str(tmp_path / "port")])
    jax_prepro_main(argv + ["--out_dir", str(tmp_path / "jax")])
    _assert_same_artifacts(str(tmp_path / "port"), str(tmp_path / "jax"))
    splits = ("train", "val", "test") if "test" in spec else ("train", "val")
    for split in splits:
        data, vocab = load_split(str(tmp_path / "port"), split)
        assert data.num_dialogs == {"train": 12, "val": 6, "test": 5}[split]
    if "test" in spec:
        test, _ = load_split(str(tmp_path / "port"), "test")
        assert not test.round_valid.any()
        np.testing.assert_array_equal(test.round_scoreable.sum(axis=1),
                                      np.ones(5, np.int32))


def test_gt_index_off_the_answer_raises_like_jax(tmp_path):
    make_visdial_json(tmp_path / "train.json", 4, 40, 30, seed=0)
    with open(tmp_path / "train.json") as f:
        raw = json.load(f)
    turn = raw["data"]["dialogs"][1]["dialog"][2]
    turn["gt_index"] = (turn["gt_index"] + 1) % K
    with open(tmp_path / "train.json", "w") as f:
        json.dump(raw, f)
    argv = ["--train_json", str(tmp_path / "train.json"),
            "--val_json", str(tmp_path / "train.json")] + ARGS
    for fn, out in ((prepro.main, "port"), (jax_prepro_main, "jax")):
        with pytest.raises(AssertionError,
                           match="dialog 1 round 2: gt_index does not point"):
            fn(argv + ["--out_dir", str(tmp_path / out)])
