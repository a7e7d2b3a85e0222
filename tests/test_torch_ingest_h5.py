"""The port's reference-artifact ingestion (visdial_tpu_torch/data/
ingest_h5.py and load_split's reference-dir route) against the JAX
package's, on artifacts written in the reference's schema by
tests/test_ingest_h5.py::_write_reference_artifacts, with the same
parametrisation (ans_index as a 1-based position or option row; img_pos
Lua-based or absent): the split array for array and the vocabulary equal,
the CLI's npz arrays equal to the JAX CLI's, and with h5py missing a clear
ImportError that names the npz route."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from tests.conftest import small_config
from tests.test_ingest_h5 import _write_reference_artifacts
from visdial_tpu.data.ingest_h5 import load_reference_split as jax_load_reference
from visdial_tpu.data.ingest_h5 import main as jax_ingest_main
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu_torch.data import ingest_h5, prepro
from visdial_tpu_torch.data.dataset import load_split

MODES = [(a, i) for i in ("lua", "absent") for a in ("position1", "row1")]


@pytest.fixture(scope="module")
def source():
    split, vocab = make_synthetic_split(small_config(), num_dialogs=6, seed=3)
    return split, vocab


def _assert_same_split(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f.name
            continue
        assert np.asarray(g).dtype == np.asarray(w).dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.mark.parametrize("ans_index_mode,img_pos_mode", MODES)
def test_load_reference_split_matches_jax(source, tmp_path, ans_index_mode,
                                          img_pos_mode):
    split, vocab = source
    paths = _write_reference_artifacts(str(tmp_path), split, vocab,
                                       ans_index_mode=ans_index_mode,
                                       img_pos_mode=img_pos_mode)
    got, got_vocab = ingest_h5.load_reference_split(*paths, "train")
    want, want_vocab = jax_load_reference(*paths, "train")
    _assert_same_split(got, want)
    assert got_vocab.word2ind == want_vocab.word2ind
    # the port's load_split takes the reference-dir route (no npz there)
    routed, routed_vocab = load_split(str(tmp_path), "train")
    _assert_same_split(routed, want)
    assert routed_vocab.word2ind == want_vocab.word2ind


@pytest.mark.parametrize("ans_index_mode,img_pos_mode", MODES)
def test_ingest_cli_writes_the_jax_clis_arrays(source, tmp_path,
                                               ans_index_mode, img_pos_mode):
    split, vocab = source
    data_h5, params_json, img_h5 = _write_reference_artifacts(
        str(tmp_path), split, vocab, ans_index_mode=ans_index_mode,
        img_pos_mode=img_pos_mode)
    _write_reference_artifacts(str(tmp_path), split, vocab, "val",
                               ans_index_mode=ans_index_mode,
                               img_pos_mode=img_pos_mode, mode="a")
    argv = ["--data_h5", data_h5, "--params_json", params_json,
            "--img_h5", img_h5, "--splits", "train,val"]
    ingest_h5.main(argv + ["--out_dir", str(tmp_path / "port")])
    jax_ingest_main(argv + ["--out_dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        got, want = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".json"):
            assert json.loads(got.read_text()) == json.loads(want.read_text())
            continue
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert g[k].dtype == w[k].dtype, (name, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{name}:{k}")


def test_ingest_cli_refuses_to_overwrite_its_input(source, tmp_path):
    split, vocab = source
    data_h5, params_json, img_h5 = _write_reference_artifacts(
        str(tmp_path), split, vocab)
    with pytest.raises(SystemExit):
        ingest_h5.main(["--data_h5", data_h5, "--params_json", params_json,
                        "--img_h5", img_h5, "--out_dir", str(tmp_path),
                        "--splits", "train"])


def test_without_h5py_the_h5_route_says_so(source, tmp_path, monkeypatch):
    """Where h5py is not installed, reading reference artifacts (through
    load_split or the CLI) or an .h5 feature file raises an ImportError
    that names h5py and the npz route, not a bare ModuleNotFoundError."""
    split, vocab = source
    paths = _write_reference_artifacts(str(tmp_path), split, vocab)
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: load_split(str(tmp_path), "train"),
                 lambda: ingest_h5.load_reference_split(*paths, "train"),
                 lambda: prepro.load_img_feats(paths[2], "train")):
        with pytest.raises(ImportError, match="needs h5py") as err:
            call()
        assert "visdial_tpu_torch.data.prepro" in str(err.value)
        assert "npz" in str(err.value)
        assert type(err.value) is ImportError
