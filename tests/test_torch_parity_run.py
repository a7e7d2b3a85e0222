"""The port's parity runbook (visdial_tpu_torch/parity_run.py): its feature
check against the JAX runbook's (scripts/parity_run.py::check_img_features)
on good, gaussian and broken features -- the same report, printed line and
verdict; and a rehearsal of the whole composition on the CPU (reference h5
artifacts -> ingest -> feature check -> both acceptance models trained,
checkpointed and re-evaluated through the port's CLIs -> summary), small
enough to run unmarked (~4 s on one CPU thread)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.conftest import small_config
from tests.test_ingest_h5 import _write_reference_artifacts
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu_torch import parity_run

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
torch.set_num_threads(1)


class _Split:
    def __init__(self, feats):
        self.img_feat = feats


def _features(kind):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((20, 64)).astype(np.float32)
    if kind == "fc7":              # post-ReLU and sparse
        return np.maximum(f - 0.5, 0.0)
    if kind == "l2":               # non-negative unit rows
        return np.abs(f) / np.linalg.norm(f, axis=1, keepdims=True)
    if kind == "nan":
        f[3, 5] = np.nan
    elif kind == "zero_row":
        f[7] = 0.0
    elif kind == "constant":
        f[:] = 0.25
    return f


@pytest.mark.parametrize("kind", ["fc7", "l2", "gaussian", "nan", "zero_row",
                                  "constant"])
def test_feature_check_matches_the_jax_runbook(kind, capsys):
    from parity_run import check_img_features as jax_check

    feats = _features(kind)
    got = parity_run.check_img_features(_Split(feats), "train", strict=False)
    got_out = capsys.readouterr().out
    want = jax_check(_Split(feats), "train", strict=False)
    want_out = capsys.readouterr().out
    # as JSON, where NaN equals NaN
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got_out == want_out
    assert got["ok"] == (kind in ("fc7", "l2", "gaussian"))
    assert bool(got["warnings"]) == (kind not in ("fc7", "l2"))
    if not got["ok"]:
        for fn in (parity_run.check_img_features, jax_check):
            with pytest.raises(SystemExit, match="image feature check failed"):
                fn(_Split(feats), "train", strict=True)


def _artifacts(root, cfg, nan=False):
    train, vocab = make_synthetic_split(cfg, num_dialogs=32, seed=0)
    val, _ = make_synthetic_split(cfg, num_dialogs=8, vocab=vocab, seed=1)
    if nan:
        train.img_feat[0, 0] = np.nan
    data_dir = os.path.join(root, "artifacts")
    os.makedirs(data_dir)
    _write_reference_artifacts(data_dir, train, vocab, "train")
    _write_reference_artifacts(data_dir, val, vocab, "val", mode="a")
    return data_dir


def _dims(cfg, path):
    dims = {f: getattr(cfg, f) for f in (
        "embed_size", "rnn_hidden_size", "img_feat_size", "img_embed_size",
        "max_ques_len", "max_ans_len", "max_cap_len", "num_rounds",
        "num_options")}
    dims.update(batch_size=8, dropout=0.0, learning_rate=0.01,
                lr_decay_rate=1.0, eval_every=30, save_every=30, log_every=30)
    with open(path, "w") as f:
        json.dump(dims, f)
    return path


def test_parity_runbook_rehearsal_on_the_cpu(tmp_path, capsys):
    """Reference h5 artifacts through the runbook with --device cpu: both
    models train, checkpoint and re-evaluate through the evaluate CLI; the
    stream ends in parity_summary with finite MRRs, LF-disc above chance
    (1/12 options: a random ranking's MRR is ~0.26)."""
    cfg = small_config()
    data_dir = _artifacts(str(tmp_path), cfg)
    summary = parity_run.main([
        "--data_dir", data_dir, "--work_dir", str(tmp_path / "runs"),
        "--config_json", _dims(cfg, str(tmp_path / "dims.json")),
        "--max_steps", "30", "--steps_per_dispatch", "1", "--no-check",
        "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    events = [x.get("event") for x in lines]
    assert events[-1] == "parity_summary" and lines[-1] == summary
    assert events.count("ingested") == events.count("img_feature_check") == 2
    assert all(x["ok"] for x in lines if x.get("event") == "img_feature_check")
    assert events.count("train_start") == events.count("parity_result") == 2
    for key in ("lf-disc", "mn-gen"):
        mrr = summary[f"{key}_mrr"]
        assert np.isfinite(mrr) and 0.0 < mrr <= 1.0
        assert summary[f"{key}_delta"] == pytest.approx(
            mrr - parity_run.TARGETS[key])
        ckpt_root = tmp_path / "runs" / f"parity-{key}"
        assert "step_00000030" in os.listdir(ckpt_root)
    assert summary["lf-disc_mrr"] > 0.30
    assert summary["all_pass"] is False


def test_parity_runbook_stops_before_training(tmp_path):
    """A NaN in data_img.h5 aborts before any training under --check, and
    an unknown --models entry before any work at all."""
    cfg = small_config()
    data_dir = _artifacts(str(tmp_path), cfg, nan=True)
    with pytest.raises(SystemExit, match="unknown --models entries"):
        parity_run.main(["--data_dir", data_dir, "--models", "lf-disc,bogus",
                         "--device", "cpu"])
    with pytest.raises(SystemExit, match="image feature check failed"):
        parity_run.main(["--data_dir", data_dir,
                         "--work_dir", str(tmp_path / "runs"),
                         "--max_steps", "4", "--device", "cpu"])
    assert not (tmp_path / "runs").exists()
