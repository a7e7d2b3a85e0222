"""The port's v0.9-scale rehearsal (visdial_tpu_torch/parity_rehearsal.py)
at a tiny scale on the CPU: its scale constants patched down to 16 train
and 8 val dialogs over 300 answers (the flagship shape caps kept), narrow
widths through --config_json, two steps a model through the unmodified
runbook in its own process; the log holds the JAX rehearsal's events
(scripts/parity_rehearsal.py) with each stage's wall clock, peak RSS and
sizes, and the projection covers both models (~1 min on one CPU)."""

import json

import numpy as np

from visdial_tpu_torch import parity_rehearsal


def test_rehearsal_runs_both_models_and_projects_the_budget(tmp_path,
                                                            monkeypatch, capsys):
    monkeypatch.setattr(parity_rehearsal, "V09_TRAIN_DIALOGS", 16)
    monkeypatch.setattr(parity_rehearsal, "V09_VAL_DIALOGS", 8)
    monkeypatch.setattr(parity_rehearsal, "V09_UNIQUE_ANSWERS", 300)
    dims = tmp_path / "dims.json"
    dims.write_text(json.dumps({
        "embed_size": 16, "rnn_hidden_size": 16, "img_embed_size": 16,
        "batch_size": 8, "dropout": 0.0, "log_every": 1, "eval_every": 1000,
        "save_every": 1000}))
    out = tmp_path / "log.json"
    projection = parity_rehearsal.main([
        "--work_dir", str(tmp_path / "w"), "--max_steps", "2",
        "--device", "cpu", "--config_json", str(dims), "--out", str(out)])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    log = json.loads(out.read_text())
    events = [e.get("event") for e in log]
    assert events[0] == "rehearsal_config" and log[0]["device"] == "cpu"
    assert events.count("generated") == 2
    assert all(e["npz_bytes"] > 0 and e["peak_rss_gb"] > 0
               for e in log if e.get("event") == "generated")
    assert events.count("train_start") == events.count("parity_result") == 2
    envelopes = [e for e in log if e.get("event") == "parity_run_envelope"]
    assert [e["model"] for e in envelopes] == ["lf-disc", "mn-gen"]
    assert all(e["wall_seconds"] > 0 and e["peak_rss_gb"] > 0
               and e["checkpoints_bytes"] > 0 for e in envelopes)
    assert log[-1] == projection and printed[-1]["event"] == "rehearsal_done"
    for key in ("lf-disc", "mn-gen"):
        p = projection[key]
        assert p["steps_per_epoch"] == 2 and p["total_steps"] == 30
        assert p["compute_dtype"] == "float32"
        assert np.isfinite(p["projected_total_hours"])
        assert p["measured_steps_per_sec"] > 0 and p["measured_eval_seconds_full_val"] > 0
