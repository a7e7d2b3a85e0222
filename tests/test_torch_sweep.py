"""The port's sweep CLI (visdial_tpu_torch/sweep.py) on the CPU: one disc
and one gen pair through the port's train CLI, the results table and the
sweep_done / sweep_complete events (tests/test_sweep_cli.py's checks)."""

import json

import torch

from visdial_tpu_torch.sweep import main as sweep_main

torch.set_num_threads(1)

EXTRA = ("--embed_size 8 --rnn_hidden_size 16 --img_feat_size 16 "
         "--max_ques_len 4 --max_ans_len 3 --max_cap_len 5 "
         "--num_rounds 3 --num_options 5 --batch_size 8 "
         "--dropout 0.0 --log_every 100 --eval_every 0")


def test_sweep_two_pairs_writes_results_table(tmp_path, capsys):
    out = str(tmp_path / "results.json")
    results = sweep_main([
        "--encoders", "lf-ques-im,mn-ques-hist", "--decoders", "disc,gen",
        "--synthetic", "16", "--max_steps", "2", "--device", "cpu",
        "--save_path", str(tmp_path / "ckpt"), "--out", out,
        "--extra", EXTRA,
    ])
    events = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith('{"event": "sweep')]
    with open(out) as f:
        table = json.load(f)
    names = {"lf-ques-im-disc", "lf-ques-im-gen", "mn-ques-hist-disc",
             "mn-ques-hist-gen"}
    assert set(table) == set(results) == names
    for v in table.values():
        assert {"mrr", "r@1", "r@5", "r@10", "mean_rank",
                "train_seconds"} <= set(v)
        assert 0.0 <= v["mrr"] <= 1.0 and 1.0 <= v["mean_rank"] <= 5.0
        assert v["num_examples"] == 8 * 3          # 8 val dialogs
        assert "resident_cache_seconds" in v       # the resident eval ran
    assert [e["model"] for e in events[:-1]] == [
        "lf-ques-im-disc", "lf-ques-im-gen", "mn-ques-hist-disc",
        "mn-ques-hist-gen"]
    assert events[-1] == {"event": "sweep_complete", "out": out, "models": 4}
