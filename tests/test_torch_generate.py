"""The port's generate CLI (visdial_tpu_torch/generate.py): the `vis/`
viewer's JSON contract in greedy, beam and sampled modes; greedy strings
and log-probs equal to the JAX generate CLI's on one checkpoint, written by
either package's train CLI; and a v1.0 test-style split, where no round
has a ground truth, keeps every round that has a question (the JAX CLI
keeps none: it gates on round_valid)."""

import json

import numpy as np
import pytest
import torch

from visdial_tpu import generate as jax_generate
from visdial_tpu.train import main as jax_train_main
from visdial_tpu_torch import generate
from visdial_tpu_torch.train import main as train_main

torch.set_num_threads(1)

ARGS = [
    "--synthetic", "8", "--encoder", "lf-ques-im", "--decoder", "gen",
    "--embed_size", "8", "--rnn_hidden_size", "16", "--img_feat_size", "16",
    "--max_ques_len", "4", "--max_ans_len", "3", "--max_cap_len", "5",
    "--num_rounds", "3", "--num_options", "5", "--batch_size", "8",
    "--dropout", "0.0", "--lr_decay_rate", "1.0", "--log_every", "100",
    "--eval_every", "0", "--learning_rate", "0.05",
]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A gen checkpoint from each package's train CLI (4 steps)."""
    root = str(tmp_path_factory.mktemp("gen"))
    extra = ["--max_steps", "4", "--save_every", "4", "--save_path", root]
    train_main(ARGS + extra + ["--run_name", "port", "--device", "cpu"])
    jax_train_main(ARGS + extra + ["--run_name", "jax"])
    return {who: f"{root}/{who}/step_00000004" for who in ("port", "jax")}


def _run(fn, path, out, extra=()):
    fn(["--load_path", path, "--synthetic", "8", "--out_path", str(out),
        *extra])
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", [[], ["--beam_size", "2"],
                                  ["--sample", "--temperature", "0.7"]],
                         ids=["greedy", "beam", "sample"])
def test_generate_cli_emits_viewer_contract(checkpoints, tmp_path, mode):
    data = _run(generate.main, checkpoints["port"], tmp_path / "g.json",
                ["--num_dialogs", "3", "--batch_size", "2", "--device", "cpu",
                 *mode])
    assert data["model"] == "lf-ques-im-gen" and data["split"] == "val"
    assert len(data["dialogs"]) == 3
    for d in data["dialogs"]:
        assert set(d) == {"image_id", "caption", "rounds"}
        assert isinstance(d["image_id"], int) and isinstance(d["caption"], str)
        assert len(d["rounds"]) == 3
        for r in d["rounds"]:
            assert set(r) == {"question", "gt_answer", "generated", "log_prob"}
            assert all(isinstance(r[k], str)
                       for k in ("question", "gt_answer", "generated"))
            assert isinstance(r["log_prob"], float) and r["log_prob"] <= 0.0


def test_sampling_follows_the_seed(checkpoints, tmp_path):
    runs = [_run(generate.main, checkpoints["port"], tmp_path / f"s{i}.json",
                 ["--num_dialogs", "8", "--sample", "--temperature", "2.0",
                  "--seed", str(seed), "--device", "cpu"])
            for i, seed in enumerate((1, 1, 2))]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_greedy_strings_match_jax_cli(checkpoints, tmp_path, writer):
    """Checkpoints cross both ways: each package decodes the other's."""
    path = checkpoints[writer]
    got = _run(generate.main, path, tmp_path / "port.json",
               ["--num_dialogs", "0", "--device", "cpu"])
    want = _run(jax_generate.main, path, tmp_path / "jax.json",
                ["--num_dialogs", "0"])
    assert got["model"] == want["model"]
    assert len(got["dialogs"]) == len(want["dialogs"]) == 8
    for g, w in zip(got["dialogs"], want["dialogs"]):
        assert (g["image_id"], g["caption"]) == (w["image_id"], w["caption"])
        assert len(g["rounds"]) == len(w["rounds"]) == 3
        for gr, wr in zip(g["rounds"], w["rounds"]):
            for k in ("question", "gt_answer", "generated"):
                assert gr[k] == wr[k], k
            assert gr["log_prob"] == pytest.approx(wr["log_prob"], abs=1e-5)


def test_test_style_split_keeps_its_question_rounds(checkpoints, tmp_path,
                                                    monkeypatch):
    """v1.0 test-style dialogs: dialog i has 1 + i % 3 rounds with a
    question, no round has a ground truth (round_valid 0), the last asked
    round has a full candidate list, the rest are padding.  The port keeps
    exactly the asked rounds; the JAX CLI keeps no round at all."""
    asked = {}

    def test_style(make):
        def wrapper(cfg, *a, **kw):
            split, vocab = make(cfg, *a, **kw)
            split.round_valid[:] = 0
            split.round_scoreable[:] = 0
            for i in range(split.num_dialogs):
                k = 1 + i % 3
                asked[int(split.img_ids[i])] = k
                split.ques[i, k:] = 0
                split.ques_len[i, k:] = 0
                split.round_scoreable[i, k - 1] = 1
            return split, vocab
        return wrapper

    monkeypatch.setattr(generate, "make_synthetic_split",
                        test_style(generate.make_synthetic_split))
    monkeypatch.setattr(jax_generate, "make_synthetic_split",
                        test_style(jax_generate.make_synthetic_split))
    got = _run(generate.main, checkpoints["port"], tmp_path / "port.json",
               ["--num_dialogs", "0", "--device", "cpu"])
    assert len(got["dialogs"]) == 8
    for d in got["dialogs"]:
        assert len(d["rounds"]) == asked[d["image_id"]]
        assert all(r["question"] for r in d["rounds"])
    want = _run(jax_generate.main, checkpoints["port"], tmp_path / "jax.json",
                ["--num_dialogs", "0"])
    assert all(d["rounds"] == [] for d in want["dialogs"])
    assert np.mean([len(d["rounds"]) for d in got["dialogs"]]) > 1


def test_generate_refuses_a_disc_checkpoint(tmp_path):
    root = str(tmp_path)
    disc = [a if a != "gen" else "disc" for a in ARGS]
    train_main(disc + ["--max_steps", "1", "--save_every", "1",
                       "--save_path", root, "--run_name", "d",
                       "--device", "cpu"])
    with pytest.raises(SystemExit, match="gen decoder"):
        generate.main(["--load_path", f"{root}/d/step_00000001",
                       "--synthetic", "8", "--device", "cpu",
                       "--out_path", str(tmp_path / "x.json")])
