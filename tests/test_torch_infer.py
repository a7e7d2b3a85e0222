"""The port's serving path (visdial_tpu_torch/infer.py) against the JAX
InferenceEngine on one JAX-written checkpoint, its JSON-lines CLI, its
nltk-free tokenizer, and that the port imports no JAX."""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.data.prepro import tokenize as shared_tokenize
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.infer import InferenceEngine as JaxEngine
from visdial_tpu.models.encoders import encoder_apply as jax_encoder_apply
from visdial_tpu.parallel.train_step import init_train_state
from visdial_tpu.utils.checkpoint import save_checkpoint
from visdial_tpu_torch.data.prepro import tokenize
from visdial_tpu_torch.infer import InferenceEngine, main

from conftest import small_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = [
    ("w002 w001 ?", "w003 w004", [("w001", "w002 w003")]),
    ("w010 w011 ?", "w012", []),
    ("w013 ?", "", [("w014 ?", "w015")] * 5),       # more turns than rounds
    ("is it sunny ?", "a park", [("is there a dog ?", "yes")]),
]


def _checkpoint(tmp_path, encoder="mn-ques-im-hist", decoder="disc"):
    """A JAX-written checkpoint.  The init weights are scaled up 8x so that
    the narrow test model's scores are far from zero (at init they are
    ~1e-7, where any absolute tolerance would hide a wrong answer)."""
    cfg = small_config(encoder=encoder, decoder=decoder)
    _, vocab = make_synthetic_split(cfg, num_dialogs=4, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    state = init_train_state(cfg)
    state = state._replace(params=jax.tree.map(lambda p: p * 8, state.params))
    return save_checkpoint(str(tmp_path / decoder), state, cfg)


@pytest.mark.parametrize("encoder", ["mn-ques-im-hist", "mn-ques-hist"])
def test_port_engine_answers_like_jax_engine(tmp_path, encoder):
    path = _checkpoint(tmp_path, encoder)
    want_eng = JaxEngine(path, synthetic=8)
    eng = InferenceEngine(path, synthetic=8, device="cpu")
    assert eng.impl == "plain" and tuple(eng.table.shape) == (
        len(want_eng.opt_list), eng.cfg.rnn_hidden_size)
    for question, caption, history in QUERIES:
        want = want_eng.rank_answers(question, caption, history, top_k=5)
        got = eng.rank_answers(question, caption, history, top_k=5)
        assert [a["answer"] for a in got] == [a["answer"] for a in want]
        np.testing.assert_allclose([a["score"] for a in got],
                                   [a["score"] for a in want],
                                   rtol=1e-4, atol=0)
        assert abs(got[0]["score"]) > 1e-2


def test_cli_json_lines(tmp_path, monkeypatch, capsys):
    path = _checkpoint(tmp_path)
    lines = [json.dumps({"question": "w010 w011 ?", "caption": "w012"}),
             json.dumps({"question": "w013 ?", "history": [["w014 ?", "w015"]]})]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    main(["--load_path", path, "--synthetic", "4", "--top_k", "3",
          "--device", "cpu"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out[0] == {"event": "ready", "model": "mn-ques-im-hist-disc"}
    assert len(out) == 3
    for reply in out[1:]:
        assert len(reply["answers"]) == 3
        scores = [a["score"] for a in reply["answers"]]
        assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_lf_checkpoints_serve_like_jax_engine(tmp_path, decoder):
    """An LF-QIH checkpoint (history read at each round's prefix bound, the
    image fused into the final concat) loads and serves: disc pool scores
    (every answer of the pool) within 1e-4 of the JAX engine's, gen answers
    and log-probs equal to its, greedy and beam 3."""
    path = _checkpoint(tmp_path, "lf-ques-im-hist", decoder)
    want_eng = JaxEngine(path, synthetic=8)
    eng = InferenceEngine(path, synthetic=8, device="cpu")
    assert eng.cfg.encoder == "lf-ques-im-hist" and eng.impl == "plain"
    for question, caption, history in QUERIES:
        if decoder == "disc":
            batch, t = want_eng._batch(caption, history, question, None)
            joint = jax_encoder_apply(want_eng.params["encoder"],
                                      want_eng.params["embed"], batch,
                                      want_eng.cfg, impl="xla")
            want = np.asarray(joint[t] @ want_eng._table.T)
            got = eng.pool_scores(question, caption, history).numpy()
            assert got.shape == want.shape and np.abs(want).max() > 1e-2
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
            top = eng.rank_answers(question, caption, history, top_k=3)
            assert [a["score"] for a in top] == sorted(got, reverse=True)[:3]
            continue
        for beam in (0, 3):
            want = want_eng.generate_answer(question, caption, history,
                                            beam_size=beam)
            got = eng.generate_answer(question, caption, history, beam_size=beam)
            assert got["answer"] == want["answer"]
            np.testing.assert_allclose(got["log_prob"], want["log_prob"],
                                       atol=1e-4)


def test_tokenizer_equals_shared_tokenizer():
    with open(os.path.join(ROOT, "tests", "golden", "token_fixture.json")) as f:
        texts = [t for t, _ in json.load(f)]
    texts += ["Yes. It is.", "no, not really...", 'a "quoted" word (maybe)',
              "Mr. Smith is here. ok?", "he said ‘hi’ -- then left",
              "cannot tell; 3:30 pm, $5", "it's 2,000 “feet”",
              "wanna go? gonna", "'tis fine", "d'ye see it ?"]
    for text in texts:
        assert tokenize(text) == shared_tokenize(text), text


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import visdial_tpu_torch, visdial_tpu_torch.infer\n"
            "import visdial_tpu_torch.ops.lstm_cuda, "
            "visdial_tpu_torch.ops.attention_cuda\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'visdial_tpu')"
            " or m.startswith(('jax.', 'visdial_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
