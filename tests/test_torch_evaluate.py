"""The port's v1.0 evaluation surface (visdial_tpu_torch/utils/metrics.py,
eval_harness.py's collect_rankings, evaluate.py) against the JAX package:
candidate rankings and NDCG on random inputs with ties, the rankings dump's
round_scoreable gate, and the evaluate CLI against the JAX CLI on one
JAX-written checkpoint and --synthetic split for both decoders (the JSON
line but for its timing keys, the --save_ranks file and the --dense_json
NDCG)."""

import json

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.eval_harness import evaluate_split as jax_evaluate_split
from visdial_tpu.evaluate import main as jax_evaluate_main
from visdial_tpu.evaluate import ndcg_from_dense as jax_ndcg_from_dense
from visdial_tpu.parallel.mesh import make_mesh
from visdial_tpu.parallel.train_step import init_train_state
from visdial_tpu.utils.checkpoint import _tree_to_dict, save_checkpoint
from visdial_tpu.utils.metrics import candidate_rankings as jax_candidate_rankings
from visdial_tpu.utils.metrics import ndcg_scores as jax_ndcg_scores
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.evaluate import main, ndcg_from_dense
from visdial_tpu_torch.utils.metrics import candidate_rankings, ndcg_scores
from visdial_tpu_torch.utils.params import params_from_numpy

from conftest import small_config

torch.set_num_threads(1)

TIMING_KEYS = {"evals_per_sec", "eval_seconds"}


@pytest.mark.parametrize("shape", [(7, 12), (3, 4, 100), (1, 1)])
def test_candidate_rankings_match_jax(shape):
    """Scores drawn from 5 values, so most rows hold ties: equal scores rank
    by candidate index, lower first, on both sides."""
    rng = np.random.default_rng(len(shape))
    scores = rng.integers(0, 5, shape).astype(np.float32) - 2.0
    got = candidate_rankings(torch.from_numpy(scores))
    want = np.asarray(jax_candidate_rankings(scores))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    K = shape[-1]
    assert (np.sort(got.numpy(), -1) == np.arange(1, K + 1)).all()


def test_ndcg_scores_match_jax():
    """Random permutations and dense relevance in {0, 0.5, 1} (ties), with
    a row without any relevant candidate (NDCG 0)."""
    rng = np.random.default_rng(0)
    N, K = 20, 100
    ranks = np.stack([rng.permutation(K) + 1 for _ in range(N)])
    rel = rng.integers(0, 3, (N, K)) / 2.0
    rel[3] = 0.0
    got = ndcg_scores(ranks, rel)
    want = jax_ndcg_scores(ranks, rel)
    assert got.dtype == np.float64 and got[3] == 0.0
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ndcg_scores(ranks[:, :5], rel)


def _checkpoint(tmp_path, decoder):
    """A JAX-written LF-QIH checkpoint, init scaled 8x (scores far apart)."""
    cfg = small_config(encoder="lf-ques-im-hist", decoder=decoder)
    _, vocab = make_synthetic_split(cfg, num_dialogs=4, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    state = init_train_state(cfg)
    state = state._replace(params=jax.tree.map(lambda p: p * 8, state.params))
    return save_checkpoint(str(tmp_path / decoder), state, cfg), cfg, state


def test_rankings_dump_is_gated_on_round_scoreable(tmp_path):
    """A round with options but no ground truth (round_valid 0,
    round_scoreable 1) is ranked into the dump but not into the metrics; a
    round that is neither is zeros.  cand_ranks equal the JAX harness's
    over 6 dialogs (the last batch padded)."""
    _, cfg, state = _checkpoint(tmp_path, "disc")
    split, vocab = make_synthetic_split(cfg, num_dialogs=6, seed=cfg.seed + 1)
    split.round_valid[0, -1] = 0
    split.round_valid[5, 1] = 0
    split.round_scoreable[5, 1] = 0
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    want_m, want = jax_evaluate_split(state.params, split, vocab, cfg, mesh,
                                      collect_rankings=True)
    params = params_from_numpy(_tree_to_dict(state.params), cfg, "cpu")
    got_m, ranks, got = evaluate_split(params, split, vocab, cfg, "cpu",
                                       return_ranks=True, collect_rankings=True)
    assert got.shape == (6, cfg.num_rounds, cfg.num_options)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[0, -1].any() and not got[5, 1].any()
    assert len(ranks) == got_m["num_examples"] == 6 * cfg.num_rounds - 2
    assert got_m["mrr"] == pytest.approx(want_m["mrr"], abs=1e-12)
    kept = split.round_valid.astype(bool)
    np.testing.assert_array_equal(
        ranks, np.take_along_axis(got, split.gt_ind[..., None], -1)[..., 0][kept])


def _json_line(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_evaluate_cli_matches_jax_cli(tmp_path, capsys, decoder):
    """Both CLIs on one checkpoint and --synthetic split (the JAX one
    streaming, as the port's does): equal JSON lines but for the timing
    keys, equal --save_ranks files, and with --dense_json (annotations
    written here: one round per image, an unknown image and a round_id out
    of range among them) the same NDCG keys."""
    path, cfg, _ = _checkpoint(tmp_path, decoder)
    args = ["--load_path", path, "--synthetic", "6", "--batch_size", "4"]
    jax_evaluate_main(args + ["--no-resident"])
    want = _json_line(capsys)
    main(args + ["--device", "cpu"])
    got = _json_line(capsys)
    assert TIMING_KEYS <= set(got)
    assert {k: v for k, v in got.items() if k not in TIMING_KEYS} == \
        {k: v for k, v in want.items() if k not in TIMING_KEYS}
    assert got["model"] == f"lf-ques-im-hist-{decoder}"
    assert got["num_examples"] == 6 * cfg.num_rounds

    rng = np.random.default_rng(1)
    dense = [{"image_id": i, "round_id": int(rng.integers(1, cfg.num_rounds + 1)),
              "gt_relevance": (rng.integers(0, 3, cfg.num_options) / 2).tolist()}
             for i in range(5)]
    dense += [{"image_id": 999, "round_id": 1,
               "gt_relevance": [1.0] * cfg.num_options},
              {"image_id": 5, "round_id": cfg.num_rounds + 1,
               "gt_relevance": [1.0] * cfg.num_options}]
    dense_path = tmp_path / "dense.json"
    dense_path.write_text(json.dumps(dense))
    files = {}
    for who, fn, extra in (("jax", jax_evaluate_main, ["--no-resident"]),
                           ("port", main, ["--device", "cpu"])):
        files[who] = tmp_path / f"ranks_{who}.json"
        fn(args + extra + ["--save_ranks", str(files[who]),
                           "--dense_json", str(dense_path)])
        files[who + "_line"] = _json_line(capsys)
    sub = json.loads(files["port"].read_text())
    assert sub == json.loads(files["jax"].read_text())
    assert len(sub) == 6 * cfg.num_rounds
    assert all(sorted(e["ranks"]) == list(range(1, cfg.num_options + 1))
               for e in sub)
    got, want = files["port_line"], files["jax_line"]
    for k in ("ndcg", "ndcg_rounds", "ndcg_missing", "mrr"):
        assert got[k] == want[k], k
    assert got["ndcg_rounds"] == 5 and got["ndcg_missing"] == 2


def test_ndcg_from_dense_matches_jax():
    rng = np.random.default_rng(2)
    cand = np.stack([np.stack([rng.permutation(8) + 1 for _ in range(3)])
                     for _ in range(4)])
    cand[2, 1] = 0                                  # a round not ranked
    entries = [{"image_id": 10 + i, "round_id": r,
                "gt_relevance": rng.integers(0, 3, 8) / 2}
               for i, r in enumerate([1, 3, 2, 0])]
    entries.append({"image_id": 77, "round_id": 1, "gt_relevance": [1] * 8})
    img_ids = np.arange(10, 14)
    assert ndcg_from_dense(cand, img_ids, entries) == \
        jax_ndcg_from_dense(cand, img_ids, entries)
    assert ndcg_from_dense(cand, img_ids, [])["ndcg_rounds"] == 0
