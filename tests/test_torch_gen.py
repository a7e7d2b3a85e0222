"""The port's gen path (visdial_tpu_torch/models/decoders.py gen half,
model.py, eval_harness.py, infer.py, train.py) against the JAX package on
the CPU, f32, dropout 0: with the MN encoders the loss and every parameter
gradient, the forwardConnect gradient into the joint embedding, candidate
scores on the sorted and unsorted paths, bucketed against direct
evaluation, greedy and beam decoding, the serving engine on one
checkpoint; with every encoder the golden fixture; and a tiny train CLI run
with resume.

impl='cuda' on CPU tensors runs the kernel path's control flow (length sort
and its inverse, LSTMLayerFn with K2's dh0, TokenLogprobFn) with each
kernel's plain version."""

import contextlib
import io
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.config import Config
from visdial_tpu.data.loader import BatchAssembler, EvalLoader, TrainLoader
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.infer import InferenceEngine as JaxEngine
from visdial_tpu.models import decoders as jax_decoders
from visdial_tpu.models import model as jax_model
from visdial_tpu.parallel.train_step import init_train_state as jax_init_state
from visdial_tpu.parallel.train_step import train_step as jax_train_step
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from visdial_tpu.utils.metrics import ranks_from_scores
from visdial_tpu_torch import config as torch_config
from visdial_tpu_torch import train as torch_train
from visdial_tpu_torch.data.loader import TrainLoader as TorchTrainLoader
from visdial_tpu_torch.data.synthetic import \
    make_synthetic_split as torch_synthetic_split
from visdial_tpu_torch.eval_harness import _GenBucketPlan, evaluate_split
from visdial_tpu_torch.infer import InferenceEngine, main
from visdial_tpu_torch.models import decoders
from visdial_tpu_torch.models.encoders import encoder_apply
from visdial_tpu_torch.models.model import (batch_to_device, model_generate,
                                            model_loss, model_scores)
from visdial_tpu_torch.parallel.optim import init_opt_state
from visdial_tpu_torch.parallel.train_step import (TrainState, gen_rows_score,
                                                   init_train_state,
                                                   loss_and_grads, train_step)
from visdial_tpu_torch.utils.params import flatten, params_from_numpy

from conftest import small_config
from test_golden import FIXTURE, GOLDEN_PATH, NUM_DIALOGS, TRAIN_STEPS

torch.set_num_threads(1)

ENCODERS = ["mn-ques-im-hist", "mn-ques-hist", "lf-ques", "lf-ques-hist",
            "lf-ques-im", "lf-ques-im-hist", "hre-ques-hist",
            "hre-ques-im-hist", "hrea-ques-im-hist"]
# the decoder's own checks run on the MN pair; every family's encoder is
# held to JAX in tests/test_torch_encoders.py, LF's gen serving in
# tests/test_torch_infer.py
SETUP_ENCODERS = ENCODERS[:2]
ATOL = 1e-4


@pytest.fixture(scope="module", params=SETUP_ENCODERS)
def setup(request):
    """JAX init scaled 4x (gradients and scores far from zero), the port's
    params from it, and a train batch with one answerless round."""
    cfg = small_config(encoder=request.param, decoder="gen")
    split, vocab = make_synthetic_split(cfg, num_dialogs=6, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * 4,
                           jax_model.model_init(jax.random.PRNGKey(1), cfg))
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    batch = BatchAssembler(split, vocab, cfg).assemble(
        np.arange(3), with_gen_options=True).as_dict()
    batch["ans_in"] = batch["ans_in"].copy()
    batch["ans_in"][1, 2, 1:] = 0                 # a round without an answer
    return cfg, split, vocab, jparams, params, batch


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_gen_loss_and_every_grad_match_jax(setup, impl):
    """gen loss within 1e-5 and every parameter gradient within 1e-4 of the
    leaf's largest, against jax.grad of the JAX model_loss (impl='xla')."""
    cfg, _, _, jparams, params, batch = setup
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_model.model_loss(p, batch, cfg, train=True, impl="xla"))(
        jparams)
    loss, grads = loss_and_grads(params, batch_to_device(batch, "cpu"), cfg,
                                 gen=None, impl=impl)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    want = _tree_to_dict(jgrads)
    got = {k: v.numpy() for k, v in flatten(grads).items()}
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=max(1e-4 * scale, 1e-7),
                                   err_msg=k)


def test_lm_hidden_joint_gradient(setup):
    """forwardConnect: h0 = joint feeds every LM layer, so the gradient of
    the LM states flows into joint through LSTMLayerFn's dh0 (K2's plain
    version here); held against autograd through the plain LSTM and against
    jax.grad of the JAX _lm_hidden."""
    cfg, _, _, jparams, params, batch = setup
    N = 3 * cfg.num_rounds
    rng = np.random.default_rng(5)
    joint = rng.standard_normal((N, cfg.rnn_hidden_size)).astype(np.float32)
    tokens = batch["ans_in"].reshape(N, -1)
    cot = rng.standard_normal(tokens.shape + (cfg.rnn_hidden_size,)).astype(
        np.float32)

    def jax_fn(j):
        outs = jax_decoders._lm_hidden(jparams["decoder"], jparams["embed"], j,
                                       jnp.asarray(tokens), cfg, impl="xla")
        return jnp.sum(outs * cot)

    want = np.asarray(jax.grad(jax_fn)(jnp.asarray(joint)))
    got = {}
    for impl in ("cuda", "plain"):
        j = torch.from_numpy(joint).requires_grad_()
        outs = decoders._lm_hidden(params["decoder"], params["embed"], j,
                                   torch.from_numpy(tokens).long(), cfg, impl=impl)
        (g,) = torch.autograd.grad((outs * torch.from_numpy(cot)).sum(), j)
        got[impl] = g.numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got["cuda"], got["plain"], atol=1e-5)
    np.testing.assert_allclose(got["cuda"], want, atol=1e-5)


def _rows_case(cfg, rows, seed=0):
    """Candidate <START>/<END> rows of random lengths (some empty)."""
    rng = np.random.default_rng(seed)
    La = cfg.max_ans_len
    tok = rng.integers(1, cfg.vocab_size - 3, (rows, La))
    lens = rng.integers(0, La + 1, rows)
    tok = np.where(np.arange(La) < lens[:, None], tok, 0)
    start, end = cfg.vocab_size - 2, cfg.vocab_size - 1
    tin = np.concatenate([np.full((rows, 1), start), tok], 1)
    tout = np.where(np.arange(La + 1) == lens[:, None], end,
                    np.concatenate([tok, np.zeros((rows, 1), int)], 1))
    joint = rng.standard_normal((rows, cfg.rnn_hidden_size)).astype(np.float32)
    return joint, tin.astype(np.int32), tout.astype(np.int32)


@pytest.mark.parametrize("rows", [decoders.LENGTH_SORT_MIN_ROWS + 37, 50],
                         ids=["sorted", "unsorted"])
def test_gen_score_rows_match_jax(setup, rows):
    """Summed token log-probs per row: the kernel path (length-sorted at
    >= LENGTH_SORT_MIN_ROWS rows, scores inverse-permuted) and the chunked
    plain path against the JAX gen_score_rows, atol 1e-4."""
    cfg, _, _, jparams, params, _ = setup
    joint, tin, tout = _rows_case(cfg, rows)
    want = np.asarray(jax_decoders.gen_score_rows(
        jparams["decoder"], jparams["embed"], jnp.asarray(joint),
        jnp.asarray(tin), jnp.asarray(tout), cfg, impl="xla"))
    args = (params["decoder"], params["embed"], torch.from_numpy(joint),
            torch.from_numpy(tin).long(), torch.from_numpy(tout).long(), cfg)
    got_k = decoders.gen_score_rows(*args, impl="cuda")
    got_p = decoders.gen_score_rows(*args, impl="plain")
    assert got_k.shape == (rows,) and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got_k.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got_p.numpy(), want, atol=ATOL)
    normed = decoders.gen_score_rows(*args[:-1], cfg.replace(
        gen_score_length_norm=True), impl="cuda")
    want_n = np.asarray(jax_decoders.gen_score_rows(
        jparams["decoder"], jparams["embed"], jnp.asarray(joint),
        jnp.asarray(tin), jnp.asarray(tout),
        cfg.replace(gen_score_length_norm=True), impl="xla"))
    np.testing.assert_allclose(normed.numpy(), want_n, atol=ATOL)


def test_plain_scoring_chunks_rows(setup, monkeypatch):
    """The plain path scores SCORE_CHUNK_ROWS rows per projection; a chunk
    size that does not divide the rows gives the same scores."""
    cfg, _, _, _, params, _ = setup
    joint, tin, tout = _rows_case(cfg, 29, seed=1)
    args = (params["decoder"], params["embed"], torch.from_numpy(joint),
            torch.from_numpy(tin).long(), torch.from_numpy(tout).long(), cfg)
    whole = decoders.gen_score_rows(*args)
    monkeypatch.setattr(decoders, "SCORE_CHUNK_ROWS", 8)
    torch.testing.assert_close(decoders.gen_score_rows(*args), whole,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_model_scores_match_jax(setup, impl):
    cfg, _, _, jparams, params, batch = setup
    want = np.asarray(jax_model.model_scores(jparams, batch, cfg, impl="xla"))
    got = model_scores(params, batch_to_device(batch, "cpu"), cfg, impl=impl)
    assert got.shape == want.shape == (3, cfg.num_rounds, cfg.num_options)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_gen_rows_score_builds_candidate_rows_like_the_loader(setup):
    """gen_rows_score's on-device <START>/<END> rows at full width score as
    the loader's opt_in / opt_out rows do (gen_candidate_scores)."""
    cfg, split, vocab, _, params, batch = setup
    d = batch_to_device(batch, "cpu")
    joint = encoder_apply(params["encoder"], params["embed"], d, cfg)
    K, N = cfg.num_options, joint.shape[0]
    want = decoders.gen_candidate_scores(
        params["decoder"], params["embed"], joint,
        d["opt_in"].reshape(N, K, -1), d["opt_out"].reshape(N, K, -1), cfg)
    got = gen_rows_score(params, joint, torch.from_numpy(split.opt_list).long(),
                         torch.from_numpy(split.opt_list_len).long(),
                         d["opt_inds"].reshape(-1),
                         torch.arange(N).repeat_interleave(K),
                         cfg.max_ans_len + 1, vocab.start, vocab.end, cfg)
    np.testing.assert_allclose(got.reshape(N, K).numpy(), want.numpy(),
                               atol=1e-5)


def test_bucket_plan_matches_jax(setup):
    from visdial_tpu.eval_harness import _GenBucketPlan as JaxPlan

    _, split, _, _, _, _ = setup
    for bs in (2, 4):
        got, want = _GenBucketPlan(split, bs), JaxPlan(split, bs)
        assert (got.widths, got.caps) == (want.widths, want.caps)
        lens = split.opt_list_len[split.opt_inds[:bs]]
        for a, b in zip(got.assign(lens), want.assign(lens)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_bucketed_eval_equals_direct_eval(setup, impl):
    """evaluate_split's width-bucketed gen path and its direct path rank
    every round alike; both agree with ranks from the JAX scores."""
    cfg, split, vocab, jparams, params, _ = setup
    out, got_ranks = {}, {}
    for bucketed in (True, False):
        out[bucketed], got_ranks[bucketed] = evaluate_split(
            params, split, vocab, cfg.replace(gen_eval_bucketed=bucketed),
            "cpu", batch_size=4, impl=impl, return_ranks=True)
    np.testing.assert_array_equal(got_ranks[True], got_ranks[False])
    for k in ("mrr", "r@1", "r@5", "r@10", "mean_rank"):
        assert out[True][k] == pytest.approx(out[False][k], abs=1e-9), k
    ranks = []
    for b in EvalLoader(split, vocab, cfg, batch_size=4):
        d = b.as_dict()
        s = np.asarray(jax_model.model_scores(jparams, d, cfg, impl="xla"))
        r = np.asarray(ranks_from_scores(s, d["gt_ind"]))
        ranks.append(r[b.dialog_valid.astype(bool)[:, None]
                       & b.round_valid.astype(bool)])
    ranks = np.concatenate(ranks)
    np.testing.assert_array_equal(got_ranks[True], ranks)
    assert out[True]["mrr"] == pytest.approx(float(np.mean(1.0 / ranks)),
                                             abs=1e-6)
    assert out[True]["evals_per_sec"] > 0


@pytest.mark.parametrize("beam_size", [0, 3])
def test_generate_matches_jax(setup, beam_size):
    """Greedy and beam tokens equal JAX model_generate's, log-probs within
    1e-4 (the shapes were checked to have no score ties)."""
    cfg, split, vocab, jparams, params, batch = setup
    start, end = vocab.start, vocab.end
    wt, wl = jax_model.model_generate(jparams, batch, cfg, start_token=start,
                                      end_token=end, beam_size=beam_size)
    for impl in ("plain", "cuda"):
        toks, logp = model_generate(params, batch_to_device(batch, "cpu"), cfg,
                                    start_token=start, end_token=end,
                                    beam_size=beam_size, impl=impl)
        assert toks.shape == (3, cfg.num_rounds, cfg.max_ans_len)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(wt))
        np.testing.assert_allclose(logp.numpy(), np.asarray(wl), atol=ATOL)
    assert (np.asarray(wt) != 0).any()


def test_sampling_draws_from_the_generator(setup):
    cfg, _, vocab, _, params, batch = setup
    d = batch_to_device(batch, "cpu")
    start, end = vocab.start, vocab.end

    def sample(seed):
        return model_generate(params, d, cfg, start_token=start, end_token=end,
                              greedy=False, gen=torch.Generator().manual_seed(seed),
                              temperature=1.5)

    a, b, c = sample(0), sample(0), sample(1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="Generator"):
        model_generate(params, d, cfg, start_token=start, end_token=end,
                       greedy=False)


@pytest.mark.parametrize("encoder", SETUP_ENCODERS)
def test_generate_answer_matches_jax_engine(tmp_path, encoder):
    """One JAX-written gen checkpoint (init scaled 8x): the port's engine
    decodes the same answers with the same log-probs as the JAX engine,
    greedy and beam 3, and its CLI prints them."""
    cfg = small_config(encoder=encoder, decoder="gen")
    _, vocab = make_synthetic_split(cfg, num_dialogs=4, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    state = jax_init_state(cfg)
    state = state._replace(params=jax.tree.map(lambda p: p * 8, state.params))
    path = jax_save_checkpoint(str(tmp_path / "gen"), state, cfg)
    want_eng = JaxEngine(path, synthetic=8)
    eng = InferenceEngine(path, synthetic=8, device="cpu")
    assert eng.table is None
    queries = [("w002 w001 ?", "w003 w004", [("w001", "w002 w003")]),
               ("w013 ?", "", [("w014 ?", "w015")] * 5)]
    for beam in (0, 3):
        for q, cap, hist in queries:
            want = want_eng.generate_answer(q, cap, hist, beam_size=beam)
            got = eng.generate_answer(q, cap, hist, beam_size=beam)
            assert got["answer"] == want["answer"]
            np.testing.assert_allclose(got["log_prob"], want["log_prob"],
                                       atol=ATOL)
    with pytest.raises(ValueError, match="disc"):
        eng.rank_answers("w002 ?")
    stdin = io.StringIO(json.dumps({"question": "w002 w001 ?"}) + "\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.stdin", stdin)
        main(["--load_path", path, "--synthetic", "8", "--beam_size", "3",
              "--device", "cpu"])
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert lines[0] == {"event": "ready", "model": f"{encoder}-gen"}
    want = want_eng.generate_answer("w002 w001 ?", beam_size=3)
    assert lines[1]["answer"] == want["answer"]


@pytest.fixture(scope="module", params=ENCODERS)
def golden_run(request):
    """The golden fixture's JAX gen run (as test_golden.py builds it)."""
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    cfg = Config(**{**FIXTURE, "encoder": request.param, "decoder": "gen"})
    split, vocab = make_synthetic_split(cfg, num_dialogs=NUM_DIALOGS, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    state = jax_init_state(cfg)
    init = _tree_to_dict(state.params)
    loader = TrainLoader(split, vocab, cfg)
    batches = [b.as_dict() for epoch in range(TRAIN_STEPS)
               for b in loader.epoch(seed=epoch)][:TRAIN_STEPS]
    step_fn = jax.jit(partial(jax_train_step, cfg=cfg, impl="xla"))
    for b in batches:
        state, _ = step_fn(state, b)
    eval_batch = next(iter(EvalLoader(split, vocab, cfg))).as_dict()
    return cfg, init, batches, _tree_to_dict(state.params), eval_batch


def test_golden_gen_losses_scores_and_ranks(golden_run):
    """golden_v1.npz's gen loss0 (eval-mode loss at init) and loss5 from the
    port's own five train steps from the JAX init, and the scores and ranks
    of the fixture's eval batch with the JAX-trained params, at the
    fixture's tolerance (atol = rtol = 1e-5)."""
    cfg, init, batches, jfinal, eval_batch = golden_run
    golden = np.load(GOLDEN_PATH)
    key = f"{cfg.encoder}|gen"
    params = params_from_numpy(init, cfg, "cpu")
    loss0 = model_loss(params, batch_to_device(eval_batch, "cpu"), cfg,
                       train=False)
    np.testing.assert_allclose(float(loss0), golden[f"{key}|loss0"],
                               atol=1e-5, rtol=1e-5)
    state = TrainState(params, init_opt_state(params, cfg),
                       torch.Generator().manual_seed(0))
    for b in batches:
        state, m = train_step(state, batch_to_device(b, "cpu"), cfg)
    np.testing.assert_allclose(float(m["loss"]), golden[f"{key}|loss5"],
                               atol=1e-5, rtol=1e-5)
    scores = model_scores(params_from_numpy(jfinal, cfg, "cpu"),
                          batch_to_device(eval_batch, "cpu"), cfg)
    np.testing.assert_allclose(scores.numpy(), golden[f"{key}|scores"],
                               atol=1e-5, rtol=1e-5)
    ranks = np.asarray(ranks_from_scores(scores.numpy(), eval_batch["gt_ind"]),
                       np.int32)
    np.testing.assert_array_equal(ranks, golden[f"{key}|ranks"])


def test_gen_decoder_learns_to_rank_above_chance():
    """The port's twin of test_train_integration.py's gen bar: MN-QH-gen
    trained 400 steps (lr 5e-3, no decay) on the separable synthetic task
    ranks the ground truth at MRR > 0.6 through the bucketed evaluate_split
    (chance over 12 options ~0.26; 0.84 measured on the CPU)."""
    cfg = small_config(encoder="mn-ques-hist", decoder="gen",
                       learning_rate=5e-3, lr_decay_rate=1.0)
    split, vocab = torch_synthetic_split(cfg, num_dialogs=32, seed=0)
    cfg = torch_config.Config.from_json(
        cfg.replace(vocab_size=vocab.size).to_json())
    state = init_train_state(cfg)
    loader, losses = TorchTrainLoader(split, vocab, cfg), []
    while len(losses) < 400:
        for b in loader.epoch(seed=len(losses)):
            state, m = train_step(state, batch_to_device(b.as_dict(), "cpu"), cfg)
            losses.append(float(m["loss"]))
            if len(losses) == 400:
                break
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert evaluate_split(state.params, split, vocab, cfg, "cpu")["mrr"] > 0.6


def test_train_cli_gen_with_resume(tmp_path, capsys):
    """A tiny `train --decoder gen` run on the CPU: train events, an eval
    with a finite MRR, checkpoints, then a resume that continues the step
    count."""
    base = ["--synthetic", "8", "--device", "cpu", "--encoder",
            "mn-ques-im-hist", "--decoder", "gen", "--embed_size", "16",
            "--rnn_hidden_size", "24", "--img_feat_size", "32",
            "--max_ques_len", "6", "--max_ans_len", "4", "--max_cap_len", "8",
            "--num_rounds", "4", "--num_options", "12", "--batch_size", "4",
            "--eval_every", "2", "--save_every", "2", "--log_every", "1",
            "--dropout", "0.3", "--save_path", str(tmp_path),
            "--run_name", "g"]
    first = torch_train.main(base + ["--max_steps", "2"])
    events = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert np.isfinite(first["mrr"]) and 0 < first["mrr"] <= 1
    assert [e["step"] for e in events if e["event"] == "checkpoint"] == [2]
    torch_train.main(base + ["--max_steps", "3", "--resume"])
    events = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert [e["event"] for e in events if e["event"] == "resumed"] == ["resumed"]
    assert [e["step"] for e in events if e["event"] == "train"] == [3]
    assert all(np.isfinite(e["loss"]) for e in events if e["event"] == "train")
    assert os.path.isdir(tmp_path / "g" / "step_00000003")

