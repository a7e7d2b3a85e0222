"""The port's training path (visdial_tpu_torch/models/model.py::model_loss,
parallel/train_step.py) against the JAX package: the loss and every
parameter gradient in both option layouts, five train steps from a shared
init (per-step loss and final params), the golden fixture's loss0/loss5,
and the port's own invariants (remat, grouped steps, dropout masks drawn
outside the kernels).  f32 on the CPU; tolerances in each test."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.config import Config
from visdial_tpu.data.loader import BatchAssembler, EvalLoader, TrainLoader
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.models import model as jax_model
from visdial_tpu.parallel.train_step import init_train_state as jax_init_state
from visdial_tpu.parallel.train_step import train_step as jax_train_step
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu_torch.models import decoders
from visdial_tpu_torch.models.model import batch_to_device, model_loss
from visdial_tpu_torch.parallel.optim import init_opt_state, tree_map
from visdial_tpu_torch.parallel.train_step import (TrainState, init_train_state,
                                                   loss_and_grads,
                                                   multi_train_step, train_step)
from visdial_tpu_torch.utils.params import flatten, params_from_numpy

from conftest import small_config
from test_golden import FIXTURE, GOLDEN_PATH, NUM_DIALOGS, TRAIN_STEPS

torch.set_num_threads(1)

ENCODERS = ["mn-ques-im-hist", "mn-ques-hist", "lf-ques", "lf-ques-hist",
            "lf-ques-im", "lf-ques-im-hist", "hre-ques-hist",
            "hre-ques-im-hist", "hrea-ques-im-hist"]
# the whole-model gradient in both option layouts; every family's encoder
# gradients are held to JAX in tests/test_torch_encoders.py
GRAD_ENCODERS = ENCODERS[:2]


def _grad_case(encoder, dedup, decoder="disc"):
    """8 dialogs x 4 rounds x 64 options = 2,048 candidate rows, so the
    kernel path length-sorts them; JAX init scaled 4x so that gradients are
    far from zero; a few rounds with round_valid = 0."""
    cfg = small_config(encoder=encoder, decoder=decoder, num_options=64,
                       batch_size=8)
    split, vocab = make_synthetic_split(cfg, num_dialogs=8, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * 4,
                           jax_model.model_init(jax.random.PRNGKey(2), cfg))
    batch = BatchAssembler(split, vocab, cfg).assemble(
        np.arange(8), dedup_options=dedup).as_dict()
    batch["round_valid"] = batch["round_valid"].copy()
    batch["round_valid"][[1, 5], [0, 3]] = 0
    return cfg, jparams, batch


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "expanded"])
@pytest.mark.parametrize("encoder", GRAD_ENCODERS)
def test_loss_and_every_grad_match_jax(encoder, dedup):
    """model_loss and the gradient of every param leaf against jax.grad of
    the JAX model_loss (impl='xla'), atol 1e-4 and rtol 1e-4 of the leaf's
    largest gradient.  The port runs impl='cuda' on CPU tensors: LSTMLayerFn
    (plain K1 with cell states, plain K2), AttentionFn and the length sort
    with its inverse, which must all carry the gradient."""
    cfg, jparams, batch = _grad_case(encoder, dedup)
    assert ("opt_uniq" in batch) == dedup
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_model.model_loss(p, batch, cfg, train=True, impl="xla"))(
        jparams)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    loss, grads = loss_and_grads(params, batch_to_device(batch, "cpu"), cfg,
                                 gen=None, impl="cuda")
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    want = _tree_to_dict(jgrads)
    got = {k: v.numpy() for k, v in flatten(grads).items()}
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], atol=max(1e-4 * scale, 1e-7),
                                   err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


@pytest.fixture(scope="module", params=ENCODERS)
def jax_run(request):
    """The golden fixture's JAX run: init_train_state, then TRAIN_STEPS
    train steps over the fixture's cycled epochs (as test_golden.py)."""
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    cfg = Config(**{**FIXTURE, "encoder": request.param, "decoder": "disc"})
    split, vocab = make_synthetic_split(cfg, num_dialogs=NUM_DIALOGS, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    state = jax_init_state(cfg)
    init = _tree_to_dict(state.params)
    loader = TrainLoader(split, vocab, cfg)
    batches = [b.as_dict() for epoch in range(TRAIN_STEPS)
               for b in loader.epoch(seed=epoch)][:TRAIN_STEPS]
    step_fn = jax.jit(partial(jax_train_step, cfg=cfg, impl="xla"))
    losses = []
    for b in batches:
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    eval_batch = next(iter(EvalLoader(split, vocab, cfg))).as_dict()
    return cfg, init, batches, losses, _tree_to_dict(state.params), eval_batch


def test_five_steps_match_jax_and_golden(jax_run):
    """From the JAX init: the port's per-step losses (atol 1e-5) and final
    params (atol 2e-5: five Adam steps of 0.004 each; a gradient entry near
    zero can move an update by lr * its error / eps) against the JAX run,
    and golden_v1.npz's loss0 (eval-mode loss at init) and loss5."""
    cfg, init, batches, jlosses, jfinal, eval_batch = jax_run
    params = params_from_numpy(init, cfg, "cpu")
    state = TrainState(params, init_opt_state(params, cfg),
                       torch.Generator().manual_seed(0))
    golden = np.load(GOLDEN_PATH)
    loss0 = model_loss(params, batch_to_device(eval_batch, "cpu"), cfg,
                       train=False)
    np.testing.assert_allclose(float(loss0), golden[f"{cfg.encoder}|disc|loss0"],
                               atol=1e-5, rtol=1e-5)
    for b, jl in zip(batches, jlosses):
        state, m = train_step(state, batch_to_device(b, "cpu"), cfg)
        np.testing.assert_allclose(float(m["loss"]), jl, atol=1e-5)
    assert state.opt.step == TRAIN_STEPS
    np.testing.assert_allclose(float(m["loss"]), golden[f"{cfg.encoder}|disc|loss5"],
                               atol=1e-5, rtol=1e-5)
    for k, v in flatten(state.params).items():
        np.testing.assert_allclose(v.numpy(), jfinal[k], atol=2e-5, err_msg=k)


def _dropout_case(encoder="mn-ques-im-hist", batch_size=8):
    """Dropout 0.5, 2,048 candidate rows, and the port's init scaled 8x so
    that scores (and the dropout's effect on them) are far from zero."""
    cfg = small_config(encoder=encoder, num_options=64, batch_size=batch_size,
                       dropout=0.5)
    split, vocab = make_synthetic_split(cfg, num_dialogs=8, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    batches = [batch_to_device(b.as_dict(), "cpu")
               for s in range(2) for b in TrainLoader(split, vocab, cfg).epoch(s)]
    state = init_train_state(cfg)
    state = state._replace(params=tree_map(lambda p: p * 8, state.params))
    return cfg, batches, state


def _grads(cfg, params, batch, impl, seed=7):
    return loss_and_grads(params, batch, cfg, torch.Generator().manual_seed(seed),
                          impl)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_remat_equals_no_remat_with_dropout(impl):
    """cfg.remat recomputes the encoder in the backward; its generator is
    made anew from the same seed, so it redraws the forward's masks: loss
    and grads equal the run without remat (atol 1e-6; the arithmetic is the
    same)."""
    cfg, batches, state = _dropout_case()
    params = state.params
    loss, grads = _grads(cfg, params, batches[0], impl)
    loss_r, grads_r = _grads(cfg.replace(remat=True), params, batches[0], impl)
    assert float(loss) == float(loss_r)
    for k, g in flatten(grads).items():
        torch.testing.assert_close(flatten(grads_r)[k], g, rtol=0, atol=1e-6)
    other, _ = _grads(cfg, params, batches[0], impl, seed=8)
    assert float(other) != float(loss)           # dropout is really on


def test_kernel_path_draws_the_plain_paths_dropout_masks():
    """Same generator state, dropout 0.5: impl='cuda' (length-sorted option
    rows, LSTMLayerFn, AttentionFn; plain versions on CPU tensors) and
    impl='plain' give the same loss and grads, so the masks are drawn
    outside the kernels and follow the rows through the sort (atol 1e-5)."""
    cfg, batches, state = _dropout_case()
    assert batches[0]["opt_uniq"].shape[0] >= decoders.LENGTH_SORT_MIN_ROWS
    params = state.params
    loss_k, grads_k = _grads(cfg, params, batches[0], "cuda")
    loss_p, grads_p = _grads(cfg, params, batches[0], "plain")
    np.testing.assert_allclose(float(loss_k), float(loss_p), atol=1e-5)
    for k, g in flatten(grads_p).items():
        torch.testing.assert_close(flatten(grads_k)[k], g, rtol=0, atol=1e-5)


def test_multi_train_step_equals_single_steps():
    """G = 3 steps in one call over a stacked batch == 3 train_steps
    (same generator stream; bit-equal), metrics stacked to (3,)."""
    cfg, batches, s1 = _dropout_case(encoder="mn-ques-hist",
                                     batch_size=4)
    s2 = s1._replace(gen=torch.Generator().manual_seed(0))
    s1 = s1._replace(gen=torch.Generator().manual_seed(0))
    singles = []
    for b in batches[:3]:
        s1, m = train_step(s1, b, cfg)
        singles.append(m)
    stacked = {k: torch.stack([b[k] for b in batches[:3]]) for k in batches[0]}
    s2, ms = multi_train_step(s2, stacked, cfg)
    assert ms["loss"].shape == ms["grad_norm"].shape == ms["lr"].shape == (3,)
    assert ms["step"].tolist() == [1, 2, 3] and s2.opt.step == 3
    assert ms["loss"].tolist() == [float(m["loss"]) for m in singles]
    assert ms["lr"].tolist() == [m["lr"] for m in singles]
    for k, v in flatten(s1.params).items():
        assert torch.equal(flatten(s2.params)[k], v), k
    assert torch.equal(s1.gen.get_state(), s2.gen.get_state())


def test_gen_decoder_training_of_lf_matches_jax():
    """gen training runs every encoder family: LF-QIH-gen's loss and every
    parameter gradient on both paths against jax.grad of the JAX
    model_loss, as above."""
    cfg, jparams, batch = _grad_case("lf-ques-im-hist", False, "gen")
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_model.model_loss(p, batch, cfg, train=True, impl="xla"))(
        jparams)
    want = _tree_to_dict(jgrads)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    for impl in ("cuda", "plain"):
        loss, grads = loss_and_grads(params, batch_to_device(batch, "cpu"), cfg,
                                     gen=None, impl=impl)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
        got = {k: v.numpy() for k, v in flatten(grads).items()}
        assert got.keys() == want.keys() and "encoder/hist_lstm/layers/0/w" in got
        for k in want:
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k],
                                       atol=max(1e-4 * scale, 1e-7), err_msg=k)
