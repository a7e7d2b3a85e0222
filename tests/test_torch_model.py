"""The port's disc model (visdial_tpu_torch/models/), every encoder family,
against the JAX package: joint embeddings, candidate scores, the option
table and table scoring (atol 1e-4), scores with the img_spatial pathway,
and the golden fixture's scores and ranks."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.config import Config
from visdial_tpu.data.loader import BatchAssembler, EvalLoader, TrainLoader
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.models import decoders as jax_decoders
from visdial_tpu.models import model as jax_model
from visdial_tpu.models.encoders import encoder_apply as jax_encoder_apply
from visdial_tpu.parallel.train_step import init_train_state, train_step
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu.utils.metrics import ranks_from_scores
from visdial_tpu_torch.models import decoders
from visdial_tpu_torch.models.encoders import encoder_apply
from visdial_tpu_torch.models.model import (batch_to_device, model_option_table,
                                            model_scores,
                                            model_scores_with_table)
from visdial_tpu_torch.utils.params import params_from_numpy

from conftest import small_config
from test_golden import FIXTURE, GOLDEN_PATH, NUM_DIALOGS, TRAIN_STEPS

torch.set_num_threads(1)

ATOL = 1e-4
ENCODERS = ["mn-ques-im-hist", "mn-ques-hist", "lf-ques", "lf-ques-hist",
            "lf-ques-im", "lf-ques-im-hist", "hre-ques-hist",
            "hre-ques-im-hist", "hrea-ques-im-hist"]


@pytest.fixture(scope="module", params=ENCODERS)
def setup(request):
    cfg = small_config(encoder=request.param, decoder="disc")
    split, vocab = make_synthetic_split(cfg, num_dialogs=6, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax_model.model_init(jax.random.PRNGKey(1), cfg)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    batch = BatchAssembler(split, vocab, cfg).assemble(np.arange(3)).as_dict()
    return cfg, split, jparams, params, batch


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_joint_embeddings_match(setup, impl):
    """impl='cuda' on CPU tensors routes through the kernel wrappers (the
    fused attention + fusion tail), which take their plain versions."""
    cfg, _, jparams, params, batch = setup
    want = jax_encoder_apply(jparams["encoder"], jparams["embed"], batch, cfg,
                             impl="xla")
    got = encoder_apply(params["encoder"], params["embed"],
                        batch_to_device(batch, "cpu"), cfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_model_scores_match(setup):
    cfg, _, jparams, params, batch = setup
    want = jax_model.model_scores(jparams, batch, cfg, impl="xla")
    got = model_scores(params, batch_to_device(batch, "cpu"), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_option_table_and_table_scores_match(setup):
    cfg, split, jparams, params, batch = setup
    opt_list = split.opt_list
    want_table = jax_model.model_option_table(jparams, jnp.asarray(opt_list),
                                              cfg, impl="xla")
    table = model_option_table(params, torch.from_numpy(opt_list).long(), cfg)
    np.testing.assert_allclose(table.numpy(), np.asarray(want_table),
                               atol=ATOL)
    want = jax_model.model_scores_with_table(jparams, batch, want_table, cfg,
                                             impl="xla")
    got = model_scores_with_table(params, batch_to_device(batch, "cpu"),
                                  table, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_length_sorted_rows_come_back_in_order(setup):
    """Above LENGTH_SORT_MIN_ROWS the kernel path length-sorts candidate
    rows; the inverse permutation must restore the original row order."""
    cfg, _, jparams, params, _ = setup
    rng = np.random.default_rng(0)
    M, La = decoders.LENGTH_SORT_MIN_ROWS + 37, cfg.max_ans_len
    rows = rng.integers(1, cfg.vocab_size, (M, La))
    rows *= np.arange(La) < rng.integers(0, La + 1, (M, 1))
    order, rank = decoders._length_sorted(torch.from_numpy(rows))
    want_order, want_rank = jax_decoders._length_sorted(jnp.asarray(rows))
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))
    tokens = torch.from_numpy(rows)[None]
    got = decoders.disc_option_embeddings(params["decoder"], params["embed"],
                                          tokens, cfg, impl="cuda")
    plain = decoders.disc_option_embeddings(params["decoder"], params["embed"],
                                            tokens, cfg, impl="plain")
    want = jax_decoders.disc_option_embeddings(
        jparams["decoder"], jparams["embed"], jnp.asarray(rows)[None], cfg,
        impl="xla")
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("encoder", ["mn-ques-im-hist", "lf-ques-im-hist"])
def test_img_spatial_scores_match(encoder):
    """img_spatial (4 pool5 locations of 8 channels here): the encoder
    attends over the projected locations with the question state; model
    scores against JAX, both impls."""
    cfg = small_config(encoder=encoder, decoder="disc", img_spatial=True,
                       img_spatial_slots=4, img_spatial_channels=8,
                       img_feat_size=32)
    split, vocab = make_synthetic_split(cfg, num_dialogs=6, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * 4,
                           jax_model.model_init(jax.random.PRNGKey(1), cfg))
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    assert tuple(params["encoder"]["img_proj"]["w"].shape) == (8, 24)
    batch = BatchAssembler(split, vocab, cfg).assemble(np.arange(3)).as_dict()
    want = jax_model.model_scores(jparams, batch, cfg, impl="xla")
    for impl in ("plain", "cuda"):
        got = model_scores(params, batch_to_device(batch, "cpu"), cfg, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_golden_scores_and_ranks(encoder):
    """tests/golden/golden_v1.npz: params from init_train_state plus the
    fixture's 5 JAX train steps, exactly as test_golden.py builds them; the
    port scores the fixture's eval batch with them."""
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    cfg = Config(**{**FIXTURE, "encoder": encoder, "decoder": "disc"})
    split, vocab = make_synthetic_split(cfg, num_dialogs=NUM_DIALOGS, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    state = init_train_state(cfg)
    eval_batch = next(iter(EvalLoader(split, vocab, cfg))).as_dict()
    step_fn = jax.jit(partial(train_step, cfg=cfg, impl="xla"))
    loader = TrainLoader(split, vocab, cfg)
    batches = (b for epoch in range(TRAIN_STEPS) for b in loader.epoch(epoch))
    for _ in range(TRAIN_STEPS):
        state, _ = step_fn(state, next(batches).as_dict())

    params = params_from_numpy(_tree_to_dict(state.params), cfg, "cpu")
    scores = model_scores(params, batch_to_device(eval_batch, "cpu"), cfg)
    golden = np.load(GOLDEN_PATH)
    np.testing.assert_allclose(scores.numpy(),
                               golden[f"{encoder}|disc|scores"],
                               atol=1e-5, rtol=1e-5)
    ranks = np.asarray(ranks_from_scores(scores.numpy(),
                                         eval_batch["gt_ind"]), np.int32)
    np.testing.assert_array_equal(ranks, golden[f"{encoder}|disc|ranks"])
