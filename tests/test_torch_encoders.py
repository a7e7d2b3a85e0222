"""The port's encoders (visdial_tpu_torch/models/encoders.py) against the JAX
package's, family by family: LF and its Q / QH / QI ablations, LF with the
per-round hist_concat history, HRE, HREA and MN, and MN, LF and HREA with
the img_spatial pool5 pathway (S = 4 locations here).  Joint embeddings in
eval mode and the gradient of every encoder and embedding parameter in
train mode (dropout 0) against encoders.py::encoder_apply(impl='xla'), at
atol 1e-4; LF's history part for a dialog with an empty caption; and LF's
eval metrics through the port's harness against the JAX harness's.

impl='cuda' on CPU tensors runs the kernel path's control flow
(LSTMLayerFn, AttentionFn, the K4 eval tail) with each kernel's plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.data.loader import BatchAssembler
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.eval_harness import evaluate_split as jax_evaluate_split
from visdial_tpu.models import model as jax_model
from visdial_tpu.models.encoders import encoder_apply as jax_encoder_apply
from visdial_tpu.parallel.mesh import make_mesh
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models import encoders
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.utils.params import flatten, params_from_numpy, unflatten

from conftest import small_config

torch.set_num_threads(1)

ATOL = 1e-4
# img_spatial at a small width: S = 4 locations of C = 8 channels
SPATIAL = dict(img_spatial=True, img_spatial_slots=4, img_spatial_channels=8,
               img_feat_size=32)
CASES = {
    "lf-ques": ("lf-ques", {}),
    "lf-ques-hist": ("lf-ques-hist", {}),
    "lf-ques-im": ("lf-ques-im", {}),
    "lf-ques-im-hist": ("lf-ques-im-hist", {}),
    "lf-ques-im-hist-concat": ("lf-ques-im-hist", {"lf_hist_incremental": False}),
    "hre-ques-hist": ("hre-ques-hist", {}),
    "hre-ques-im-hist": ("hre-ques-im-hist", {}),
    "hrea-ques-im-hist": ("hrea-ques-im-hist", {}),
    "mn-ques-hist": ("mn-ques-hist", {}),
    "mn-ques-im-hist": ("mn-ques-im-hist", {}),
    "mn-ques-im-hist-spatial": ("mn-ques-im-hist", SPATIAL),
    "lf-ques-im-hist-spatial": ("lf-ques-im-hist", SPATIAL),
    "hrea-ques-im-hist-spatial": ("hrea-ques-im-hist", SPATIAL),
}


def _setup(encoder, extra, empty_caption=False):
    """JAX init scaled 4x (gradients and embeddings far from zero), the
    port's params from it, and a 3-dialog batch (dialog 0 without a
    caption when asked)."""
    cfg = small_config(encoder=encoder, decoder="disc", **extra)
    split, vocab = make_synthetic_split(cfg, num_dialogs=6, seed=0)
    if empty_caption:
        split.cap[0] = 0
        split.cap_len[0] = 0
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * 4,
                           jax_model.model_init(jax.random.PRNGKey(3), cfg))
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    batch = BatchAssembler(split, vocab, cfg).assemble(np.arange(3)).as_dict()
    return cfg, split, vocab, jparams, params, batch


def _jax_grads(cfg, jparams, batch, cot):
    """jax.grad of sum(joint * cot) in train mode over the encoder's and
    the embedding's params, flattened by tree path."""
    def fn(p):
        joint = jax_encoder_apply(p["encoder"], p["embed"], batch, cfg,
                                  train=True, impl="xla")
        return jnp.sum(joint * cot)

    return _tree_to_dict(jax.grad(fn)({"encoder": jparams["encoder"],
                                       "embed": jparams["embed"]}))


@pytest.fixture(scope="module", params=list(CASES))
def setup(request):
    return _setup(*CASES[request.param])


@pytest.fixture(scope="module")
def jax_grads(setup):
    """(cot, JAX grads) of the case, shared by both impls."""
    cfg, _, _, jparams, _, batch = setup
    N, H = 3 * cfg.num_rounds, cfg.rnn_hidden_size
    cot = np.random.default_rng(0).standard_normal((N, H)).astype(np.float32)
    return cot, _jax_grads(cfg, jparams, batch, cot)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_joint_embeddings_match_jax(setup, impl):
    cfg, _, _, jparams, params, batch = setup
    want = np.asarray(jax_encoder_apply(jparams["encoder"], jparams["embed"],
                                        batch, cfg, impl="xla"))
    got = encoders.encoder_apply(params["encoder"], params["embed"],
                                 batch_to_device(batch, "cpu"), cfg, impl=impl)
    assert got.shape == want.shape == (3 * cfg.num_rounds, cfg.rnn_hidden_size)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_every_encoder_grad_matches_jax(setup, jax_grads, impl):
    """The gradient of sum(joint * cot) in train mode (dropout 0) with
    respect to every encoder and embedding parameter, against jax.grad,
    atol 1e-4 and 1e-4 of the leaf's largest gradient."""
    cfg, _, _, _, params, batch = setup
    cot, want = jax_grads
    flat = {k: v.detach().requires_grad_() for k, v in flatten(
        {"encoder": params["encoder"], "embed": params["embed"]}).items()}
    p = unflatten(flat)
    joint = encoders.encoder_apply(p["encoder"], p["embed"],
                                   batch_to_device(batch, "cpu"), cfg,
                                   train=True, impl=impl)
    grads = torch.autograd.grad((joint * torch.from_numpy(cot)).sum(),
                                list(flat.values()))
    got = {k: g.numpy() for k, g in zip(flat, grads)}
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k],
                                   atol=max(1e-4 * scale, 1e-7), err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


@pytest.mark.parametrize("incremental", [True, False], ids=["flat", "concat"])
def test_lf_empty_caption_round0_history_is_zero(incremental):
    """A dialog whose caption is empty has no history token at round 0: its
    bound is 0 (the clamp reads step 0, the where zeroes it) or its
    right-aligned history is all pads, and the history part is exactly 0;
    the joint embeddings still match JAX."""
    cfg, _, _, jparams, params, batch = _setup(
        "lf-ques-hist", {"lf_hist_incremental": incremental},
        empty_caption=True)
    dev = batch_to_device(batch, "cpu")
    if incremental:
        assert int(dev["hist_bounds"][0, 0]) == 0
        assert int(dev["hist_bounds"][1, 0]) > 0
    else:
        assert not dev["hist_concat"][0, 0].any()
    B, R = dev["ques"].shape[:2]
    for impl in ("plain", "cuda"):
        hist = encoders._lf_history(params["encoder"], params["embed"], dev, cfg,
                                    impl, False, None, B, R)
        assert torch.equal(hist[0], torch.zeros_like(hist[0]))
        assert hist[1].abs().max() > 0 and hist[R].abs().max() > 0
    want = jax_encoder_apply(jparams["encoder"], jparams["embed"], batch, cfg,
                             impl="xla")
    got = encoders.encoder_apply(params["encoder"], params["embed"], dev, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("incremental", [True, False], ids=["flat", "concat"])
def test_lf_eval_metrics_match_jax_harness(incremental):
    """evaluate_split of LF-QIH-disc ships the history keys to the encoder:
    the port's streaming harness gives the JAX harness's metrics over a
    6-dialog split (two batches, the second padded)."""
    cfg, split, vocab, jparams, params, _ = _setup(
        "lf-ques-im-hist", {"lf_hist_incremental": incremental})
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    want = jax_evaluate_split(jparams, split, vocab, cfg, mesh)
    for impl in ("plain", "cuda"):
        got = evaluate_split(params, split, vocab, cfg, "cpu", impl=impl)
        for k in ("mrr", "r@1", "r@5", "r@10", "mean_rank", "num_examples"):
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert want["num_examples"] == 6 * cfg.num_rounds
