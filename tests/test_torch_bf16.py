"""The port at the reference's production precision, bf16, held to the JAX
package on the CPU: the whole model's loss and every gradient leaf against
jax.value_and_grad of the JAX model_loss at compute_dtype bfloat16, for MN,
LF and HREA with each decoder; LSTMLayerFn's and TokenLogprobFn's bf16
backward against the JAX custom VJPs on their kernel paths (the Pallas
kernels in interpret mode); and the contraction helper (ops/contract.py)
on CPU tensors, which keeps the upcast product.

Both sides compute in bf16 and round at the same places (operands cast to
bf16 before each contraction, f32 sums, outputs cast back), but not in the
same order: the port's plain LSTM and XLA's sum their f32 products in
another order, so an output that lands near a bf16 rounding boundary
rounds the other way (one bf16 ulp, 2^-8 relative), and the flip feeds
every later step and layer.  The tolerances below are set from that, with
the measured gaps beside them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.data.loader import BatchAssembler
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.models import model as jax_model
from visdial_tpu.ops import lstm_pallas as jax_lstm_pallas
from visdial_tpu.ops.lm_loss import _token_logprobs
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.ops.contract import mm_f32, scores_f32
from visdial_tpu_torch.ops.lm_loss import TokenLogprobFn
from visdial_tpu_torch.ops.lstm_cuda import LSTMLayerFn
from visdial_tpu_torch.parallel.train_step import loss_and_grads
from visdial_tpu_torch.utils.params import flatten, params_from_numpy

from conftest import small_config

torch.set_num_threads(1)

# The whole model (measured on this test's cases: the loss within 7.4e-5
# of JAX's, every gradient leaf within 2.9e-2 of its largest |value|, LF
# the widest; at f32 the same cases agree within 4.8e-7 and 1.9e-6).  The
# loss is a mean of f32 log-softmaxes over bf16-rounded scores, so one
# flipped rounding moves it by ~1e-5; the gradients sum bf16-rounded terms
# over every row, and a leaf with few large entries (a bias, a fusion
# weight) carries a flip's 2^-8 relative error almost whole.  Limits: about
# 2x the widest measured gap; the gradient limit is also the JAX package's
# own bf16 gate (BENCH_r05.json, rel_tol 0.06).
MODEL_LOSS_TOL = 2e-4
MODEL_GRAD_RTOL = 0.06        # of each leaf's largest |gradient|
BF16_CASES = [(enc, dec) for enc in ("mn-ques-im-hist", "lf-ques-im-hist",
                                     "hrea-ques-im-hist")
              for dec in ("disc", "gen")]


def _bf16_case(encoder, decoder):
    """tests/test_torch_train.py::_grad_case at compute_dtype bfloat16: 8
    dialogs x 4 rounds x 64 options (the kernel path length-sorts them),
    JAX init scaled 4x, a few rounds with round_valid = 0.  The batch is
    assembled at f32 for both packages (the port's loader always assembles
    in f32 and casts on the device; the JAX loader's bf16 batch holds
    ml_dtypes arrays that torch cannot take), and each model casts it to
    bf16 where it computes."""
    cfg = small_config(encoder=encoder, decoder=decoder, num_options=64,
                       batch_size=8)
    split, vocab = make_synthetic_split(cfg, num_dialogs=8, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * 4,
                           jax_model.model_init(jax.random.PRNGKey(2), cfg))
    batch = BatchAssembler(split, vocab, cfg).assemble(np.arange(8)).as_dict()
    batch["round_valid"] = batch["round_valid"].copy()
    batch["round_valid"][[1, 5], [0, 3]] = 0
    return cfg.replace(compute_dtype="bfloat16"), jparams, batch


@pytest.mark.parametrize("encoder,decoder", BF16_CASES)
def test_bf16_model_loss_and_every_grad_match_jax(encoder, decoder):
    """model_loss and every gradient leaf at bf16 against jax.value_and_grad
    of the JAX model_loss at bf16 (impl='xla'); the port on impl='cuda'
    with CPU tensors (LSTMLayerFn over plain K1/K2, the contraction helper's
    CPU route)."""
    cfg, jparams, batch = _bf16_case(encoder, decoder)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_model.model_loss(p, batch, cfg, train=True, impl="xla"))(
        jparams)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    loss, grads = loss_and_grads(params, batch_to_device(batch, "cpu"), cfg,
                                 gen=None, impl="cuda")
    want = _tree_to_dict(jgrads)
    got = {k: v.float().numpy() for k, v in flatten(grads).items()}
    assert got.keys() == want.keys()
    loss_err = abs(float(loss) - float(jloss))
    grad_err = max(float(np.abs(got[k] - want[k]).max())
                   / max(float(np.abs(want[k]).max()), 1e-30) for k in want)
    assert loss_err <= MODEL_LOSS_TOL, loss_err
    assert grad_err <= MODEL_GRAD_RTOL, grad_err


# LSTMLayerFn's bf16 backward against the JAX _layer VJP on its kernel
# path: the same rounding points (hs, cs and dgp in bf16, f32 dW/dx sums)
# and the same operands, so the two differ only by a bf16 rounding that
# lands apart (measured: dW 9.2e-6 of its largest value, db 7.1e-6, dh0
# 2.4e-6, dc0 1.1e-7, dx equal).  Limit: 10x the widest.
LAYER_RTOL = 1e-4
N, T, E, H = 9, 6, 20, 16


def _layer_operands(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.5, 0.5, (E + H, 4 * H)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (4 * H,)).astype(np.float32)
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    mask = (rng.random((N, T)) < 0.7).astype(np.float32)
    mask[4] = 0.0                                        # an all-pad row
    h0, c0 = (rng.standard_normal((N, H)).astype(np.float32) for _ in range(2))
    g_hs = rng.standard_normal((N, T, H)).astype(np.float32)
    g_ht, g_ct = (rng.standard_normal((N, H)).astype(np.float32)
                  for _ in range(2))
    return (w, b, x, mask, h0, c0), (g_hs, g_ht, g_ct)


def test_layer_fn_bf16_backward_matches_jax_kernel_path():
    """dW, db, dx, dh0, dc0 of LSTMLayerFn at bf16 (plain K1 with cell
    states, plain K2, then the contraction helper) against jax.vjp of
    lstm_pallas._layer with FORCE_BWD_KERNEL (K1 and K2 in interpret mode,
    then _layer_bwd_kernel_path's bf16 x bf16 -> f32 dots)."""
    (w, b, x, mask, h0, c0), (g_hs, g_ht, g_ct) = _layer_operands()
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    old = jax_lstm_pallas.FORCE_BWD_KERNEL
    jax_lstm_pallas.FORCE_BWD_KERNEL = True
    try:
        (jhs, _, _), vjp = jax.vjp(jax_lstm_pallas._layer, jnp.asarray(w),
                                   jnp.asarray(b), jx, jnp.asarray(mask),
                                   jnp.asarray(h0), jnp.asarray(c0))
        want = vjp((jnp.asarray(g_hs).astype(jnp.bfloat16), jnp.asarray(g_ht),
                    jnp.asarray(g_ct)))
    finally:
        jax_lstm_pallas.FORCE_BWD_KERNEL = old
    ins = [torch.from_numpy(a) for a in (w, b, x, mask, h0, c0)]
    ins[2] = ins[2].bfloat16()
    for i in (0, 1, 2, 4, 5):
        ins[i].requires_grad_()
    hs, ht, ct = LSTMLayerFn.apply(*ins)
    assert hs.dtype == torch.bfloat16
    got = torch.autograd.grad(
        (hs, ht, ct), [ins[i] for i in (0, 1, 2, 4, 5)],
        (torch.from_numpy(g_hs).bfloat16(), torch.from_numpy(g_ht),
         torch.from_numpy(g_ct)))
    hs_err = float(np.abs(hs.detach().float().numpy()
                          - np.asarray(jhs.astype(jnp.float32))).max())
    assert hs_err <= 2 ** -7, hs_err
    for name, a, r in zip(("dw", "db", "dx", "dh0", "dc0"), got,
                          [want[i] for i in (0, 1, 2, 4, 5)]):
        assert a.dtype == (torch.bfloat16 if name == "dx" else torch.float32)
        r = np.asarray(r.astype(jnp.float32))
        err = float(np.abs(a.float().numpy() - r).max()) / float(np.abs(r).max())
        assert err <= LAYER_RTOL, (name, err)


# TokenLogprobFn's bf16 backward against _token_logprobs' VJP: d-logits in
# bf16 on both sides (K6 and its plain version round the same f32 value),
# then f32 sums of exact bf16 products in another order (measured: dW
# 1.4e-7 of its largest value, db 7.2e-8, dx equal).  Limit: ~70x the
# widest, an f32 summation-order gap over these 40 rows.
TOKEN_RTOL = 1e-5


def test_token_logprob_fn_bf16_backward_matches_jax_kernel_path():
    """dx, dW, db of TokenLogprobFn at bf16 (plain K5, plain K6, then the
    contraction helper) against jax.vjp of lm_loss._token_logprobs (K5 and
    K6 in interpret mode, then _token_logprobs_bwd's bf16 dots)."""
    rng = np.random.default_rng(1)
    NT, Hh, V = 40, 24, 1100
    x = rng.standard_normal((NT, Hh)).astype(np.float32)
    w = (rng.standard_normal((Hh, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, NT).astype(np.int32)
    g = rng.standard_normal(NT).astype(np.float32)
    jlp, vjp = jax.vjp(lambda x, w, b: _token_logprobs(x, w, b, jnp.asarray(tgt)),
                       jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                       jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(x).bfloat16().requires_grad_(),
           torch.from_numpy(w).requires_grad_(),
           torch.from_numpy(b).requires_grad_()]
    lp = TokenLogprobFn.apply(*ins, torch.from_numpy(tgt).long())
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), atol=2e-5)
    got = torch.autograd.grad(lp, ins, torch.from_numpy(g))
    for name, a, r in zip(("dx", "dw", "db"), got, want):
        r = np.asarray(r.astype(jnp.float32))
        err = float(np.abs(a.float().numpy() - r).max()) / float(np.abs(r).max())
        assert err <= TOKEN_RTOL, (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contraction_cpu_route_is_the_upcast_product(dtype):
    """On CPU tensors both forms keep the upcast product, bit for bit, and
    the tensor-core counts do not move."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 7, 33, generator=g).to(dtype)
    b = torch.randn(33, 12, generator=g).to(dtype)
    q = torch.randn(5, 33, generator=g).to(dtype)
    e = torch.randn(5, 9, 33, generator=g).to(dtype)
    before = (mm_f32.tensor_core, scores_f32.tensor_core)
    y, s = mm_f32(a, b), scores_f32(q, e)
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, a.float() @ b.float())
    assert torch.equal(s, torch.einsum("nh,nkh->nk", q.float(), e.float()))
    assert (mm_f32.tensor_core, scores_f32.tensor_core) == before


def test_contraction_refuses_mixed_dtypes():
    with pytest.raises(TypeError, match="differ in dtype"):
        mm_f32(torch.zeros(2, 3), torch.zeros(3, 4, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="differ in dtype"):
        scores_f32(torch.zeros(2, 3, dtype=torch.bfloat16), torch.zeros(2, 4, 3))
