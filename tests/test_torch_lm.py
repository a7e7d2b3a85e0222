"""The gen decoder's LM head in the port (visdial_tpu_torch/ops/lm_score.py,
lm_score_cuda.py, lm_loss.py) against the JAX package: the plain versions
of K5 and K6 against lm_token_logprobs_lse_pallas and lm_dlogits_pallas run
in interpret mode (as tests/test_pallas.py runs them), and masked_nll_fused's
value and gradients against the materialized-logits twin, in f32 and bf16.

Tolerances: f32 atol 1e-5 on log-probs (a logsumexp over <= 1,100 terms,
online on one side and materialized on the other); 1e-4 on gradients.
bf16 as test_pallas.py::test_masked_nll_fused_bf16_grads holds the JAX
package: d-logits rounded to bf16 before the dW/dx products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.ops.lm_loss import masked_nll_ref as jax_masked_nll_ref
from visdial_tpu.ops.lm_score_pallas import (lm_dlogits_pallas,
                                             lm_token_logprobs_lse_pallas)
from visdial_tpu_torch.ops.lm_loss import (TokenLogprobFn, masked_nll_fused,
                                           masked_nll_ref)
from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain, lm_logits,
                                            lm_token_logprobs_lse_plain)
from visdial_tpu_torch.ops.lm_score_cuda import (BLOCKS_PER_SM, PAD_BIAS,
                                                 ROW_TILE, VOCAB_TILE, lm_dlogits,
                                                 lm_token_logprobs_lse,
                                                 pack_lm_weight, pad_lm_bias,
                                                 pad_lm_input, vocab_splits)
from visdial_tpu_torch.ops.lstm_cuda import k_tile

torch.set_num_threads(1)

# NT not a multiple of the TPU's 512-row tile, V not a multiple of its
# 1024-column vocab tile (and one vocab narrower than a tile)
SHAPES = [(37, 16, 1100), (5, 8, 11), (600, 24, 1030)]


def _case(NT, H, V, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((NT, H)).astype(np.float32)
    w = (rng.standard_normal((H, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, NT).astype(np.int32)
    tgt[::7] = 0                                 # pad targets get a real logp
    g = rng.standard_normal(NT).astype(np.float32)
    g[tgt == 0] = 0.0
    return x, w, b, tgt, g


@pytest.mark.parametrize("NT,H,V", SHAPES)
def test_plain_lm_score_matches_pallas(NT, H, V):
    x, w, b, tgt, _ = _case(NT, H, V)
    want_lp, want_lse = lm_token_logprobs_lse_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(tgt),
        interpret=True)
    got_lp, got_lse = lm_token_logprobs_lse_plain(
        *(torch.from_numpy(a) for a in (x, w, b, tgt)))
    assert got_lp.dtype == got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=1e-5)
    # a CPU tensor takes the plain version through the kernel's wrapper
    lp, lse = lm_token_logprobs_lse(*(torch.from_numpy(a) for a in (x, w, b, tgt)))
    assert torch.equal(lp, got_lp) and torch.equal(lse, got_lse)


@pytest.mark.parametrize("NT,H,V", SHAPES)
def test_plain_lm_dlogits_matches_pallas(NT, H, V):
    x, w, b, tgt, g = _case(NT, H, V, seed=1)
    _, lse = lm_token_logprobs_lse_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(tgt),
        interpret=True)
    want = lm_dlogits_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             jnp.asarray(tgt), lse, jnp.asarray(g),
                             interpret=True)
    args = [torch.from_numpy(a) for a in (x, w, b, tgt)]
    lse_t = torch.from_numpy(np.array(lse))
    got = lm_dlogits_plain(*args, lse_t, torch.from_numpy(g))
    assert got.shape == (NT, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert torch.equal(lm_dlogits(*args, lse_t, torch.from_numpy(g)), got)
    # zero cotangent rows (pad targets) give exactly zero d-logits
    assert not got[torch.from_numpy(g) == 0].any()


def test_plain_lm_dlogits_bf16_rounds_like_pallas():
    NT, H, V = 40, 16, 1100
    x, w, b, tgt, g = _case(NT, H, V, seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _, lse = lm_token_logprobs_lse_pallas(xb, jnp.asarray(w), jnp.asarray(b),
                                          jnp.asarray(tgt), interpret=True)
    want = lm_dlogits_pallas(xb, jnp.asarray(w), jnp.asarray(b),
                             jnp.asarray(tgt), lse, jnp.asarray(g),
                             interpret=True)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got_lp, got_lse = lm_token_logprobs_lse_plain(
        xt, torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(tgt))
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=1e-4)
    got = lm_dlogits_plain(xt, torch.from_numpy(w), torch.from_numpy(b),
                           torch.from_numpy(tgt), got_lse, torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the largest |d-logit| (|g| < 4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=2e-2)


def test_vocab_splits_cover_the_vocab():
    for NT, V, sms in [(2880, 8804, 132), (288000, 8804, 132), (1, 10, 132),
                       (513, 8848, 132), (64, 128 * 69, 1), (73728, 8804, 132),
                       (300, 129, 132)]:
        splits, per = vocab_splits(NT, V, sms)
        n_vt = -(-V // VOCAB_TILE)
        assert splits >= 1 and per >= 1
        assert (splits - 1) * per < n_vt <= splits * per, (NT, V, sms)
    # On an H100's 132 SMs.  f32, one block an SM: the training shape's 23
    # row tiles take 69 splits of one vocab tile, 1,587 blocks in 12.02
    # waves (5 splits would leave 17 SMs idle in one wave of 14 tiles); one
    # gen-eval chunk's 576 row tiles take 23 splits of 3, 13,248 blocks in
    # 100.4 waves.  bf16, two blocks an SM: 10 splits of 7 (230 blocks in
    # one wave of 264) and 5 of 14 (2,880 blocks in 10.9 waves).
    assert VOCAB_TILE == 128 and ROW_TILE == 128
    assert BLOCKS_PER_SM == {torch.float32: 1, torch.bfloat16: 2}
    assert vocab_splits(2880, 8804, 132) == (69, 1)
    assert vocab_splits(73728, 8804, 132) == (23, 3)
    assert vocab_splits(2880, 8804, 132, 2) == (10, 7)
    assert vocab_splits(73728, 8804, 132, 2) == (5, 14)
    assert [-(-NT // ROW_TILE) * s for NT, s in
            [(2880, 69), (73728, 23), (2880, 10), (73728, 5)]] == [
                1587, 13248, 230, 2880]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [512, 33, 8])
@pytest.mark.parametrize("V", [8804, 129, 10])
def test_packed_lm_operands_give_the_plain_logits(V, H, dtype):
    """K5's and K6's operands as their wrappers prepare them: W^T packed
    K-major with H zero-padded to a whole k-tile, x padded to the same
    depth only where H is off the k-tile, b padded with the TPU kernel's
    -1e30 to whole vocab tiles.  Through a plain matmul (W's rows past V
    loading as zeros, as in the kernels) they give lm_logits exactly (small
    integers: every sum is exact) and -1e30 past V."""
    rng = np.random.default_rng(H + V)
    n = 5
    x = torch.from_numpy(rng.integers(-8, 9, (n, H)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.integers(-8, 9, (H, V)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 9, V).astype(np.float32))
    wk, xp, bp = pack_lm_weight(w, dtype), pad_lm_input(x), pad_lm_bias(b)
    bk = k_tile(dtype)
    Hp, Vp = -(-H // bk) * bk, -(-V // VOCAB_TILE) * VOCAB_TILE
    assert wk.shape == (V, Hp) and wk.dtype == dtype and wk.is_contiguous()
    assert xp.shape == (n, Hp) and xp.dtype == dtype and xp.is_contiguous()
    assert (xp is x) == (H % bk == 0)
    assert not wk[:, H:].any() and not xp[:, H:].any()
    assert bp.shape == (Vp,) and bp.dtype == torch.float32
    w_rows = torch.zeros(Vp, Hp)
    w_rows[:V] = wk.float()
    got = xp.float() @ w_rows.T + bp
    assert torch.equal(got[:, :V], lm_logits(x, w, b))
    assert bool((got[:, V:] == PAD_BIAS).all())


def _nll_case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    N, T, H, V = 6, 5, 32, 1037
    outs = rng.standard_normal((N, T, H)).astype(np.float32)
    w = (rng.standard_normal((H, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    tgt = rng.integers(1, V, (N, T)).astype(np.int64)
    tgt[1] = 0                      # a fully ignored row
    tgt[0, 2:] = 0                  # trailing pad
    outs_t = torch.from_numpy(outs).to(dtype)
    return outs_t, torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(tgt)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_masked_nll_fused_value_and_grads(dtype, tol):
    """TokenLogprobFn (K5 forward, K6 backward; their plain versions on the
    CPU) against autograd through the materialized-logits twin, and the
    twin's value against the JAX package's masked_nll_ref."""
    outs, w, b, tgt = _nll_case(dtype)
    vals, grads = [], []
    for fn in (masked_nll_fused, masked_nll_ref):
        ins = [t.clone().requires_grad_() for t in (outs, w, b)]
        v = fn(*ins, tgt)
        grads.append(torch.autograd.grad(v, ins))
        vals.append(float(v.detach()))
    np.testing.assert_allclose(vals[0], vals[1], atol=1e-5 if
                               dtype == torch.float32 else 1e-3)
    for a, r in zip(*grads):
        assert a.dtype == r.dtype
        scale = float(r.float().abs().max())
        np.testing.assert_allclose(a.float().numpy(), r.float().numpy(),
                                   atol=tol * scale)
    want = jax_masked_nll_ref(jnp.asarray(outs.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
        jnp.asarray(tgt.numpy().astype(np.int32)))
    np.testing.assert_allclose(vals[1], float(want), atol=1e-5 if
                               dtype == torch.float32 else 1e-3)


def test_token_logprob_fn_grads_match_jax_custom_vjp():
    """dx, dW, db of the port's autograd Function against jax.grad through
    the JAX package's custom-vjp head (its Pallas kernels in interpret
    mode), f32."""
    from visdial_tpu.ops.lm_loss import masked_nll_fused as jax_fused

    outs, w, b, tgt = _nll_case(torch.float32, seed=3)
    jv, jg = jax.value_and_grad(jax_fused, argnums=(0, 1, 2))(
        jnp.asarray(outs.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(b.numpy()), jnp.asarray(tgt.numpy().astype(np.int32)))
    ins = [t.clone().requires_grad_() for t in (outs, w, b)]
    v = masked_nll_fused(*ins, tgt)
    grads = torch.autograd.grad(v, ins)
    np.testing.assert_allclose(float(v.detach()), float(jv), atol=1e-5)
    for a, r in zip(grads, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
    # tgt takes no gradient
    x = outs.reshape(-1, outs.shape[-1]).clone().requires_grad_()
    lp = TokenLogprobFn.apply(x, w, b, tgt.reshape(-1))
    assert lp.shape == (x.shape[0],) and lp.dtype == torch.float32
