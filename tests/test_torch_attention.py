"""Port's slot attention and attention + fusion tail
(visdial_tpu_torch/ops/attention.py) against the JAX package: the xla
twin, kernel K3 (masked_slot_attention_pallas) and its gradients, kernel K4
(attention_fusion_pallas) and its unfused twin, the Pallas kernels in
interpret mode on the CPU.  f32, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.ops.attention import masked_slot_attention as jax_attention
from visdial_tpu.ops.attention_pallas import (_attention_fusion_ref,
                                              attention_fusion_pallas,
                                              masked_slot_attention_pallas)
from visdial_tpu_torch.ops.attention import (attention_fusion_ref,
                                             attention_plain,
                                             masked_slot_attention)
from visdial_tpu_torch.ops import attention_cuda
from visdial_tpu_torch.ops.attention_cuda import AttentionFn, attention_fusion

torch.set_num_threads(1)

ATOL = 1e-5


def _case(B, R, S, H, *, masked_row: bool, seed=0):
    """Causal validity (slot <= round) over a batch B that is not a multiple
    of the TPU kernel's 8-row tile; optionally one fully masked row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, R, H)).astype(np.float32)
    s = rng.standard_normal((B, S, H)).astype(np.float32)
    valid = (np.arange(S)[None, :] <= np.arange(R)[:, None]).astype(np.float32)
    valid = np.broadcast_to(valid, (B, R, S)).copy()
    if masked_row:
        valid[1, 2] = 0.0
    fw = rng.uniform(-0.3, 0.3, (2 * H, H)).astype(np.float32)
    fb = rng.uniform(-0.3, 0.3, (H,)).astype(np.float32)
    return q, s, valid, fw, fb


CASES = [pytest.param(3, 4, 4, 16, False, id="B3-causal"),
         pytest.param(3, 4, 4, 16, True, id="B3-masked-row"),
         pytest.param(9, 5, 7, 24, True, id="B9-S7-masked-row")]


@pytest.mark.parametrize("B,R,S,H,masked_row", CASES)
def test_masked_slot_attention_matches_jax(B, R, S, H, masked_row):
    q, s, valid, _, _ = _case(B, R, S, H, masked_row=masked_row)
    want = jax_attention(jnp.asarray(q), jnp.asarray(s), jnp.asarray(valid),
                         impl="xla")
    got = masked_slot_attention(*map(torch.from_numpy, (q, s, valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("B,R,S,H,masked_row", CASES)
def test_fusion_tail_matches_pallas_kernel_and_twin(B, R, S, H, masked_row):
    args = _case(B, R, S, H, masked_row=masked_row)
    jargs = [jnp.asarray(a) for a in args]
    want_kernel = np.asarray(attention_fusion_pallas(*jargs))
    want_twin = np.asarray(_attention_fusion_ref(*jargs))
    targs = [torch.from_numpy(a) for a in args]
    before = attention_fusion.launches
    for fn in (attention_fusion_ref, attention_fusion):
        got = fn(*targs).numpy()
        np.testing.assert_allclose(got, want_kernel, atol=ATOL)
        np.testing.assert_allclose(got, want_twin, atol=ATOL)
    assert attention_fusion.launches == before   # CPU: plain version


@pytest.mark.parametrize("B,R,S,H,masked_row", CASES)
def test_attention_kernel_and_grads_match_pallas(B, R, S, H, masked_row):
    """K3's plain version and AttentionFn (CPU tensors: the plain version
    forward, the plain vjp backward) against masked_slot_attention_pallas
    and jax.grad through its custom vjp."""
    q, s, valid, _, _ = _case(B, R, S, H, masked_row=masked_row, seed=2)
    g = np.random.default_rng(3).standard_normal((B, R, H)).astype(np.float32)
    jv = jnp.asarray(valid)
    want = masked_slot_attention_pallas(jnp.asarray(q), jnp.asarray(s), jv)
    want_dq, want_ds = jax.grad(
        lambda q, s: jnp.sum(masked_slot_attention_pallas(q, s, jv) * g),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(s))
    before = attention_cuda.masked_slot_attention.launches
    np.testing.assert_allclose(
        attention_plain(*map(torch.from_numpy, (q, s, valid))).numpy(),
        np.asarray(want), atol=ATOL)
    qt, st = (torch.from_numpy(a).requires_grad_() for a in (q, s))
    out = AttentionFn.apply(qt, st, torch.from_numpy(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL)
    dq, ds = torch.autograd.grad(out, (qt, st), torch.from_numpy(g))
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), atol=ATOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=ATOL)
    assert attention_cuda.masked_slot_attention.launches == before  # CPU


def test_fully_masked_row_attends_uniformly():
    q, s, valid, _, _ = _case(3, 4, 4, 16, masked_row=True)
    for fn in (masked_slot_attention, attention_plain):
        got = fn(*map(torch.from_numpy, (q, s, valid)))
        np.testing.assert_allclose(got[1, 2].numpy(), s[1].mean(0), atol=ATOL)


def test_wrapper_has_no_silent_fallback():
    meta = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for device"):
        attention_cuda.masked_slot_attention(meta(1, 4, 8), meta(1, 4, 8),
                                             meta(1, 4, 4))
    with pytest.raises(ValueError, match="no kernel for device"):
        attention_fusion(meta(1, 4, 8), meta(1, 4, 8), meta(1, 4, 4),
                         meta(16, 8), meta(8))
