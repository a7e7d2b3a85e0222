"""Port's slot attention and attention + fusion tail
(visdial_tpu_torch/ops/attention.py) against the JAX package: the xla
twin, kernel K4 (attention_fusion_pallas, interpret mode on the CPU) and
its unfused twin.  f32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.ops.attention import masked_slot_attention as jax_attention
from visdial_tpu.ops.attention_pallas import (_attention_fusion_ref,
                                              attention_fusion_pallas)
from visdial_tpu_torch.ops.attention import (attention_fusion_ref,
                                             masked_slot_attention)
from visdial_tpu_torch.ops.attention_cuda import attention_fusion

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


def test_fully_masked_row_attends_uniformly():
    q, s, valid, _, _ = _case(3, 4, 4, 16, masked_row=True)
    got = masked_slot_attention(*map(torch.from_numpy, (q, s, valid)))
    np.testing.assert_allclose(got[1, 2].numpy(), s[1].mean(0), atol=ATOL)


def test_wrapper_has_no_silent_fallback():
    meta = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for device"):
        attention_fusion(meta(1, 4, 8), meta(1, 4, 8), meta(1, 4, 4),
                         meta(16, 8), meta(8))
