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
                                             fusion_preactivation,
                                             masked_slot_attention)
from visdial_tpu_torch.ops import attention_cuda
from visdial_tpu_torch.ops.attention_cuda import AttentionFn, attention_fusion
from visdial_tpu_torch.ops.lstm_cuda import k_tile

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
         pytest.param(9, 5, 7, 24, True, id="B9-S7-masked-row"),
         # img_spatial's 49 pool5 slots, at a narrow width
         pytest.param(3, 10, 49, 16, True, id="B3-S49-masked-row")]


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


def test_expanded_mask_crosses_without_a_copy():
    """The encoder hands its causal mask over as an expanded view (batch
    stride 0): `_mask` hands the kernels its storage as it is, with strides
    (0, S), and converts another dtype.  On the CPU the three wrappers take
    the plain version, so the outputs' equality with the contiguous copy's
    holds the plain path to the view; the `cuda` cases hold the kernels to
    it."""
    B, R, S, H = 3, 4, 4, 16
    q, s, valid, fw, fb = map(torch.from_numpy, _case(B, R, S, H, masked_row=False))
    base = valid[0].clone()
    view = base[None].expand(B, R, S)
    got, vb, vr = attention_cuda._mask(view)
    assert got.data_ptr() == base.data_ptr() and (vb, vr) == (0, S)
    got, _, _ = attention_cuda._mask(view.bfloat16())
    assert got.dtype == torch.float32 and torch.equal(got, view)
    dense = view.contiguous()
    for fn, extra in ((attention_cuda.masked_slot_attention, ()),
                      (AttentionFn.apply, ()),
                      (attention_fusion, (fw, fb))):
        assert torch.equal(fn(q, s, view, *extra), fn(q, s, dense, *extra))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [16, 40, 100])
def test_packed_fusion_operands_give_the_plain_preactivation(H, dtype):
    """K4's tensor-core operands as its wrapper prepares them: Wf^T packed
    K-major (H, 2 Hp), each half zero-padded to a whole k-tile, against
    [q; mem] laid out at the same depths.  Through a plain matmul they give
    attention_fusion_ref's pre-activation exactly (small integers: every sum
    is exact)."""
    rng = np.random.default_rng(H)
    n = 6
    ints = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.integers(-8, 9, shape).astype(np.float32))
    q, mem = ints(n, H).to(dtype), ints(n, H).to(dtype)
    fw, fb = ints(2 * H, H), ints(H)
    wk = attention_cuda.pack_fusion_weight(fw, dtype)
    Hp = -(-H // k_tile(dtype)) * k_tile(dtype)
    assert wk.shape == (H, 2 * Hp) and wk.dtype == dtype and wk.is_contiguous()
    assert not wk[:, H:Hp].any() and not wk[:, Hp + H:].any()
    a = torch.zeros(n, 2 * Hp)
    a[:, :H], a[:, Hp:Hp + H] = q.float(), mem.float()
    got = a @ wk.float().T + fb
    assert torch.equal(got, fusion_preactivation(q, mem, fw, fb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusion_route_threshold(dtype, monkeypatch):
    """K4 streams Wf up to FUSION_STREAM_ROWS rows (a served request: 10)
    and takes the tensor cores above (an eval batch: 320), and wherever the
    streaming block's shared memory would not fit (stream_fits, which asks
    the library; the `cuda` cases hold its answers)."""
    t = attention_cuda.FUSION_STREAM_ROWS[dtype]
    assert 10 <= t < 320
    route = attention_cuda.fusion_route
    monkeypatch.setattr(attention_cuda, "stream_fits", lambda *_: True)
    assert route(1, 10, 10, 512, dtype) == route(t // 10, 10, 10, 512, dtype) \
        == route(t, 1, 4, 512, dtype) == "stream"
    assert route(t // 10 + 1, 10, 10, 512, dtype) == route(32, 10, 10, 512, dtype) \
        == route(t + 1, 1, 10, 512, dtype) == "tiles"
    monkeypatch.setattr(attention_cuda, "stream_fits", lambda *_: False)
    assert route(1, 10, 10, 512, dtype) == route(t, 1, 64, 2048, dtype) == "tiles"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_plans_at_the_head_shapes(dtype):
    """The blocks a cluster the wrapper hands the kernels at the model's
    width (H = 512): K3 at the training batch (32 dialogs) and at one, the
    few-rows route at a served request (16 clusters of 8: 128 blocks), the
    tensor-core product at the eval batch (320 rows: 40 tiles, 4 k-slices
    in f32, 8 in bf16); and the rule's limits (the cluster size, the pieces
    there are to split)."""
    ac = attention_cuda
    assert ac.attention_blocks(32, 512, dtype) == ac.attention_blocks(1, 512, dtype) == 8
    assert ac.attention_blocks(256, 512, dtype) == 1
    assert ac.stream_blocks(512, dtype) == 8
    assert ac.fusion_splits(320, 512, dtype) == (8 if dtype == torch.bfloat16 else 4)
    assert ac.attention_blocks(32, 16, dtype) == (2 if dtype == torch.bfloat16 else 4)
    assert ac.fill_split(1, 1000) == ac.MAX_CLUSTER and ac.fill_split(1, 3) == 2
    assert ac.fill_split(64, 1000) == 2 and ac.fill_split(200, 1000) == 1


def test_wrapper_has_no_silent_fallback():
    meta = lambda *shape: torch.zeros(shape, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for device"):
        attention_cuda.masked_slot_attention(meta(1, 4, 8), meta(1, 4, 8),
                                             meta(1, 4, 4))
    with pytest.raises(ValueError, match="no kernel for device"):
        attention_fusion(meta(1, 4, 8), meta(1, 4, 8), meta(1, 4, 4),
                         meta(16, 8), meta(8))
