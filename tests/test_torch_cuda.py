"""The port's CUDA kernels against their plain versions on the GPU, at
ragged shapes the main paths do not reach (row, unit and depth counts that
are not multiples of the kernels' tiles), in float32 and bfloat16, plus the
wrappers' checks.  Tolerances: absolute for forward outputs in [-1, 1]
(f32 sums in another order; bf16 output rounding); relative to the largest
reference value for gradients.

Needs an NVIDIA GPU: every test skips without one.  On the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from visdial_tpu_torch.models.core import linear
from visdial_tpu_torch.ops.attention import attention_fusion_ref, attention_plain
from visdial_tpu_torch.ops.attention_cuda import (AttentionFn, attention_fusion,
                                                  masked_slot_attention)
from visdial_tpu_torch.ops.contract import mm_f32, scores_f32
from visdial_tpu_torch.ops.lm_loss import masked_nll_fused, masked_nll_ref
from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,
                                            lm_token_logprobs_lse_plain)
from visdial_tpu_torch.ops.lm_score_cuda import lm_dlogits, lm_token_logprobs_lse
from visdial_tpu_torch.ops.lstm import (INIT_SCALE, lstm_layer_bwd_plain,
                                        lstm_layer_plain)
from visdial_tpu_torch.ops.lstm_cuda import LSTMLayerFn, lstm_layer, lstm_layer_bwd

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# K1 / K2 shapes: rows off the 64- and 256-row tiles (65, 130, 321, 600),
# E off a multiple of 8 (33, 300), H off the unit tiles (20, 36, 40), T = 1,
# and the question / fact LSTMs' real width; at that width 640, 1,696 and
# 8,192 rows take the other tiles and K-splits (ops/lstm_cuda.py::lstm_tile)
LSTM_CASES = [(5, 7, 10, 12), (70, 3, 33, 40), (200, 4, 20, 36), (600, 5, 20, 36),
              (65, 3, 33, 20), (130, 1, 300, 36), (321, 2, 8, 20),
              (320, 16, 300, 512), (640, 3, 300, 512), (1696, 2, 300, 512),
              (8192, 1, 300, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,E,H", LSTM_CASES)
def test_lstm_kernel_matches_plain(dev, N, T, E, H, dtype):
    g = torch.Generator().manual_seed(N)
    w = torch.empty(E + H, 4 * H).uniform_(-_w_scale(E, H), _w_scale(E, H),
                                           generator=g)
    b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=g)
    x = torch.randn(N, T, E, generator=g).to(dtype)
    mask = (torch.rand(N, T, generator=g) < 0.6).float()
    mask[::3] = 0.0                                  # all-pad rows
    h0, c0 = torch.randn(2, N, H, generator=g)
    args = [t.to(dev) for t in (w, b, x, mask, h0, c0)]
    before = lstm_layer.launches
    got = lstm_layer(*args)
    want = lstm_layer_plain(*args)
    torch.cuda.synchronize()
    assert lstm_layer.launches == before + 1
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert float((a.float() - r.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,R,S,H", [(3, 4, 4, 16), (9, 5, 7, 24), (2, 3, 5, 100),
                                     (2, 3, 64, 40)])
def test_attention_kernel_matches_plain(dev, B, R, S, H, dtype):
    g = torch.Generator().manual_seed(B * S)
    q = torch.randn(B, R, H, generator=g)
    s = torch.randn(B, S, H, generator=g)
    valid = (torch.rand(B, R, S, generator=g) < 0.5).float()
    valid[0, 0] = 0.0                                # a fully masked row
    fw = torch.empty(2 * H, H).uniform_(-0.3, 0.3, generator=g)
    fb = torch.empty(H).uniform_(-0.3, 0.3, generator=g)
    args = [q.to(dev, dtype), s.to(dev, dtype), valid.to(dev), fw.to(dev),
            fb.to(dev)]
    got = attention_fusion(*args)
    want = attention_fusion_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


def _w_scale(E, H):
    """Weights uniform in +-0.5 at the narrow widths; above 100 inputs a
    gate, the model's init scale (ops/lstm.py INIT_SCALE): +-0.5 over ~800
    terms drives the gate sums to |z| ~ 10, where two f32 sums in another
    order already differ by ~1e-5."""
    return 0.5 if E + H <= 100 else INIT_SCALE


def _lstm_case(N, T, E, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.empty(E + H, 4 * H).uniform_(-_w_scale(E, H), _w_scale(E, H),
                                           generator=g)
    b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=g)
    x = torch.randn(N, T, E, generator=g).to(dtype)
    mask = (torch.rand(N, T, generator=g) < 0.6).float()
    mask[::3] = 0.0                                  # all-pad rows
    h0, c0 = torch.randn(2, N, H, generator=g)
    return w, b, x, mask, h0, c0, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,E,H", [(5, 7, 10, 12), (600, 5, 20, 36),
                                     (321, 2, 8, 20)])
def test_lstm_kernel_cell_states_match_plain(dev, N, T, E, H, dtype):
    """K1 with save_cell: cs equals the plain version's."""
    *case, _ = _lstm_case(N, T, E, H, dtype, N + 1)
    args = [t.to(dev) for t in case]
    got = lstm_layer(*args, save_cell=True)
    want = lstm_layer_plain(*args, save_cell=True)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert float((a.float() - r.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,E,H", [(5, 7, 10, 12), (70, 1, 33, 40),
                                     *LSTM_CASES[2:]])
def test_lstm_bwd_kernel_matches_plain(dev, N, T, E, H, dtype):
    """K2 against its plain version on the same residuals (relative to the
    largest reference value: bf16 rounds dgp, which feeds dh)."""
    w, b, x, mask, h0, c0, g = _lstm_case(N, T, E, H, dtype, N + 2)
    hp = torch.randn(N, T, H, generator=g).to(dtype)
    cp = torch.randn(N, T, H, generator=g).to(dtype)
    ghs = torch.randn(N, T, H, generator=g).to(dtype)
    args = [t.to(dev) for t in (w, b, x, mask, hp, cp, ghs, h0, c0)]
    before = lstm_layer_bwd.launches
    got = lstm_layer_bwd(*args)
    want = lstm_layer_bwd_plain(*args)
    torch.cuda.synchronize()
    assert lstm_layer_bwd.launches == before + 1
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and a.shape == r.shape
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_layer_fn_grads_match_autograd(dev, dtype):
    w, b, x, mask, h0, c0, g = _lstm_case(40, 6, 24, 20, dtype, 3)
    cot = [torch.randn(40, 6, 20, generator=g).to(dtype),
           torch.randn(40, 20, generator=g), torch.randn(40, 20, generator=g)]
    grads = []
    for fn in (LSTMLayerFn.apply, lstm_layer_plain):
        ins = [t.to(dev).requires_grad_(t.is_floating_point())
               for t in (w, b, x)] + [mask.to(dev)] + [
               t.to(dev).requires_grad_() for t in (h0, c0)]
        outs = fn(*ins)
        grads.append(torch.autograd.grad(outs, ins[:3] + ins[4:],
                                         [c.to(dev) for c in cot]))
    for a, r in zip(*grads):
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= 3 * TOL[dtype] * scale


def _causal(B, R, S, dev, all_masked: bool):
    """The encoder's causal mask (slot s visible to round r where s <= r) as
    it hands it over, an expanded view with batch stride 0; or, with
    all_masked, a materialised copy with two all-masked rows."""
    valid = (torch.arange(S)[None, :] <= torch.arange(R)[:, None]).float()
    valid = valid.to(dev)[None].expand(B, R, S)
    if all_masked:
        valid = valid.contiguous()
        valid[0, R - 1] = 0.0
        valid[B - 1, 0] = 0.0
    return valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("all_masked", [False, True], ids=["broadcast", "all-masked"])
@pytest.mark.parametrize("route", ["stream", "tiles"])
@pytest.mark.parametrize("B,R,S,H", [(1, 10, 10, 512), (7, 10, 10, 512),
                                     (32, 10, 10, 512), (2, 10, 64, 512),
                                     (3, 4, 4, 16), (2, 3, 5, 100), (9, 5, 7, 40)])
def test_attention_fusion_routes_match_plain(dev, monkeypatch, B, R, S, H, route,
                                             all_masked, dtype):
    """K4 on each route (served requests, ragged and eval batches and the
    limit of 64 slots at the model's width, and widths off the 16-byte
    chunks and k-tiles), with the encoder's broadcast mask or all-masked
    rows.
    At H = 512 inputs at the smoke's scale: over 512 unit-variance terms a
    score reaches ~50, where two f32 sums in another order already differ
    by ~1e-5."""
    from visdial_tpu_torch.ops import attention_cuda

    if route == "stream" and not attention_cuda.stream_fits(B, R, S, H, dtype):
        route = "tiles"   # the few-rows block's shared memory would not fit
    monkeypatch.setattr(attention_cuda, "fusion_route", lambda *_: route)
    g = torch.Generator().manual_seed(B * H + S)
    scale, w_scale = (0.5, 0.08) if H > 100 else (1.0, 0.3)
    q = torch.randn(B, R, H, generator=g) * scale
    s = torch.randn(B, S, H, generator=g) * scale
    fw = torch.empty(2 * H, H).uniform_(-w_scale, w_scale, generator=g)
    fb = torch.empty(H).uniform_(-w_scale, w_scale, generator=g)
    args = [q.to(dev, dtype), s.to(dev, dtype), _causal(B, R, S, dev, all_masked),
            fw.to(dev), fb.to(dev)]
    before = attention_fusion.launches
    got = attention_fusion(*args)
    want = attention_fusion_ref(*args)
    torch.cuda.synchronize()
    assert attention_fusion.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, R, H)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusion_route_asks_the_library_what_fits(dev, dtype):
    """The few-rows route's shared memory, sized by the library alone: it
    fits at a served request and up to the threshold at the model's width,
    so those calls stream Wf; 64 slots of many one-round dialogs at H =
    2,048 do not fit, and the call takes the tensor cores."""
    from visdial_tpu_torch.ops import attention_cuda

    t = attention_cuda.FUSION_STREAM_ROWS[dtype]
    for B in range(1, t // 10 + 1):
        assert attention_cuda.fusion_route(B, 10, 10, 512, dtype) == "stream"
    assert not attention_cuda.stream_fits(t, 1, 64, 2048, dtype)
    assert attention_cuda.fusion_route(t, 1, 64, 2048, dtype) == "tiles"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,R,S,H", [(32, 10, 10, 512), (4, 10, 49, 512),
                                     (4, 10, 64, 512), (3, 4, 4, 16)])
def test_attention_only_kernel_broadcast_mask(dev, B, R, S, H, dtype):
    """K3 with the encoder's expanded causal mask (batch stride 0, no copy)
    and, on the same inputs, with all-masked rows; img_spatial's 49 slots
    and the limit of 64 at the model's width (inputs at the smoke's scale,
    as above)."""
    g = torch.Generator().manual_seed(B * S + 2)
    scale = 0.5 if H > 100 else 1.0
    q = (torch.randn(B, R, H, generator=g) * scale).to(dev, dtype)
    s = (torch.randn(B, S, H, generator=g) * scale).to(dev, dtype)
    for all_masked in (False, True):
        valid = _causal(B, R, S, dev, all_masked)
        got = masked_slot_attention(q, s, valid)
        want = attention_plain(q, s, valid)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,R,S,H", [(3, 4, 4, 16), (9, 5, 7, 24), (2, 3, 64, 40)])
def test_attention_only_kernel_matches_plain(dev, B, R, S, H, dtype):
    """K3 forward and AttentionFn's grads against the plain version."""
    g = torch.Generator().manual_seed(B * S + 1)
    q = torch.randn(B, R, H, generator=g)
    s = torch.randn(B, S, H, generator=g)
    valid = (torch.rand(B, R, S, generator=g) < 0.5).float()
    valid[0, 0] = 0.0                                # a fully masked row
    cot = torch.randn(B, R, H, generator=g).to(dev, dtype)
    before = masked_slot_attention.launches
    outs, grads = [], []
    for fn in (AttentionFn.apply, attention_plain):
        qq = q.to(dev, dtype).requires_grad_()
        ss = s.to(dev, dtype).requires_grad_()
        out = fn(qq, ss, valid.to(dev))
        grads.append(torch.autograd.grad(out, (qq, ss), cot))
        outs.append(out.detach())
    torch.cuda.synchronize()
    assert masked_slot_attention.launches == before + 1
    assert outs[0].dtype == dtype
    assert float((outs[0].float() - outs[1].float()).abs().max()) <= TOL[dtype]
    for a, r in zip(*grads):
        assert float((a.float() - r.float()).abs().max()) <= TOL[dtype]


def _lm_case(NT, H, V, dtype):
    """Above 64 terms a logit, x and W as the model's LM head sees them
    (tanh-bounded LSTM states, W at 0.1): unit-variance x and W at 0.3 over
    ~500 terms give |logit| ~ 30, where two f32 sums in another order
    already differ by ~3e-5 (scripts/lm_f64_error.py), beyond K6's f32
    limit."""
    g = torch.Generator().manual_seed(NT + V)
    x = torch.randn(NT, H, generator=g)
    w = torch.randn(H, V, generator=g) * 0.3
    if H > 64:
        x, w = torch.tanh(x), w / 3
    x = x.to(dtype)
    b = torch.randn(V, generator=g) * 0.1
    tgt = torch.randint(0, V, (NT,), generator=g)
    tgt[::5] = 0                                     # pad targets
    cot = torch.randn(NT, generator=g)
    cot[tgt == 0] = 0.0
    return x, w, b, tgt, cot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NT,H,V", [(1, 8, 10), (70, 33, 2000), (513, 40, 1030),
                                    (300, 16, 129), (127, 48, 1030),
                                    (128, 100, 129), (129, 72, 2001),
                                    (257, 520, 8804)])
def test_lm_score_kernels_match_plain(dev, NT, H, V, dtype):
    """K5 (one to 35 vocab splits) and K6 at row counts around their
    128-row tiles, depths off their 32- (f32) and 64-value (bf16) k-tiles,
    and vocab counts off their 128-column tiles.  K5's products are exact
    in f32 (bf16) or f32-accurate (3xTF32) and summed in f32, so log-probs
    and lse are held to 1e-5 of the largest |logp|; K6 per element to 1e-5
    of |ref| in f32 and one bf16 ulp of ref in bf16 (both sides round the
    same f32 value), plus a floor of that size times |g_i| / V.  K6's f32
    reference is the plain formula in float64 (_dlogits_ref): the f32 plain
    version's own product is off float64 by as much as the limit."""
    x, w, b, tgt, cot = _lm_case(NT, H, V, dtype)
    args = [t.to(dev) for t in (x, w, b, tgt)]
    before = (lm_token_logprobs_lse.launches, lm_dlogits.launches)
    lp, lse = lm_token_logprobs_lse(*args)
    want_lp, want_lse = lm_token_logprobs_lse_plain(*args)
    dl = lm_dlogits(*args, want_lse, cot.to(dev))
    want_dl = _dlogits_ref(*args, want_lse, cot.to(dev))
    plain_dl = lm_dlogits_plain(*args, want_lse, cot.to(dev))
    torch.cuda.synchronize()
    assert (lm_token_logprobs_lse.launches, lm_dlogits.launches) == (
        before[0] + 1, before[1] + 1)
    scale = max(1.0, float(want_lp.abs().max()))
    assert lp.dtype == lse.dtype == torch.float32
    assert float((lp - want_lp).abs().max()) <= 1e-5 * scale
    assert float((lse - want_lse).abs().max()) <= 1e-5 * scale
    assert dl.dtype == dtype and dl.shape == (NT, V)
    r = want_dl.float().abs()
    if dtype == torch.bfloat16:
        lim = torch.where(r > 0, torch.exp2((torch.frexp(r).exponent - 8).float()),
                          0.0) + 2.0 ** -8 * cot.to(dev).abs()[:, None] / V
    else:
        lim = 1e-5 * (r + cot.to(dev).abs()[:, None] / V)
    err = (dl.float() - want_dl.float()).abs()
    # information only, not the bar: the kernel against the f32 plain version
    plain_over = float(((dl.float() - plain_dl.float()).abs() / lim).max())
    print(f"K6 {(NT, H, V)} {dtype}: error over limit "
          f"{float((err / lim).max())} (float64 ref), {plain_over} (plain)")
    assert bool((err <= lim).all())
    assert not dl[cot.to(dev) == 0].any()            # g = 0 rows: no NaN


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("NT,H,V", [(257, 520, 4402), (130, 48, 1031)])
def test_lm_kernels_take_out_of_shard_targets(dev, NT, H, V, dtype):
    """A target outside [0, V) -- -1, or V and up to the last padded vocab
    tile and beyond, as a vocab shard of the model axis gives the targets
    of the other shards -- has no target logit in K5 (logp = -lse) and no
    one-hot term in K6, as in the plain versions; the in-range rows are
    unchanged."""
    x, w, b, tgt, cot = _lm_case(NT, H, V, dtype)
    tgt[1::3] = -1
    tgt[2::7] = V
    tgt[3::11] = V + 5          # inside the last 128-column tile's padding
    tgt[4::13] = 10 * V
    args = [t.to(dev) for t in (x, w, b, tgt)]
    lp, lse = lm_token_logprobs_lse(*args)
    want_lp, want_lse = lm_token_logprobs_lse_plain(*args)
    out = (tgt < 0) | (tgt >= V)
    scale = max(1.0, float(want_lp.abs().max()))
    assert float((lp - want_lp).abs().max()) <= 1e-5 * scale
    assert float((lse - want_lse).abs().max()) <= 1e-5 * scale
    assert torch.equal(lp[out.to(dev)], -lse[out.to(dev)])
    dl = lm_dlogits(*args, want_lse, cot.to(dev)).float()
    want = lm_dlogits_plain(*args, want_lse, cot.to(dev)).float()
    tol = TOL[dtype] * max(1e-3, float(want.abs().max()))
    assert float((dl - want).abs().max()) <= tol
    # no one-hot term: every entry of an out-of-shard row has the sign of -g
    rows = out.to(dev) & (cot.to(dev) != 0)
    assert bool((dl[rows] * cot.to(dev)[rows, None] <= 0).all())


def _dlogits_ref(x, w, b, tgt, lse, g):
    """What K6 is held to (a copy of chip_smoke.py::dlogits_ref): its plain
    version in bf16, and in f32 the same formula evaluated in float64 and
    rounded to f32."""
    if x.dtype != torch.float32:
        return lm_dlogits_plain(x, w, b, tgt, lse, g)
    d = (x.double() @ w.double()).add_(b.double())
    d.sub_(lse.double()[:, None]).exp_().neg_()
    d.scatter_add_(1, tgt.long()[:, None], torch.ones_like(d[:, :1]))
    return d.mul_(g.double()[:, None]).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_token_logprob_fn_grads_match_autograd(dev, dtype):
    """masked_nll_fused (K5 forward, K6 backward) against autograd through
    the materialized-logits twin: value, dx, dW, db relative to the largest
    reference value."""
    g = torch.Generator().manual_seed(3)
    N, T, H, V = 40, 9, 48, 1037
    outs = torch.randn(N, T, H, generator=g).to(dtype)
    w = torch.randn(H, V, generator=g) * 0.3
    b = torch.randn(V, generator=g) * 0.1
    tgt = torch.randint(1, V, (N, T), generator=g)
    tgt[:, 5:] = 0
    tgt[3] = 0
    vals, grads = [], []
    for fn in (masked_nll_fused, masked_nll_ref):
        ins = [t.to(dev).requires_grad_() for t in (outs, w, b)]
        v = fn(*ins, tgt.to(dev))
        grads.append(torch.autograd.grad(v, ins))
        vals.append(float(v.detach()))
    torch.cuda.synchronize()
    assert abs(vals[0] - vals[1]) <= 1e-5 * max(1.0, abs(vals[1]))
    for a, r in zip(*grads):
        assert a.dtype == r.dtype
        assert float((a.float() - r.float()).abs().max()) <= \
            TOL[dtype] * float(r.float().abs().max())


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 3, 8, device=dev)
    w, b = torch.zeros(8 + 6, 24, device=dev), torch.zeros(24, device=dev)
    h = torch.zeros(4, 6, device=dev)
    mask = torch.ones(4, 3, device=dev)
    with pytest.raises(TypeError):
        lstm_layer(w, b, x.half(), mask, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_layer(w, b, x.transpose(0, 1).contiguous().transpose(0, 1),
                   mask, h, h)
    with pytest.raises(TypeError):
        lstm_layer_bwd(w, b, x.half(), mask, h[:, None].expand(4, 3, 6),
                       h[:, None].expand(4, 3, 6), h[:, None].expand(4, 3, 6),
                       h, h)
    seq = torch.zeros(4, 3, 6, device=dev)
    with pytest.raises(ValueError, match="h_prev"):
        lstm_layer_bwd(w, b, x, mask, seq.double(), seq, seq, h, h)
    with pytest.raises(ValueError, match="g_hs"):
        lstm_layer_bwd(w, b, x, mask, seq, seq, seq[:, :2], h, h)
    q = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(ValueError, match="S <= 64"):
        attention_fusion(q, torch.zeros(1, 65, 8, device=dev),
                         torch.ones(1, 2, 65, device=dev),
                         torch.zeros(16, 8, device=dev),
                         torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="S <= 64"):
        masked_slot_attention(q, torch.zeros(1, 65, 8, device=dev),
                              torch.ones(1, 2, 65, device=dev))
    with pytest.raises(TypeError):
        masked_slot_attention(q, q.bfloat16(), torch.ones(1, 2, 2, device=dev))
    with pytest.raises(ValueError, match="valid"):
        masked_slot_attention(q, q, torch.ones(1, 2, 3, device=dev))
    x, w, b, tgt, cot = (t.to(dev) for t in _lm_case(8, 4, 20, torch.float32))
    with pytest.raises(TypeError):
        lm_token_logprobs_lse(x.half(), w, b, tgt)
    with pytest.raises(ValueError, match="contiguous"):
        lm_token_logprobs_lse(x[None], w, b, tgt)
    with pytest.raises(ValueError, match="do not fit"):
        lm_token_logprobs_lse(x, w[:3], b, tgt)
    with pytest.raises(ValueError, match="b "):
        lm_dlogits(x, w, b[:5], tgt, cot, cot)
    with pytest.raises(ValueError, match="lse"):
        lm_dlogits(x, w, b, tgt, cot[:3], cot)


def _history_case(N, T, E, H, dtype, align, seed):
    """w (the model's init scale), b, x, mask, h0 = c0 = 0 at the widths
    the encoders give K1 and K2: LF's history left-aligned with ragged ends
    (lengths 1..T, as each dialog's concat ends where its tokens do), or the
    dialog LSTM's all-ones mask."""
    g = torch.Generator().manual_seed(seed)
    w = torch.empty(E + H, 4 * H).uniform_(-INIT_SCALE, INIT_SCALE, generator=g)
    b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=g)
    x = (torch.randn(N, T, E, generator=g) * 0.5).to(dtype)
    if align == "left":
        lens = torch.randint(1, T + 1, (N,), generator=g)
        lens[0] = T
        mask = (torch.arange(T)[None] < lens[:, None]).float()
    else:
        mask = torch.ones(N, T)
    h0 = torch.zeros(2, N, H)
    return w, b, x, mask, h0[0], h0[1], g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,E,H,align", [(32, 256, 300, 512, "left"),
                                           (32, 10, 512, 512, "ones")],
                         ids=["lf-history", "dialog-lstm"])
def test_lstm_encoder_shapes_match_plain(dev, N, T, E, H, align, dtype):
    """K1 (with and without cell states) and K2 at LF's history layer, 256
    steps left-aligned with rows ending at different steps (the tile skip
    must carry each row past its end), and at HRE/HREA's one-layer dialog
    LSTM over 512-wide fact states; K2 against its plain version on the
    forward's residuals."""
    w, b, x, mask, h0, c0, g = _history_case(N, T, E, H, dtype, align, T)
    args = [t.to(dev) for t in (w, b, x, mask, h0, c0)]
    for save_cell in (False, True):
        got = lstm_layer(*args, save_cell=save_cell)
        want = lstm_layer_plain(*args, save_cell=save_cell)
        torch.cuda.synchronize()
        for a, r in zip(got, want):
            assert a.dtype == r.dtype and a.shape == r.shape
            assert float((a.float() - r.float()).abs().max()) <= TOL[dtype]
    hs, cs, _, _ = want
    h_prev = torch.cat([args[4].to(dtype)[:, None], hs[:, :-1]], dim=1)
    c_prev = torch.cat([args[5].to(dtype)[:, None], cs[:, :-1]], dim=1)
    ghs = torch.randn(N, T, H, generator=g).to(dev, dtype)
    bwd = (*args[:4], h_prev, c_prev, ghs, *torch.randn(2, N, H, generator=g).to(dev))
    got, want = lstm_layer_bwd(*bwd), lstm_layer_bwd_plain(*bwd)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_layer_fn_grads_at_history_bounds(dev, dtype):
    """LF's top history layer: the output gets gradient only at each
    round's prefix bound (10 a row, inside its real steps) and none at the
    final state (g_hT = g_cT = 0, materialised as zeros); dW, db, dx, dh0
    and dc0 through LSTMLayerFn (K1, K2) against autograd through the plain
    layer, relative to the largest reference value."""
    N, T, E, H = 32, 256, 300, 512
    w, b, x, mask, h0, c0, g = _history_case(N, T, E, H, dtype, "left", 7)
    lens = mask.sum(1).long()
    at = torch.zeros(N, T, dtype=torch.bool)
    at[torch.arange(N)[:, None],
       torch.randint(0, T, (N, 10), generator=g) % lens[:, None]] = True
    ghs = torch.where(at[..., None], torch.randn(N, T, H, generator=g), 0.0)
    grads = []
    for fn in (LSTMLayerFn.apply, lstm_layer_plain):
        ins = [t.to(dev).requires_grad_() for t in (w, b, x)] + [mask.to(dev)] + [
            t.to(dev).requires_grad_() for t in (h0, c0)]
        hs, _, _ = fn(*ins)
        grads.append(torch.autograd.grad(hs, ins[:3] + ins[4:],
                                         ghs.to(dev, dtype)))
    for a, r in zip(*grads):
        scale = float(r.float().abs().max())
        assert scale > 0
        assert float((a.float() - r.float()).abs().max()) <= 3 * TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 32])
def test_attention_fusion_as_hrea_tail(dev, B, dtype):
    """K4 as HREA's eval tail: the slots are the dialog LSTM's outputs (K1
    over (B, 10) fact states, all-ones mask), the query a tanh fusion, the
    causal mask as the encoder hands it over; a served request (B = 1, the
    few-rows route) and an eval batch (B = 32, the tensor cores)."""
    from visdial_tpu_torch.ops import attention_cuda

    R, H = 10, 512
    w, b, facts, mask, h0, c0, g = _history_case(B, R, H, H, dtype, "ones", B)
    d_outs, _, _ = lstm_layer(*[t.to(dev) for t in (w, b, facts, mask, h0, c0)])
    q = torch.tanh(torch.randn(B, R, H, generator=g)).to(dev, dtype)
    fw = torch.empty(2 * H, H).uniform_(-INIT_SCALE, INIT_SCALE, generator=g)
    fb = torch.empty(H).uniform_(-INIT_SCALE, INIT_SCALE, generator=g)
    args = [q, d_outs, _causal(B, R, R, dev, False), fw.to(dev), fb.to(dev)]
    assert attention_cuda.fusion_route(B, R, R, H, dtype) == (
        "stream" if B == 1 else "tiles")
    got = attention_fusion(*args)
    want = attention_fusion_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, R, H)
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 32])
def test_attention_only_kernel_spatial_mask(dev, B, dtype):
    """K3 as the img_spatial pathway calls it: 49 pool5 locations, every
    one visible (an all-ones mask expanded from (1, R, S), batch stride 0),
    forward and AttentionFn's grads against the plain version."""
    R, S, H = 10, 49, 512
    g = torch.Generator().manual_seed(B + 49)
    q = torch.randn(B, R, H, generator=g) * 0.5
    s = torch.randn(B, S, H, generator=g) * 0.5
    valid = torch.ones((1, R, S), device=dev).expand(B, R, S)
    cot = torch.randn(B, R, H, generator=g).to(dev, dtype)
    outs, grads = [], []
    for fn in (AttentionFn.apply, attention_plain):
        qq = q.to(dev, dtype).requires_grad_()
        ss = s.to(dev, dtype).requires_grad_()
        out = fn(qq, ss, valid)
        grads.append(torch.autograd.grad(out, (qq, ss), cot))
        outs.append(out.detach())
    torch.cuda.synchronize()
    assert float((outs[0].float() - outs[1].float()).abs().max()) <= TOL[dtype]
    for a, r in zip(*grads):
        scale = float(r.float().abs().max())
        assert float((a.float() - r.float()).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_kernel_launches_on_a_second_card(dtype):
    """One process launches K1-K6 on cuda:0 and then on cuda:1, each held
    against its plain version on that card.  A kernel's dynamic
    shared-memory limit is an attribute of a device, so the launchers must
    raise it on each card they launch on (csrc/common.cuh::allow_smem);
    a card without it refuses the launch with "invalid argument"."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    for i in (0, 1):
        dev = torch.device("cuda", i)
        for N, T, E, H in ((320, 16, 300, 512), (600, 5, 20, 36)):
            w, b, x, mask, h0, c0, g = _lstm_case(N, T, E, H, dtype, N + i)
            args = [t.to(dev) for t in (w, b, x, mask, h0, c0)]
            for a, r in zip(lstm_layer(*args), lstm_layer_plain(*args)):
                assert a.device == dev
                assert float((a.float() - r.float()).abs().max()) <= TOL[dtype]
            hp, cp, ghs = (torch.randn(N, T, H, generator=g).to(dtype).to(dev)
                           for _ in range(3))
            bargs = args[:4] + [hp, cp, ghs] + args[4:]
            for a, r in zip(lstm_layer_bwd(*bargs), lstm_layer_bwd_plain(*bargs)):
                scale = float(r.float().abs().max())
                assert float((a.float() - r.float()).abs().max()) <= (
                    TOL[dtype] * scale)
        g = torch.Generator().manual_seed(i)
        for B in (1, 32):            # K4 on its few-rows route, then tiles
            q = (torch.randn(B, 10, 512, generator=g) * 0.5).to(dev, dtype)
            s = (torch.randn(B, 10, 512, generator=g) * 0.5).to(dev, dtype)
            fw = torch.empty(1024, 512).uniform_(-0.08, 0.08, generator=g).to(dev)
            fb = torch.empty(512).uniform_(-0.08, 0.08, generator=g).to(dev)
            valid = _causal(B, 10, 10, dev, False)
            got = attention_fusion(q, s, valid, fw, fb)
            want = attention_fusion_ref(q, s, valid, fw, fb)
            assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
        got = masked_slot_attention(q, s, valid)
        want = attention_plain(q, s, valid)
        assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
        x, w, b, tgt, cot = (t.to(dev) for t in _lm_case(257, 520, 8804, dtype))
        lp, lse = lm_token_logprobs_lse(x, w, b, tgt)
        want_lp, want_lse = lm_token_logprobs_lse_plain(x, w, b, tgt)
        scale = max(1.0, float(want_lp.abs().max()))
        assert float((lp - want_lp).abs().max()) <= 1e-5 * scale
        dl = lm_dlogits(x, w, b, tgt, want_lse, cot)
        want_dl = _dlogits_ref(x, w, b, tgt, want_lse, cot)
        r = want_dl.float().abs()
        if dtype == torch.bfloat16:
            lim = torch.where(r > 0, torch.exp2((torch.frexp(r).exponent - 8)
                                                .float()), 0.0)
            lim = lim + 2.0 ** -8 * cot.abs()[:, None] / r.shape[1]
        else:
            lim = 1e-5 * (r + cot.abs()[:, None] / r.shape[1])
        assert bool(((dl.float() - want_dl.float()).abs() <= lim).all())
        torch.cuda.synchronize(dev)


# The contraction helper (ops/contract.py): bf16 operands, f32 results on
# the tensor cores, against a float64 product of the same bf16 operands,
# relative to its largest |value|.  Products of bf16 values are exact; the
# f32 sums differ by order and by the tensor cores' truncating f32
# accumulation (~7e-5 over 256,000 rows on the H100; chip_smoke.py's
# CONTRACT_TOL).  (rows a, depth, columns b, a stored transposed): ragged
# sizes, the LM head's dx, and dW-like reductions over more than 100,000
# rows with a transposed operand.
CONTRACT_TOL = 5e-4
CONTRACT_CASES = [(1, 8, 10, False), (70, 33, 130, False),
                  (2880, 8804, 512, False), (40, 120_000, 64, True),
                  (300, 150_001, 2048, True)]


@pytest.mark.parametrize("M,K,N,transposed", CONTRACT_CASES)
def test_contraction_bf16_matches_float64(dev, M, K, N, transposed):
    g = torch.Generator(device=dev).manual_seed(M + K)
    a = torch.randn(*((K, M) if transposed else (M, K)), generator=g,
                    device=dev).bfloat16()
    a = a.T if transposed else a
    b = (torch.randn(K, N, generator=g, device=dev) * 0.1).bfloat16()
    before = mm_f32.tensor_core
    got = mm_f32(a, b)
    ref = a.double() @ b.double()
    torch.cuda.synchronize()
    assert mm_f32.tensor_core == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    err = float((got.double() - ref).abs().max()) / float(ref.abs().max())
    assert err <= CONTRACT_TOL, err


def test_contraction_ignores_the_reduced_precision_flag(dev):
    """cuBLAS reduces in f32 when the output is f32: the bf16 GEMM gives the
    same bits with allow_bf16_reduced_precision_reduction on and off."""
    g = torch.Generator(device=dev).manual_seed(4)
    a = torch.randn(150_001, 300, generator=g, device=dev).bfloat16().T
    b = torch.randn(150_001, 2048, generator=g, device=dev).bfloat16()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        outs = []
        for on in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
            outs.append(mm_f32(a, b))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    assert torch.equal(*outs)


def test_contraction_scores_bf16_matches_float64(dev):
    """The (N, H) x (N, K, H) form of the disc scores, at the flagship eval
    batch (320 rounds x 100 candidates x 512)."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(320, 512, generator=g, device=dev).bfloat16()
    e = torch.randn(320, 100, 512, generator=g, device=dev).bfloat16()
    got = scores_f32(q, e)
    ref = torch.einsum("nh,nkh->nk", q.double(), e.double())
    assert got.dtype == torch.float32 and got.shape == (320, 100)
    assert float((got.double() - ref).abs().max()) <= \
        CONTRACT_TOL * float(ref.abs().max())


def test_contraction_f32_route_is_unchanged(dev):
    """float32 operands on the card keep the f32 product, bit for bit, and
    never reach the tensor-core route; another dtype raises."""
    g = torch.Generator(device=dev).manual_seed(6)
    a = torch.randn(4, 600, 300, generator=g, device=dev)
    b = torch.randn(300, 2048, generator=g, device=dev)
    q, e = a[0], torch.randn(600, 7, 300, generator=g, device=dev)
    before = (mm_f32.tensor_core, scores_f32.tensor_core)
    assert torch.equal(mm_f32(a, b), a @ b)
    assert torch.equal(scores_f32(q, e), torch.einsum("nh,nkh->nk", q, e))
    assert (mm_f32.tensor_core, scores_f32.tensor_core) == before
    with pytest.raises(TypeError, match="float16"):
        mm_f32(a.half(), b.half())


def test_contraction_gradients_are_the_upcast_products(dev):
    """Where autograd differentiates a site (linear, the disc scores), the
    gradients on the tensor-core route are what autograd of the upcast
    product gives: the f32 cotangent times the other operand upcast, cast to
    the operand's dtype (dx, dW bit for bit; the scores' einsum within f32
    rounding)."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(320, 300, generator=g, device=dev).bfloat16()
    p = {"w": torch.randn(300, 512, generator=g, device=dev) * 0.08,
         "b": torch.randn(512, generator=g, device=dev) * 0.1}
    cot = torch.randn(320, 512, generator=g, device=dev)
    grads = []
    for fn in (lambda x, w, b: linear({"w": w, "b": b}, x, torch.float32),
               lambda x, w, b: x.float() @ w.to(x.dtype).float() + b):
        ins = [t.clone().requires_grad_() for t in (x, p["w"], p["b"])]
        grads.append(torch.autograd.grad(fn(*ins), ins, cot))
    for a, r in zip(*grads):
        assert a.dtype == r.dtype and torch.equal(a, r)
    q = torch.randn(64, 512, generator=g, device=dev).bfloat16()
    e = torch.randn(64, 100, 512, generator=g, device=dev).bfloat16()
    cot = torch.randn(64, 100, generator=g, device=dev)
    grads = []
    for fn in (scores_f32,
               lambda q, e: torch.einsum("nh,nkh->nk", q.float(), e.float())):
        ins = [t.clone().requires_grad_() for t in (q, e)]
        grads.append(torch.autograd.grad(fn(*ins), ins, cot))
    for a, r in zip(*grads):
        assert a.dtype == r.dtype == torch.bfloat16
        assert float((a.float() - r.float()).abs().max()) <= \
            2.0 ** -8 * float(r.float().abs().max())


def test_bench_train_row_at_flagship_widths(dev):
    """The bench's headline row (visdial_tpu_torch.bench.bench_train) at the
    flagship widths in bf16, two dispatches a window: an MFU in (0, 1] from
    the counted plain step, and K1, K2 and K3 launched by the timed steps."""
    from visdial_tpu_torch import bench

    cfg = bench.flagship_config()
    before = bench.kernel_launches()
    row = bench.bench_train(cfg, dev, steps=2 * bench.TRAIN_DISPATCH_GROUP,
                            warmup=1)
    launched = {k: n - before[k] for k, n in bench.kernel_launches().items()}
    assert 0 < row["train_mfu"] <= 1
    assert all(launched[k] > 0
               for k in ("lstm_layer", "lstm_layer_bwd", "attention")), launched


# ---------------------------------------------------------------------------
# CUDA graphs (parallel/graph.py, the train factories, the engine's serving)
# ---------------------------------------------------------------------------

GRAPH_GROUP = 8        # steps a dispatch, as the bench's
GRAPH_DISPATCHES = 3


def _stacked(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decoder,batch_size", [("disc", 32), ("gen", 64)])
def test_multistep_graph_equals_eager_steps(dev, decoder, batch_size, dtype,
                                            dropout):
    """make_multistep_train_fn (8 steps, one graph) against multi_train_step
    at the bench's points, flagship widths: 3 dispatches, every loss and
    grad norm, then every param and moment and the CPU generator, bit for
    bit; one capture; the replays' kernel launches counted as eager's.
    Then a state from elsewhere (another init, a resume) is copied into the
    graph's buffers and stepped as eager steps it, bit for bit."""
    from visdial_tpu_torch.bench import kernel_launches
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       make_multistep_train_fn,
                                                       multi_train_step)
    from visdial_tpu_torch.profile_train import flagship_setup
    from visdial_tpu_torch.utils.params import flatten

    cfg, batches, eager = flagship_setup(dev, GRAPH_GROUP, dropout=dropout,
                                         decoder=decoder, compute_dtype=dtype,
                                         batch_size=batch_size)
    stack = _stacked(batches)
    graphed = init_train_state(cfg, device=dev, seed=0)
    fn = make_multistep_train_fn(cfg)
    for _ in range(GRAPH_DISPATCHES):
        before = kernel_launches()
        eager, me = multi_train_step(eager, stack, cfg)
        mid = kernel_launches()
        graphed, mg = fn(graphed, stack)
        after = kernel_launches()
        assert {k: after[k] - mid[k] for k in after} == \
            {k: mid[k] - before[k] for k in after}
        assert torch.equal(me["loss"], mg["loss"])
        assert torch.equal(me["grad_norm"], mg["grad_norm"])
        assert torch.equal(me["lr"], mg["lr"])
        assert torch.equal(me["step"], mg["step"])
    assert fn.captures == 1
    for tree in ("params", "m", "v"):
        get = (lambda s: s.params) if tree == "params" else (
            lambda s: getattr(s.opt, tree))
        for k, v in flatten(get(eager)).items():
            assert torch.equal(flatten(get(graphed))[k], v), (tree, k)
    assert torch.equal(eager.gen.get_state(), graphed.gen.get_state())
    buffers = flatten(graphed.params)
    eager, me = multi_train_step(init_train_state(cfg, device=dev, seed=4),
                                 stack, cfg)
    graphed, mg = fn(init_train_state(cfg, device=dev, seed=4), stack)
    assert fn.captures == 1 and torch.equal(me["loss"], mg["loss"])
    for k, v in flatten(eager.params).items():
        assert flatten(graphed.params)[k] is buffers[k]
        assert torch.equal(flatten(graphed.params)[k], v), k


def test_registered_generators_redraw_the_eager_masks(dev):
    """The dropout mechanism under replay: a captured keep_mask over a
    registered generator, re-seeded before each replay, draws what a fresh
    generator with that seed draws eagerly; two seeds draw different masks;
    the keep share is within 4 sigma of 0.5."""
    from visdial_tpu_torch.models.core import seeded
    from visdial_tpu_torch.ops.lstm import keep_mask
    from visdial_tpu_torch.parallel.graph import Graphed

    shape = (320, 40, 512)
    gen = torch.Generator(device=dev)
    g = Graphed(lambda x: keep_mask(gen, shape, 0.5) & (x > 0))
    x = torch.ones(1, device=dev)
    masks = []
    for seed in (11, 12, 11, 13):
        gen.manual_seed(seed)
        masks.append(g(x, generators=[gen]))
        assert torch.equal(masks[-1], keep_mask(seeded(seed, dev), shape, 0.5))
    assert g.captures == 1
    assert not torch.equal(masks[1], masks[3]) and torch.equal(masks[0],
                                                               masks[2])
    n = masks[1].numel()
    assert abs(float(masks[1].float().mean()) - 0.5) <= 4 * (0.25 / n) ** 0.5


def _small_graph_case(dev, batch_size=8, dropout=0.5):
    """A narrow MN-QIH-disc (the bench's points are held bit for bit in
    test_multistep_graph_equals_eager_steps)."""
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.loader import TrainLoader
    from visdial_tpu_torch.data.synthetic import make_synthetic_split
    from visdial_tpu_torch.models.model import batch_to_device

    cfg = Config(encoder="mn-ques-im-hist", embed_size=32, rnn_hidden_size=64,
                 img_feat_size=64, img_embed_size=32, max_ques_len=6,
                 max_ans_len=5, max_cap_len=8, num_rounds=4, num_options=20,
                 batch_size=batch_size, dropout=dropout, vocab_size=0)
    split, vocab = make_synthetic_split(cfg, num_dialogs=32, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    batches = [batch_to_device(b.as_dict(), dev)
               for b in TrainLoader(split, vocab, cfg).epoch(0)]
    return cfg, batches


def test_train_graph_captures_once_a_signature(dev):
    """make_train_fn: one capture for a run of equal batches, another for a
    new batch shape (whose first call, the warm-up, is train_step's step
    from the state it was given, bit for bit), none for the first shape
    again."""
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       make_train_fn,
                                                       train_step)
    from visdial_tpu_torch.utils.params import flatten

    cfg, batches = _small_graph_case(dev)
    fn = make_train_fn(cfg)
    state = init_train_state(cfg, device=dev)
    for b in batches[:3]:
        state, m = fn(state, b)
    assert fn.captures == 1 and state.opt.step == 3
    small, halves = _small_graph_case(dev, batch_size=4)
    want, wm = train_step(init_train_state(small, device=dev, seed=5),
                          halves[0], small)
    got, gm = fn(init_train_state(small, device=dev, seed=5), halves[0])
    assert fn.captures == 2
    assert torch.equal(gm["loss"], wm["loss"]) and got.opt.step == 1
    for k, v in flatten(want.params).items():
        assert torch.equal(flatten(got.params)[k], v), k
    out, _ = fn(got, batches[1])
    assert fn.captures == 2 and out.opt.step == 2


def test_graph_spans_a_capture_a_signature_and_each_replay(dev):
    """With the port's recorder on: one graph.capture span for each new
    signature, graph.captures following it, and one graph.replay span for
    each replay, graph.replays following it."""
    from visdial_tpu_torch.parallel.graph import Graphed
    from visdial_tpu_torch.utils import trace

    g = Graphed(lambda x: x * 2 + 1)
    trace.start()
    try:
        for n in (8, 8, 8, 16, 8):
            out = g(torch.full((n,), float(n), device=dev))
    finally:
        record = trace.stop()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((8,), 17.0, device=dev))
    names = [record["names"][s[0]] for s in record["spans"]]
    assert names.count("graph.capture") == 2 == g.captures
    assert record["counters"]["graph.captures"] == 2
    assert names.count("graph.replay") == 3 == g.replays
    assert record["counters"]["graph.replays"] == 3


def _bench_batches(dev, decoder, n, remat=False, dropout=0.5, **kw):
    """(cfg, n random batches on the card) at the bench's train point in
    bf16 (flagship widths; disc at batch 32, gen at 64)."""
    from visdial_tpu_torch.bench import flagship_config
    from visdial_tpu_torch.data.synthetic import random_batch
    from visdial_tpu_torch.models.model import batch_to_device

    cfg = flagship_config(decoder=decoder,
                          batch_size=32 if decoder == "disc" else 64)
    cfg = cfg.replace(remat=remat, dropout=dropout, **kw)
    return cfg, [batch_to_device(random_batch(cfg, seed=s), dev)
                 for s in range(n)]


def _assert_states(got, want, what):
    from visdial_tpu_torch.utils.params import flatten

    for tree in ("params", "m", "v"):
        get = (lambda s: s.params) if tree == "params" else (
            lambda s: getattr(s.opt, tree))
        for k, v in flatten(get(want)).items():
            assert torch.equal(flatten(get(got))[k], v), (what, tree, k)
    assert torch.equal(got.gen.get_state(), want.gen.get_state()), what


def test_train_graph_with_remat_equals_eager_remat(dev):
    """make_train_fn under cfg.remat at the bench's disc point (bf16,
    dropout 0.5): three calls against train_step's remat steps bit for bit
    (the recomputation draws from its own registered generator, seeded as
    the encoder's), one capture; at dropout 0 the remat graph equals the
    graph without remat bit for bit."""
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       make_train_fn,
                                                       train_step)

    cfg, batches = _bench_batches(dev, "disc", 3, remat=True)
    fn = make_train_fn(cfg)
    graphed = init_train_state(cfg, device=dev, seed=0)
    eager = init_train_state(cfg, device=dev, seed=0)
    for b in batches:
        graphed, mg = fn(graphed, b)
        eager, me = train_step(eager, b, cfg)
        assert torch.equal(mg["loss"], me["loss"])
        assert torch.equal(mg["grad_norm"], me["grad_norm"])
    assert fn.captures == 1
    _assert_states(graphed, eager, "remat")
    cfg0 = cfg.replace(dropout=0.0)
    states = []
    for remat in (True, False):
        f = make_train_fn(cfg0.replace(remat=remat))
        s = init_train_state(cfg0, device=dev, seed=0)
        for b in batches:
            s, _ = f(s, b)
        states.append(s)
    _assert_states(*states, "remat against no remat at dropout 0")


@pytest.fixture
def nccl_mesh(dev):
    """A NCCL process group of one rank in this process and its (1, 1)
    mesh: every collective a real NCCL call that acts as the identity;
    torn down after the test."""
    import torch.distributed as dist

    from visdial_tpu_torch.parallel.launch import free_port
    from visdial_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, "cuda")
    finally:
        dist.destroy_process_group()


def _counts():
    from visdial_tpu_torch.bench import kernel_launches
    from visdial_tpu_torch.parallel import mesh as mesh_mod

    return {**kernel_launches(), "collectives": mesh_mod.collectives}


def _delta(a, b):
    return {k: b[k] - a[k] for k in a}


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_mesh_graph_equals_eager_mesh_steps(dev, nccl_mesh, decoder, remat):
    """make_multistep_train_fn over a world-1 NCCL mesh (the step's
    all-reduces captured in the graph) against multi_train_step(...,
    mesh=) at the bench's point in bf16, dropout 0.5, 2 steps a dispatch:
    three dispatches' metrics, then the params, moments and CPU generator
    bit for bit; a replay's launches and collectives an eager dispatch's;
    one capture."""
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       make_multistep_train_fn,
                                                       multi_train_step,
                                                       shard_train_state)

    mesh = nccl_mesh
    cfg, batches = _bench_batches(dev, decoder, 2, remat=remat)
    stack = _stacked(batches)
    fn = make_multistep_train_fn(cfg, mesh)
    graphed, eager = (shard_train_state(init_train_state(cfg, device=dev,
                                                         seed=0), cfg, mesh)
                      for _ in range(2))
    for _ in range(3):
        before = _counts()
        graphed, mg = fn(graphed, stack)
        mid = _counts()
        eager, me = multi_train_step(eager, stack, cfg, mesh=mesh)
        after = _counts()
        assert _delta(before, mid) == _delta(mid, after)
        assert _delta(mid, after)["collectives"] > 0
        for k in ("loss", "grad_norm", "lr", "step"):
            assert torch.equal(mg[k], me[k]), k
    assert fn.captures == 1
    _assert_states(graphed, eager, f"mesh {decoder}")


def test_mesh_step_without_round_valid_captures(dev, nccl_mesh):
    """A disc batch with no round_valid key over the world-1 NCCL mesh: the
    loss's count is made on the device (a copy from the host would fail
    the capture), and make_train_fn's graph equals train_step(...,
    mesh=) bit for bit over three calls."""
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       make_train_fn,
                                                       shard_train_state,
                                                       train_step)

    mesh = nccl_mesh
    cfg, batches = _bench_batches(dev, "disc", 3)
    batches = [{k: v for k, v in b.items() if k != "round_valid"}
               for b in batches]
    fn = make_train_fn(cfg, mesh)
    graphed, eager = (shard_train_state(init_train_state(cfg, device=dev,
                                                         seed=0), cfg, mesh)
                      for _ in range(2))
    for b in batches:
        graphed, mg = fn(graphed, b)
        eager, me = train_step(eager, b, cfg, mesh=mesh)
        assert torch.equal(mg["loss"], me["loss"])
    assert fn.captures == 1
    _assert_states(graphed, eager, "without round_valid")


@pytest.mark.parametrize("mesh_shape,decoder,remat", [
    ((2, 1), "disc", False), ((2, 1), "gen", False), ((1, 2), "gen", True)],
    ids=["2x1-disc", "2x1-gen", "1x2-gen-remat"])
def test_two_rank_mesh_graphs_equal_eager(mesh_shape, decoder, remat):
    """Two NCCL ranks on two cards (parallel/launch.py::run_ranks): each
    rank's make_multistep_train_fn graph equals its eager mesh steps bit
    for bit (metrics, collectives, params, moments, generator), one
    capture; on (1, 2) the vocab shard's reductions and remat's
    recomputation inside the graph."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import torch_dist_workers as workers
    from visdial_tpu_torch.parallel.launch import run_ranks

    got = run_ranks(workers.cuda_mesh_graph_steps, 2, mesh_shape, decoder,
                    remat, timeout=600)
    assert got == [(True, 1), (True, 1)]


@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_served_answers_equal_the_eager_path(dev, decoder):
    """InferenceEngine's graphed serve functions against their eager bodies
    and (disc) the eager pool scores' top 5: equal indices and scores,
    tokens and log-probs; one capture a top_k or beam; K1 (and K4 for MN)
    launches counted on every replay."""
    from visdial_tpu_torch.bench import kernel_launches
    from visdial_tpu_torch.data.synthetic import make_synthetic_split
    from visdial_tpu_torch.infer import InferenceEngine
    from visdial_tpu_torch.models.model import model_init

    cfg, _ = _small_graph_case(dev, dropout=0.0)
    cfg = cfg.replace(decoder=decoder)
    split, vocab = make_synthetic_split(cfg, num_dialogs=8, seed=1)
    params = model_init(cfg, seed=3, device=dev)
    eng = InferenceEngine(params=params, cfg=cfg, data=split, vocab=vocab,
                          device=dev)
    queries = [("w002 w001 ?", "w003 w004", [("w001", "w002 w003")]),
               ("w010 w011 ?", "w012", [])]
    for _ in range(2):
        for q, cap, hist in queries:
            batch, t = eng._batch(cap, hist, q, None)
            if decoder == "disc":
                before = kernel_launches()
                got = eng.serve_disc(batch, eng._round(t), 5)
                step = {k: n - before[k] for k, n in kernel_launches().items()}
                want = eng.serve_disc.fn(batch, eng._round(t), 5)
                top_s, top_i = torch.topk(eng.pool_scores(q, cap, hist), 5)
                assert torch.equal(got, want)
                assert torch.equal(got[0].long(), top_i)
                assert torch.equal(got[1], top_s)
                assert step["lstm_layer"] > 0 and step["attention_fusion"] > 0
            else:
                for beam in (0, 5):
                    got = eng.serve_gen(batch, eng._round(t), beam)
                    want = eng.serve_gen.fn(batch, eng._round(t), beam)
                    assert torch.equal(got, want)
    served = eng.serve_disc if decoder == "disc" else eng.serve_gen
    assert served.captures == (1 if decoder == "disc" else 2)


# ---------------------------------------------------------------------------
# The eval dispatch as CUDA graphs (the eval factories, evaluate_split's
# batch graphs, generate's decode, VGG-16's forward)
# ---------------------------------------------------------------------------

def _assert_equal(graphed, eager, what):
    from torch.utils import _pytree as pytree

    a, b = pytree.tree_leaves(graphed), pytree.tree_leaves(eager)
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert torch.equal(x, y), what


def _assert_repeats(fn, what):
    """Two eager runs of fn give equal tensors: at the smoke's shapes these
    paths repeat themselves (its `graphs` phase holds every call to the
    first eager call's outputs), so the graphed path is held to eager bit
    for bit; a narrow train step need not (scripts/graph_determinism.py)."""
    _assert_equal(fn(), fn(), f"{what}: eager does not repeat itself")


def _eval_case(dev, decoder, dtype="bfloat16", batch_size=None):
    """The bench's eval point (flagship widths, random weights from a
    seed; disc at batch 32, gen at bench.GEN_BATCH) and one random batch on
    the card."""
    from visdial_tpu_torch.bench import GEN_BATCH, flagship_config
    from visdial_tpu_torch.data.synthetic import random_batch
    from visdial_tpu_torch.models.model import batch_to_device, model_init

    batch_size = batch_size or (32 if decoder == "disc" else GEN_BATCH)
    cfg = flagship_config(decoder=decoder, batch_size=batch_size,
                          compute_dtype=dtype).replace(dropout=0.0)
    params = model_init(cfg, seed=1, device=dev)
    return cfg, params, batch_to_device(random_batch(cfg, seed=2), dev)


@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_eval_fn_graph_equals_eager(dev, decoder):
    """make_eval_fn's graph against its eager function at the bench's
    point in bf16: three calls (the capture's warm-up, two replays), the
    scores bit for bit (eager repeats itself at this point), one capture,
    the kernels' launches of a replay an eager call's."""
    from visdial_tpu_torch.bench import kernel_launches
    from visdial_tpu_torch.parallel.train_step import make_eval_fn

    cfg, params, batch = _eval_case(dev, decoder)
    fn = make_eval_fn(cfg)
    with torch.inference_mode():
        _assert_repeats(lambda: fn.fn(params, batch), decoder)
    for _ in range(3):
        before = kernel_launches()
        got = fn(params, batch)
        mid = kernel_launches()
        with torch.inference_mode():
            want = fn.fn(params, batch)
        after = kernel_launches()
        assert {k: mid[k] - before[k] for k in mid} == \
            {k: after[k] - mid[k] for k in mid}
        _assert_equal(got, want, decoder)
    assert fn.captures == 1 and mid["lstm_layer"] > before["lstm_layer"]


def test_disc_table_graphs_equal_eager(dev):
    """make_disc_table_eval_fns' two graphs against their eager functions
    at the bench's point in bf16 over its TABLE_ROWS-answer option list,
    called as the bench calls them (the factories' params copy, the table
    read where its graph wrote it, score_fn in the table graph's pool) and
    with the caller's params and a clone of the table: the table and the
    scores bit for bit, one capture each."""
    from visdial_tpu_torch.bench import TABLE_ROWS
    from visdial_tpu_torch.parallel.train_step import make_disc_table_eval_fns

    cfg, params, batch = _eval_case(dev, "disc")
    g = torch.Generator().manual_seed(3)
    opt_list = torch.randint(1, cfg.vocab_size - 3, (TABLE_ROWS,
                                                     cfg.max_ans_len),
                             generator=g).to(dev)
    table_fn, score_fn = make_disc_table_eval_fns(cfg)
    with torch.inference_mode():
        _assert_repeats(lambda: table_fn.fn(params, opt_list), "table")
        want_table = table_fn.fn(params, opt_list)
        want = score_fn.fn(params, want_table, batch)
    p = table_fn.held.load(params)
    for _ in range(2):
        table = table_fn(p, opt_list, clone=False)
        _assert_equal(table, want_table, "table in place")
        _assert_equal(score_fn(p, table, batch), want, "scores in place")
        table = table_fn(params, opt_list)
        _assert_equal(table, want_table, "table")
        _assert_equal(score_fn(params, table, batch), want, "scores")
    assert table_fn.captures == 1 and score_fn.captures == 2


@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_evaluate_split_graphs_equal_eager(dev, decoder, resident):
    """evaluate_split at the bench's eval point in bf16 over 96 dialogs
    (disc 3 batches of 32, gen 2 of 64), through the factories' graphs
    and through their eager functions, in turns: ranks and candidate
    rankings bit for bit (eager repeats itself at this point), the launches
    equal, one capture
    a factory's graph (gen: one row graph a width bucket), one batch graph
    a resident variant.  Memory is the smoke's to hold (graph_turns: a
    graph's pool is invisible to max_memory_allocated)."""
    from visdial_tpu_torch.bench import kernel_launches
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import _GenBucketPlan, evaluate_split
    from visdial_tpu_torch.models.model import model_init
    from visdial_tpu_torch.parallel.train_step import (
        make_disc_table_eval_fns, make_gen_bucket_eval_fns)

    cfg, _, _ = _eval_case(dev, decoder)
    split, vocab = make_random_split(cfg, num_dialogs=96,
                                     num_unique_answers=5000, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=1, device=dev)
    make = (make_disc_table_eval_fns if decoder == "disc"
            else make_gen_bucket_eval_fns)
    key = "table_fns" if decoder == "disc" else "gen_fns"
    graphs = make(cfg)
    paths = {"graph": graphs, "eager": tuple(f.fn for f in graphs)}
    import numpy as np

    outs, launches = {}, {}
    for path in ("eager", "graph", "graph", "eager"):
        before = kernel_launches()
        _, ranks, cand = evaluate_split(
            params, split, vocab, cfg, dev, return_ranks=True,
            collect_rankings=True, resident=resident, **{key: paths[path]})
        launches[path] = {k: n - before[k] for k, n in
                          kernel_launches().items()}
        outs.setdefault(path, []).append((ranks, cand))
    want = outs["eager"][0]
    for got in (outs["eager"][1], *outs["graph"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert launches["graph"] == launches["eager"]
    assert launches["graph"]["lstm_layer"] > 0
    if resident:
        res = next(iter(split._torch_resident_eval.values()))
        assert res.captures == 1 and len(res.keep) == -(-96 // cfg.batch_size)
    else:
        buckets = (len(_GenBucketPlan.cached(split, cfg.batch_size).active)
                   if decoder == "gen" else 1)
        assert [f.captures for f in graphs] == [1, buckets]


@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_mesh_evaluate_split_graphs_equal_eager(dev, nccl_mesh, decoder,
                                                resident):
    """evaluate_split over the world-1 NCCL mesh through the eval factories
    made for it (their graphs) against their eager functions, 96 dialogs
    at the bench's eval point in bf16: ranks and candidate rankings bit
    for bit, launches and collectives equal, the factories captured once
    (gen: a row graph a width bucket)."""
    import numpy as np

    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import _GenBucketPlan, evaluate_split
    from visdial_tpu_torch.models.model import model_init
    from visdial_tpu_torch.parallel.graph import Graphed
    from visdial_tpu_torch.parallel.train_step import (
        make_disc_table_eval_fns, make_gen_bucket_eval_fns)

    mesh = nccl_mesh
    cfg, _, _ = _eval_case(dev, decoder)
    split, vocab = make_random_split(cfg, num_dialogs=96,
                                     num_unique_answers=5000, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=1, device=dev)
    graphs = (make_disc_table_eval_fns if decoder == "disc"
              else make_gen_bucket_eval_fns)(cfg, mesh)
    assert all(isinstance(f, Graphed) for f in graphs)
    key = "table_fns" if decoder == "disc" else "gen_fns"
    paths = {"graph": graphs, "eager": tuple(f.fn for f in graphs)}
    outs, counts = {}, {}
    for path in ("eager", "graph", "graph"):
        before = _counts()
        _, ranks, cand = evaluate_split(
            params, split, vocab, cfg, dev, return_ranks=True,
            collect_rankings=True, resident=resident, mesh=mesh,
            **{key: paths[path]})
        counts[path] = _delta(before, _counts())
        outs.setdefault(path, []).append((ranks, cand))
    for got in outs["graph"]:
        for a, b in zip(got, outs["eager"][0]):
            np.testing.assert_array_equal(a, b)
    assert counts["graph"] == counts["eager"]
    assert counts["graph"]["lstm_layer"] > 0
    if resident:
        res = next(iter(split._torch_resident_eval.values()))
        assert res.captures == 1
    else:
        buckets = (len(_GenBucketPlan.cached(split, cfg.batch_size).active)
                   if decoder == "gen" else 1)
        assert [f.captures for f in graphs] == [1, buckets]


class _EagerDecode:
    """generate's graph replaced by its body under inference mode."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, generators=(), clone=True):
        with torch.inference_mode():
            return self.fn(*args)


@pytest.mark.parametrize("mode", ["greedy", "sample"])
def test_mesh_generate_cli_equals_eager(dev, nccl_mesh, tmp_path,
                                        monkeypatch, mode):
    """The generate CLI in this process under the world-1 NCCL group (its
    own mesh; the decode one graph a batch, the ranks' gather after it),
    flagship MN-QIH-gen from a seeded init over 64 synthetic dialogs, in
    bf16: the JSON equal to the same CLI's with the graph replaced by its
    eager body."""
    import json

    from visdial_tpu_torch import generate
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_synthetic_split
    from visdial_tpu_torch.parallel.train_step import init_train_state
    from visdial_tpu_torch.utils.checkpoint import save_checkpoint

    base = Config(encoder="mn-ques-im-hist", decoder="gen", dropout=0.0,
                  compute_dtype="bfloat16")
    _, vocab = make_synthetic_split(base, num_dialogs=64, seed=base.seed + 1)
    cfg = base.replace(vocab_size=vocab.size)
    ckpt = save_checkpoint(str(tmp_path / "g"),
                           init_train_state(cfg, device=dev), cfg)
    extra = ["--sample", "--seed", "3"] if mode == "sample" else []
    outs = []
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(generate, "InferenceGraphed", _EagerDecode)
        out = str(tmp_path / f"{eager}.json")
        generate.main(["--load_path", ckpt, "--synthetic", "64",
                       "--num_dialogs", "0", "--mesh_data", "1",
                       "--out_path", out, *extra])
        with open(out) as f:
            outs.append(json.load(f))
    assert outs[0] == outs[1]
    assert sum(len(d["rounds"]) for d in outs[0]["dialogs"]) > 0


def test_staged_eval_copies_on_no_capture_stream(dev):
    """The streamed eval's copy stream is never a stream a CUDA graph
    captures on: after the default-priority pool has wrapped round twice
    (64 streams drawn) it is none of them, nor torch.cuda.graph's capture
    stream.  A copy the staging thread queued on the stream the main
    thread captures would join that graph (the capture's thread_local mode
    does not refuse it), and its event would then fail outside it."""
    from visdial_tpu_torch.eval_harness import _Transfer

    drawn = {torch.cuda.Stream(dev).cuda_stream for _ in range(64)}
    capture = torch.cuda.graph(torch.cuda.CUDAGraph()).capture_stream
    copy = _Transfer(torch.device("cuda", 0)).copy
    assert copy.cuda_stream not in drawn | {capture.cuda_stream}


def test_staged_upload_waits_for_a_capture(dev):
    """The staging thread's upload takes graph.CAPTURING, which every
    capture holds: an upload started while it is held finishes only after
    its release, with the batch on the card.  The copy stream is one a
    card, however the card is named."""
    import threading

    from visdial_tpu_torch.eval_harness import _Transfer
    from visdial_tpu_torch.parallel.graph import CAPTURING

    t = _Transfer(torch.device("cuda", 0))
    assert _Transfer(torch.device("cuda")).copy.cuda_stream == \
        t.copy.cuda_stream
    got = []
    with CAPTURING:
        th = threading.Thread(
            target=lambda: got.append(t.upload({"x": [[1, 2, 3], [4, 5, 6]]})))
        th.start()
        th.join(timeout=0.5)
        assert th.is_alive() and not got
    th.join(timeout=30)
    (arrays, done), = got
    t.wait(done)
    assert torch.equal(arrays["x"].cpu(), torch.arange(1, 7).view(2, 3))


def test_sampled_draw_is_torch_multinomial_on_the_card(dev):
    """gen_decode's written-out draw against torch.multinomial on the card:
    the same classes from two generators of one seed, which end in the
    same state."""
    probs = torch.softmax(torch.randn(320, 8848, device=dev) * 3, dim=-1)
    a = torch.Generator(device=dev).manual_seed(7)
    b = torch.Generator(device=dev).manual_seed(7)
    for _ in range(4):
        want = torch.multinomial(probs, 1, generator=a)[:, 0]
        e = torch.empty_like(probs).exponential_(1, generator=b)
        assert torch.equal((probs / e).argmax(dim=-1), want)
    assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize("mode", ["greedy", "beam5", "sample"])
def test_generate_graph_equals_eager(dev, mode):
    """generate's decode (one graph over the params it closes over) against
    its eager body over three batches of 32 dialogs (the smoke's) in bf16:
    tokens and log-probs bit for bit (eager repeats itself there);
    sampled, each path draws from its own generator of one seed (the
    graph's registered), and the two end in the same state."""
    from functools import partial

    from visdial_tpu_torch.data.synthetic import random_batch
    from visdial_tpu_torch.generate import _decode
    from visdial_tpu_torch.models.model import batch_to_device
    from visdial_tpu_torch.parallel.graph import InferenceGraphed

    cfg, params, _ = _eval_case(dev, "gen", batch_size=32)
    batches = [batch_to_device(random_batch(cfg, seed=s), dev)
               for s in range(3)]
    body = partial(_decode, params, cfg)
    graph = InferenceGraphed(body)
    sample, beam = mode == "sample", 5 if mode == "beam5" else 0
    gens = [torch.Generator(device=dev).manual_seed(4) if sample else None
            for _ in range(3)]
    static = (1, 2, not sample, 0.8, beam)
    with torch.inference_mode():
        if sample:
            _assert_repeats(lambda: body(batches[0], *static, torch.Generator(
                device=dev).manual_seed(9)), mode)
        else:
            _assert_repeats(lambda: body(batches[0], *static, None), mode)
    for b in batches:
        got = graph(b, *static, gens[0],
                    generators=[gens[0]] if sample else [])
        with torch.inference_mode():
            want = body(b, *static, gens[1])
        _assert_equal(got, want, mode)
    assert graph.captures == 1
    if sample:
        assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg16_graph_equals_eager(dev, dtype):
    """prepro_img's forward graph (VGG-16 over the params it closes over)
    against vgg16.apply on three batches of 64 seeded images (the smoke's
    batch): fc7 and pool5 bit for bit, one capture."""
    from functools import partial

    from visdial_tpu_torch.models import vgg16
    from visdial_tpu_torch.parallel.graph import Graphed

    params = vgg16.init_params(torch.Generator().manual_seed(0), he=True,
                               dtype=dtype, device=dev)
    g = torch.Generator().manual_seed(1)
    images = [torch.randn(64, 224, 224, 3, generator=g).to(dev)
              for _ in range(3)]
    forward = Graphed(partial(vgg16.apply, params))
    _assert_repeats(lambda: vgg16.apply(params, images[0]), str(dtype))
    for x in images:
        got = forward(x)
        want = vgg16.apply(params, x)
        _assert_equal(got, want, str(dtype))
    assert forward.captures == 1
