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

from visdial_tpu_torch.ops.attention import attention_fusion_ref, attention_plain
from visdial_tpu_torch.ops.attention_cuda import (AttentionFn, attention_fusion,
                                                  masked_slot_attention)
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
# and the question / fact LSTMs' real width
LSTM_CASES = [(5, 7, 10, 12), (70, 3, 33, 40), (200, 4, 20, 36), (600, 5, 20, 36),
              (65, 3, 33, 20), (130, 1, 300, 36), (321, 2, 8, 20),
              (320, 16, 300, 512)]


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
