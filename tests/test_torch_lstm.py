"""Port's masked LSTM (visdial_tpu_torch/ops/lstm.py) against the JAX
package: the stacked twin masked_lstm(impl='xla') and its gradients, each
layer against the Pallas kernel K1 (with and without save_cell) and the
backward against the Pallas kernel K2, both in interpret mode.  f32, atol
1e-5 for values and 1e-4 for gradients (sums over more terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.ops.lstm import masked_lstm as jax_masked_lstm
from visdial_tpu.ops.lstm_pallas import lstm_layer_bwd_pallas, lstm_layer_pallas
from visdial_tpu_torch.ops.lstm import (keep_mask, lstm_keep_masks,
                                        lstm_layer_bwd_plain, lstm_layer_plain,
                                        masked_lstm)
from visdial_tpu_torch.ops.lstm_cuda import (DH_SPLITS, TILES, LSTMLayerFn,
                                             choice_counters, dh_splits, k_tile,
                                             lstm_layer, lstm_layer_bwd,
                                             lstm_tile, pack_weights, pad_input)
from visdial_tpu_torch.parallel import graph

torch.set_num_threads(1)

N, T, E, H, L = 6, 7, 10, 12, 2
ATOL = 1e-5


def _mask(kind: str, rng) -> np.ndarray:
    lens = np.array([7, 3, 1, 5, 0, 2])           # row 4 is all pad
    steps = np.arange(T)[None]
    if kind == "right":
        m = steps >= (T - lens)[:, None]
    elif kind == "left":
        m = steps < lens[:, None]
    else:                                          # mixed, with interior gaps
        m = rng.random((N, T)) < 0.6
        m[4] = False
    return m.astype(np.float32)


def _case(kind: str, with_state: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    layers = []
    for li in range(L):
        in_dim = E if li == 0 else H
        layers.append({
            "w": rng.uniform(-0.5, 0.5, (in_dim + H, 4 * H)).astype(np.float32),
            "b": rng.uniform(-0.5, 0.5, (4 * H,)).astype(np.float32)})
    x = rng.standard_normal((N, T, E)).astype(np.float32)
    h0 = c0 = None
    if with_state:
        h0 = rng.standard_normal((L, N, H)).astype(np.float32)
        c0 = rng.standard_normal((L, N, H)).astype(np.float32)
    return {"layers": layers}, x, _mask(kind, rng), h0, c0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _port_params(params):
    return {"layers": [{k: torch.from_numpy(v) for k, v in lp.items()}
                       for lp in params["layers"]]}


CASES = [("right", False), ("left", False), ("mixed", False),
         ("right", True), ("left", True), ("mixed", True)]


@pytest.mark.parametrize("kind,with_state", CASES)
def test_masked_lstm_matches_jax_twin(kind, with_state):
    params, x, mask, h0, c0 = _case(kind, with_state)
    want_out, (want_h, want_c) = jax_masked_lstm(
        params, jnp.asarray(x), jnp.asarray(mask),
        None if h0 is None else jnp.asarray(h0),
        None if c0 is None else jnp.asarray(c0), impl="xla")
    out, (h, c) = masked_lstm(_port_params(params), _t(x), _t(mask), _t(h0),
                              _t(c0), impl="plain")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=ATOL)


@pytest.mark.parametrize("kind,with_state", CASES)
def test_layer_matches_pallas_kernel(kind, with_state):
    """Each layer, plain and through the kernel wrapper (which takes the
    plain version for CPU tensors), against K1 in interpret mode."""
    params, x, mask, h0, c0 = _case(kind, with_state, seed=1)
    if h0 is None:
        h0 = c0 = np.zeros((L, N, H), np.float32)
    layer_in = x
    for li, lp in enumerate(params["layers"]):
        want_hs, want_h, want_c = lstm_layer_pallas(
            jnp.asarray(lp["w"]), jnp.asarray(lp["b"]), jnp.asarray(layer_in),
            jnp.asarray(mask), jnp.asarray(h0[li]), jnp.asarray(c0[li]),
            interpret=True)
        args = (_t(lp["w"]), _t(lp["b"]), _t(layer_in), _t(mask),
                _t(h0[li]), _t(c0[li]))
        for fn in (lstm_layer_plain, lstm_layer):
            hs, h, c = fn(*args)
            np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=ATOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)
            np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=ATOL)
        layer_in = np.array(want_hs)


def test_all_pad_rows_carry_initial_state():
    params, x, _, h0, c0 = _case("right", True)
    mask = np.zeros((N, T), np.float32)
    out, (h, c) = masked_lstm(_port_params(params), _t(x), _t(mask), _t(h0),
                              _t(c0))
    np.testing.assert_array_equal(h.numpy(), h0)
    np.testing.assert_array_equal(c.numpy(), c0)
    np.testing.assert_array_equal(out.numpy(), np.repeat(h0[-1][:, None], T, 1))


def test_cuda_impl_on_cpu_tensors_is_the_plain_version():
    """impl='cuda' reaches the kernel wrapper; a CPU tensor takes the plain
    version there and counts no launch."""
    params, x, mask, h0, c0 = _case("mixed", True)
    before = lstm_layer.launches
    got = masked_lstm(_port_params(params), _t(x), _t(mask), _t(h0), _t(c0),
                      impl="cuda")
    want = masked_lstm(_port_params(params), _t(x), _t(mask), _t(h0), _t(c0),
                       impl="plain")
    assert lstm_layer.launches == before
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1][0], want[1][0], rtol=0, atol=0)


def test_wrapper_has_no_silent_fallback():
    """A tensor that is neither on the CPU nor on a GPU is refused, not
    quietly computed by the plain version."""
    x = torch.zeros((N, T, E), device="meta")
    w = torch.zeros((E + H, 4 * H), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        lstm_layer(w, torch.zeros(4 * H), x, torch.ones(N, T),
                   torch.zeros(N, H), torch.zeros(N, H))


def test_dropout_and_unknown_impl_raise():
    """Dropout needs the caller's keep masks (drawn outside the kernels);
    an unknown impl is refused."""
    params, x, mask, _, _ = _case("right", False)
    with pytest.raises(ValueError, match="keep masks"):
        masked_lstm(_port_params(params), _t(x), _t(mask), dropout_rate=0.5)
    with pytest.raises(ValueError, match="impl"):
        masked_lstm(_port_params(params), _t(x), _t(mask), impl="pallas")


def test_inter_layer_dropout_applies_the_keep_masks():
    """Layer 1 sees where(keep, hs_0 / 0.5, 0), on both paths; the masks
    come from the generator in layer order."""
    params, x, mask, h0, c0 = _case("mixed", True)
    p = _port_params(params)
    keep = lstm_keep_masks(torch.Generator().manual_seed(4), L, (N, T, H), 0.5)
    assert len(keep) == L - 1 and keep[0].dtype == torch.bool
    again = keep_mask(torch.Generator().manual_seed(4), (N, T, H), 0.5)
    assert torch.equal(keep[0], again) and 0 < int(keep[0].sum()) < keep[0].numel()
    hs0, _, _ = lstm_layer_plain(p["layers"][0]["w"], p["layers"][0]["b"],
                                 _t(x), _t(mask), _t(h0[0]), _t(c0[0]))
    want = lstm_layer_plain(p["layers"][1]["w"], p["layers"][1]["b"],
                            torch.where(keep[0], hs0 / 0.5, 0.0), _t(mask),
                            _t(h0[1]), _t(c0[1]))
    for impl in ("plain", "cuda"):
        out, (h, c) = masked_lstm(p, _t(x), _t(mask), _t(h0), _t(c0),
                                  impl=impl, dropout_rate=0.5, keep_masks=keep)
        torch.testing.assert_close(out, want[0], rtol=0, atol=0)
        torch.testing.assert_close(h[1], want[1], rtol=0, atol=0)


KINDS_T = [("right", 7), ("left", 7), ("mixed", 7), ("right", 1)]


def _layer_case(kind, steps, seed):
    """One layer's operands at T = steps, with an all-pad row."""
    params, x, mask, h0, c0 = _case(kind, True, seed)
    lp = params["layers"][0]
    return (lp["w"], lp["b"], x[:, :steps].copy(), mask[:, :steps].copy(),
            h0[0], c0[0])


@pytest.mark.parametrize("kind,steps", KINDS_T)
def test_save_cell_matches_pallas_kernel(kind, steps):
    """K1's save_cell output cs: plain version and kernel wrapper (CPU
    tensors: the plain version) against lstm_layer_pallas(save_cell=True)
    in interpret mode."""
    args = _layer_case(kind, steps, 2)
    want = lstm_layer_pallas(*map(jnp.asarray, args), interpret=True,
                             save_cell=True)
    for fn in (lstm_layer_plain, lstm_layer):
        got = fn(*map(_t, args), save_cell=True)
        assert len(got) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def _bwd_case(kind, steps, seed):
    """Forward residuals from K1 (interpret) and random cotangents."""
    w, b, x, mask, h0, c0 = _layer_case(kind, steps, seed)
    hs, cs, _, _ = lstm_layer_pallas(*map(jnp.asarray, (w, b, x, mask, h0, c0)),
                                     interpret=True, save_cell=True)
    hs, cs = np.asarray(hs), np.asarray(cs)
    h_prev = np.concatenate([h0[:, None], hs[:, :-1]], axis=1)
    c_prev = np.concatenate([c0[:, None], cs[:, :-1]], axis=1)
    rng = np.random.default_rng(seed + 10)
    g_hs = rng.standard_normal(hs.shape).astype(np.float32)
    g_ht = rng.standard_normal(h0.shape).astype(np.float32)
    g_ct = rng.standard_normal(c0.shape).astype(np.float32)
    return w, b, x, mask, h_prev, c_prev, g_hs, g_ht, g_ct


@pytest.mark.parametrize("kind,steps", KINDS_T)
def test_bwd_matches_pallas_kernel(kind, steps):
    """K2's plain version, and the kernel wrapper on CPU tensors, against
    lstm_layer_bwd_pallas in interpret mode: dgp, dh0, dc0.  Rows with m=0
    (the all-pad row) must give dgp = 0 exactly."""
    args = _bwd_case(kind, steps, 3)
    want = lstm_layer_bwd_pallas(*map(jnp.asarray, args), interpret=True)
    mask = args[3]
    for fn in (lstm_layer_bwd_plain, lstm_layer_bwd):
        got = fn(*map(_t, args))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
        assert not got[0].numpy()[mask == 0].any()


@pytest.mark.parametrize("kind,with_state", CASES)
def test_layer_fn_grads_match_jax_autodiff(kind, with_state):
    """masked_lstm(impl='cuda') on CPU tensors routes every layer through
    LSTMLayerFn (K1 with cs, then K2 and the dW/db/dx contractions, each in
    its plain version): its gradients w.r.t. every weight, bias, the input
    and the initial state against jax.grad of masked_lstm(impl='xla')."""
    params, x, mask, h0, c0 = _case(kind, True, seed=4)
    rng = np.random.default_rng(5)
    g_out = rng.standard_normal((N, T, H)).astype(np.float32)
    g_h = rng.standard_normal((L, N, H)).astype(np.float32)

    def jloss(params, x, h0, c0):
        out, (h, c) = jax_masked_lstm(params, x, jnp.asarray(mask), h0, c0,
                                      impl="xla")
        return jnp.sum(out * g_out) + jnp.sum(h * g_h) + jnp.sum(c)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(h0),
        jnp.asarray(c0))
    p = {"layers": [{k: torch.from_numpy(v).requires_grad_()
                     for k, v in lp.items()} for lp in params["layers"]]}
    xt, h0t, c0t = (torch.from_numpy(a).requires_grad_() for a in (x, h0, c0))
    out, (h, c) = masked_lstm(p, xt, _t(mask), h0t, c0t, impl="cuda")
    assert out.grad_fn is not None and "LSTMLayerFn" in str(out.grad_fn)
    loss = (out * _t(g_out)).sum() + (h * _t(g_h)).sum() + c.sum()
    leaves = [p["layers"][li][k] for li in range(L) for k in ("w", "b")]
    got = torch.autograd.grad(loss, leaves + [xt, h0t, c0t])
    want_leaves = [want[0]["layers"][li][k] for li in range(L) for k in ("w", "b")]
    for g, w in zip(got, want_leaves + list(want[1:])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_layer_fn_is_used_only_when_a_gradient_is_needed():
    """Serving (no grad) takes K1 without cell states; training takes
    LSTMLayerFn."""
    params, x, mask, h0, c0 = _case("mixed", True)
    p = _port_params(params)
    out, _ = masked_lstm(p, _t(x), _t(mask), impl="cuda")
    assert out.grad_fn is None
    p["layers"][0]["w"].requires_grad_()
    with torch.no_grad():
        out, _ = masked_lstm(p, _t(x), _t(mask), impl="cuda")
    assert out.grad_fn is None
    out, _ = masked_lstm(p, _t(x), _t(mask), impl="cuda")
    assert type(out.grad_fn).__name__.startswith("LSTMLayerFn")
    assert LSTMLayerFn is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,H", [(10, 12), (33, 20), (300, 36)])
def test_packed_operands_give_the_plain_gates(E, H, dtype):
    """The kernels' operands as the wrapper prepares them: x padded to a
    multiple of 8 and laid into the first Kx columns of the A operand, h
    from column Kx, through the K-major gate-interleaved W, by a plain
    matmul; undoing the interleave gives the plain version's gates exactly
    (small integers: every sum is exact)."""
    rng = np.random.default_rng(E + H)
    n = 5
    w = torch.from_numpy(rng.integers(-8, 9, (E + H, 4 * H)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-8, 9, (n, 2, E)).astype(np.float32)).to(dtype)
    h = torch.from_numpy(rng.integers(-8, 9, (n, H)).astype(np.float32)).to(dtype)
    wk, kx, kw = pack_weights(w, E, dtype)
    bk = k_tile(dtype)
    assert bk * x.element_size() == 128
    assert kx % bk == 0 and kx >= E and kw == kx + -(-H // bk) * bk
    assert wk.shape == (4 * H, kw) and wk.dtype == dtype
    xp = pad_input(x)
    assert xp.shape[-1] % 8 == 0 and E <= xp.shape[-1] <= kx
    assert not xp[..., E:].any()
    a = torch.zeros(n, kw)
    a[:, :xp.shape[-1]] = xp[:, 1].float()
    a[:, kx:kx + H] = h.float()
    packed = a @ wk.float().T                     # column 4j + g: gate g of unit j
    gates = packed.reshape(n, H, 4).transpose(1, 2).reshape(n, 4 * H)
    want = torch.cat([x[:, 1], h], dim=-1).float() @ w.to(dtype).float()
    assert torch.equal(gates, want)



@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows", [1, 10, 32, 320, 640, 1696, 8192, 32000])
def test_tile_and_dh_split_run_in_the_fewest_waves(rows, sms):
    """lstm_tile takes the tile whose grid of (4H / BN) x (N / BM) blocks
    runs in the fewest waves (sms x the blocks an SM holds), the narrowest
    of those; dh_splits the most slices whose grid of (H / BN) x (N / BM) x
    S blocks still runs in one wave, each slice holding a k-tile.  At gen's
    640 rows on 132 SMs that is no longer the 256 x 128 tile at S = 1 (48
    and 12 blocks)."""
    h = 512

    def waves(blocks, t):
        return -(-blocks // (sms * t[2]))

    for dtype in (torch.float32, torch.bfloat16):
        tile = lstm_tile(rows, h, dtype, sms)
        w = {t: waves(-(-4 * h // t[1]) * -(-rows // t[0]), t)
             for t in TILES[dtype]}
        assert w[tile] == min(w.values())
        assert all(w[t] > w[tile] for t in TILES[dtype][:TILES[dtype].index(tile)])
        s = dh_splits(rows, h, dtype, tile, sms)
        blocks = -(-h // tile[1]) * -(-rows // tile[0])
        assert s in DH_SPLITS and s <= 4 * h // k_tile(dtype)
        assert waves(blocks * s, tile) == 1 or s == 1
        assert s == DH_SPLITS[-1] or waves(blocks * 2 * s, tile) > 1
    if sms == 132:
        tile = lstm_tile(640, h, torch.bfloat16, sms)
        assert tile[:2] != (256, 128)
        assert dh_splits(640, h, torch.bfloat16, tile, sms) > 1


def test_tile_and_split_counters_are_graph_counters():
    """K1's and K2's tile counters and K2's split counters are integers on
    the wrappers, and parallel/graph.py::counters() lists them, so graph
    replays add them as they add the launches."""
    names = {(n, id(o), a) for n, o, a in graph.counters()}
    want = choice_counters()
    assert {(n, id(o), a) for n, o, a in want} <= names
    attrs = {(o, a) for _, o, a in want}
    for fn in (lstm_layer, lstm_layer_bwd):
        for bm in (64, 128, 256):
            assert (fn, f"tile_{bm}") in attrs
    assert {(lstm_layer_bwd, f"dh_split_{s}") for s in DH_SPLITS} <= attrs
    assert all(isinstance(getattr(o, a), int) for _, o, a in want)
