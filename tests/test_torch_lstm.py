"""Port's masked LSTM (visdial_tpu_torch/ops/lstm.py) against the JAX
package: the stacked twin masked_lstm(impl='xla'), and each layer against
the Pallas kernel K1 in interpret mode.  f32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.ops.lstm import masked_lstm as jax_masked_lstm
from visdial_tpu.ops.lstm_pallas import lstm_layer_pallas
from visdial_tpu_torch.ops.lstm import lstm_layer_plain, masked_lstm
from visdial_tpu_torch.ops.lstm_cuda import lstm_layer

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
    params, x, mask, _, _ = _case("right", False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        masked_lstm(_port_params(params), _t(x), _t(mask), dropout_rate=0.5)
    with pytest.raises(ValueError, match="impl"):
        masked_lstm(_port_params(params), _t(x), _t(mask), impl="pallas")
