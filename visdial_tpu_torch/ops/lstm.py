"""Masked multi-layer LSTM over time (port of visdial_tpu/ops/lstm.py).

Mask semantics as in the reference: at a padded step the hidden and cell
state carry through unchanged, so "final state" is the state after the last
real token whatever the alignment.  Weights keep the JAX package's packed
layout: per layer W (in+H, 4H) for [x; h] with one bias (4H,), gate order
i, f, g, o (never torch.nn.LSTM's two-bias layout).

Two implementations behind one interface, like the reference's impl switch:
  * impl='plain' — `lstm_layer_plain`, the twin of lstm_pallas.py::_layer_xla
    (a Python loop over time; runs on any device), differentiated by
    autograd;
  * impl='cuda'  — the K1 kernel, one call per layer, and when a gradient is
    needed `LSTMLayerFn`, whose backward is the K2 kernel (ops/lstm_cuda.py).
`lstm_layer_bwd_plain` is K2's plain version.
"""

from __future__ import annotations

import torch

INIT_SCALE = 0.08


def uniform(gen: torch.Generator, shape, device="cpu",
            scale: float = INIT_SCALE) -> torch.Tensor:
    """uniform(-scale, scale) drawn from `gen` (a CPU generator; on the meta
    device only the shape is made)."""
    return torch.empty(shape, device=device).uniform_(-scale, scale,
                                                      generator=gen)


def lstm_init(gen: torch.Generator, input_size: int, hidden_size: int,
              num_layers: int, device="cpu") -> dict:
    """Per layer W (in+H, 4H) uniform(-0.08, 0.08) and b (4H,) zero with the
    forget-gate bias at 1.0 (lstm.py::lstm_init)."""
    layers = []
    for layer in range(num_layers):
        in_dim = input_size if layer == 0 else hidden_size
        w = uniform(gen, (in_dim + hidden_size, 4 * hidden_size), device)
        b = torch.zeros(4 * hidden_size, device=device)
        b[hidden_size:2 * hidden_size] = 1.0
        layers.append({"w": w, "b": b})
    return {"layers": layers}


def lstm_cell(w, b, x_t, h_prev, c_prev, mask_t):
    """One masked step (lstm.py::lstm_cell) with lstm_pallas.py::_layer_xla's
    numerics: [x_t; h_prev] and W in x_t's dtype, f32 accumulation, f32
    carries.  x_t (N, E), h_prev/c_prev (N, H) f32, mask_t (N,)."""
    dt = x_t.dtype
    zx = torch.cat([x_t, h_prev.to(dt)], dim=-1).float()
    gates = zx @ w.to(dt).float() + b.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c_prev + i * torch.tanh(g)
    h_new = o * torch.tanh(c_new)
    m = mask_t.float()[:, None]
    return m * h_new + (1 - m) * h_prev, m * c_new + (1 - m) * c_prev


def lstm_layer_plain(w, b, x, mask, h0, c0, *, save_cell: bool = False):
    """Plain PyTorch version of kernel K1 (twin of _layer_xla): one masked
    layer.  x (N, T, E); mask (N, T); h0/c0 (N, H) f32.  Returns hs (N, T, H)
    in x.dtype and (hT, cT) in f32; with save_cell (lstm_layer_pallas's
    option) (hs, cs, hT, cT), cs (N, T, H) the post-mask cell states in
    x.dtype."""
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(x.shape[1]):
        h, c = lstm_cell(w, b, x[:, t], h, c, mask[:, t])
        hs.append(h.to(x.dtype))
        if save_cell:
            cs.append(c.to(x.dtype))
    if save_cell:
        return torch.stack(hs, dim=1), torch.stack(cs, dim=1), h, c
    return torch.stack(hs, dim=1), h, c


def lstm_layer_bwd_plain(w, b, x, mask, h_prev, c_prev, g_hs, g_ht, g_ct):
    """Plain PyTorch version of kernel K2 (twin of lstm_pallas.py::
    lstm_layer_bwd_pallas): the reverse-time LSTM backward from the
    forward's residuals.  x (N, T, E), h_prev / c_prev (N, T, H) the states
    that fed each step and g_hs (N, T, H), all in the compute dtype x.dtype;
    g_ht, g_ct (N, H).  Gates are recomputed from x_t and h_prev_t, the
    chain rule runs in f32 with f32 (dh, dc) carries, and dgp is rounded to
    the compute dtype before its product with Wh^T.  Returns dgp (N, T, 4H)
    in x.dtype, dh0 and dc0 (N, H) f32."""
    dt = x.dtype
    E, H = x.shape[-1], w.shape[1] // 4
    wf = w.to(dt).float()
    gates_all = (torch.cat([x, h_prev], dim=-1).float() @ wf + b.float())
    wh_t = wf[E:].T                                            # (4H, H)
    dh, dc = g_ht.float(), g_ct.float()
    dgps = [None] * x.shape[1]
    for t in reversed(range(x.shape[1])):
        i, f, g, o = gates_all[:, t].chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        cp = c_prev[:, t].float()
        tcn = torch.tanh(f * cp + i * g)
        m = mask[:, t].float()[:, None]
        Dh = g_hs[:, t].float() + dh
        dhn = m * Dh
        dcn = m * dc + dhn * o * (1.0 - tcn * tcn)
        dc = (1.0 - m) * dc + dcn * f
        dgp = torch.cat([(dcn * g) * i * (1.0 - i),
                         (dcn * cp) * f * (1.0 - f),
                         (dcn * i) * (1.0 - g * g),
                         (dhn * tcn) * o * (1.0 - o)], dim=-1).to(dt)
        dh = (1.0 - m) * Dh + dgp.float() @ wh_t
        dgps[t] = dgp
    return torch.stack(dgps, dim=1), dh, dc


def keep_mask(gen: torch.Generator, shape, rate: float) -> torch.Tensor:
    """Inverted-dropout keep mask: True with probability 1 - rate, drawn
    from `gen` on gen.device (jax.random.bernoulli in core.py::dropout)."""
    return torch.rand(shape, generator=gen, device=gen.device) < 1.0 - rate


def lstm_keep_masks(gen: torch.Generator, num_layers: int, shape,
                    rate: float) -> list:
    """The inter-layer dropout keep masks of a stacked LSTM: num_layers - 1
    boolean tensors of `shape` (N, T, H), drawn in layer order from `gen` on
    its device (keep_mask), before any layer runs."""
    return [keep_mask(gen, shape, rate) for _ in range(num_layers - 1)]


def lstm_step(params: dict, x_t: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor):
    """One unmasked step through the stacked LSTM (lstm.py::lstm_step, the
    token-by-token decode path; plain PyTorch, as the JAX package runs it
    outside any kernel).  x_t (N, E); h, c (L, N, H).  Returns (top-layer h,
    new h, new c), the states in h's and c's dtypes."""
    ones = torch.ones(x_t.shape[0], device=x_t.device)
    layer_in, hs, cs = x_t, [], []
    for li, lp in enumerate(params["layers"]):
        h_new, c_new = lstm_cell(lp["w"], lp["b"], layer_in, h[li].float(),
                                 c[li].float(), ones)
        hs.append(h_new.to(h.dtype))
        cs.append(c_new.to(c.dtype))
        layer_in = hs[-1]
    return layer_in, torch.stack(hs), torch.stack(cs)


def masked_lstm(params: dict, x: torch.Tensor, mask: torch.Tensor,
                h0: torch.Tensor | None = None, c0: torch.Tensor | None = None,
                *, impl: str = "plain", dropout_rate: float = 0.0,
                keep_masks: list | None = None):
    """Run the stacked masked LSTM (lstm.py::masked_lstm).

    x (N, T, E); mask (N, T) 1.0 at real tokens; h0/c0 optional (L, N, H).
    Returns outputs (N, T, H) and (h_final, c_final), each (L, N, H), all in
    x.dtype.  Inter-layer dropout (lstm.py:127-131): with dropout_rate > 0,
    layer l's outputs become where(keep_masks[l], hs / keep, 0) before layer
    l + 1; the caller draws the masks (lstm_keep_masks), so the kernel path
    and the plain path apply the same ones.  With impl='cuda' a layer runs
    through LSTMLayerFn (K1 saving cell states, K2 backward) when grad mode
    is on and an input requires grad, else through K1 alone.
    """
    layers = params["layers"]
    if dropout_rate > 0.0 and len(layers) > 1 and keep_masks is None:
        raise ValueError("dropout_rate > 0 needs the keep masks "
                         "(lstm_keep_masks)")
    if impl == "cuda":
        from .lstm_cuda import LSTMLayerFn, lstm_layer

        def layer_fn(*args):
            if torch.is_grad_enabled() and any(t.requires_grad for t in args):
                return LSTMLayerFn.apply(*args)
            return lstm_layer(*args)
    elif impl == "plain":
        layer_fn = lstm_layer_plain
    else:
        raise ValueError(f"impl must be 'plain' or 'cuda', got {impl!r}")
    L, N = len(layers), x.shape[0]
    H = layers[0]["w"].shape[1] // 4
    if h0 is None:
        h0 = torch.zeros((L, N, H), device=x.device)
    if c0 is None:
        c0 = torch.zeros((L, N, H), device=x.device)
    mask_f = mask.float()
    layer_in = x
    h_fin, c_fin = [], []
    for li, lp in enumerate(layers):
        layer_in, ht, ct = layer_fn(lp["w"], lp["b"], layer_in, mask_f,
                                    h0[li].float().contiguous(),
                                    c0[li].float().contiguous())
        h_fin.append(ht)
        c_fin.append(ct)
        if li < L - 1 and dropout_rate > 0.0:
            keep = 1.0 - dropout_rate
            layer_in = torch.where(keep_masks[li], layer_in / keep, 0.0)
    return layer_in, (torch.stack(h_fin).to(x.dtype),
                      torch.stack(c_fin).to(x.dtype))
