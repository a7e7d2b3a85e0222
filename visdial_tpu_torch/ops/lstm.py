"""Masked multi-layer LSTM over time (port of visdial_tpu/ops/lstm.py).

Mask semantics as in the reference: at a padded step the hidden and cell
state carry through unchanged, so "final state" is the state after the last
real token whatever the alignment.  Weights keep the JAX package's packed
layout: per layer W (in+H, 4H) for [x; h] with one bias (4H,), gate order
i, f, g, o (never torch.nn.LSTM's two-bias layout).

Two implementations behind one interface, like the reference's impl switch:
  * impl='plain' — `lstm_layer_plain`, the twin of lstm_pallas.py::_layer_xla
    (a Python loop over time; runs on any device);
  * impl='cuda'  — the K1 kernel, one call per layer (ops/lstm_cuda.py).
Eval only: inter-layer dropout belongs to the training slice.
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


def lstm_layer_plain(w, b, x, mask, h0, c0):
    """Plain PyTorch version of kernel K1 (twin of _layer_xla): one masked
    layer.  x (N, T, E); mask (N, T); h0/c0 (N, H) f32.  Returns hs (N, T, H)
    in x.dtype and (hT, cT) in f32."""
    h, c = h0.float(), c0.float()
    outs = []
    for t in range(x.shape[1]):
        h, c = lstm_cell(w, b, x[:, t], h, c, mask[:, t])
        outs.append(h.to(x.dtype))
    return torch.stack(outs, dim=1), h, c


def masked_lstm(params: dict, x: torch.Tensor, mask: torch.Tensor,
                h0: torch.Tensor | None = None, c0: torch.Tensor | None = None,
                *, impl: str = "plain", dropout_rate: float = 0.0):
    """Run the stacked masked LSTM (lstm.py::masked_lstm).

    x (N, T, E); mask (N, T) 1.0 at real tokens; h0/c0 optional (L, N, H).
    Returns outputs (N, T, H) and (h_final, c_final), each (L, N, H), all in
    x.dtype.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "inter-layer LSTM dropout is training-only and not ported yet "
            "(see ROADMAP.md, queue 1)")
    if impl == "cuda":
        from .lstm_cuda import lstm_layer as layer_fn
    elif impl == "plain":
        layer_fn = lstm_layer_plain
    else:
        raise ValueError(f"impl must be 'plain' or 'cuda', got {impl!r}")
    layers = params["layers"]
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
    return layer_in, (torch.stack(h_fin).to(x.dtype),
                      torch.stack(c_fin).to(x.dtype))
