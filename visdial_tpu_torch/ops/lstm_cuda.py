"""Kernels K1 and K2: one masked LSTM layer forward and backward on Hopper
(csrc/lstm_fwd.cu, csrc/lstm_bwd.cu), and LSTMLayerFn, the autograd
Function that joins them.

Counterparts of visdial_tpu/ops/lstm_pallas.py::lstm_layer_pallas,
lstm_layer_bwd_pallas and the custom-vjp `_layer` (_layer_fwd,
_layer_bwd_kernel_path).  A CUDA tensor launches the kernel (or the call
raises); a CPU tensor takes the plain version (ops/lstm.py::
lstm_layer_plain, lstm_layer_bwd_plain).

One divergence from the JAX package: it engages its backward kernel only
for bf16 on a TPU (_use_bwd_kernel) and otherwise differentiates with the
XLA backward _layer_bwd; the math is the same.  Here LSTMLayerFn takes K2
on CUDA for both float32 and bfloat16.
"""

from __future__ import annotations

import torch

from . import _build
from .contract import mm_f32
from .lstm import lstm_layer_bwd_plain, lstm_layer_plain


def k_tile(dtype: torch.dtype) -> int:
    """Depth of the kernels' k-tiles: 128 bytes of the compute dtype."""
    return 128 // torch.empty((), dtype=dtype).element_size()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_input(x: torch.Tensor) -> torch.Tensor:
    """x (N, T, E) with E zero-padded to a multiple of 8, so that rows start
    16 bytes apart (what the kernels' 16-byte copies take)."""
    E = x.shape[-1]
    pad = _round_up(E, 8) - E
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def pack_weights(w: torch.Tensor, E: int, dtype: torch.dtype):
    """The gate product's B operand from W (E+H, 4H), in `dtype`, K-major:
    wk (4H, KW), row 4j + g of which is gate column g*H + j of W
    (gate-interleaved, so a tile of 4u rows holds all four gates of u
    units); columns [0, E) hold W's x rows, zero-padded to Kx = E rounded up
    to a k-tile, then W's h rows from Kx, zero-padded to KW = Kx + H rounded
    up.  (K2's dh product takes W[E:] as it is stored.)  Returns (wk, Kx,
    KW)."""
    H = w.shape[1] // 4
    bk = k_tile(dtype)
    kx, kh = _round_up(E, bk), _round_up(H, bk)
    w = w.to(dtype)
    wt = w.T.reshape(4, H, E + H).transpose(0, 1).reshape(4 * H, E + H)
    wk = w.new_zeros(4 * H, kx + kh)
    wk[:, :E] = wt[:, :E]
    wk[:, kx:kx + H] = wt[:, E:]
    return wk, kx, kx + kh


def _check_layer(what: str, w, b, x, mask, h0, c0) -> tuple[int, int, int, int]:
    """Validate what K1 and K2 take; returns (N, T, E, H)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (N, T, E) tensor, "
                         f"got shape {tuple(x.shape)}")
    N, T, E = x.shape
    H = w.shape[1] // 4
    if T < 1 or N < 1:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")
    if tuple(w.shape) != (E + H, 4 * H) or tuple(b.shape) != (4 * H,):
        raise ValueError(f"{what}: w {tuple(w.shape)} / b {tuple(b.shape)} "
                         f"do not fit E={E}, H={H}")
    if tuple(mask.shape) != (N, T):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} != {(N, T)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if (tuple(s.shape) != (N, H) or s.dtype != torch.float32
                or not s.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{(N, H)}, got {s.dtype} {tuple(s.shape)}")
    for t in (mask, w, b, h0, c0):
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
    return N, T, E, H


def lstm_layer(w, b, x, mask, h0, c0, *, save_cell: bool = False):
    """One masked LSTM layer (K1).  w (E+H, 4H) packed [x; h] (cast to
    x.dtype, as the TPU wrapper does), b (4H,), x (N, T, E) float32 or
    bfloat16, mask (N, T), h0/c0 (N, H) float32.  Returns hs (N, T, H) in
    x.dtype and (hT, cT) (N, H) in float32; with save_cell (hs, cs, hT, cT),
    cs the post-mask cell state of every step in x.dtype (the training
    forward's residual; without it the kernel writes none).
    `lstm_layer.launches` counts the calls that went to the kernel."""
    if x.device.type == "cpu":
        return lstm_layer_plain(w, b, x, mask, h0, c0, save_cell=save_cell)
    N, T, E, H = _check_layer("lstm_layer", w, b, x, mask, h0, c0)
    wk, kx, kw = pack_weights(w, E, x.dtype)
    xp = pad_input(x)
    b = b.float().contiguous()
    mask = mask.float().contiguous()
    hs = torch.empty((N, T, H), dtype=x.dtype, device=x.device)
    cs = torch.empty_like(hs) if save_cell else None
    h0c = h0.to(x.dtype).contiguous()
    h, c = h0.clone(), c0.clone()      # the carries: (h0, c0) in, (hT, cT) out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lstm_layer_fwd(
            _build.DTYPE_CODE[x.dtype], xp.data_ptr(), mask.data_ptr(),
            wk.data_ptr(), b.data_ptr(), h0c.data_ptr(), h.data_ptr(),
            c.data_ptr(), hs.data_ptr(), cs.data_ptr() if save_cell else None,
            N, T, xp.shape[-1], kx, kw, H, _build.stream_of(x))
    _build.check(err, "lstm_layer")
    lstm_layer.launches += 1
    if save_cell:
        return hs, cs, h, c
    return hs, h, c


lstm_layer.launches = 0


def lstm_layer_bwd(w, b, x, mask, h_prev, c_prev, g_hs, g_ht, g_ct):
    """One masked LSTM layer backward (K2), the twin of
    lstm_layer_bwd_pallas.  x, h_prev, c_prev and g_hs (N, T, ·) share the
    compute dtype (float32 or bfloat16); h_prev / c_prev hold the state
    that fed each step ([h0; hs[:, :-1]], [c0; cs[:, :-1]]); g_ht, g_ct
    (N, H).  Returns dgp (N, T, 4H) in the compute dtype (the gate
    pre-activation grads), dh0 and dc0 (N, H) float32.
    `lstm_layer_bwd.launches` counts the calls that went to the kernel."""
    if x.device.type == "cpu":
        return lstm_layer_bwd_plain(w, b, x, mask, h_prev, c_prev, g_hs, g_ht,
                                    g_ct)
    dh = g_ht.float().contiguous().clone()   # the carries: (g_hT, g_cT) in,
    dc = g_ct.float().contiguous().clone()   # (dh0, dc0) out
    N, T, E, H = _check_layer("lstm_layer_bwd", w, b, x, mask, dh, dc)
    for name, s in (("h_prev", h_prev), ("c_prev", c_prev), ("g_hs", g_hs)):
        if (tuple(s.shape) != (N, T, H) or s.dtype != x.dtype
                or not s.is_contiguous() or s.device != x.device):
            raise ValueError(f"lstm_layer_bwd: {name} must be a contiguous "
                             f"{x.dtype} {(N, T, H)} on {x.device}, got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")
    wk, kx, kw = pack_weights(w, E, x.dtype)
    wh = w.to(x.dtype)[E:].contiguous()
    xp = pad_input(x)
    b = b.float().contiguous()
    mask = mask.float().contiguous()
    dgp = torch.empty((N, T, 4 * H), dtype=x.dtype, device=x.device)
    # K2's dh product is cut over K into S slices, each writing its partial
    # product to its own buffer (S = 8 up to the kernel's 512-row tiles,
    # where the row tiles alone leave most of the card idle)
    dhp = torch.zeros((8 if N <= 512 else 1, N, H), dtype=torch.float32,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lstm_layer_bwd(
            _build.DTYPE_CODE[x.dtype], xp.data_ptr(), h_prev.data_ptr(),
            c_prev.data_ptr(), mask.data_ptr(), wk.data_ptr(), wh.data_ptr(),
            b.data_ptr(), g_hs.data_ptr(), dh.data_ptr(), dc.data_ptr(),
            dhp.data_ptr(), dgp.data_ptr(), N, T, xp.shape[-1], kx, kw, H,
            dhp.shape[0], _build.stream_of(x))
    _build.check(err, "lstm_layer_bwd")
    lstm_layer_bwd.launches += 1
    return dgp, dh + dhp.sum(dim=0), dc


lstm_layer_bwd.launches = 0


class LSTMLayerFn(torch.autograd.Function):
    """One masked LSTM layer with a kernel backward (lstm_pallas.py::_layer
    with _layer_fwd and _layer_bwd_kernel_path).

    forward(w, b, x, mask, h0, c0) -> (hs, hT, cT) runs K1 saving the cell
    states.  backward runs K2 on the residuals, then the dW, db and dx
    contractions over all N*T rows as matmuls of compute-dtype operands
    with f32 results (ops/contract.py; the JAX package leaves them to XLA
    outside its kernel).  On CPU tensors both directions take the plain
    versions of K1 and K2."""

    @staticmethod
    def forward(ctx, w, b, x, mask, h0, c0):
        hs, cs, ht, ct = lstm_layer(w, b, x, mask, h0, c0, save_cell=True)
        ctx.save_for_backward(w, b, x, mask, h0, c0, hs, cs)
        return hs, ht, ct

    @staticmethod
    def backward(ctx, g_hs, g_ht, g_ct):
        w, b, x, mask, h0, c0, hs, cs = ctx.saved_tensors
        N, T, E = x.shape
        H = w.shape[1] // 4
        cdt = x.dtype
        # unused outputs arrive as zeros (materialized grads)
        h_prev = torch.cat([h0.to(cdt)[:, None], hs[:, :-1]], dim=1)
        c_prev = torch.cat([c0.to(cdt)[:, None], cs[:, :-1]], dim=1)
        dgp, dh0, dc0 = lstm_layer_bwd(w, b, x, mask, h_prev, c_prev,
                                       g_hs.to(cdt).contiguous(), g_ht, g_ct)
        # the reference's bf16 x bf16 -> f32 dots (ops/contract.py): dgp
        # stays in the compute dtype, with no f32 copy of it
        dgp_flat = dgp.reshape(N * T, 4 * H)
        dwx = mm_f32(x.reshape(N * T, E).T, dgp_flat)
        dwh = mm_f32(h_prev.reshape(N * T, H).T, dgp_flat)
        dw = torch.cat([dwx, dwh], dim=0).to(w.dtype)
        db = dgp_flat.sum(dim=0, dtype=torch.float32).to(b.dtype)
        dx = mm_f32(dgp_flat, w[:E].to(cdt).T).reshape(N, T, E).to(cdt)
        return dw, db, dx, None, dh0.to(h0.dtype), dc0.to(c0.dtype)
