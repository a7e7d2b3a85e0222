"""Kernel K1: one masked LSTM layer forward on Hopper (csrc/lstm_fwd.cu).

Counterpart of visdial_tpu/ops/lstm_pallas.py::lstm_layer_pallas.  A CUDA
tensor launches the kernel (or the call raises); a CPU tensor takes the
plain version, ops/lstm.py::lstm_layer_plain.
"""

from __future__ import annotations

import torch

from . import _build
from .lstm import lstm_layer_plain


def lstm_layer(w, b, x, mask, h0, c0):
    """One masked LSTM layer.  w (E+H, 4H) packed [x; h] (cast to x.dtype,
    as the TPU wrapper does), b (4H,), x (N, T, E) float32 or bfloat16,
    mask (N, T), h0/c0 (N, H) float32.  Returns hs (N, T, H) in x.dtype and
    (hT, cT) (N, H) in float32.  `lstm_layer.launches` counts the calls that
    went to the kernel."""
    if x.device.type == "cpu":
        return lstm_layer_plain(w, b, x, mask, h0, c0)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_layer: no kernel for device {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"lstm_layer: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"lstm_layer: x must be a contiguous (N, T, E) tensor, "
                         f"got shape {tuple(x.shape)}")
    N, T, E = x.shape
    H = w.shape[1] // 4
    if T < 1 or N < 1:
        raise ValueError(f"lstm_layer: empty input {tuple(x.shape)}")
    if tuple(w.shape) != (E + H, 4 * H) or tuple(b.shape) != (4 * H,):
        raise ValueError(f"lstm_layer: w {tuple(w.shape)} / b {tuple(b.shape)} "
                         f"do not fit E={E}, H={H}")
    if tuple(mask.shape) != (N, T):
        raise ValueError(f"lstm_layer: mask {tuple(mask.shape)} != {(N, T)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if (tuple(s.shape) != (N, H) or s.dtype != torch.float32
                or not s.is_contiguous()):
            raise ValueError(f"lstm_layer: {name} must be contiguous float32 "
                             f"{(N, H)}, got {s.dtype} {tuple(s.shape)}")
    for t in (mask, w, b, h0, c0):
        if t.device != x.device:
            raise ValueError(f"lstm_layer: operands on {t.device} and {x.device}")
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    mask = mask.float().contiguous()
    hs = torch.empty((N, T, H), dtype=x.dtype, device=x.device)
    hbuf = torch.empty((2, N, H), dtype=torch.float32, device=x.device)
    cbuf = torch.empty_like(hbuf)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lstm_layer_fwd(
            _build.DTYPE_CODE[x.dtype], x.data_ptr(), mask.data_ptr(),
            w.data_ptr(), b.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hbuf.data_ptr(), cbuf.data_ptr(), hs.data_ptr(), N, T, E, H,
            _build.stream_of(x))
    _build.check(err, "lstm_layer")
    lstm_layer.launches += 1
    last = (T - 1) % 2
    return hs, hbuf[last], cbuf[last]


lstm_layer.launches = 0
