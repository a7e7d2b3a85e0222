"""Kernel K4: masked slot attention + fusion tail on Hopper
(csrc/attention_fusion.cu).

Counterpart of visdial_tpu/ops/attention_pallas.py::attention_fusion_pallas
(forward only, as the eval path uses it).  A CUDA tensor launches the kernel
(or the call raises); a CPU tensor takes the plain version,
ops/attention.py::attention_fusion_ref.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import attention_fusion_ref

MAX_SLOTS = 64


def attention_fusion(query, slots, valid, fusion_w, fusion_b):
    """joint = tanh([query; attention(query, slots)] @ fusion_w + fusion_b).
    query (B, R, H) and slots (B, S, H) float32 or bfloat16, valid (B, R, S),
    fusion_w (2H, H) (cast to query.dtype), fusion_b (H,).  Returns
    (B, R, H) in query.dtype.  `attention_fusion.launches` counts the calls
    that went to the kernel."""
    if query.device.type == "cpu":
        return attention_fusion_ref(query, slots, valid, fusion_w, fusion_b)
    if query.device.type != "cuda":
        raise ValueError(f"attention_fusion: no kernel for device {query.device}")
    dt = query.dtype
    if dt not in _build.DTYPE_CODE or slots.dtype != dt:
        raise TypeError(f"attention_fusion: query/slots must share float32 or "
                        f"bfloat16, got {dt}/{slots.dtype}")
    if query.dim() != 3 or slots.dim() != 3:
        raise ValueError("attention_fusion: query and slots must be 3-D")
    B, R, H = query.shape
    S = slots.shape[1]
    if tuple(slots.shape) != (B, S, H) or not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"attention_fusion: slots {tuple(slots.shape)} do not "
                         f"fit query {tuple(query.shape)} with 1 <= S <= {MAX_SLOTS}")
    if (tuple(valid.shape) != (B, R, S) or tuple(fusion_w.shape) != (2 * H, H)
            or tuple(fusion_b.shape) != (H,)):
        raise ValueError(f"attention_fusion: valid {tuple(valid.shape)}, "
                         f"fusion_w {tuple(fusion_w.shape)}, fusion_b "
                         f"{tuple(fusion_b.shape)} do not fit B={B} R={R} "
                         f"S={S} H={H}")
    if not (query.is_contiguous() and slots.is_contiguous()):
        raise ValueError("attention_fusion: query and slots must be contiguous")
    for t in (slots, valid, fusion_w, fusion_b):
        if t.device != query.device:
            raise ValueError(f"attention_fusion: operands on {t.device} and "
                             f"{query.device}")
    wf = fusion_w.to(dt).contiguous()
    bias = fusion_b.float().contiguous()
    valid = valid.float().contiguous()
    out = torch.empty_like(query)
    lib = _build.library()
    with torch.cuda.device(query.device):
        err = lib.vd_attention_fusion(
            _build.DTYPE_CODE[dt], query.data_ptr(), slots.data_ptr(),
            valid.data_ptr(), wf.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, R, S, H, _build.stream_of(query))
    _build.check(err, "attention_fusion")
    attention_fusion.launches += 1
    return out


attention_fusion.launches = 0
