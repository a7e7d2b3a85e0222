"""Kernels K3 and K4 on Hopper (csrc/attention_fusion.cu): masked slot
attention alone (K3, the training path) and with the fusion tail (K4, the
eval path).

Counterparts of visdial_tpu/ops/attention_pallas.py::
masked_slot_attention_pallas (custom-vjp `_attention`) and
attention_fusion_pallas (forward only, as the eval path uses it).  A CUDA
tensor launches the kernel (or the call raises); a CPU tensor takes the
plain version, ops/attention.py::attention_plain / attention_fusion_ref.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import attention_fusion_ref, attention_plain

MAX_SLOTS = 64


def _check(what: str, query, slots, valid, *others) -> tuple[int, int, int, int]:
    """Validate what K3 and K4 take; returns (B, R, S, H)."""
    if query.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {query.device}")
    dt = query.dtype
    if dt not in _build.DTYPE_CODE or slots.dtype != dt:
        raise TypeError(f"{what}: query/slots must share float32 or "
                        f"bfloat16, got {dt}/{slots.dtype}")
    if query.dim() != 3 or slots.dim() != 3:
        raise ValueError(f"{what}: query and slots must be 3-D")
    B, R, H = query.shape
    S = slots.shape[1]
    if tuple(slots.shape) != (B, S, H) or not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"{what}: slots {tuple(slots.shape)} do not fit "
                         f"query {tuple(query.shape)} with 1 <= S <= {MAX_SLOTS}")
    if tuple(valid.shape) != (B, R, S):
        raise ValueError(f"{what}: valid {tuple(valid.shape)} != {(B, R, S)}")
    if not (query.is_contiguous() and slots.is_contiguous()):
        raise ValueError(f"{what}: query and slots must be contiguous")
    for t in (slots, valid, *others):
        if t.device != query.device:
            raise ValueError(f"{what}: operands on {t.device} and {query.device}")
    return B, R, S, H


def masked_slot_attention(query, slots, valid):
    """Attention-weighted slot sum (K3): query (B, R, H) and slots (B, S, H)
    float32 or bfloat16, valid (B, R, S) 1.0 where slot s is visible to
    round r.  Returns (B, R, H) in query.dtype, f32 math inside.  Forward
    only; AttentionFn adds the gradient.  `masked_slot_attention.launches`
    counts the calls that went to the kernel."""
    if query.device.type == "cpu":
        return attention_plain(query, slots, valid)
    B, R, S, H = _check("masked_slot_attention", query, slots, valid)
    valid = valid.float().contiguous()
    out = torch.empty_like(query)
    lib = _build.library()
    with torch.cuda.device(query.device):
        err = lib.vd_attention(
            _build.DTYPE_CODE[query.dtype], query.data_ptr(), slots.data_ptr(),
            valid.data_ptr(), out.data_ptr(), B, R, S, H,
            _build.stream_of(query))
    _build.check(err, "masked_slot_attention")
    masked_slot_attention.launches += 1
    return out


masked_slot_attention.launches = 0


class AttentionFn(torch.autograd.Function):
    """K3 with a gradient (attention_pallas.py::_attention with
    _attention_fwd / _attention_bwd): the forward is the kernel; the backward
    recomputes the plain version and returns its vjp, as the JAX package
    does (K3 has no backward kernel there either).  valid gets no grad."""

    @staticmethod
    def forward(ctx, query, slots, valid):
        ctx.save_for_backward(query, slots, valid)
        return masked_slot_attention(query, slots, valid)

    @staticmethod
    def backward(ctx, g):
        query, slots, valid = ctx.saved_tensors
        with torch.enable_grad():
            q = query.detach().requires_grad_()
            s = slots.detach().requires_grad_()
            dq, ds = torch.autograd.grad(attention_plain(q, s, valid), (q, s), g)
        return dq, ds, None


def attention_fusion(query, slots, valid, fusion_w, fusion_b):
    """joint = tanh([query; attention(query, slots)] @ fusion_w + fusion_b)
    (K4).  query (B, R, H) and slots (B, S, H) float32 or bfloat16, valid
    (B, R, S), fusion_w (2H, H) (cast to query.dtype), fusion_b (H,).
    Returns (B, R, H) in query.dtype.  Forward only (the eval path).
    `attention_fusion.launches` counts the calls that went to the kernel."""
    if query.device.type == "cpu":
        return attention_fusion_ref(query, slots, valid, fusion_w, fusion_b)
    B, R, S, H = _check("attention_fusion", query, slots, valid, fusion_w,
                        fusion_b)
    if tuple(fusion_w.shape) != (2 * H, H) or tuple(fusion_b.shape) != (H,):
        raise ValueError(f"attention_fusion: fusion_w {tuple(fusion_w.shape)}, "
                         f"fusion_b {tuple(fusion_b.shape)} do not fit H={H}")
    wf = fusion_w.to(query.dtype).contiguous()
    bias = fusion_b.float().contiguous()
    valid = valid.float().contiguous()
    out = torch.empty_like(query)
    lib = _build.library()
    with torch.cuda.device(query.device):
        err = lib.vd_attention_fusion(
            _build.DTYPE_CODE[query.dtype], query.data_ptr(), slots.data_ptr(),
            valid.data_ptr(), wf.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, R, S, H, _build.stream_of(query))
    _build.check(err, "attention_fusion")
    attention_fusion.launches += 1
    return out


attention_fusion.launches = 0
