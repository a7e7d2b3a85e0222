"""Masked attention over dialog-round memory slots (port of
visdial_tpu/ops/attention.py and of attention_pallas.py's plain twins).

Scores are unscaled dot products, masked to -1e30 where a slot is not
visible, so a round with no visible slot attends uniformly.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _weights(query, slots, valid) -> torch.Tensor:
    """f32 softmax weights (B, R, S) of the masked unscaled scores."""
    scores = torch.einsum("brh,bsh->brs", query.float(), slots.float())
    scores = torch.where(valid > 0, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1)


def masked_slot_attention(query: torch.Tensor, slots: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Attention-weighted slot sum (attention.py::masked_slot_attention,
    impl='xla').  query (B, R, H), slots (B, S, H), valid (B, R, S) 1.0
    where slot s is visible to round r.  Returns (B, R, H) in query.dtype."""
    att = _weights(query, slots, valid)
    mem = torch.einsum("brs,bsh->brh", att.to(slots.dtype).float(),
                       slots.float())
    return mem.to(query.dtype)


def attention_plain(query: torch.Tensor, slots: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K3 (attention_pallas.py::
    _attention_ref): f32 scores, softmax and weighted sum (the weights are
    not rounded to the slots' dtype), out in query.dtype.  Differentiable;
    K3's backward is this function's vjp."""
    att = _weights(query, slots, valid)
    return torch.einsum("brs,bsh->brh", att, slots.float()).to(query.dtype)


def fusion_preactivation(query, mem, fusion_w, fusion_b):
    """K4's pre-activation: [query; mem] (N, 2H) in their dtype times
    fusion_w rounded to that dtype, in f32, plus fusion_b."""
    cat = torch.cat([query, mem], dim=-1)
    return cat.float() @ fusion_w.to(cat.dtype).float() + fusion_b.float()


def attention_fusion_ref(query, slots, valid, fusion_w, fusion_b):
    """Plain PyTorch version of kernel K4 (attention_pallas.py::
    _attention_fusion_ref): attention -> concat -> linear -> tanh.
    fusion_w (2H, H) rows [query half; memory half], fusion_b (H,)."""
    B, R, H = query.shape
    mem = attention_plain(query, slots, valid)
    pre = fusion_preactivation(query.reshape(-1, H), mem.reshape(-1, H),
                               fusion_w, fusion_b)
    return torch.tanh(pre).reshape(B, R, H).to(query.dtype)
