"""The gen decoder's masked-NLL training loss over the LM head (port of
visdial_tpu/ops/lm_loss.py).

`TokenLogprobFn` is the counterpart of the JAX package's custom-vjp
`_token_logprobs`: its forward is K5 (per-token log p(target), saving the
row logsumexp), its backward K6 (d-logits rebuilt tile by tile from that
logsumexp, in the compute dtype) followed by dx = dlog . W^T,
dW = x^T . dlog and db = sum(dlog) as plain matmuls with f32 results (the
JAX package leaves those three to XLA outside its kernel).  The (N*T, V)
logits never exist in either direction on the card.  On CPU tensors K5 and
K6 take their plain versions (ops/lm_score.py).

`masked_nll_ref` is the materialized-logits twin (the behavior of record).
In bf16 the two differ only by the rounding of d-logits to bf16 before the
dW/dx products, which is part of the contract (lm_score_pallas.py:176).
"""

from __future__ import annotations

import torch

from .lm_score import lm_logits
from .lm_score_cuda import lm_dlogits, lm_token_logprobs_lse


class TokenLogprobFn(torch.autograd.Function):
    """log p(tgt_i | x_i) per row: x (NT, H) in the compute dtype, w (H, V)
    f32 param, b (V,), tgt (NT,) ids.  Returns (NT,) float32; tgt gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, b, tgt):
        logp, lse = lm_token_logprobs_lse(x, w, b, tgt)
        ctx.save_for_backward(x, w, b, tgt, lse)
        return logp

    @staticmethod
    def backward(ctx, g):
        x, w, b, tgt, lse = ctx.saved_tensors
        dlog = lm_dlogits(x, w, b, tgt, lse, g.float().contiguous()).float()
        dx = (dlog @ w.to(x.dtype).float().T).to(x.dtype)
        dw = (x.float().T @ dlog).to(w.dtype)
        db = dlog.sum(dim=0).to(b.dtype)
        return dx, dw, db, None


def _masked_mean(tok_lp: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-mean of tok_lp over the non-pad targets (0 = ignore)."""
    mask = (targets != 0).to(tok_lp.dtype)
    return -(tok_lp * mask).sum() / mask.sum().clamp(min=1.0)


def masked_nll_fused(outs, w, b, targets) -> torch.Tensor:
    """Mean NLL over non-pad targets through TokenLogprobFn (K5 forward, K6
    backward).  outs (N, T, H) LM hidden states in the compute dtype; w (H,
    V) / b (V,) the output projection; targets (N, T) with 0 = ignore."""
    N, T, H = outs.shape
    tgt = targets.reshape(N * T)
    tok_lp = TokenLogprobFn.apply(outs.reshape(N * T, H).contiguous(), w, b, tgt)
    return _masked_mean(tok_lp, tgt)


def masked_nll_ref(outs, w, b, targets) -> torch.Tensor:
    """Materialized-logits twin of masked_nll_fused (lm_loss.py::
    masked_nll_ref)."""
    logp = torch.log_softmax(lm_logits(outs, w, b), dim=-1)
    tok_lp = logp.gather(-1, targets.long()[..., None])[..., 0]
    return _masked_mean(tok_lp, targets)
