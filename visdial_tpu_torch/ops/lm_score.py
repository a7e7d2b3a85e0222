"""Plain PyTorch versions of kernels K5 and K6, the gen decoder's LM head
(twins of visdial_tpu/ops/lm_score_pallas.py).

K5 gives, per row of LM hidden states, log p(target) and the row's
logsumexp; K6 the d-logits of the training loss, rebuilt from that
logsumexp.  Numerics as in the TPU kernels: W cast to x's dtype, products
accumulated in f32, the bias in f32, K6's result in x's dtype.  These
versions materialize the (NT, V) f32 logits, which the kernels
(ops/lm_score_cuda.py, csrc/lm_score.cu) never do.
"""

from __future__ import annotations

import torch


def lm_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(NT, V) float32 logits x . W + b, W cast to x.dtype, f32 products."""
    return x.float() @ w.to(x.dtype).float() + b.float()


def lm_token_logprobs_lse_plain(x, w, b, tgt):
    """Plain version of K5 (twin of lm_token_logprobs_lse_pallas).  x (NT, H)
    in the compute dtype, w (H, V), b (V,), tgt (NT,) target ids.  Returns
    (logp, lse), each (NT,) float32."""
    logits = lm_logits(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    return logits.gather(1, tgt.long()[:, None])[:, 0] - lse, lse


def lm_dlogits_plain(x, w, b, tgt, lse, g):
    """Plain version of K6 (twin of lm_dlogits_pallas): d logits (NT, V) =
    g_i (onehot(tgt_i) - exp(logits_i - lse_i)) in x.dtype.  lse and g are
    (NT,) float32 (the saved row logsumexp and the cotangent of logp)."""
    logits = lm_logits(x, w, b)
    d = -torch.exp(logits - lse.float()[:, None])
    d.scatter_add_(1, tgt.long()[:, None], torch.ones_like(d[:, :1]))
    return (g.float()[:, None] * d).to(x.dtype)
