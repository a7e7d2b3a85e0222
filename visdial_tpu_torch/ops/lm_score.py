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


def _in_vocab(tgt: torch.Tensor, V: int):
    """(tgt clamped into [0, V) as int64, whether tgt was inside).  A target
    outside [0, V) lies in another rank's vocab shard (ops/lm_loss.py)."""
    tgt = tgt.long()
    return tgt.clamp(0, V - 1), (tgt >= 0) & (tgt < V)


def lm_token_logprobs_lse_plain(x, w, b, tgt):
    """Plain version of K5 (twin of lm_token_logprobs_lse_pallas).  x (NT, H)
    in the compute dtype, w (H, V), b (V,), tgt (NT,) target ids.  Returns
    (logp, lse), each (NT,) float32; a target outside [0, V) has no target
    logit (logp = -lse), as in the kernel."""
    logits = lm_logits(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    col, inside = _in_vocab(tgt, logits.shape[1])
    tl = logits.gather(1, col[:, None])[:, 0]
    return torch.where(inside, tl, 0.0) - lse, lse


def lm_dlogits_plain(x, w, b, tgt, lse, g):
    """Plain version of K6 (twin of lm_dlogits_pallas): d logits (NT, V) =
    g_i (onehot(tgt_i) - exp(logits_i - lse_i)) in x.dtype.  lse and g are
    (NT,) float32 (the saved row logsumexp and the cotangent of logp); a
    target outside [0, V) has no one-hot term."""
    logits = lm_logits(x, w, b)
    d = -torch.exp(logits - lse.float()[:, None])
    col, inside = _in_vocab(tgt, logits.shape[1])
    d.scatter_add_(1, col[:, None], inside.to(d.dtype)[:, None])
    return (g.float()[:, None] * d).to(x.dtype)
