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

On a model axis (parallel/mesh.py) w and b hold this rank's vocab columns
(a VocabShard): K5 runs on the shard with the targets re-based to it and -1
for a target in another shard; the global logsumexp combines every shard's
and the target logit comes from its owner (logp + lse there, 0 elsewhere),
both gathered over the model group (combine_shards).  The backward runs K6 on
the shard with the global logsumexp; dx is summed over the model group and
dW, db stay the shard's own.
"""

from __future__ import annotations

import torch

from .lm_score import (lm_dlogits_plain, lm_logits,
                       lm_token_logprobs_lse_plain)
from .lm_score_cuda import lm_dlogits, lm_token_logprobs_lse


def target_logit(logp, lse, local):
    """A shard's part of the target logit: logp + lse (the logit) where the
    shard holds the target (local >= 0), else 0."""
    return torch.where(local >= 0, logp + lse, 0.0)


def combine_shards(lses: torch.Tensor, target_logits: torch.Tensor):
    """(logp, lse) over the whole vocab from every shard's (M, NT) row
    logsumexp and target_logit."""
    lse = torch.logsumexp(lses, dim=0)
    return target_logits.sum(dim=0) - lse, lse


def token_logprobs(x, w, b, tgt, shard=None, plain: bool = False):
    """(logp, lse, the targets as K5/K6 take them): per-row log p(tgt | x)
    and the row logsumexp over the whole vocab, each (NT,) float32, through
    K5 (its plain version with `plain`), on `shard`'s columns where given."""
    score = lm_token_logprobs_lse_plain if plain else lm_token_logprobs_lse
    if shard is None:
        logp, lse = score(x, w, b, tgt)
        return logp, lse, tgt
    local = shard.local_ids(tgt)
    logp, lse = score(x, w, b, local)
    logp, lse = combine_shards(shard.gather(lse),
                               shard.gather(target_logit(logp, lse, local)))
    return logp, lse, local


class TokenLogprobFn(torch.autograd.Function):
    """log p(tgt_i | x_i) per row: x (NT, H) in the compute dtype, w (H, V)
    f32 param, b (V,), tgt (NT,) ids; on `shard`'s vocab columns where
    given, through the plain versions with `plain`.  Returns (NT,) float32;
    tgt gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, b, tgt, shard=None, plain=False):
        logp, lse, tgt = token_logprobs(x, w, b, tgt, shard, plain)
        ctx.save_for_backward(x, w, b, tgt, lse)
        ctx.shard, ctx.plain = shard, plain
        return logp

    @staticmethod
    def backward(ctx, g):
        x, w, b, tgt, lse = ctx.saved_tensors
        dlogits = lm_dlogits_plain if ctx.plain else lm_dlogits
        dlog = dlogits(x, w, b, tgt, lse, g.float().contiguous()).float()
        dx = dlog @ w.to(x.dtype).float().T
        if ctx.shard is not None:
            dx = ctx.shard.sum(dx)
        dw = (x.float().T @ dlog).to(w.dtype)
        db = dlog.sum(dim=0).to(b.dtype)
        return dx.to(x.dtype), dw, db, None, None, None


def _masked_mean(tok_lp: torch.Tensor, targets: torch.Tensor,
                 denominator=None) -> torch.Tensor:
    """-mean of tok_lp over the non-pad targets (0 = ignore); the count is
    denominator(this batch's count) where given (the global batch's, on a
    data axis)."""
    mask = (targets != 0).to(tok_lp.dtype)
    count = mask.sum() if denominator is None else denominator(mask.sum())
    return -(tok_lp * mask).sum() / count.clamp(min=1.0)


def masked_nll_fused(outs, w, b, targets, denominator=None, shard=None,
                     plain: bool = False) -> torch.Tensor:
    """Mean NLL over non-pad targets through TokenLogprobFn (K5 forward, K6
    backward).  outs (N, T, H) LM hidden states in the compute dtype; w (H,
    V) / b (V,) the output projection (or `shard`'s columns of it); targets
    (N, T) with 0 = ignore."""
    N, T, H = outs.shape
    tgt = targets.reshape(N * T)
    tok_lp = TokenLogprobFn.apply(outs.reshape(N * T, H).contiguous(), w, b,
                                  tgt, shard, plain)
    return _masked_mean(tok_lp, tgt, denominator)


def masked_nll_ref(outs, w, b, targets, denominator=None) -> torch.Tensor:
    """Materialized-logits twin of masked_nll_fused (lm_loss.py::
    masked_nll_ref)."""
    logp = torch.log_softmax(lm_logits(outs, w, b), dim=-1)
    tok_lp = logp.gather(-1, targets.long()[..., None])[..., 0]
    return _masked_mean(tok_lp, targets, denominator)
