"""Kernels K5 and K6 on Hopper (csrc/lm_score.cu): the gen decoder's LM
head, per-token target log-probabilities with the row logsumexp (K5) and
the d-logits of the training loss (K6), without materializing the logits.

Counterparts of visdial_tpu/ops/lm_score_pallas.py::
lm_token_logprobs_lse_pallas and lm_dlogits_pallas.  A CUDA tensor
launches the kernel (or the call raises); a CPU tensor takes the plain
version (ops/lm_score.py).
"""

from __future__ import annotations

import torch

from . import _build
from .lm_score import lm_dlogits_plain, lm_token_logprobs_lse_plain

VOCAB_TILE = 128     # csrc/lm_score.cu's BN: vocab columns per tile
ROW_TILE = 64        # csrc/lm_score.cu's BM
BLOCKS_PER_SM = 4    # K5's vocab split aims at this many blocks per SM


def vocab_splits(NT: int, V: int, sms: int) -> tuple[int, int]:
    """(splits, tiles_per_split) for K5's first pass: enough vocab splits
    that the (row tiles x splits) grid puts about BLOCKS_PER_SM blocks on
    each of `sms` SMs, every split a non-empty range of vocab tiles."""
    n_vt = -(-V // VOCAB_TILE)
    row_tiles = -(-NT // ROW_TILE)
    want = min(n_vt, max(1, -(-BLOCKS_PER_SM * sms // row_tiles)))
    per = -(-n_vt // want)
    return -(-n_vt // per), per


def _check(what: str, x, w, b, tgt, *rows) -> tuple[int, int, int]:
    """Validate what K5 and K6 take; returns (NT, H, V)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous (NT, H) tensor, got "
                         f"shape {tuple(x.shape)}")
    NT, H = x.shape
    if NT < 1 or H < 1 or w.dim() != 2 or w.shape[0] != H:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "do not fit (NT, H) x (H, V)")
    V = w.shape[1]
    if tuple(b.shape) != (V,):
        raise ValueError(f"{what}: b {tuple(b.shape)} != {(V,)}")
    for name, t in (("tgt", tgt), *rows):
        if tuple(t.shape) != (NT,):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != {(NT,)}")
    for t in (w, b, tgt, *(t for _, t in rows)):
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
    return NT, H, V


def lm_token_logprobs_lse(x, w, b, tgt):
    """Per-row log p(tgt | x) and row logsumexp (K5).  x (NT, H) float32 or
    bfloat16 LM hidden states, w (H, V) (cast to x.dtype, as the TPU wrapper
    does), b (V,), tgt (NT,) target ids.  Returns (logp, lse), each (NT,)
    float32.  `lm_token_logprobs_lse.launches` counts the calls that went
    to the kernel."""
    if x.device.type == "cpu":
        return lm_token_logprobs_lse_plain(x, w, b, tgt)
    NT, H, V = _check("lm_token_logprobs_lse", x, w, b, tgt)
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    tgt = tgt.to(torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per = vocab_splits(NT, V, sms)
    part = torch.empty((splits, NT, 3), dtype=torch.float32, device=x.device)
    logp = torch.empty(NT, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(logp)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lm_score(
            _build.DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            tgt.data_ptr(), part.data_ptr(), logp.data_ptr(), lse.data_ptr(),
            NT, H, V, per, splits, _build.stream_of(x))
    _build.check(err, "lm_token_logprobs_lse")
    lm_token_logprobs_lse.launches += 1
    return logp, lse


lm_token_logprobs_lse.launches = 0


def lm_dlogits(x, w, b, tgt, lse, g):
    """d logits (NT, V) in x.dtype of the per-row target log-probability
    (K6): g_i (onehot(tgt_i) - exp(logits_i - lse_i)), the logits recomputed
    from x and w.  lse (NT,) the forward's row logsumexp, g (NT,) the
    cotangent of logp; other operands as lm_token_logprobs_lse.
    `lm_dlogits.launches` counts the calls that went to the kernel."""
    if x.device.type == "cpu":
        return lm_dlogits_plain(x, w, b, tgt, lse, g)
    NT, H, V = _check("lm_dlogits", x, w, b, tgt, ("lse", lse), ("g", g))
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    tgt = tgt.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    dlog = torch.empty((NT, V), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lm_dlogits(
            _build.DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
            tgt.data_ptr(), lse.data_ptr(), g.data_ptr(), dlog.data_ptr(),
            NT, H, V, _build.stream_of(x))
    _build.check(err, "lm_dlogits")
    lm_dlogits.launches += 1
    return dlog


lm_dlogits.launches = 0
