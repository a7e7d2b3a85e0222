"""Kernels K5 and K6 on Hopper (csrc/lm_score.cu): the gen decoder's LM
head, per-token target log-probabilities with the row logsumexp (K5) and
the d-logits of the training loss (K6), without materializing the logits.

Counterparts of visdial_tpu/ops/lm_score_pallas.py::
lm_token_logprobs_lse_pallas and lm_dlogits_pallas.  A CUDA tensor
launches the kernel (or the call raises); a CPU tensor takes the plain
version (ops/lm_score.py).

Both kernels run the logits product on the tensor cores (common.cuh::
tile_product), whose operands are K-major: each call packs W^T once
(pack_lm_weight), pads x to the same depth where it must (pad_lm_input) and
pads b with the TPU kernel's -1e30 to whole vocab tiles (pad_lm_bias).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .lm_score import lm_dlogits_plain, lm_token_logprobs_lse_plain
from .lstm_cuda import k_tile

VOCAB_TILE = 128     # csrc/lm_score.cu's kBN: vocab columns per tile
ROW_TILE = 128       # csrc/lm_score.cu's LmTile<T>::BM, both dtypes
# csrc/lm_score.cu's LmTile<T>::BLOCKS: K5 blocks that share an SM
BLOCKS_PER_SM = {torch.float32: 1, torch.bfloat16: 2}
PAD_BIAS = -1e30     # the bias of a column past V (lm_score_pallas.py's pad)
# what a K5 block costs beyond its tile products (set-up, merge, partial
# write), in tile products: the value that picks the fastest split count of
# `scripts/lm_check.py --splits` at 2,880 and 73,728 rows in both dtypes
BLOCK_COST = 0.05


def pack_lm_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The logits product's B operand from W (H, V): W^T in `dtype`, a
    contiguous (V, Hp) tensor, H zero-padded to Hp, a whole k-tile
    (k_tile(dtype) values, 128 bytes), so that every row starts 16-byte
    aligned and no k-tile straddles H."""
    H, V = w.shape
    wk = w.new_zeros((V, -(-H // k_tile(dtype)) * k_tile(dtype)), dtype=dtype)
    wk[:, :H] = w.to(dtype).T
    return wk


def pad_lm_input(x: torch.Tensor) -> torch.Tensor:
    """x (NT, H) with H zero-padded to pack_lm_weight's Hp; x itself where H
    is already a whole number of k-tiles."""
    H = x.shape[1]
    pad = -H % k_tile(x.dtype)
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def pad_lm_bias(b: torch.Tensor) -> torch.Tensor:
    """b (V,) in float32, padded with PAD_BIAS to whole vocab tiles."""
    V = b.shape[0]
    bp = torch.full((-(-V // VOCAB_TILE) * VOCAB_TILE,), PAD_BIAS,
                    dtype=torch.float32, device=b.device)
    bp[:V] = b
    return bp


def vocab_splits(NT: int, V: int, sms: int,
                 blocks_per_sm: int = 1) -> tuple[int, int]:
    """(splits, tiles_per_split) for K5's first pass.  The (row tiles x
    splits) grid runs in waves of sms x blocks_per_sm blocks, and a block
    takes tiles_per_split tile products plus BLOCK_COST: the split count is
    the one with the fewest waves x (tiles_per_split + BLOCK_COST) (the
    fewest splits among equals), every split a non-empty range of vocab
    tiles."""
    n_vt = -(-V // VOCAB_TILE)
    row_tiles = -(-NT // ROW_TILE)
    best = None
    for want in range(1, n_vt + 1):
        per = -(-n_vt // want)
        splits = -(-n_vt // per)
        waves = math.ceil(row_tiles * splits / (sms * blocks_per_sm))
        cost = waves * (per + BLOCK_COST)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


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
    float32; a target outside [0, V) (another vocab shard's) has no target
    logit, so its logp is -lse.  `lm_token_logprobs_lse.launches` counts the
    calls that went to the kernel."""
    if x.device.type == "cpu":
        return lm_token_logprobs_lse_plain(x, w, b, tgt)
    NT, H, V = _check("lm_token_logprobs_lse", x, w, b, tgt)
    xp, wk, bp = pad_lm_input(x), pack_lm_weight(w, x.dtype), pad_lm_bias(b)
    tgt = tgt.to(torch.int32).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per = vocab_splits(NT, V, sms, BLOCKS_PER_SM[x.dtype])
    part = torch.empty((splits, NT, 3), dtype=torch.float32, device=x.device)
    logp = torch.empty(NT, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(logp)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lm_score(
            _build.DTYPE_CODE[x.dtype], xp.data_ptr(), wk.data_ptr(), bp.data_ptr(),
            tgt.data_ptr(), part.data_ptr(), logp.data_ptr(), lse.data_ptr(),
            NT, xp.shape[1], V, per, splits, _build.stream_of(x))
    _build.check(err, "lm_token_logprobs_lse")
    lm_token_logprobs_lse.launches += 1
    return logp, lse


lm_token_logprobs_lse.launches = 0


def lm_dlogits(x, w, b, tgt, lse, g):
    """d logits (NT, V) in x.dtype of the per-row target log-probability
    (K6): g_i (onehot(tgt_i) - exp(logits_i - lse_i)), the logits recomputed
    from x and w.  lse (NT,) the forward's row logsumexp, g (NT,) the
    cotangent of logp; other operands as lm_token_logprobs_lse (a target
    outside [0, V) has no one-hot term).
    `lm_dlogits.launches` counts the calls that went to the kernel."""
    if x.device.type == "cpu":
        return lm_dlogits_plain(x, w, b, tgt, lse, g)
    NT, H, V = _check("lm_dlogits", x, w, b, tgt, ("lse", lse), ("g", g))
    xp, wk, bp = pad_lm_input(x), pack_lm_weight(w, x.dtype), pad_lm_bias(b)
    tgt = tgt.to(torch.int32).contiguous()
    lse = lse.float().contiguous()
    g = g.float().contiguous()
    dlog = torch.empty((NT, V), dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.vd_lm_dlogits(
            _build.DTYPE_CODE[x.dtype], xp.data_ptr(), wk.data_ptr(), bp.data_ptr(),
            tgt.data_ptr(), lse.data_ptr(), g.data_ptr(), dlog.data_ptr(),
            NT, xp.shape[1], V, _build.stream_of(x))
    _build.check(err, "lm_dlogits")
    lm_dlogits.launches += 1
    return dlog


lm_dlogits.launches = 0
