"""The reference's batches, worked out from the split's arrays.

A training epoch visits the dialogs in the order of a permutation drawn
from the epoch's seed with NumPy (`np.random.default_rng(seed).permutation`,
the order the program's loader is documented to take for the same seed),
B dialogs a step; on a data axis of D ranks, rank d takes dialogs
[d B / D, (d + 1) B / D) of each step's B.
"""

from __future__ import annotations

import numpy as np


def epoch_order(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


def right_align(tok: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Left-aligned rows (..., L) moved to the right edge."""
    L = tok.shape[-1]
    src = np.arange(L) - (L - lens[..., None])
    out = np.take_along_axis(tok, np.clip(src, 0, L - 1), axis=-1)
    return np.where(src >= 0, out, 0).astype(np.int32)


def image(split: dict, idx: np.ndarray, config: dict) -> np.ndarray:
    """The fc7 features of dialogs idx (B, F) in float32, L2-normalised
    unless the configuration's img_norm is false."""
    img = split["img_feat"][idx].astype(np.float32)
    if config.get("img_norm", True):
        norm = np.linalg.norm(img, axis=1, keepdims=True)
        img = img / np.maximum(norm, 1e-8)
    return img.astype(np.float32)


def disc_candidates(split: dict, idx: np.ndarray):
    """The candidates of dialogs idx as unique pool rows: (the rows' tokens
    (U, La), each candidate's index into them (B * R, K))."""
    sel = split["opt_inds"][idx]
    uniq, inv = np.unique(sel, return_inverse=True)
    return split["opt_list"][uniq], inv.reshape(-1, sel.shape[-1])


def gen_targets(split: dict, idx: np.ndarray, start: int, end: int):
    """(ans_in, ans_out) (B * R, La + 1): <START> + answer, answer + <END>."""
    a, al = split["ans"][idx], split["ans_len"][idx]
    a = a.reshape(-1, a.shape[-1])
    al = al.reshape(-1)
    n, La = a.shape
    ans_in = np.zeros((n, La + 1), np.int32)
    ans_out = np.zeros((n, La + 1), np.int32)
    ans_in[:, 0] = start
    ans_in[:, 1:] = a
    ans_out[:, :La] = a
    ans_out[np.arange(n), al] = end
    return ans_in, ans_out
