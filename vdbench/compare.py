"""The numbers that decide `correct`, each against its limit
(limits/<cell>.json).

Training (the checked steps of the first dispatch, program against the
reference from the same start):
  loss_gap     the widest relative gap of a step's loss
  grad_gap     the worst leaf's gap between the norms of the two first
               moments after the checked steps (the clipped gradients as
               Adam accumulated them), over the reference's norm of that
               leaf or of the median leaf, whichever is larger
  update_gap   the same for the change of the params over the checked steps
Leaves whose reference moment is under a thousandth of the median leaf's
(gradients that are nought to rounding) are left out of both.

Retrieval (every pass of the window against the reference's ranks):
  rank_moved   the share of rounds whose ground-truth rank differs
  out_of_band  the rounds whose rank lies outside the reference's band at
               the limits' tolerance `band` (reference/steps.py::ranks):
               a rank that no rounding of the scores within it explains
A pass that returns another number of ranks than the split has rounds
counts as failed.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF_FLOOR = 1e-3


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _worst_gap(prog: dict, ref: dict, keep: list) -> float:
    p, r = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    floor = float(np.median([r[k] for k in keep]))
    return max(abs(p[k] - r[k]) / max(r[k], floor) for k in keep)


def train_numbers(prog: dict, ref: dict, start: dict) -> dict:
    """prog / ref: {"loss": [...], "params": {path: t}, "m": {path: t}};
    start: the params both began from."""
    lp = np.asarray(prog["loss"], np.float64)
    lr = np.asarray(ref["loss"], np.float64)
    if lp.shape != lr.shape or not np.isfinite(lp).all():
        loss_gap = float("inf")
    else:
        loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    m_ref = _norms(ref["m"])
    median = float(np.median(list(m_ref.values())))
    keep = [k for k, n in m_ref.items() if n >= LEAF_FLOOR * median]
    move = {k: prog["params"][k].double() - start[k].double() for k in keep}
    ref_move = {k: ref["params"][k].double().cpu() - start[k].double()
                for k in keep}
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_gap({k: prog["m"][k] for k in keep},
                                   {k: ref["m"][k].cpu() for k in keep}, keep),
            "update_gap": _worst_gap(move, ref_move, keep)}


def eval_numbers(passes: list, ref: np.ndarray, band: tuple) -> tuple[dict, int]:
    """({rank_moved, out_of_band} over every pass's ranks, passes failed);
    band: the reference's (lo, hi) ranks at the limits' tolerance."""
    moved, outside, failed = 0.0, 0, 0
    lo, hi = band
    for ranks in passes:
        ranks = np.asarray(ranks).reshape(-1)
        if ranks.shape != ref.shape:
            failed += 1
            continue
        moved = max(moved, float((ranks != ref).mean()))
        outside = max(outside, int(((ranks < lo) | (ranks > hi)).sum()))
    if failed or not passes:
        return {"rank_moved": float("inf"), "out_of_band": float("inf")}, failed
    return {"rank_moved": moved, "out_of_band": float(outside)}, 0


def train_detail(prog: dict, ref: dict, start: dict) -> dict:
    """What the limits were chosen from: both sides' losses and, a leaf,
    the norms of the first moments and of the change [prog m, ref m, prog
    change, ref change]."""
    leaves = {}
    for k in ref["m"]:
        leaves[k] = [float(torch.linalg.vector_norm(x.double().cpu())) for x in (
            prog["m"][k], ref["m"][k], prog["params"][k].cpu() - start[k],
            ref["params"][k].cpu() - start[k])]
    return {"loss_prog": list(prog["loss"]), "loss_ref": list(ref["loss"]),
            "leaves": leaves}


def eval_detail(passes: list, ref: np.ndarray, bands: dict) -> dict:
    """rank_moved and out_of_band at each band of `bands`."""
    return {"out_of_band": {str(a): eval_numbers(passes, ref, b)[0]["out_of_band"]
                            for a, b in bands.items()},
            "rank_moved": eval_numbers(passes, ref, next(iter(bands.values())))[0][
                "rank_moved"]}


BANDS = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: [number, limit]})."""
    shown = {k: [numbers[k], limits[k]["limit"]] for k in limits}
    ok = all(np.isfinite(v) and v <= lim for v, lim in shown.values())
    return bool(ok), shown
