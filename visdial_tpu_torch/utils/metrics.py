"""Retrieval metrics for the VisDial protocol (port of
visdial_tpu/utils/metrics.py: ranks_from_scores and retrieval_metrics).

Per dialog round, the rank of the ground-truth answer among the candidate
scores (descending), then MRR = mean(1/rank), R@k = mean(rank <= k) for k in
{1, 5, 10}, and mean rank.  `ranks_from_scores` runs on the scores' device,
so an eval reads back (B, R) ranks, not (B, R, K) scores.
"""

from __future__ import annotations

import numpy as np
import torch


def ranks_from_scores(scores: torch.Tensor, gt_index: torch.Tensor,
                      ties: str = "optimistic") -> torch.Tensor:
    """Rank of the ground-truth candidate per row.  scores (..., K), higher
    is better; gt_index (...,).  Candidates scoring exactly the ground
    truth's score count by `ties`:
      'optimistic'  — ties do not push the GT down (the behavior of record)
      'pessimistic' — every tie outranks the GT
      'mean'        — ties share the average of their rank range
    Returns (...,) ranks in [1, K]: int32, or float32 for 'mean'."""
    gt_score = torch.gather(scores, -1, gt_index[..., None].long())
    higher = (scores > gt_score).sum(dim=-1, dtype=torch.int32)
    if ties == "optimistic":
        return higher + 1
    equal = (scores == gt_score).sum(dim=-1, dtype=torch.int32) - 1
    if ties == "pessimistic":
        return higher + equal + 1
    if ties == "mean":
        return higher.float() + equal.float() / 2 + 1
    raise ValueError(f"unknown ties convention {ties!r}")


def retrieval_metrics(ranks) -> dict[str, float]:
    """MRR / R@1 / R@5 / R@10 / mean rank from a flat array of ranks."""
    r = np.asarray(ranks, dtype=np.float64).reshape(-1)
    if r.size == 0:
        # a split with zero rankable rounds: empty metrics, not NaN
        return {"mrr": 0.0, "r@1": 0.0, "r@5": 0.0, "r@10": 0.0,
                "mean_rank": 0.0, "num_examples": 0}
    return {
        "mrr": float(np.mean(1.0 / r)),
        "r@1": float(np.mean(r <= 1)),
        "r@5": float(np.mean(r <= 5)),
        "r@10": float(np.mean(r <= 10)),
        "mean_rank": float(np.mean(r)),
        "num_examples": int(r.size),
    }
