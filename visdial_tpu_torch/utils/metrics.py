"""Retrieval metrics for the VisDial protocol (port of
visdial_tpu/utils/metrics.py).

Per dialog round, the rank of the ground-truth answer among the candidate
scores (descending), then MRR = mean(1/rank), R@k = mean(rank <= k) for k in
{1, 5, 10}, and mean rank.  `ranks_from_scores` runs on the scores' device,
so an eval reads back (B, R) ranks, not (B, R, K) scores.

The VisDial v1.0 additions: the rank of every candidate in the challenge
submission convention (`candidate_rankings`, also on the device) and NDCG
over dense ground-truth relevance (`ndcg_scores`, the official challenge
evaluation: K = number of candidates with nonzero relevance, gains the raw
relevance values, discount 1/log2(position + 1)).
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


def candidate_rankings(scores: torch.Tensor) -> torch.Tensor:
    """1-indexed rank of every candidate by descending score (..., K) ->
    (..., K) int32, a permutation of 1..K per row.  Equal scores rank by
    candidate index, lower first (stable sorts), as the v1.0 submission
    format's `ranks[k] = position of option k` takes them."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (torch.argsort(order, dim=-1, stable=True) + 1).to(torch.int32)


def ndcg_scores(cand_ranks, relevance) -> np.ndarray:
    """Per-row NDCG (N,) float64 from 1-indexed candidate rankings (N, K)
    and dense relevance (N, K): with K_i = #{k : relevance_ik > 0},
    DCG@K_i = sum over the first K_i ranked candidates of rel / log2(i + 1),
    IDCG@K_i the same over the relevance sorted descending, NDCG their
    ratio (0 where a row has no relevant candidate)."""
    cand_ranks = np.asarray(cand_ranks)
    relevance = np.asarray(relevance, dtype=np.float64)
    N, K = relevance.shape
    if cand_ranks.shape != (N, K):
        raise ValueError(f"cand_ranks {cand_ranks.shape} != relevance {(N, K)}")
    # relevance in predicted rank order (position i holds rank i + 1)
    order = np.argsort(cand_ranks, axis=-1, kind="stable")
    rel_pred = np.take_along_axis(relevance, order, axis=-1)
    rel_ideal = -np.sort(-relevance, axis=-1)
    k = (relevance > 0).sum(axis=-1)
    discounts = 1.0 / np.log2(np.arange(2, K + 2, dtype=np.float64))
    within_k = np.arange(K)[None, :] < k[:, None]
    dcg = (rel_pred * discounts * within_k).sum(axis=-1)
    idcg = (rel_ideal * discounts * within_k).sum(axis=-1)
    out = np.zeros(N, np.float64)
    np.divide(dcg, idcg, out=out, where=idcg > 0)
    return out


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
