"""Retrieval evaluation on one device (port of visdial_tpu/eval_harness.py,
the streaming paths).

disc: the split's deduplicated option list is embedded once
(model_option_table); each EvalLoader batch is then an encoder forward plus
a table gather (model_scores_with_table).

gen, bucketed (cfg.gen_eval_bucketed, the default): a candidate scores the
same at any width >= its length + 1, so each batch's candidate rows are cut
into three width buckets (_GenBucketPlan) and scored bucket by bucket, the
<START>/<END> rows built on the device from the split's opt_list
(parallel/train_step.py::gen_rows_score).  gen, direct: the loader expands
every candidate to full width and model_scores scores them.

Either way the scores are ranked on the device, and the ranks of the rounds
with dialog_valid and round_valid set give MRR / R@1 / R@5 / R@10 / mean
rank.  With collect_rankings every candidate is ranked on the device too
(the v1.0 submission rankings) and kept for the rounds with dialog_valid
and round_scoreable set.  The resident evals and the staging thread are not
ported yet (ROADMAP.md, M8).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .config import Config
from .data.dataset import VisDialSplit, Vocabulary
from .data.loader import EvalLoader

from .models.encoders import encoder_apply
from .models.model import (_impl, batch_to_device, model_option_table,
                           model_scores, model_scores_with_table)
from .parallel.train_step import gen_rows_score
from .utils.metrics import (candidate_rankings, ranks_from_scores,
                            retrieval_metrics)

# batch fields any encoder reads (eval_harness.py::_ENCODER_BATCH_KEYS)
_ENCODER_KEYS = ("ques", "hist_concat", "hist_flat", "hist_bounds", "facts",
                 "img")


class _GenBucketPlan:
    """Length-bucket plan for gen candidate scoring over one split
    (eval_harness.py::_GenBucketPlan).

    Rows go to the narrowest sufficient of the widths {T/3, 2T/3, T}
    (T = La + 1).  A bucket's capacity is its largest per-batch row count
    over the split's batch sequence, rounded up to 128, so every score call
    has one of three fixed shapes; the padded slots are scattered to a
    dumpster slot."""

    def __init__(self, data: VisDialSplit, batch_size: int):
        T_full = int(data.opt_list.shape[1]) + 1   # tokens + <END>
        self.T_full = T_full
        self.widths = sorted({max(2, (T_full + 2) // 3),
                              max(3, (2 * T_full + 2) // 3), T_full})
        n, bs = data.num_dialogs, batch_size
        edges = np.asarray(self.widths)
        caps = np.zeros(len(self.widths), np.int64)
        for s in range(0, n, bs):
            idx = np.arange(s, min(s + bs, n))
            if len(idx) < bs:                                # pad_to repeats
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - len(idx))])
            lens = data.opt_list_len[data.opt_inds[idx]] + 1
            b = np.searchsorted(edges, lens.reshape(-1))
            caps = np.maximum(caps, np.bincount(b, minlength=len(self.widths)))
        self.caps = [int(-(-c // 128) * 128) for c in caps]

    @classmethod
    def cached(cls, data: VisDialSplit, batch_size: int) -> "_GenBucketPlan":
        """The plan of (split, batch size), kept on the split object."""
        cache = data.__dict__.setdefault("_torch_gen_bucket_plans", {})
        key = (batch_size, int(data.opt_list.shape[1]))
        if key not in cache:
            cache[key] = cls(data, batch_size)
        return cache[key]

    def assign(self, opt_len: np.ndarray) -> list[np.ndarray]:
        """Flat row positions per bucket for one batch (opt_len (B, R, K))."""
        need = opt_len.reshape(-1) + 1
        b = np.searchsorted(np.asarray(self.widths), need)
        return [np.flatnonzero(b == i) for i in range(len(self.widths))]


def _gen_bucket_scorer(params, data: VisDialSplit, vocab: Vocabulary,
                       cfg: Config, batch_size: int, device, impl: str):
    """score(dev, batch) -> (B, R, K) gen candidate scores by width bucket."""
    plan = _GenBucketPlan.cached(data, batch_size)
    opt_list = torch.from_numpy(data.opt_list.astype(np.int64)).to(device)
    opt_len = torch.from_numpy(data.opt_list_len.astype(np.int64)).to(device)
    K = cfg.num_options

    def score(dev, batch):
        joint = encoder_apply(params["encoder"], params["embed"], dev, cfg,
                              impl=impl)                          # (N, H)
        B, R = batch.gt_ind.shape
        brk = B * R * K
        flat_rows = batch.opt_inds.reshape(-1)
        flat = torch.zeros(brk + 1, dtype=torch.float32, device=device)
        for width, cap, rows in zip(plan.widths, plan.caps,
                                    plan.assign(batch.opt_len)):
            if cap == 0:
                continue
            pad = cap - len(rows)
            if pad < 0:
                raise RuntimeError(f"gen bucket of width {width} overflows its "
                                   f"capacity {cap} ({len(rows)} rows)")
            rpad = np.pad(rows, (0, pad))
            # padded slots repeat row 0 and land in the dumpster slot brk
            idx = batch_to_device({"rows": flat_rows[rpad], "ridx": rpad // K,
                                   "scat": np.concatenate([rows, np.full(pad, brk)])},
                                  device)
            flat[idx["scat"]] = gen_rows_score(
                params, joint, opt_list, opt_len, idx["rows"], idx["ridx"],
                width, vocab.start, vocab.end, cfg, impl=impl).float()
        return flat[:brk].reshape(B, R, K)

    return score


def evaluate_split(params, data: VisDialSplit, vocab: Vocabulary, cfg: Config,
                   device, *, batch_size: int | None = None,
                   ties: str = "optimistic", impl: str | None = None,
                   return_ranks: bool = False, collect_rankings: bool = False):
    """Score every candidate of every round of `data` and return the
    retrieval metrics plus 'evals_per_sec' (rounds ranked per second, the
    disc option table's build excluded, as in the JAX harness) and
    'eval_seconds'.  gen takes the bucketed path when
    cfg.gen_eval_bucketed, else the direct one (the same scores).

    With return_ranks the return is (metrics, ranks): the gt rank of every
    ranked round, in loader order.  With collect_rankings it is (metrics,
    cand_ranks) (eval_harness.py::evaluate_split): cand_ranks
    (num_dialogs, R, K) int32 holds candidate_rankings of every round that
    is scoreable (a full candidate list, with or without a ground truth:
    the v1.0 test split's rounds have none), zeros elsewhere.  With both,
    (metrics, ranks, cand_ranks)."""
    device = torch.device(device)
    impl = impl or _impl(cfg, device)
    direct = cfg.decoder == "gen" and not cfg.gen_eval_bucketed
    # batches are assembled in float32; the encoder casts on the device
    loader = EvalLoader(data, vocab, cfg.replace(compute_dtype="float32"),
                        batch_size=batch_size, option_tokens=direct)
    keys = _ENCODER_KEYS + ("gt_ind",)
    all_ranks = []
    cand_out = (np.zeros((data.num_dialogs, cfg.num_rounds, cfg.num_options),
                         np.int32) if collect_rankings else None)
    with torch.inference_mode():
        if cfg.decoder == "disc":
            table = model_option_table(
                params, torch.from_numpy(data.opt_list.astype(np.int64)).to(device),
                cfg, impl=impl)
            keys += ("opt_inds",)

            def score(dev, _batch):
                return model_scores_with_table(params, dev, table, cfg, impl=impl)
        elif direct:
            keys += ("opt_in", "opt_out")

            def score(dev, _batch):
                return model_scores(params, dev, cfg, impl=impl)
        else:
            score = _gen_bucket_scorer(params, data, vocab, cfg, loader.bs,
                                       device, impl)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        n_rounds = 0
        for bi, batch in enumerate(loader):
            d = batch.as_dict()
            dev = batch_to_device({k: d[k] for k in keys if k in d}, device)
            scores = score(dev, batch)
            ranks = ranks_from_scores(scores, dev["gt_ind"], ties).cpu().numpy()
            keep = (batch.dialog_valid.astype(bool)[:, None]
                    & batch.round_valid.astype(bool))
            all_ranks.append(ranks[keep])
            n_rounds += int(keep.sum())
            if collect_rankings:
                cand = candidate_rankings(scores).cpu().numpy()
                dump = (batch.dialog_valid.astype(bool)[:, None]
                        & batch.round_scoreable.astype(bool))
                start = bi * loader.bs
                n = min(start + cand.shape[0], data.num_dialogs) - start
                cand_out[start:start + n] = np.where(dump[:n, :, None],
                                                     cand[:n], 0)
        elapsed = time.time() - t0
    ranks = np.concatenate(all_ranks)
    metrics = retrieval_metrics(ranks)
    metrics["evals_per_sec"] = n_rounds / max(elapsed, 1e-9)
    metrics["eval_seconds"] = elapsed
    extra = ((ranks,) if return_ranks else ()) + (
        (cand_out,) if collect_rankings else ())
    return (metrics, *extra) if extra else metrics
