"""Retrieval evaluation on one device (port of visdial_tpu/eval_harness.py,
the disc streaming table path).

The split's deduplicated option list is embedded once (model_option_table);
each EvalLoader batch is then an encoder forward plus a table gather
(model_scores_with_table), ranked on the device, and the ranks of the
rounds with dialog_valid and round_valid set give MRR / R@1 / R@5 / R@10 /
mean rank.  The gen decoder's eval paths, the resident evals and the
staging thread are not ported yet (ROADMAP.md, M8).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from visdial_tpu.config import Config
from visdial_tpu.data.dataset import VisDialSplit, Vocabulary
from visdial_tpu.data.loader import EvalLoader

from .models.model import (_impl, batch_to_device, model_option_table,
                           model_scores_with_table)
from .utils.metrics import ranks_from_scores, retrieval_metrics

# batch fields the MN encoder and the table scoring read
_DEVICE_KEYS = ("ques", "facts", "img", "opt_inds", "gt_ind")


def evaluate_split(params, data: VisDialSplit, vocab: Vocabulary, cfg: Config,
                   device, *, batch_size: int | None = None,
                   ties: str = "optimistic", impl: str | None = None) -> dict:
    """Score every candidate of every round of `data` and return the
    retrieval metrics plus 'evals_per_sec' (rounds ranked per second, the
    option table's build excluded, as in the JAX harness) and
    'eval_seconds'."""
    if cfg.decoder != "disc":
        raise NotImplementedError(
            "gen decoder evaluation is not ported yet (see ROADMAP.md, M8)")
    device = torch.device(device)
    impl = impl or _impl(cfg, device)
    # batches are assembled in float32 (the shared assembler needs ml_dtypes
    # for bfloat16); the encoder casts on the device
    loader = EvalLoader(data, vocab, cfg.replace(compute_dtype="float32"),
                        batch_size=batch_size, option_tokens=False)
    all_ranks = []
    with torch.inference_mode():
        table = model_option_table(
            params, torch.from_numpy(data.opt_list.astype(np.int64)).to(device),
            cfg, impl=impl)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        n_rounds = 0
        for batch in loader:
            d = batch.as_dict()
            dev = batch_to_device({k: d[k] for k in _DEVICE_KEYS if k in d},
                                  device)
            scores = model_scores_with_table(params, dev, table, cfg, impl=impl)
            ranks = ranks_from_scores(scores, dev["gt_ind"], ties).cpu().numpy()
            keep = (batch.dialog_valid.astype(bool)[:, None]
                    & batch.round_valid.astype(bool))
            all_ranks.append(ranks[keep])
            n_rounds += int(keep.sum())
        elapsed = time.time() - t0
    metrics = retrieval_metrics(np.concatenate(all_ranks))
    metrics["evals_per_sec"] = n_rounds / max(elapsed, 1e-9)
    metrics["eval_seconds"] = elapsed
    return metrics
