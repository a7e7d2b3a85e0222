"""Evaluation CLI on one GPU (port of visdial_tpu/evaluate.py).

Loads a checkpoint of either package (it embeds its Config), ranks the 100
candidates of every round of a split and prints one JSON line: model,
split, MRR, R@1, R@5, R@10, mean rank, num_examples, evals_per_sec and
eval_seconds.

The VisDial v1.0 additions, as in the JAX CLI: `--save_ranks` writes every
candidate's rank in the challenge submission format (`[{"image_id",
"round_id", "ranks": [K ints]}, ...]`, one entry per scoreable round), and
`--dense_json` adds NDCG against dense annotations (the
`visdial_1.0_val_dense_annotations.json` schema: per image the densely
annotated round and its 100 relevance values).

Usage:
    python -m visdial_tpu_torch.evaluate --load_path checkpoints/run/step_N \
        [--data_dir data | --synthetic 64] [--batch_size 32] \
        [--save_ranks ranks.json] [--dense_json dense_annotations.json] \
        [--device cuda | --device cpu]

--device cuda (the default) runs the kernels; --device cpu the plain
versions.  The resident eval is not ported (ROADMAP.md, M8): --resident is
accepted, and the eval streams batches either way.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .data.dataset import load_split
from .data.synthetic import make_synthetic_split
from .eval_harness import evaluate_split
from .utils.checkpoint import load_checkpoint
from .utils.metrics import ndcg_scores


def ranks_to_submission(cand_ranks, img_ids, round_valid) -> list[dict]:
    """Challenge-format payload from (N, R, K) rankings: one entry per
    (dialog, round) with round_valid set; round_id is 1-indexed."""
    out = []
    for i in range(cand_ranks.shape[0]):
        for r in range(cand_ranks.shape[1]):
            if round_valid[i, r]:
                out.append({"image_id": int(img_ids[i]), "round_id": r + 1,
                            "ranks": [int(x) for x in cand_ranks[i, r]]})
    return out


def ndcg_from_dense(cand_ranks, img_ids, dense_entries) -> dict:
    """Mean NDCG over the densely annotated (image, round) pairs.
    dense_entries: dicts with `image_id`, `round_id` (1-indexed) and
    `gt_relevance` (K floats).  An entry whose image is not in the split,
    whose round_id is out of range, or whose round was not ranked counts
    as missing."""
    by_img = {int(e["image_id"]): e for e in dense_entries}
    rows, rels = [], []
    missing = 0
    for i, img in enumerate(np.asarray(img_ids)):
        e = by_img.get(int(img))
        if e is None:
            continue
        r = int(e["round_id"]) - 1
        if not 0 <= r < cand_ranks.shape[1]:
            missing += 1        # a 0 or out-of-range id must not wrap
            continue
        ranks_row = cand_ranks[i, r]
        if not ranks_row.any():         # round not ranked in this split
            missing += 1
            continue
        rows.append(ranks_row)
        rels.append(np.asarray(e["gt_relevance"], np.float64))
    matched = {int(i) for i in np.asarray(img_ids)} & set(by_img)
    missing += len(by_img) - len(matched)
    if not rows:
        return {"ndcg": 0.0, "ndcg_rounds": 0, "ndcg_missing": missing}
    vals = ndcg_scores(np.stack(rows), np.stack(rels))
    return {"ndcg": float(vals.mean()), "ndcg_rounds": int(len(vals)),
            "ndcg_missing": missing}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--length_norm", type=str, default="", choices=("", "0", "1"),
                   help="override gen_score_length_norm from the checkpoint "
                        "('' keeps the saved value)")
    p.add_argument("--ties", type=str, default="optimistic",
                   choices=("optimistic", "pessimistic", "mean"),
                   help="rank convention for score ties")
    p.add_argument("--resident", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for the JAX CLI's surface; the resident "
                        "eval is not ported (ROADMAP.md, M8): eval streams")
    p.add_argument("--save_ranks", type=str, default="",
                   help="write every candidate's rank here in the v1.0 "
                        "challenge submission JSON format")
    p.add_argument("--dense_json", type=str, default="",
                   help="v1.0 dense annotations JSON; adds NDCG")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to "
                         "evaluate with the plain versions on the CPU)")
    if args.resident:
        print(json.dumps({"event": "notice",
                          "msg": "resident: the resident eval is not ported "
                                 "(ROADMAP.md, M8); the eval streams batches"}),
              file=sys.stderr, flush=True)
    params, cfg, _ = load_checkpoint(args.load_path, device)
    if args.data_dir:
        cfg = cfg.replace(data_dir=args.data_dir)
    if args.length_norm:
        cfg = cfg.replace(gen_score_length_norm=args.length_norm == "1")
    if args.synthetic:
        data, vocab = make_synthetic_split(cfg, num_dialogs=args.synthetic,
                                           seed=cfg.seed + 1)
    else:
        data, vocab = load_split(cfg.data_dir, args.split)
    if vocab.size != cfg.vocab_size:
        raise SystemExit(f"checkpoint/vocab mismatch: the checkpoint has "
                         f"vocab_size {cfg.vocab_size}, the data {vocab.size}")

    want_rankings = bool(args.save_ranks or args.dense_json)
    out = evaluate_split(params, data, vocab, cfg, device,
                         batch_size=args.batch_size or None, ties=args.ties,
                         collect_rankings=want_rankings)
    if want_rankings:
        metrics, cand_ranks = out
        if args.save_ranks:
            with open(args.save_ranks, "w") as f:
                json.dump(ranks_to_submission(cand_ranks, data.img_ids,
                                              cand_ranks.any(axis=-1)), f)
        if args.dense_json:
            with open(args.dense_json) as f:
                metrics.update(ndcg_from_dense(cand_ranks, data.img_ids,
                                               json.load(f)))
    else:
        metrics = out
    print(json.dumps({"model": f"{cfg.encoder}-{cfg.decoder}",
                      "split": args.split, **metrics}), flush=True)
    return metrics


if __name__ == "__main__":
    main()
