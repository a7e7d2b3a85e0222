"""Parity runbook: reference artifacts -> the two acceptance MRR numbers
(port of scripts/parity_run.py).

The acceptance test of the system (SURVEY.md §6) is training LF-QIH-disc
and MN-QIH-gen on real VisDial v0.9 and landing within ±0.002 MRR of the
published numbers (BASELINE.md).  This module is that composition, run
through the port's own CLIs on the card (or, with --device cpu, on the
CPU):

  1. load both splits of --data_dir through data/dataset.py::load_split --
     the reference's three artifacts (visdial_data.h5, visdial_params.json,
     data_img.h5, read through data/ingest_h5.py where h5py is installed)
     or the native npz/json;
  2. sanity-check the VGG fc7 feature distribution before any training;
  3. train LF-QIH-disc and MN-QIH-gen at the survey hparams (the Config
     defaults) with checkpoints, through visdial_tpu_torch.train;
  4. evaluate each final checkpoint through visdial_tpu_torch.evaluate (the
     checkpoint round trip, not the in-training eval);
  5. print one JSON line per model with the MRR delta against the published
     number and a verdict at the ±0.002 bar.

Usage (real data):

    python -m visdial_tpu_torch.parity_run --data_dir /path/to/artifacts

Rehearsal (generated artifacts, small dims or a step cap):

    python -m visdial_tpu_torch.parity_run --data_dir <dir> \\
        --config_json dims.json --max_steps 60 --no-check [--device cpu]

Under torchrun, --mesh_data / --mesh_model pass through to both CLIs, and
rank 0 alone prints.  Every stage prints a JSON line (ingested,
img_feature_check and img_feature_check_failed, train_start,
parity_result); the last line is parity_summary.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .parallel.mesh import add_mesh_args

# Published v0.9 val MRR (BASELINE.md high-confidence rows).
TARGETS = {"lf-disc": 0.5807, "mn-gen": 0.5259}
MODELS = {"lf-disc": ("lf-ques-im-hist", "disc"),
          "mn-gen": ("mn-ques-im-hist", "gen")}
MRR_BAR = 0.002


def emit(obj: dict) -> None:
    """One JSON line, from rank 0 only (RANK as torchrun sets it)."""
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(obj), flush=True)


def check_img_features(split, name: str, strict: bool) -> dict:
    """VGG fc7 feature-distribution sanity, before any training.

    Real fc7 activations are post-ReLU: non-negative, sparse (typically
    50-90% exact zeros before normalization), with no NaN/Inf and no
    all-zero rows.  L2-normalized features have unit row norms instead.
    Hard failures (NaN/Inf, all-zero rows, a constant matrix) abort under
    `strict`; distribution oddities are warnings (gaussian rehearsal
    features trip them legitimately)."""
    # f64 accumulators without an f64 copy: real v0.9 train features are
    # ~1.3 GB in f32
    f = np.asarray(split.img_feat)
    flat = f.reshape(f.shape[0], -1)
    row_norms = np.sqrt(np.einsum("ij,ij->i", flat, flat, dtype=np.float64))
    mean = float(f.mean(dtype=np.float64))
    report = {
        "event": "img_feature_check", "split": name,
        "shape": list(f.shape), "mean": mean,
        "std": float(np.sqrt(max(
            float(np.einsum("ij,ij->", flat, flat, dtype=np.float64))
            / f.size - mean ** 2, 0.0))),
        "min": float(f.min()), "max": float(f.max()),
        "zero_frac": float((f == 0).mean(dtype=np.float64)),
        "neg_frac": float((f < 0).mean(dtype=np.float64)),
        "row_norm_mean": float(row_norms.mean()),
        "row_norm_min": float(row_norms.min()),
        "nonfinite": int((~np.isfinite(f)).sum()),
    }
    problems, warnings = [], []
    if report["nonfinite"]:
        problems.append(f"{report['nonfinite']} NaN/Inf feature values")
    if (row_norms == 0).any():
        problems.append(f"{int((row_norms == 0).sum())} all-zero feature "
                        "rows (missing images?)")
    if report["std"] == 0.0:
        problems.append("constant feature matrix")
    if report["neg_frac"] > 0:
        warnings.append("negative values present — fc7 is post-ReLU, so "
                        "expect 0 unless features were centered/whitened")
    unit = np.allclose(row_norms[row_norms > 0], 1.0, atol=1e-3)
    if report["zero_frac"] < 0.05 and not unit:
        warnings.append("feature matrix is dense (<5% zeros) and not "
                        "L2-normalized — unusual for raw fc7; check the "
                        "extraction layer")
    report["warnings"] = warnings
    report["ok"] = not problems
    emit(report)
    if problems:
        emit({"event": "img_feature_check_failed", "split": name,
              "problems": problems})
        if strict:
            raise SystemExit(f"image feature check failed: {problems}")
    return report


def cfg_flags(overrides: dict) -> list[str]:
    out = []
    for k, v in overrides.items():
        out += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True,
                   help="directory load_split understands: the three "
                        "reference h5/json artifacts, or native npz")
    p.add_argument("--work_dir", default="runs/parity",
                   help="checkpoints + metrics root for both training runs")
    p.add_argument("--models", default="lf-disc,mn-gen",
                   help="comma list from {lf-disc, mn-gen}")
    p.add_argument("--num_epochs", type=int, default=0,
                   help="override Config.num_epochs (0 = keep default)")
    p.add_argument("--max_steps", type=int, default=0,
                   help="cap steps (rehearsal); 0 = run the full epochs")
    p.add_argument("--config_json", default="",
                   help="JSON file of Config field overrides applied to "
                        "BOTH runs (rehearsal dims / hparam probing)")
    p.add_argument("--check", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="exit non-zero unless every MRR lands within "
                        "±0.002 of the published number (--no-check for "
                        "rehearsals on synthetic data)")
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="train dispatch grouping (see train.py)")
    p.add_argument("--device", type=str, default="cuda")
    add_mesh_args(p)
    args = p.parse_args(argv)

    # validate the whole model list before the (hours-long) ingest and
    # training, so that a typo cannot abort a run halfway through
    model_keys = [k.strip() for k in args.models.split(",") if k.strip()]
    unknown = [k for k in model_keys if k not in MODELS]
    if unknown:
        raise SystemExit(f"unknown --models entries {unknown}; "
                         f"valid: {', '.join(MODELS)}")

    from .data.dataset import load_split
    from .evaluate import main as evaluate_main
    from .train import main as train_main
    from .utils.checkpoint import latest_checkpoint

    overrides = {}
    if args.config_json:
        with open(args.config_json) as f:
            overrides = json.load(f)
    if args.num_epochs:
        overrides["num_epochs"] = args.num_epochs
    run_flags = ["--device", args.device, "--mesh_data", str(args.mesh_data),
                 "--mesh_model", str(args.mesh_model)]

    # stages 1 and 2: ingest (or the native load) and the feature check
    for split_name in ("train", "val"):
        data, vocab = load_split(args.data_dir, split_name)
        emit({"event": "ingested", "split": split_name,
              "dialogs": data.num_dialogs,
              "unique_options": int(data.opt_list.shape[0]),
              "vocab": vocab.size, "vocab_sha": vocab.content_hash()})
        check_img_features(data, split_name, strict=args.check)
        del data

    summary = {"event": "parity_summary", "data_dir": args.data_dir}
    all_pass = True
    for key in model_keys:
        encoder, decoder = MODELS[key]
        run_name = f"parity-{key}"
        train_argv = [
            "--encoder", encoder, "--decoder", decoder,
            "--data_dir", args.data_dir, "--save_path", args.work_dir,
            "--run_name", run_name,
            "--steps_per_dispatch", str(args.steps_per_dispatch),
        ] + cfg_flags(overrides) + run_flags
        if args.max_steps:
            train_argv += ["--max_steps", str(args.max_steps)]
        emit({"event": "train_start", "model": key, "argv": train_argv})
        train_main(train_argv)

        ckpt = latest_checkpoint(os.path.join(args.work_dir, run_name))
        assert ckpt, f"no checkpoint written for {key}"
        metrics = evaluate_main(["--load_path", ckpt,
                                 "--data_dir", args.data_dir] + run_flags)
        delta = metrics["mrr"] - TARGETS[key]
        ok = abs(delta) <= MRR_BAR
        all_pass &= ok
        emit({"event": "parity_result", "model": key, "checkpoint": ckpt,
              "mrr": metrics["mrr"], "target_mrr": TARGETS[key],
              "delta": delta, "bar": MRR_BAR, "pass": ok})
        summary[f"{key}_mrr"] = metrics["mrr"]
        summary[f"{key}_delta"] = delta

    summary["all_pass"] = all_pass
    emit(summary)
    if args.check and not all_pass:
        raise SystemExit("parity FAILED: MRR outside the ±0.002 acceptance "
                         "bar (see parity_result lines above)")
    return summary


if __name__ == "__main__":
    main()
