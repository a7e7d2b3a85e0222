"""Dress-rehearse the parity runbook at v0.9 scale (port of
scripts/parity_rehearsal.py).

It generates random artifacts at v0.9 scale (80,000 train dialogs, 40,000
val dialogs, 100,000 unique answers, the flagship shape caps) in the native
npz format, drives the unmodified runbook (visdial_tpu_torch.parity_run)
over them with --max_steps capping the training legs, one model a process,
and records each stage's wall clock and peak RSS, the artifact and
checkpoint sizes and the steps/s, then projects the 15-epoch budget.  The
MRR numbers it produces are meaningless (random data); the envelope is the
deliverable.

    python -m visdial_tpu_torch.parity_rehearsal --max_steps 48 \\
        [--config_json dims.json] [--device cuda] [--reuse_data] \\
        [--work_dir build/parity_rehearsal] [--out <json>]

--config_json passes Config overrides to both training runs (for example
{"compute_dtype": "bfloat16"}); --reuse_data keeps the artifacts of an
earlier run in --work_dir.  Every stage prints a JSON line; --out holds
them all, the projection last but one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import shutil
import subprocess
import sys
import time

import numpy as np

V09_TRAIN_DIALOGS = 80_000   # v0.9 train is 82,783 images
V09_VAL_DIALOGS = 40_000     # v0.9 val is 40,504 images
V09_UNIQUE_ANSWERS = 100_000
EPOCHS = 15                  # Config.num_epochs, the real run's budget
MODELS = ("lf-disc", "mn-gen")


def du_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def peak_rss_gb(usage) -> float:
    """A getrusage record's peak resident set (Linux reports KiB)."""
    return usage.ru_maxrss * 1024 / 1e9


def generate(data_dir: str, log: list) -> None:
    from .config import Config
    from .data.synthetic import make_random_split

    os.makedirs(data_dir, exist_ok=True)
    cfg = Config(vocab_size=0)           # flagship shape caps
    for split_name, n, seed in (("train", V09_TRAIN_DIALOGS, 0),
                                ("val", V09_VAL_DIALOGS, 1)):
        t0 = time.time()
        split, vocab = make_random_split(
            cfg, num_dialogs=n, num_unique_answers=V09_UNIQUE_ANSWERS,
            seed=seed)
        path = os.path.join(data_dir, f"visdial_data_{split_name}.npz")
        # uncompressed: random arrays do not compress; the fields one by
        # one (dataclasses.asdict would deep-copy every array)
        np.savez(path, **{f.name: getattr(split, f.name)
                          for f in dataclasses.fields(split)})
        if split_name == "train":
            vocab.save(os.path.join(data_dir, "visdial_params.json"))
        del split
        rec = {"event": "generated", "split": split_name, "dialogs": n,
               "seconds": round(time.time() - t0, 1),
               "npz_bytes": os.path.getsize(path),
               # this process's peak so far
               "peak_rss_gb": round(peak_rss_gb(
                   resource.getrusage(resource.RUSAGE_SELF)), 2)}
        log.append(rec)
        print(json.dumps(rec), flush=True)


def run_model(key: str, data_dir: str, runs_dir: str, args, log: list) -> None:
    """One model through the runbook in its own process, its run directory
    (this rehearsal's own output) emptied first: its JSON lines into the
    log, then its wall clock, peak RSS and checkpoint bytes."""
    out_path = os.path.join(runs_dir, f"{key}.stdout")
    shutil.rmtree(os.path.join(runs_dir, f"parity-{key}"), ignore_errors=True)
    cmd = [sys.executable, "-m", "visdial_tpu_torch.parity_run",
           "--data_dir", data_dir, "--work_dir", runs_dir, "--models", key,
           "--max_steps", str(args.max_steps), "--device", args.device,
           "--no-check"]
    if args.config_json:
        cmd += ["--config_json", args.config_json]
    os.makedirs(runs_dir, exist_ok=True)
    t0 = time.time()
    with open(out_path, "w") as out:
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.PIPE,
                                text=True,
                                cwd=os.path.dirname(os.path.dirname(
                                    os.path.abspath(__file__))))
        err = proc.stderr.read()
        _, status, usage = os.wait4(proc.pid, 0)
    seconds = time.time() - t0
    code = os.waitstatus_to_exitcode(status)
    if code != 0:
        raise SystemExit(f"parity_run --models {key} exited {code}:\n"
                         f"{err[-3000:]}")
    with open(out_path) as f:
        for line in f:
            try:
                log.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    rec = {"event": "parity_run_envelope", "model": key,
           "wall_seconds": round(seconds, 1),
           "peak_rss_gb": round(peak_rss_gb(usage), 2),
           "checkpoints_bytes": du_bytes(os.path.join(runs_dir,
                                                      f"parity-{key}"))}
    log.append(rec)
    print(json.dumps(rec), flush=True)


def project(runs_dir: str) -> dict:
    """Steps/s and eval costs from each run's metrics.jsonl, over the full
    15 epochs of v0.9 train."""
    projection: dict = {"event": "projected_full_run", "epochs": EPOCHS}
    for key in MODELS:
        mpath = os.path.join(runs_dir, f"parity-{key}", "metrics.jsonl")
        if not os.path.exists(mpath):
            continue
        events = [json.loads(x) for x in open(mpath)]
        trains = [e for e in events if e.get("event") == "train"]
        evals = [e for e in events if e.get("event") == "eval"]
        cfg_ev = next(e for e in events if e.get("event") == "config")
        spe = V09_TRAIN_DIALOGS // cfg_ev["batch_size"]
        # steady state: the first window holds the kernels' builds and the
        # first batches' allocations
        rps = float(np.median([e["rounds_per_sec"] for e in trains[1:]])
                    if len(trains) > 1 else trains[-1]["rounds_per_sec"])
        eval_s = float(np.median([e["eval_seconds"] for e in evals])) \
            if evals else 0.0
        # the resident eval's cache is built once a training run and
        # reused by every later eval: it enters the budget once
        cache_s = float(max((e.get("resident_cache_seconds", 0.0)
                             for e in evals), default=0.0))
        rounds_per_step = cfg_ev["batch_size"] * cfg_ev["num_rounds"]
        total_steps = EPOCHS * spe
        train_h = total_steps * rounds_per_step / rps / 3600
        eval_h = (EPOCHS * eval_s + cache_s) / 3600
        projection[key] = {
            "compute_dtype": cfg_ev["compute_dtype"],
            "steps_per_epoch": spe, "total_steps": total_steps,
            "measured_rounds_per_sec": round(rps, 1),
            "measured_steps_per_sec": round(rps / rounds_per_step, 3),
            "measured_eval_seconds_full_val": round(eval_s, 1),
            "resident_cache_seconds_one_time": round(cache_s, 1),
            "projected_train_hours": round(train_h, 2),
            "projected_eval_hours": round(eval_h, 2),
            "projected_total_hours": round(train_h + eval_h, 2),
        }
    return projection


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--work_dir", default="build/parity_rehearsal")
    p.add_argument("--max_steps", type=int, default=304,
                   help="training-leg cap per model")
    p.add_argument("--out", default="",
                   help="the JSON log (default: <work_dir>/rehearsal.json)")
    p.add_argument("--reuse_data", action="store_true",
                   help="skip generation if the npz artifacts exist")
    p.add_argument("--config_json", default="",
                   help="JSON file of Config overrides for both runs")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.config_json:
        args.config_json = os.path.abspath(args.config_json)

    data_dir = os.path.join(args.work_dir, "data")
    runs_dir = os.path.join(args.work_dir, "runs")
    log: list = [{"event": "rehearsal_config",
                  "train_dialogs": V09_TRAIN_DIALOGS,
                  "val_dialogs": V09_VAL_DIALOGS,
                  "unique_answers": V09_UNIQUE_ANSWERS,
                  "max_steps": args.max_steps, "device": args.device,
                  "config_json": args.config_json}]
    if not (args.reuse_data and os.path.exists(
            os.path.join(data_dir, "visdial_data_val.npz"))):
        generate(data_dir, log)
    log.append({"event": "artifacts", "bytes": du_bytes(data_dir)})
    for key in MODELS:
        run_model(key, os.path.abspath(data_dir), os.path.abspath(runs_dir),
                  args, log)
    projection = project(runs_dir)
    log.append(projection)
    print(json.dumps(projection), flush=True)

    out = args.out or os.path.join(args.work_dir, "rehearsal.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(log, f, indent=1)
    done = {"event": "rehearsal_done", "out": out}
    print(json.dumps(done), flush=True)
    return projection


if __name__ == "__main__":
    main()
