#!/usr/bin/env python3
"""Eval rates of the port on one GPU, and where an eval's time goes.

    python scripts/eval_rates.py [--root DIR] [--label NAME] [--reps 5] \
        [--profile]

evaluate_split over gen_eval's 256-dialog split (make_random_split, seed 1,
100,000 unique answers) for flagship MN-QIH-disc (the parameters outside
the LSTMs times 4, as chip_smoke.py's disc evals) and MN-QIH-gen, f32, TF32
off, kernels on: the streaming path and, where the checkout has it, the
resident one, --reps runs of each in turn after one warm-up run of each.
Prints one JSON line per model with every run's evals_per_sec (the
resident rate includes the disc option table's build, the streaming one
excludes it, as in the JAX harness).  --profile adds one torch.profiler
run of each path: the device's busy share of the wall time, kernel
launches and the top kernels (profile_train.device_time_summary).

--root imports visdial_tpu_torch from another checkout, so that two commits
are compared in one call on one card (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", type=str,
                   default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--label", type=str, default="")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--dialogs", type=int, default=256)
    p.add_argument("--profile", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("eval_rates: needs a CUDA device")
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.models.model import model_init
    from visdial_tpu_torch.profile_train import device_time_summary
    from visdial_tpu_torch.utils.params import flatten, unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    has_resident = "resident" in inspect.signature(evaluate_split).parameters
    paths = {"stream": {}} | ({"resident": {"resident": True}}
                              if has_resident else {})
    for decoder in ("disc", "gen"):
        base = Config(encoder="mn-ques-im-hist", decoder=decoder, dropout=0.0)
        split, vocab = make_random_split(base, num_dialogs=args.dialogs, seed=1)
        cfg = base.replace(vocab_size=vocab.size)
        params = model_init(cfg, seed=0, device=dev)
        if decoder == "disc":
            params = unflatten({n: v if "lstm" in n else v * 4.0
                                for n, v in flatten(params).items()})

        def run(kw):
            return evaluate_split(params, split, vocab, cfg, dev, **kw)

        for kw in paths.values():
            run(kw)                                         # warm-up
        rates = {name: [] for name in paths}
        for _ in range(args.reps):
            for name, kw in paths.items():
                rates[name].append(run(kw)["evals_per_sec"])
        row = {"label": args.label, "root": os.path.abspath(args.root),
               "model": f"mn-ques-im-hist-{decoder}", "dialogs": args.dialogs,
               "nvidia_smi": smi,
               **{f"{n}_evals_per_sec": statistics.median(r)
                  for n, r in rates.items()},
               **{f"{n}_evals_per_sec_runs": r for n, r in rates.items()}}
        if args.profile:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            for name, kw in paths.items():
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    run(kw)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                row[f"{name}_profile"] = {
                    "wall_ms": wall * 1e3,
                    **device_time_summary(prof, 1, wall, top=6)}
        print(json.dumps(row), flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
