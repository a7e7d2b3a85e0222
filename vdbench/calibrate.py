"""The readings the limits of `correct` are set from (limits/<cell>.json),
read on the chip in one process a cell:

    python3 -m vdbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control 3] [--faults half,token] [--seconds 1] --out <file.jsonl>

For each seed, a run of the cell's driver (set-up, a short window, the
comparison): the lower readings.  --control n: on the first n seeds the
reference computed in float8 (e4m3, reference/model.py) put in the
program's place against the float32 reference: the upper readings.
--faults: runs with each planted fault (drivers/), on the first three
seeds.  One JSON line a reading: {cell, mode, seed, numbers}.  A cell over
several ranks is read through `python -m vdbench.run`, a process a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from . import compare, spec, traffic, weights
from .drivers import RunArgs
from .reference import data as ref_data
from .reference import steps as ref_steps


def control(cell: spec.Cell, seed: int, device) -> tuple[dict, dict]:
    """The float8 reference against the float32 one, from the same start:
    (its numbers, what the limits are chosen from)."""
    conf, mix = cell.config, cell.traffic
    arrays = traffic.make_split(mix, conf, seed,
                                options=conf["decoder"] == "disc")
    fam = cell.family
    start = weights.make(conf, fam, traffic.seed_for(seed, 1), device)
    if mix["kind"] == "eval":
        band = cell.limits["out_of_band"]["band"]
        r32, bands = ref_steps.ranks(conf, fam, arrays, start, device=device,
                                     bands=tuple(sorted({band, *compare.BANDS})))
        r8, _ = ref_steps.ranks(conf, fam, arrays, start, precision="fp8",
                                device=device)
        return (compare.eval_numbers([r8], r32, bands[band])[0],
                compare.eval_detail([r8], r32, bands))
    G = int(mix["steps_per_dispatch"])
    B = conf["batch_size"] * int(mix.get("ranks", 1))       # the global batch
    order = ref_data.epoch_order(traffic.seed_for(seed, 3), int(mix["dialogs"]))
    ids = list(order[:G * B].reshape(G, B))
    words = traffic.vocab_words(conf)
    kw = dict(ranks=int(mix.get("ranks", 1)), device=device,
              tokens=(words["<START>"], words["<END>"]))
    drop = traffic.seed_for(seed, 2)
    host = {k: v.cpu() for k, v in start.items()}
    r32 = ref_steps.train(conf, fam, arrays, host, ids, drop, **kw)
    r8 = ref_steps.train(conf, fam, arrays, host, ids, drop, precision="fp8",
                         **kw)
    r8 = {"loss": r8["loss"], "params": {k: v.cpu() for k, v in r8["params"].items()},
          "m": {k: v.cpu() for k, v in r8["m"].items()}}
    return (compare.train_numbers(r8, r32, host),
            compare.train_detail(r8, r32, host))




def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--skip_program", action="store_true")
    p.add_argument("--spec", default=spec.SPEC)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    from .run import cache_dirs, driver, log

    cache_dirs(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cell = spec.load_cell(args.workload, args.spec)
    seeds = [int(s) for s in args.seeds.split(",")]
    ranks = int(cell.traffic.get("ranks", 1))
    device = torch.device("cuda", 0)
    with open(args.out, "a") as out:
        def put(mode, seed, numbers, **extra):
            line = {"cell": cell.name, "mode": mode, "seed": seed,
                    "numbers": numbers, **extra}
            out.write(json.dumps(line) + "\n")
            out.flush()
            log(json.dumps({k: v for k, v in line.items() if k != "detail"}))

        def one(seed, fault=None):
            if ranks > 1:
                cmd = [sys.executable, "-m", "vdbench.run", "--workload",
                       cell.name, "--seed", str(seed), "--seconds",
                       str(args.seconds), "--trace", "0"]
                if fault:
                    cmd += ["--fault", fault]
                r = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
                res = json.loads(r.stdout.strip().splitlines()[-1])
                return ({k: v for k, (v, _) in res["compared"].items()},
                        res["correct"], None)
            res = driver(cell).run(RunArgs(cell=cell, seed=seed,
                                           seconds=args.seconds, trace=False,
                                           device="cuda", t0=time.time(),
                                           fault=fault, log=log, detail=True))
            return ({k: v for k, (v, _) in res["compared"].items()},
                    res["correct"], res.get("detail"))

        if not args.skip_program:
            for seed in seeds:
                t = time.time()
                numbers, ok, detail = one(seed)
                put("program", seed, numbers, correct=ok, detail=detail,
                    seconds=time.time() - t)
        for seed in seeds[:args.control]:
            t = time.time()
            numbers, detail = control(cell, seed, device)
            put("control_fp8", seed, numbers, detail=detail,
                seconds=time.time() - t)
        for fault in filter(None, args.faults.split(",")):
            for seed in seeds[:3]:
                numbers, ok, detail = one(seed, fault)
                put("fault_" + fault, seed, numbers, correct=ok, detail=detail)
    return 0


if __name__ == "__main__":
    sys.exit(main())
