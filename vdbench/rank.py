"""One rank of a run over several ranks (launch.py starts it).

    python -m vdbench.rank <run.py's arguments> --t0 <parent start> --out <file>

It runs the cell's driver with the environment torchrun would give it,
writes its result to --out, destroys its process group and exits.
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import run, spec
from .drivers import RunArgs


def main(argv=None) -> int:
    p = run.parser()
    p.add_argument("--t0", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, args.spec)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    import torch
    import torch.distributed as dist

    try:
        if args.fault in ("raise", "hang") and os.environ["RANK"] == "1":
            if args.fault == "raise":      # the launcher's tests: a rank fails
                raise RuntimeError("planted fault: rank 1 raises")
            time.sleep(3600)               # ... or outlives the deadline
        res = run.driver(cell).run(RunArgs(
            cell=cell, seed=args.seed, seconds=args.seconds,
            trace=bool(args.trace), device=args.device, t0=args.t0,
            fault=args.fault, log=log))
        res["card"] = (run.card(torch.cuda.current_device())
                       if args.device == "cuda" else {"kind": "cpu"})
        res["forbidden"] = run.forbidden_modules()
        with open(args.out, "w") as f:
            json.dump(res, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
