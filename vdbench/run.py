"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m vdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, with --trace 1 breakdown, and
last `compared`: each number that decided `correct` beside its limit,
which also close standard error.  Progress goes to standard error.

The run exits non-zero and prints no result where there is no card or
fewer than the cell asks for, where a rank fails, or where JAX, jaxlib,
flax or the JAX package (visdial_tpu) is loaded once the window has closed.
`--device cpu` rehearses a run on the CPU with the port's plain versions
(the tests' tiny cells); its numbers are no device's.
"""

from __future__ import annotations

import time

T0 = time.time()   # the process's start, for setup_s

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "visdial_tpu")
RANKS_DEADLINE_S = 1100.0   # ends hung ranks; a first run builds and compiles


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: visdial_tpu_torch is not visdial_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every compile cache in fixed directories inside the checkout."""
    build = os.path.join(root, "build", "vdbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--spec", default=spec.SPEC)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    p.add_argument("--deadline", type=float, default=None, help=argparse.SUPPRESS)
    return p


def driver(cell: spec.Cell):
    return importlib.import_module(f"vdbench.drivers.{cell.traffic['kind']}")


def card(device_index: int = 0) -> dict:
    """The card's name and power limit (nvidia-smi; None where unread)."""
    import subprocess

    import torch

    out = {"kind": torch.cuda.get_device_name(device_index), "power_limit_w": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={device_index}"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip().splitlines()[0]
        out["power_limit_w"] = float(line)
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return out


def _one_process(args, cell) -> dict:
    from .drivers import RunArgs

    res = driver(cell).run(RunArgs(cell=cell, seed=args.seed,
                                   seconds=args.seconds, trace=bool(args.trace),
                                   device=args.device, t0=T0, fault=args.fault,
                                   log=log))
    res["card"] = card() if args.device == "cuda" else {"kind": "cpu"}
    res["traces"] = [res["readings"]["trace"]]
    return res


def _ranks(args, cell, ranks: int) -> dict:
    """Rank 0's result, with the memory peak of the fullest rank and the
    busy time averaged over the ranks."""
    from . import launch

    launch.build_once(args.device, log)
    deadline = args.deadline or RANKS_DEADLINE_S
    argv = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace),
            "--spec", os.path.abspath(args.spec), "--device", args.device,
            "--t0", repr(T0)]
    if args.fault:
        argv += ["--fault", args.fault]
    results = launch.run_ranks(argv, ranks, deadline - (time.time() - T0), log)
    bad = sorted({m for r in results for m in r.get("forbidden", [])})
    if bad:
        raise RuntimeError(f"a rank loaded {bad}")
    res = results[0]
    res["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in results)
    res["traces"] = [r["readings"]["trace"] for r in results]
    return res


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache_dirs(root)
    cell = spec.load_cell(args.workload, args.spec)
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < cell.chips):
        log(f"[vdbench] {args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    ranks = int(cell.traffic.get("ranks", 1))
    try:
        res = _ranks(args, cell, ranks) if ranks > 1 else _one_process(args, cell)
    except RuntimeError as e:
        log(f"[vdbench] run failed: {e}")
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"[vdbench] the run loaded {bad}: the benchmark runs the port alone")
        return 3
    readings = res["readings"]
    metrics = spec.read_metrics(cell.per_layer if args.trace else cell.end_to_end,
                                readings)
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": res["card"]["kind"], "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power_limit_w": res["card"].get("power_limit_w")}
    line = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device}
    traces = [t for t in res["traces"] if t]
    if args.trace and traces:
        device["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        device["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        line["breakdown"] = {"device_ops": readings["trace"]["device_ops"],
                             "idle_gaps": readings["trace"]["idle_gaps"]}
    # a number that could not be read (no finite value) shows as null
    line["compared"] = {k: [v if math.isfinite(v) else None, lim]
                        for k, (v, lim) in res["compared"].items()}
    for name, (value, limit) in res["compared"].items():
        log(f"{name} {value!r} limit {limit!r}")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
