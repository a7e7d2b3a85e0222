"""Run a function on N ranks of a fresh process group from one process: the
environment torchrun would give each rank, set by hand (the tests' gloo
worlds on the CPU; chip_smoke.py's NCCL ranks on a machine with several
cards).

    results = run_ranks(fn, 2, arg1, arg2, timeout=120)

fn(rank, *args) runs in a spawned process with RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR (127.0.0.1) and MASTER_PORT (a free port) set, so
parallel/mesh.py::make_mesh joins the group; its return value (picklable)
comes back in rank order.  A rank that raises, dies or outlives the timeout
fails the whole run, and every process is ended before run_ranks returns.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn, args, out) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    try:
        out.put((rank, True, fn(rank, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 300.0) -> list:
    """[fn(rank, *args) for each rank], each in its own process."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, fn, args, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {world - len(results)} "
                                       f"rank(s) still running after "
                                       f"{timeout} s") from None
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in results]
                if dead and out.empty():
                    raise RuntimeError(f"run_ranks: rank(s) {dead} exited "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{val}")
            results[rank] = val
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world)]
