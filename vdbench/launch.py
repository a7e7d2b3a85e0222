"""A run over several ranks: the run's process starts each rank itself and
reaps every one before it prints.

Each rank is a plain child process (`python -m vdbench.rank`) in a
process group of its own (in the run's session), with the environment
torchrun gives a rank (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); it hands its result back in a file of the run's own
temporary directory.  No multiprocessing context, queue,
manager or resource tracker is used.  The parent builds the port's kernel
library and its native loader core once, before any rank starts, so no two
ranks compile at once.

The parent waits for every rank's exit status.  On a rank's failure, or at
the deadline, it sends SIGTERM to every rank's process group, SIGKILL after
a grace, and waits for each; it does the same to the groups of ranks that
exited cleanly, so that nothing a rank started outlives the run.  It
names on stderr every entry that appeared in /dev/shm while the ranks ran
and removes none: /dev/shm is the machine's, and an entry there may be
another process's (vdbench/tests/test_bench_hygiene.py fails on one the
ranks leave).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHM = "/dev/shm"
GRACE_S = 10.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shm() -> set:
    try:
        return set(os.listdir(SHM))
    except OSError:
        return set()


def _signal_group(pid: int, sig: int) -> None:
    try:
        os.killpg(pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def reap(procs: list, grace: float = GRACE_S) -> None:
    """End every rank's process group and wait for every rank."""
    for p in procs:
        if p.poll() is None:
            _signal_group(p.pid, signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        _signal_group(p.pid, signal.SIGKILL)   # the group's stragglers too
        p.wait()


def build_once(device: str, log) -> None:
    """Build what the ranks load (the native loader core; on the card the
    kernel library)."""
    from visdial_tpu_torch.data import native
    from visdial_tpu_torch.ops import _build

    t = time.time()
    native.available()
    if device == "cuda":
        _build.library_path()
    log(f"[vdbench] native core and kernels ready in {time.time() - t:.1f} s")


def run_ranks(argv: list, world: int, deadline_s: float, log=print) -> list:
    """Run `python -m vdbench.rank <argv> --out <file>` on `world` ranks;
    every rank's result (a dict) in rank order.  Raises RuntimeError when a
    rank fails or the deadline passes, after every rank is reaped."""
    before = _shm()
    port = free_port()
    procs, outs = [], []
    with tempfile.TemporaryDirectory(prefix="vdbench-ranks-") as tmp:
        try:
            for r in range(world):
                out = os.path.join(tmp, f"rank{r}.json")
                outs.append(out)
                env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                               filter(None, [ROOT, os.environ.get("PYTHONPATH")])),
                           RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "vdbench.rank", *argv, "--out", out],
                    env=env, stdin=subprocess.DEVNULL, stdout=sys.stderr,
                    process_group=0))
            end = time.monotonic() + deadline_s
            failure = None
            while failure is None and any(p.poll() is None for p in procs):
                bad = [(r, p.returncode) for r, p in enumerate(procs)
                       if p.returncode not in (None, 0)]
                if bad:
                    failure = f"rank {bad[0][0]} exited with {bad[0][1]}"
                elif time.monotonic() > end:
                    failure = f"ranks still running after {deadline_s:.0f} s"
                else:
                    time.sleep(0.2)
            if failure is None:
                bad = [(r, p.returncode) for r, p in enumerate(procs)
                       if p.returncode != 0]
                if bad:
                    failure = f"rank {bad[0][0]} exited with {bad[0][1]}"
        finally:
            reap(procs)
            log(f"[vdbench] ranks reaped: exit codes "
                f"{[p.returncode for p in procs]}; new /dev/shm entries "
                f"{sorted(_shm() - before)}")
        if failure is not None:
            raise RuntimeError(failure)
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
    return results
