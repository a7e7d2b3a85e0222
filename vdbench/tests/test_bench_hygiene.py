"""A run over several ranks leaves nothing behind: the four-card cell's
launch path as a gloo world of two ranks at the tiny config, started in a
session of its own.  After the command returns, no process of that session
is left (read from /proc/*/stat) and no new file is in /dev/shm; so also
when a rank raises and when one hangs past the deadline."""

import os
import subprocess
import sys
import time

import pytest

from vdbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _session_members(sid: int) -> list:
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid:          # stat field 6: the session id
            out.append(int(pid))
    return out


def _shm() -> set:
    return set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")), ranks=2)


@pytest.mark.parametrize("fault,ok", [(None, True), ("raise", False),
                                      ("hang", False)])
def test_ranks_reaped(spec_path, fault, ok):
    cmd = [sys.executable, "-m", "vdbench.run", "--workload",
           "tiny-gen.train-dp2", "--seed", "4242", "--seconds", "0.5",
           "--trace", "0", "--spec", spec_path, "--device", "cpu"]
    if fault:
        cmd += ["--fault", fault, "--deadline", "40"]
    before = _shm()
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    out, err = p.communicate(timeout=600)
    assert (p.returncode == 0) == ok, err[-3000:]
    assert bool(out.strip()) == ok
    time.sleep(0.5)
    assert _session_members(p.pid) == [], err[-2000:]
    assert _shm() - before == set()
    assert "ranks reaped" in err
