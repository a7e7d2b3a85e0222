"""setup_capture_s: seconds of set-up in the port's graph captures (span
graph.capture, parallel/graph.py: each new signature's warm-up and
capture); a CPU run captures nothing and has none."""

from vdbench import metrics as shared


def read(r):
    return shared.setup_seconds(r, "graph.capture")
