"""graph_launch_ms.train: host ms of the graphed step's replays (span
graph.replay, parallel/graph.py) over the window record, untraced, a
dispatch; a CPU run replays no graph and has none."""

from vdbench import metrics as shared


def read(r):
    return shared.span_ms(r, "train", "graph.replay")
