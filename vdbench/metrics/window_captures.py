"""window_captures: graphs the port captured in the window record (the
window's dispatches or passes before the traced stretch; the change in the
counter graph.captures, parallel/graph.py); 0 where set-up captured every
signature the window replays."""

from vdbench import metrics as shared


def read(r):
    got = shared.program(r, "window")
    if got is None:
        return None
    return float(got[1].get("graph.captures", 0))
