"""loader_empty_pct.train: the share of the window record's gets from the
port's TrainLoader queue that found it empty and waited (counters
loader.empty_gets over loader.gets, data/loader.py), in %."""

from vdbench import metrics as shared


def read(r):
    got = shared.program(r, "window", "train")
    if got is None or not got[1].get("loader.gets"):
        return None
    return 100.0 * got[1].get("loader.empty_gets", 0) / got[1]["loader.gets"]
