"""device_idle_pct.train: the share of the traced stretch's wall time in which
no kernel ran on the card (the union of the kernels' intervals), in %."""

from vdbench import metrics as shared


def read(r):
    return shared.idle_pct(r, "train")
