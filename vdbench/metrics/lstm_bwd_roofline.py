"""lstm_bwd_roofline: K2's bound (work.py) over its kernels' summed time in the
trace (lstm_bwd_gates_kernel, lstm_bwd_dh_kernel), in %."""

from vdbench import metrics as shared


def read(r):
    return shared.roofline(r, "train", "k2", shared.work.K2)
