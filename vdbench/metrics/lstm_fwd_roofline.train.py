"""lstm_fwd_roofline.train: K1's bound (its operations or bytes from work.py,
over the real LSTM steps fed) over K1's summed kernel time in the trace
(lstm_fwd_step_kernel), in %."""

from vdbench import metrics as shared


def read(r):
    return shared.roofline(r, "train", "k1", shared.work.K1)
