"""lm_head_roofline: K5 and K6's bound (work.py, over the real target tokens)
over their kernels' summed time in the trace (lm_score_partial_kernel,
lm_score_combine_kernel, lm_dlogits_kernel), in %."""

from vdbench import metrics as shared


def read(r):
    return shared.roofline(r, "train", "k5k6", shared.work.K5K6)
