"""setup_kernels_s: seconds of set-up in the kernel library's first load,
its build included where the checkout has none yet (span kernels.load,
ops/_build.py); a CPU run loads none."""

from vdbench import metrics as shared


def read(r):
    return shared.setup_seconds(r, "kernels.load")
