"""nccl_ms_per_step: NCCL kernels' device ms (names holding "nccl") in the
traced stretch over its optimizer steps, on rank 0."""

from vdbench import metrics as shared


def read(r):
    got = shared.traced(r, "train")
    if got is None or not got[1]["steps"]:
        return None
    seconds = shared.trace.kernel_seconds(got[0], ("nccl",))
    return None if seconds is None else 1e3 * seconds / got[1]["steps"]
