"""eval_enqueue_ms.eval: host ms of the resident eval's batch loop (span
eval.batches, eval_harness.py: the batches' graph replays enqueued) over
the window record (the passes before the traced one), a pass."""

from vdbench import metrics as shared


def read(r):
    return shared.span_ms(r, "eval", "eval.batches")
