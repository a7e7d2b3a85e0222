"""eval_host_tail_ms.eval: host ms of the eval's metrics from the ranks
read back (span eval.metrics, eval_harness.py) over the window record, a
pass."""

from vdbench import metrics as shared


def read(r):
    return shared.span_ms(r, "eval", "eval.metrics")
