"""dispatch_self_ms.train: host ms of the port's train dispatch
(span train.dispatch, parallel/train_step.py) less its child spans (the
graph's copies in and out and its replay): the seeds, the scalars and the
call's own overhead, over the window record, a dispatch."""

from vdbench import metrics as shared


def read(r):
    return shared.span_ms(r, "train", "train.dispatch", "self_seconds")
