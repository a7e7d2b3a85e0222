"""loader_assemble_ms.train: host ms the port's TrainLoader spends assembling
batches on its worker thread (span loader.assemble, data/loader.py) over
the window record (the dispatches before the traced stretch), a dispatch."""

from vdbench import metrics as shared


def read(r):
    return shared.span_ms(r, "train", "loader.assemble")
