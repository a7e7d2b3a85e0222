"""upload_ms.train: host ms of the port's upload of a dispatch's batches
to the card (span upload, models/model.py::batch_to_device: the host
tensors and their copies) over the window record, a dispatch; a CPU run
ships nothing and has none."""

from vdbench import metrics as shared


def read(r):
    return shared.span_ms(r, "train", "upload")
