"""train_mfu: the model's operations in the traced stretch (counted by
work.py from the fed shapes and real lengths, none recomputed) over the
stretch's time at the card's dense bf16 peak, in %."""

from vdbench import metrics as shared


def read(r):
    return shared.mfu(r, "train")
