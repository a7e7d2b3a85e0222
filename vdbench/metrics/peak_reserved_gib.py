"""peak_reserved_gib: torch.cuda.max_memory_reserved() at the window's close,
graph pools included, on the run's fullest card."""


def read(r):
    if not r["peak_reserved_bytes"]:
        return None
    return r["peak_reserved_bytes"] / 2 ** 30
