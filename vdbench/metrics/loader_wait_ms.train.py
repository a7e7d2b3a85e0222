"""loader_wait_ms.train: host ms a dispatch waits on the port's TrainLoader for
its group of batches (the benchmark's span around next())."""


def read(r):
    waits = r["spans"].get("loader_wait") if r["kind"] == "train" else None
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
