"""dispatch_host_ms.train: host ms from the call into the graphed train step
to its return (the enqueue; the device runs on), a dispatch."""


def read(r):
    calls = r["spans"].get("dispatch") if r["kind"] == "train" else None
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
