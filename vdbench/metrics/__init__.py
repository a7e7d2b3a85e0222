"""One reader a metric: metrics/<metric>.py holds `read(readings)`, which
returns the metric's value or None where the run holds nothing to read
(drivers/__init__.py lists the readings).  What the trace-based readers
share is here: the traced stretch's work and its kernels' time."""

from .. import trace, work


def traced(r, kind):
    """(trace summary, work dict) of a traced run of this kind, else None."""
    if r["kind"] != kind or not r.get("trace") or not r.get("work"):
        return None
    return r["trace"], r["work"]


def mfu(r, kind):
    got = traced(r, kind)
    if got is None or not got[1]["model"]:
        return None
    summary, w = got
    return 100.0 * w["model"] / (summary["window_s"] * work.PEAK_BF16)


def roofline(r, kind, group, names):
    got = traced(r, kind)
    if got is None:
        return None
    summary, w = got
    return work.roofline_pct(w[group], trace.kernel_seconds(summary, names))


def idle_pct(r, kind):
    got = traced(r, kind)
    if got is None or not got[0]["busy_s"]:
        return None
    summary = got[0]
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
