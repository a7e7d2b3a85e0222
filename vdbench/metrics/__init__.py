"""One reader a metric: metrics/<metric>.py holds `read(readings)`, which
returns the metric's value or None where the run holds nothing to read
(drivers/__init__.py lists the readings).  What the trace-based readers
share is here: the traced stretch's work and its kernels' time, and the
port's own spans and counters in a traced run's two records (setup, and
window: the window's dispatches or passes before the traced stretch)."""

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


def program(r, record, kind=None):
    """(spans, counters) of the port's record `record` ("setup" or "window")
    in a traced run (of this kind), else None."""
    records = r.get("program_spans")
    if not records or record not in records or kind not in (None, r["kind"]):
        return None
    return records[record], r["program_counters"][record]


def span_ms(r, kind, name, field="seconds"):
    """ms of the port's span `name` (its `field`: seconds or self_seconds)
    in the window record, a dispatch or pass; None where it holds none."""
    got = program(r, "window", kind)
    if got is None or name not in got[0]:
        return None
    return 1e3 * got[0][name][field] / r["window_units"]


def setup_seconds(r, name):
    """Seconds of the port's span `name` in set-up, None where it holds
    none."""
    got = program(r, "setup")
    if got is None or name not in got[0]:
        return None
    return got[0][name]["seconds"]
