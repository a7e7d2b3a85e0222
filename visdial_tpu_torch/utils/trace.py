"""Spans and counters of the port's host work, at the boundaries of its
layers: the loader, the upload, the graphed dispatch, the resident eval and
set-up.

    trace.start()
    with trace.span("upload"):
        ...
    trace.count("upload.bytes", n)
    record = trace.stop()
    trace.self_seconds(record, "train.dispatch")

`span(name)` is a context manager.  While no recording runs it returns one
shared object that does nothing: no clock read, no allocation, no
record_function, so the spans cost the hot paths almost nothing when off.
While one runs, each span keeps (name, parent, thread, start, end) in
memory, on time.perf_counter_ns's clock; the parent is the innermost span
open on the same thread.  While a torch.profiler is active as well, each
span also opens record_function("vdt." + name), which puts it on the
profiler's timeline beside the kernels it enqueued.  A profiler records
the host events of the threads it profiles: by default only the thread
that started it, so a worker thread's spans then stay in memory only.
Each Python garbage collection while recording is a span named "gc" on the
thread that ran it.

`count(name, n)` adds to a named counter, on or off.  `counters()` reads
them together with the launch counters of parallel/graph.py::counters (the
kernels' launches, the bf16 contractions' tensor-core calls, the mesh's
collectives).  A record holds the spans, each counter's change over the
recording and the spans' names, all JSON, so a rank can hand it on.

Spans and counters (parallel/graph.py, parallel/train_step.py,
data/loader.py, models/model.py, eval_harness.py, ops/_build.py,
parallel/mesh.py):

  loader.assemble   one batch assembled on TrainLoader's worker thread
  loader.wait       the consumer blocked on an empty queue; counters
                    loader.gets, loader.empty_gets
  upload            batch_to_device to a device; child upload.copy (the
                    copies); counter upload.bytes (a CPU target is none)
  train.dispatch    GraphedTrainStep's call: seeds, scalars, the graph
  graph.copy_in, graph.replay, graph.clone_out
                    a replay of a Graphed call; counter graph.replays
  graph.capture     a new signature's warm-up and capture; counter
                    graph.captures
  eval.table, eval.batches, eval.readback, eval.metrics
                    a resident eval pass: the params and the option table,
                    the batches' replays, the ranks read back, the
                    metrics
  build.host        host set-up: BatchAssembler's image normalisation,
                    the resident eval's stacks
  kernels.load      the kernel library's first load (its build included)
  mesh.init         make_mesh: the process groups and their communicators

train.py --profile_steps records them over set-up (to the end of the first
dispatch), over its profiled steps and over each eval, and logs each
record's summary() as a 'spans' event.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PROFILER_PREFIX = "vdt."


class _Null:
    """The span while no recording runs: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Recording:
    """The spans of one recording: a span is an index drawn from one
    counter, and each of its fields (name code, parent, thread, t0_ns,
    t1_ns) is an int stored under that index in the field's dict.  No
    lock: drawing an index and storing an int are single steps under the
    interpreter lock, and Python may collect garbage (and so open a gc
    span) between any two steps of a span's own.  The ints are no objects
    the collector tracks, so a recording leaves its pace unchanged."""

    def __init__(self):
        self.codes: dict = {}            # span name -> its code
        self.next = itertools.count()
        self.fields = tuple({} for _ in range(5))
        self.local = threading.local()
        self.counts0 = counters()
        self.gc_open: dict = {}          # thread -> its open gc span

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_recording: _Recording | None = None
_counts: dict = {}


class _Span:
    __slots__ = ("rec", "name", "index", "rf")

    def __init__(self, rec: _Recording, name: str):
        self.rec, self.name, self.rf = rec, name, None

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        i = self.index = next(rec.next)
        code, parent, thread, t0, t1 = rec.fields
        code[i] = rec.codes.setdefault(self.name, len(rec.codes))
        parent[i] = stack[-1] if stack else -1
        thread[i] = threading.get_ident()
        t1[i] = 0
        stack.append(i)
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self.rf.__enter__()
        t0[i] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec.fields[4][self.index] = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = self.rec.stack()
        if stack and stack[-1] == self.index:
            stack.pop()
        return False


def span(name: str):
    """A span named `name` while recording, else the shared no-op."""
    rec = _recording
    if rec is None:
        return _NULL
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """Every counter's value now: this module's and parallel/graph.py's
    launch counters."""
    from ..parallel.graph import counters as launch_counters

    return {**_counts,
            **{name: getattr(obj, attr) for name, obj, attr in launch_counters()}}


def _on_gc(phase: str, info: dict) -> None:
    rec = _recording
    if rec is None:
        return
    tid = threading.get_ident()
    if phase == "start":
        s = rec.gc_open[tid] = _Span(rec, "gc")
        s.__enter__()
    else:
        s = rec.gc_open.pop(tid, None)
        if s is not None:
            s.__exit__(None, None, None)


def start() -> None:
    """Start a recording (a running one is dropped)."""
    global _recording
    _recording = _Recording()
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)


def stop() -> dict | None:
    """End the recording and return it, None if none ran: {"names": [span
    name, ...], "spans": [(name index, parent, thread, t0_ns, t1_ns), ...]
    (a span still open ends at the stop), "counters": {name: change}}."""
    global _recording
    rec = _recording
    if rec is None:
        return None
    _recording = None
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    now = time.perf_counter_ns()
    # t0 is a span's last field set, so it is copied first: a span that
    # another thread enters during the copies is in the later copies or in
    # none, and each span in t0's copy has all its fields
    t0 = dict(rec.fields[3])
    code, parent, thread, _, t1 = (dict(f) for f in rec.fields)
    names = sorted(rec.codes, key=rec.codes.get)
    kept = sorted(t0)
    at = {i: j for j, i in enumerate(kept)}
    # tuples of ints, which the collector stops tracking: a record kept
    # alive does not change when Python next collects in full
    spans = [(code[i], at.get(parent[i], -1), thread[i], t0[i], t1[i] or now)
             for i in kept]
    after = counters()
    return {"names": names, "spans": spans,
            "counters": {k: v - rec.counts0.get(k, 0)
                         for k, v in after.items()
                         if v != rec.counts0.get(k, 0)}}


def _of(record: dict, name: str) -> list[int]:
    """Indices of the spans called `name` that lie inside no other span of
    that name (so a nested one is not counted twice)."""
    if name not in record["names"]:
        return []
    code = record["names"].index(name)
    spans = record["spans"]

    def nested(i: int) -> bool:
        p = spans[i][1]
        while p >= 0:
            if spans[p][0] == code:
                return True
            p = spans[p][1]
        return False

    return [i for i, s in enumerate(spans) if s[0] == code and not nested(i)]


def spans_of(record: dict, name: str) -> int:
    """How many spans called `name` the record holds (nested ones of the
    same name not counted)."""
    return len(_of(record, name))


def seconds(record: dict, name: str) -> float:
    """Summed duration of the spans called `name`, in seconds."""
    spans = record["spans"]
    return sum(spans[i][4] - spans[i][3] for i in _of(record, name)) / 1e9


def self_seconds(record: dict, name: str) -> float:
    """Summed self time of the spans called `name`, in seconds: each
    span's duration less the part of it that its child spans cover."""
    spans = record["spans"]
    wanted = set(_of(record, name))
    children: dict = {}
    for s in spans:
        if s[1] in wanted:
            children.setdefault(s[1], []).append((s[3], s[4]))
    total = 0
    for i in wanted:
        t0, t1 = spans[i][3], spans[i][4]
        covered, end = 0, t0
        for a, b in sorted(children.get(i, [])):
            a, b = max(a, end), min(b, t1)
            if b > a:
                covered += b - a
                end = b
        total += t1 - t0 - covered
    return total / 1e9


def summary(record: dict) -> dict:
    """{"spans": {name: {"count", "seconds", "self_seconds"}}, "counters":
    the record's counter changes}: the operator's one-line account."""
    return {"spans": {n: {"count": spans_of(record, n),
                          "seconds": seconds(record, n),
                          "self_seconds": self_seconds(record, n)}
                      for n in record["names"]},
            "counters": dict(record["counters"])}
