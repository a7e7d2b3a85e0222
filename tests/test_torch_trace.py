"""The port's spans and counters (visdial_tpu_torch/utils/trace.py) on the
CPU: the off path's shared no-op, nesting and self time, the gc span, the
profiler's `vdt.` events, and the spans and counters at the loader, the
upload, the graphed dispatch (on graph.py's stand-ins, test_torch_graphs.py's
fake_card) and the resident eval."""

import dataclasses
import gc
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from visdial_tpu_torch.data.loader import TrainLoader
from visdial_tpu_torch.data.synthetic import make_synthetic_split
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.ops.lstm_cuda import lstm_layer
from visdial_tpu_torch.parallel import graph
from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_disc_table_eval_fns,
                                                   make_multistep_train_fn)
from visdial_tpu_torch.train import main as train_main
from visdial_tpu_torch.utils import trace

from conftest import small_config
from test_torch_graphs import fake_card  # noqa: F401


@pytest.fixture
def recorder():
    """A recording over the test, ended whatever happens."""
    trace.start()
    try:
        yield
    finally:
        trace.stop()


def _names(record) -> list:
    return [record["names"][s[0]] for s in record["spans"]]


def _split(cfg, dialogs=16):
    split, vocab = make_synthetic_split(cfg, num_dialogs=dialogs, seed=0)
    return split, vocab, cfg.replace(vocab_size=vocab.size)


def test_off_span_is_one_shared_no_op(monkeypatch):
    """Off, span() returns one shared object and reads no clock, calls no
    record_function and records nothing."""
    assert trace.stop() is None

    def refuse(*args, **kw):
        raise AssertionError("called while the recorder is off")

    monkeypatch.setattr(trace.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = trace.span("upload"), trace.span("graph.replay")
    assert a is b
    with a:
        with b:
            pass
    assert trace.stop() is None


def test_nesting_parents_and_self_seconds(monkeypatch):
    """Parents are the innermost span open on the same thread; a span on
    another thread has none; self time is a span's duration less what its
    children cover; a span nested in one of its own name counts once."""
    clock = iter(range(0, 10 ** 6, 1000))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(clock))
    gc.disable()
    try:
        trace.start()
        with trace.span("dispatch"):                 # 0 .. 8000
            with trace.span("copy"):                  # 1000 .. 2000
                pass
            with trace.span("replay"):                # 3000 .. 7000
                with trace.span("replay"):            # 4000 .. 6000
                    t = threading.Thread(             # 5000 .. the stop
                        target=lambda: trace.span("worker").__enter__())
                    t.start()
                    t.join(timeout=10)
        record = trace.stop()                         # at 9000
    finally:
        gc.enable()
    assert not t.is_alive()
    names = _names(record)
    assert names == ["dispatch", "copy", "replay", "replay", "worker"]
    parents = [s[1] for s in record["spans"]]
    assert parents == [-1, 0, 0, 2, -1]
    assert record["spans"][4][2] != record["spans"][0][2]     # its thread
    assert record["spans"][4][4] == 9000                      # open: the stop
    assert trace.seconds(record, "dispatch") == 8000 / 1e9
    assert trace.self_seconds(record, "dispatch") == (8000 - 1000 - 4000) / 1e9
    assert trace.spans_of(record, "replay") == 1
    assert trace.seconds(record, "replay") == 4000 / 1e9
    assert trace.self_seconds(record, "replay") == 2000 / 1e9
    assert trace.seconds(record, "missing") == 0.0
    got = trace.summary(record)["spans"]
    assert got["dispatch"]["count"] == 1
    assert got["copy"]["self_seconds"] == got["copy"]["seconds"] == 1e-6


def test_threads_and_collections_record_every_span(recorder):
    """Threads recording at once while Python collects after nearly every
    allocation (a gc span may open between any two steps of another
    span's): every span is kept, closed, and nested on its own thread,
    and nothing blocks."""
    n, per = 2 * (os.cpu_count() or 1) + 2, 300

    def work():
        for _ in range(per):
            with trace.span("outer"):
                with trace.span("inner"):
                    a = []
                    a.append(a)                 # a cycle for the collector

    threshold, interval = gc.get_threshold(), sys.getswitchinterval()
    gc.set_threshold(1)
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        record = trace.stop()
    finally:
        gc.set_threshold(*threshold)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    names, spans = _names(record), record["spans"]
    assert names.count("outer") == names.count("inner") == n * per
    assert "gc" in names
    for s, name in zip(spans, names):
        assert s[3] <= s[4]
        if name == "inner":
            assert names[s[1]] == "outer"
        if s[1] >= 0:
            assert spans[s[1]][2] == s[2]       # the parent's thread


def test_a_span_entered_while_stopping_is_whole_or_left_out():
    """stop() copies the span fields one dict at a time; a span that
    another thread enters between two of the copies (the loader's worker,
    still assembling) is kept with every field or left out, never half."""

    class Copying(dict):
        """A field dict that, once its keys are taken for a copy, lets a
        span be entered on another thread."""
        hook = None

        def __iter__(self):                 # copies go through keys()
            return iter(list(super().keys()))

        def keys(self):
            ks = list(super().keys())
            hook, Copying.hook = Copying.hook, None
            if hook is not None:
                hook()
            return ks

    trace.start()
    with trace.span("main"):
        pass
    rec = trace._recording
    late = trace.span("worker")             # got before the stop
    rec.fields = tuple(Copying(f) for f in rec.fields)

    def enter():
        t = threading.Thread(target=late.__enter__)
        t.start()
        t.join(timeout=10)

    Copying.hook = enter
    record = trace.stop()
    assert Copying.hook is None                 # it ran during the copies
    assert late.index in rec.fields[3]          # entered, after t0's copy
    assert _names(record) == ["main"]


def test_gc_collection_is_a_span(recorder):
    with trace.span("eval.metrics"):
        gc.collect()
    record = trace.stop()
    names = _names(record)
    assert "eval.metrics" in [names[s[1]] for s, n in zip(record["spans"], names)
                              if n == "gc"]


def test_a_span_is_a_profiler_event_while_profiling(recorder):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with trace.span("upload"):
        torch.ones(4).sum()
    prof.stop()
    assert "vdt.upload" in {e.name for e in prof.events()}
    assert "upload" in trace.stop()["names"]


def test_counters_read_the_launch_counters_once_built():
    """counters() holds this module's counters beside graph.py's launch
    counters, whose list is built once (a replay reads it)."""
    assert graph.counters() is graph.counters()
    names = {n for n, _, _ in graph.counters()}
    assert {"launches.lstm_layer", "launches.lm_dlogits",
            "tensor_core.mm_f32", "mesh.collectives"} <= names
    trace.count("test.things", 3)
    now = trace.counters()
    assert now["test.things"] >= 3 and now["launches.lstm_layer"] == \
        lstm_layer.launches


def test_train_loader_spans_and_counters(recorder):
    """One loader.assemble a batch, on the loader's worker thread; the gets
    are the batches taken; the image normalisation is build.host."""
    cfg = small_config(encoder="mn-ques-im-hist")
    split, vocab, cfg = _split(cfg)
    loader = TrainLoader(split, vocab, cfg)
    got = list(loader.epoch(0))
    record = trace.stop()
    names = _names(record)
    assert len(got) == loader.steps_per_epoch == 4
    assert names.count("loader.assemble") == len(got)
    main = threading.get_ident()
    assert all(s[2] != main for s, n in zip(record["spans"], names)
               if n == "loader.assemble")
    assert names.count("build.host") == 1
    c = record["counters"]
    assert c["loader.gets"] == len(got)
    assert 0 <= c.get("loader.empty_gets", 0) <= c["loader.gets"]
    waits = c.get("loader.empty_gets", 0)        # the epoch's end may wait too
    assert waits <= names.count("loader.wait") <= waits + 1


def test_upload_counts_the_bytes_it_ships(recorder):
    """A copy to a device (here the meta device) is one upload with its
    upload.copy and the bytes shipped; a CPU target ships nothing and
    records nothing."""
    cfg = small_config(encoder="mn-ques-im-hist")
    split, vocab, cfg = _split(cfg)
    batch = list(TrainLoader(split, vocab, cfg).epoch(0))[0].as_dict()
    trace.start()                       # the upload alone
    out = batch_to_device(batch, "meta")
    record = trace.stop()
    assert {t.device.type for t in out.values()} == {"meta"}
    assert record["counters"]["upload.bytes"] == sum(
        t.nbytes for t in out.values())
    assert _names(record) == ["upload", "upload.copy"]
    assert record["spans"][1][1] == 0
    trace.start()
    host = batch_to_device(batch, torch.device("cpu"))
    record = trace.stop()
    assert record["spans"] == [] and "upload.bytes" not in record["counters"]
    assert sum(t.nbytes for t in host.values()) == sum(
        t.nbytes for t in out.values())


def _stacked(cfg, split, vocab, G=2):
    batches = [b.as_dict() for b in TrainLoader(split, vocab, cfg).epoch(0)]
    return batch_to_device({k: np.stack([b[k] for b in batches[:G]])
                            for k in batches[0]}, "cpu")


def test_graphed_train_step_records_its_dispatch(recorder):
    """On CPU tensors the step runs eagerly, inside train.dispatch; no
    graph span."""
    cfg = small_config(encoder="mn-ques-im-hist")
    split, vocab, cfg = _split(cfg)
    stacked = _stacked(cfg, split, vocab)
    fn = make_multistep_train_fn(cfg)
    trace.start()
    fn(init_train_state(cfg), stacked)
    record = trace.stop()
    names = _names(record)
    assert names.count("train.dispatch") == 1
    assert not [n for n in names if n.startswith("graph.")]


def test_graph_spans_and_counters_on_stand_ins(fake_card, recorder,
                                               monkeypatch):
    """On graph.py's stand-ins: graph.capture once a signature, with
    graph.captures; each replay one graph.copy_in, graph.replay and
    graph.clone_out, with graph.replays; and the captured launch count
    added again on each replay."""
    monkeypatch.setattr(lstm_layer, "launches", 0)

    def fn(x):
        lstm_layer.launches += 2
        return x * 2

    g = graph.Graphed(fn)
    trace.start()
    for x in (torch.zeros(3), torch.ones(3), torch.ones(3), torch.ones(4)):
        g(x)
    record = trace.stop()
    names = _names(record)
    assert names.count("graph.capture") == 2 == record["counters"][
        "graph.captures"]
    for n in ("graph.copy_in", "graph.replay", "graph.clone_out"):
        assert names.count(n) == 2, n
    assert record["counters"]["graph.replays"] == 2
    assert record["counters"]["launches.lstm_layer"] == 2 * 2 + 2 * 2
    assert lstm_layer.launches == 8


def test_resident_eval_spans_once_a_call(recorder):
    """evaluate_split, resident: one eval.table, eval.batches,
    eval.readback and eval.metrics a call; the stacks' host build once."""
    cfg = small_config(encoder="mn-ques-im-hist")
    split, vocab, cfg = _split(cfg, dialogs=12)
    params = init_train_state(cfg).params
    fns = make_disc_table_eval_fns(cfg)
    trace.start()
    for _ in range(2):
        evaluate_split(params, split, vocab, cfg, "cpu", table_fns=fns,
                       resident=True)
    record = trace.stop()
    names = _names(record)
    for n in ("eval.table", "eval.batches", "eval.readback", "eval.metrics"):
        assert names.count(n) == 2, n
    assert trace.spans_of(record, "build.host") == 1
    assert trace.seconds(record, "eval.metrics") > 0
    assert "upload" not in names              # the stacks stay on the host


def test_profile_steps_logs_the_spans_of_setup_steps_and_evals(tmp_path):
    """train.py --profile_steps: one 'spans' event for set-up (to the end
    of the first dispatch), one for the profiled steps and one for each
    eval outside them, and the recorder off at the end."""
    cfg = small_config(encoder="mn-ques-im-hist", num_rounds=3)
    argv = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name != "vocab_size" and v != f.default:
            argv += [f"--{f.name}", str(v)]
    train_main(argv + ["--synthetic", "12", "--device", "cpu",
                       "--max_steps", "4", "--eval_every", "2",
                       "--profile_steps", "2,3", "--save_path",
                       str(tmp_path), "--run_name", "spans"])
    assert trace.stop() is None
    with open(tmp_path / "spans" / "metrics.jsonl") as f:
        events = [json.loads(ln) for ln in f]
    got = [(e["phase"], e.get("step")) for e in events
           if e["event"] == "spans"]
    assert got == [("setup", 1), ("eval", 2), ("steps", None), ("eval", 4)]
    setup, first_eval, steps, last_eval = (e for e in events
                                           if e["event"] == "spans")
    assert {"mesh.init", "build.host", "loader.assemble",
            "train.dispatch"} <= set(setup["spans"])
    assert setup["spans"]["train.dispatch"]["count"] == 1
    assert steps["steps"] == [2, 3]
    assert steps["spans"]["train.dispatch"]["count"] == 1
    assert steps["counters"]["loader.gets"] == 1
    for e in (first_eval, last_eval):
        assert {"eval.table", "eval.batches", "eval.readback",
                "eval.metrics"} <= set(e["spans"])
    assert "build.host" in first_eval["spans"]          # the resident stacks
    assert "build.host" not in last_eval["spans"]
    assert all(s["self_seconds"] <= s["seconds"] + 1e-9
               for e in (setup, first_eval, steps, last_eval)
               for s in e["spans"].values())
