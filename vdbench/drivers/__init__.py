"""One driver a traffic kind (a traffic file's "kind"): drivers/<kind>.py
holds `run(args) -> dict`, which sets the cell up from the seed, measures
the window and decides `correct`.

What a driver returns (JSON, so that a rank can hand it to its parent):
  correct, attempted, failed, compared   as the result line carries them
  memory_peak_bytes                      the process's reserved peak
  readings                               what the metric readers read:
      kind, setup_s, window_s, rounds, peak_reserved_bytes,
      spans {name: [seconds, ...]}, trace (trace.summarize) or None,
      work (work.Work of the traced stretch, as a dict) or None
    and in a traced run alone (ProgramRecords.readings), the port's own:
      program_spans {record: {span: {count, seconds, self_seconds}}},
      program_counters {record: {counter: its change}},
      window_units  the dispatches (train) or passes (eval) of "window"
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass
class RunArgs:
    cell: object              # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str               # "cuda" on the card; "cpu" rehearses
    t0: float                 # wall time the run's process started
    fault: str | None = None  # a planted fault (tests and calibration)
    log: object = print
    detail: bool = False      # return what the limits are chosen from


def port_config(config: dict):
    """The port's Config from a configuration file's fields."""
    from visdial_tpu_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in config.items() if k in names}).validate()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host spans of the benchmark's own code around its calls into the
    port: durations kept by name, and on a traced stretch marked in the
    profiler (record_function "vdbench.<name>")."""

    def __init__(self):
        self.seconds: dict = {}

    @contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        with torch.profiler.record_function("vdbench." + name):
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t)


class ProgramRecords:
    """The port's own spans and counters (visdial_tpu_torch/utils/trace.py)
    in a traced run, kept as two records: "setup", from the start of the
    run's set-up to its first timed dispatch (or pass), and "window", to the
    start of the traced stretch: the window's dispatches as an untraced run
    makes them (under the profiler a graph's launch costs the host several
    times as much).  Over the traced stretch the recorder runs on, so that
    the port's spans name the trace's idle gaps, and its record is dropped.
    An untraced run leaves the recorder off: no span costs a clock read."""

    def __init__(self, on: bool):
        self.port = None
        self.records: dict = {}
        if on:
            from visdial_tpu_torch.utils import trace as port

            self.port = port
            port.start()

    def cut(self, record: str) -> None:
        """Keep the running recording as `record` and start the next."""
        if self.port:
            self.records[record] = self.port.summary(self.port.stop())
            self.port.start()

    def stop(self) -> None:
        if self.port:
            self.port.stop()

    def readings(self, window_units: int) -> dict:
        if not self.records:
            return {}
        return {"program_spans": {k: r["spans"] for k, r in self.records.items()},
                "program_counters": {k: r["counters"]
                                     for k, r in self.records.items()},
                "window_units": window_units}


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
