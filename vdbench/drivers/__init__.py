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
