"""trace.summarize on a synthetic profiler event list: the ranges the
profiler draws on the device for the host's spans, the benchmark's
("vdbench.") and the port's ("vdt."), are no kernels and no busy time; an
idle gap is named by the innermost span open on the host when it began."""

import pytest
import torch

from vdbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, device, start, end):
        self.name, self.device_type = name, device
        self.time_range = _Range(start, end)
        self.is_user_annotation = False


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _summary(events):
    return trace.summarize(_Prof(events), wall_s=1e-3)


@pytest.mark.parametrize("prefix", ["vdt.", "vdbench."])
def test_span_ranges_on_the_device_are_no_kernels(prefix):
    got = _summary([_Event("k", CUDA, 0, 10), _Event("k", CUDA, 30, 40),
                    _Event(prefix + "train.dispatch", CUDA, 0, 100),
                    _Event(prefix + "train.dispatch", CPU, 0, 100)])
    assert got["kernels"] == {"k": pytest.approx(20e-6)}
    assert got["busy_s"] == pytest.approx(20e-6)
    assert got["device_ops"] == [["k", pytest.approx(20e-6)]]


def test_gaps_named_by_the_innermost_open_span():
    got = _summary([
        _Event("k", CUDA, 0, 10), _Event("k", CUDA, 40, 45),
        _Event("k", CUDA, 60, 65), _Event("k", CUDA, 200, 210),
        _Event("k", CUDA, 400, 401), _Event("k", CUDA, 402, 403),
        _Event("vdbench.eval_pass", CPU, 0, 150),
        _Event("vdt.eval.batches", CPU, 5, 55),
        _Event("vdt.gc", CPU, 8, 35),                 # a collection
        _Event("vdbench.upload", CPU, 400, 500),      # two opened together
        _Event("vdt.upload", CPU, 401, 450),
        _Event("vdt.upload.copy", CPU, 401, 420)])
    assert got["idle_gaps"] == [["host", pytest.approx(190e-6)],
                                ["eval_pass", pytest.approx(135e-6)],
                                ["gc", pytest.approx(30e-6)],
                                ["eval.batches", pytest.approx(15e-6)],
                                ["upload.copy", pytest.approx(1e-6)]]
