"""CUDA graphs over the port's hot calls: the counterpart of jax.jit.

The JAX package builds each hot call (the train step, G steps under
lax.scan, the serving functions) as one device program with jax.jit.  Here
the same call is captured once per signature of its arguments as a
torch.cuda.CUDAGraph and replayed: one launch from the host for the whole
call, where the eager path issues every kernel from Python.

`Graphed(fn)` is the helper.  Its arguments are pytrees (dicts, lists,
tuples) whose tensor leaves are the graph's inputs and whose other leaves
are static, part of the signature, as jax.jit's static_argnums.  The first
call of a signature runs fn on a side stream (the warm-up PyTorch requires
before a capture; it also builds the kernels and sets their shared-memory
attributes outside capture) and returns that run's result; then fn is
captured over the graph's own copies of the tensor leaves.  A later call
copies its tensors into those buffers, replays the graph and returns clones
of the graph's outputs.  On CPU tensors fn runs eagerly: dispatch follows
the device, as the kernels' does.  On the card a capture or a replay that
fails raises; nothing goes on eagerly after one.

fn must not read device values on the host (.item(), .tolist(), float() of a
tensor) or build a device tensor from host data: capture refuses both.
What fn reads outside its arguments (params, the train state) it reads at
the addresses it had at capture: callers keep those tensors and write into
them in place.

The kernels' wrappers count their launches in Python (`.launches`, and the
contraction helper's `.tensor_core`), and a replay runs no Python.  So a
capture records each counter's change, takes it back out (capture executes
nothing), and every replay adds it again.
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree


def counters() -> list[tuple[object, str]]:
    """(function, attribute) of every launch counter in the port: the six
    kernels' wrappers' `.launches` and the bf16 contractions'
    `.tensor_core`."""
    from ..ops import kernel_wrappers
    from ..ops.contract import mm_f32, scores_f32

    return [(fn, "launches") for fn in kernel_wrappers().values()] + [
        (mm_f32, "tensor_core"), (scores_f32, "tensor_core")]


def _device(leaves) -> torch.device | None:
    """The card a call runs on (its first CUDA tensor's), or None: then fn
    runs eagerly."""
    return next((x.device for x in leaves
                 if isinstance(x, torch.Tensor) and x.is_cuda), None)


def _read(cs) -> list[int]:
    return [getattr(obj, attr) for obj, attr in cs]


def _add(cs, counts) -> None:
    for (obj, attr), n in zip(cs, counts):
        setattr(obj, attr, getattr(obj, attr) + n)


class _Capture(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list        # the flattened arguments: the graph's tensor buffers
    output: object      # the graph's output tensors (a pytree)
    counts: list        # each counter's change in one run of fn


class Graphed:
    """fn as one CUDA graph per signature of its arguments (module
    docstring).  `captures` counts the graphs captured; `fn` is the eager
    function, the reference the graphs are held to."""

    def __init__(self, fn):
        self.fn = fn
        self.captures = 0
        self._graphs: dict = {}

    def __call__(self, *args, generators=()):
        """fn(*args), replayed from this signature's graph.  `generators`
        are device generators fn draws from: each new graph registers them
        (CUDAGraph.register_generator_state), so a replay reads their state
        at replay time; whoever calls re-seeds them before each call."""
        leaves, spec = pytree.tree_flatten(args)
        device = _device(leaves)
        if device is None:
            return self.fn(*args)
        key = (spec, tuple((tuple(x.shape), x.dtype, x.device)
                           if isinstance(x, torch.Tensor) else x for x in leaves))
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, leaves, spec, device, generators)
        for buf, x in zip(entry.inputs, leaves):
            if isinstance(x, torch.Tensor) and x is not buf:
                buf.copy_(x, non_blocking=True)
        entry.graph.replay()
        _add(counters(), entry.counts)
        return pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            entry.output)

    def _capture(self, key, leaves, spec, device, generators):
        # dead Python cycles may hold other graphs and their memory pools; a
        # capture that runs short of memory cannot release cached blocks
        # without invalidating itself, so collect them first
        gc.collect()
        inputs = [x.to(device, copy=True) if isinstance(x, torch.Tensor)
                  else x for x in leaves]
        args = pytree.tree_unflatten(inputs, spec)
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            result = self.fn(*args)          # the warm-up: this call's result
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        cs = counters()
        before = _read(cs)
        collecting = gc.isenabled()
        gc.disable()      # a collection inside the capture could free a dead
        try:              # graph, whose pool's release the capture refuses
            # thread_local: a CUDA call of another thread (the eval's
            # staging thread, a process group's watchdog) must not
            # invalidate this thread's capture
            with torch.cuda.device(device), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                output = self.fn(*args)
            counts = [a - b for a, b in zip(_read(cs), before)]
        finally:
            if collecting:
                gc.enable()
            for (obj, attr), n in zip(cs, before):
                setattr(obj, attr, n)      # a capture executes nothing
        self._graphs[key] = _Capture(graph, inputs, output, counts)
        self.captures += 1
        return result
