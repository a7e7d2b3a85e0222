"""CUDA graphs over the port's hot calls: the counterpart of jax.jit.

The JAX package builds each hot call (the train step, G steps under
lax.scan, the serving functions) as one device program with jax.jit.  Here
the same call is captured once per signature of its arguments as a
torch.cuda.CUDAGraph and replayed: one launch from the host for the whole
call, where the eager path issues every kernel from Python.

`Graphed(fn)` is the helper.  Its arguments are pytrees (dicts, lists,
tuples) whose tensor leaves are the graph's inputs and whose other leaves
are static, part of the signature, as jax.jit's static_argnums.  The first
call of a signature runs fn on the device's side stream (the warm-up
PyTorch requires before a capture; it also builds the kernels and sets their
shared-memory attributes outside capture) and returns that run's result;
then fn is captured on that stream over the graph's own copies of the
tensor leaves.  A later call
copies its tensors into those buffers, replays the graph and returns clones
of the graph's outputs.  On CPU tensors fn runs eagerly: dispatch follows
the device, as the kernels' does.  On the card a capture or a replay that
fails raises; nothing goes on eagerly after one.

fn must not read device values on the host (.item(), .tolist(), float() of a
tensor) or build a device tensor from host data: capture refuses both.
What fn reads outside its arguments (params, the train state) it reads at
the addresses it had at capture: callers keep those tensors and write into
them in place (copy_into).  `InferenceGraphed`, what the eval factories
return, runs the whole call, copy-in included, under torch.inference_mode().

Two kinds of tensor are read where they are, never copied:

  * `Held` buffers: one device copy of the params that several graphs
    share (the eval factories' functions, the resident eval's batch graph).
    A graph built with `held` loads its first argument into them
    (Held.load: a copy unless it is them) and reads them in place; they are
    not part of its signature.
  * tensors marked with `read_in_place`, among them a graph's own outputs
    returned with clone=False: a graph captured over one holds it as its
    input and is keyed on that tensor itself, so a call with another
    tensor there captures anew and nothing is ever written into it.  A
    graph captured over another graph's output is captured in that graph's
    memory pool (what the second graph needs is what the first freed: the
    disc table's build and its batches take one working set, as eagerly).
    Its own outputs may then lie where the first graph's next replay
    writes, so it returns clones only.

The kernels' wrappers count their launches in Python (`.launches`, and the
contraction helper's `.tensor_core`), as the mesh counts its collectives
(parallel/mesh.py), and a replay runs no Python.  So a capture records each
counter's change, takes it back out (capture executes nothing), and every
replay adds it again.

A graph may hold NCCL collectives (a step or an eval over a mesh): the
warm-up issues them and the capture records them on the capturing stream,
so every rank of a group must capture and replay the same signatures in
the same order, as it would issue the eager calls.  The groups'
communicators exist before any capture (parallel/mesh.py::make_mesh).

A capture holds `CAPTURING`, and a thread that queues device work beside
the capturing one (the streamed eval's staging thread) takes it around
that work: in thread_local mode a capture does not refuse another
thread's calls, and work queued on the stream being captured would join
the graph.
"""

from __future__ import annotations

import functools
import gc
import threading
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..utils import trace


CAPTURING = threading.Lock()      # held by every capture (the docstring)


@functools.cache
def side_stream(index: int) -> torch.cuda.Stream:
    """The stream on which every graph of CUDA device `index` is warmed up
    and captured, made once.  cuBLAS keeps a workspace for each thread's
    handle and stream it multiplies on, allocated at the first product
    there and never freed.  One first allocated inside a warm-up (the
    backward's, on autograd's device thread) is cut from the warm-up's
    freed memory and keeps that whole segment reserved after the capture
    releases the rest: 32 MiB held 500 MiB in the disc step.  So the
    stream's first products, forward on this thread and backward on
    autograd's, run here before any warm-up, and their workspaces take
    segments of their own."""
    device = torch.device("cuda", index)
    stream = torch.cuda.Stream(device)
    with torch.inference_mode(False), torch.enable_grad(), \
            torch.cuda.device(device), torch.cuda.stream(stream):
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.ones(16, 16, device=device, dtype=dtype, requires_grad=True)
            torch.addmm(a[0], a, a).sum().backward()
        b = a.detach().bfloat16()
        torch.mm(b, b, out_dtype=torch.float32)
    stream.synchronize()
    return stream


@functools.cache
def counters() -> tuple[tuple[str, object, str], ...]:
    """(name, object, attribute) of every launch counter in the port: the
    six kernels' wrappers' `.launches`, K1's and K2's tile and split
    choices (ops/lstm_cuda.py::choice_counters), the bf16 contractions'
    `.tensor_core` and the mesh's `collectives` (parallel/mesh.py); built
    at the first call, since every replay reads it."""
    from ..ops import kernel_wrappers
    from ..ops.contract import mm_f32, scores_f32
    from ..ops.lstm_cuda import choice_counters
    from . import mesh

    return tuple([(f"launches.{name}", fn, "launches")
                  for name, fn in kernel_wrappers().items()]
                 + choice_counters() + [
        ("tensor_core.mm_f32", mm_f32, "tensor_core"),
        ("tensor_core.scores_f32", scores_f32, "tensor_core"),
        ("mesh.collectives", mesh, "collectives")])


def _device(leaves) -> torch.device | None:
    """The card a call runs on (its first CUDA tensor's), or None: then fn
    runs eagerly."""
    return next((x.device for x in leaves
                 if isinstance(x, torch.Tensor) and x.is_cuda), None)


def _read(cs) -> list[int]:
    return [getattr(obj, attr) for _, obj, attr in cs]


def _add(cs, counts) -> None:
    for (_, obj, attr), n in zip(cs, counts):
        setattr(obj, attr, getattr(obj, attr) + n)


_IN_PLACE = "_graph_reads_in_place"   # the attribute: its owner graph or None


def read_in_place(tree, owner=None):
    """Mark tree's tensors as read in place by the graphs captured over them
    (module docstring); `owner` is the CUDAGraph whose outputs they are,
    None for tensors of the caller's (which it keeps and does not write
    while a graph holds them).  Returns tree."""
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            setattr(x, _IN_PLACE, owner)
    return tree


def _in_place(x) -> bool:
    return isinstance(x, torch.Tensor) and hasattr(x, _IN_PLACE)


def _owner(x):
    return getattr(x, _IN_PLACE, None) if isinstance(x, torch.Tensor) else None


def copy_into(dst, src) -> None:
    """src's tensors copied into dst's in place, leaf by leaf, matched by
    their paths in the two pytrees (dict keys in any order); a leaf of dst
    that already is src's is skipped.  Raises ValueError where the paths
    or a tensor's shape differ (another model or optimizer)."""
    d = dict(pytree.tree_flatten_with_path(dst)[0])
    s = dict(pytree.tree_flatten_with_path(src)[0])
    if d.keys() != s.keys() or any(
            isinstance(t, torch.Tensor) and t.shape != s[k].shape
            for k, t in d.items()):
        raise ValueError("a tree that does not fit the graph's buffers: "
                         "another model or optimizer")
    for k, t in d.items():
        if isinstance(t, torch.Tensor) and t is not s[k]:
            t.copy_(s[k], non_blocking=True)


class Held:
    """One device copy of a pytree (the params) that several graphs read in
    place: `load(tree)` returns the buffers holding tree's values, copying
    tree in (the first load allocates them) unless tree is them; a tree of
    CPU tensors is returned as it is (its graphs run eagerly).  Raises
    ValueError on a tree of another shape (copy_into).  Runs under
    torch.inference_mode(), as InferenceGraphed does."""

    def __init__(self):
        self.tree = None

    def load(self, tree):
        if tree is self.tree or _device(pytree.tree_leaves(tree)) is None:
            return tree
        with torch.inference_mode():
            if self.tree is None:
                self.tree = pytree.tree_map(
                    lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                    tree)
            else:
                copy_into(self.tree, tree)
        return self.tree


class _Capture(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list        # the flattened arguments: the graph's tensor buffers
    output: object      # the graph's output tensors (a pytree)
    counts: list        # each counter's change in one run of fn
    shared: bool        # captured in another graph's pool: clones only


class Graphed:
    """fn as one CUDA graph per signature of its arguments (module
    docstring).  `captures` counts the graphs captured and `replays` their
    replays; `fn` is the eager function, the reference the graphs are held
    to.  With `held` (a Held) fn's first argument is loaded into those
    shared buffers and read there."""

    def __init__(self, fn, held: Held | None = None):
        self.fn = fn
        self.held = held
        self.captures = 0
        self.replays = 0
        self._graphs: dict = {}

    def __call__(self, *args, generators=(), clone: bool = True):
        """fn(*args), replayed from this signature's graph.  `generators`
        are device generators fn draws from: each new graph registers them
        (CUDAGraph.register_generator_state), so a replay reads their state
        at replay time and advances it as an eager call would.  With
        clone=False the result is the graph's own output tensors, which the
        next replay of this signature overwrites (after a capture, the
        warm-up's result copied into them): a caller that reads them in
        place, as another graph's input, keeps one address (and is read
        there: read_in_place)."""
        pre = args[:1] if self.held is not None else ()
        leaves, spec = pytree.tree_flatten(args[len(pre):])
        device = _device(leaves)
        if device is None:
            return self.fn(*args)
        pre = tuple(self.held.load(p) for p in pre)
        key = (spec, tuple(
            ("in place", id(x)) if _in_place(x)
            else (tuple(x.shape), x.dtype, x.device)
            if isinstance(x, torch.Tensor) else x for x in leaves))
        entry = self._graphs.get(key)
        if entry is None:
            with trace.span("graph.capture"):
                result = self._capture(key, pre, leaves, spec, device,
                                       generators, clone)
            if clone:
                return result
            output = self._graphs[key].output
            copy_into(output, result)
            return output
        if not clone and entry.shared:
            raise ValueError("a graph captured in another graph's memory "
                             "pool returns clones only")
        with trace.span("graph.copy_in"):
            for buf, x in zip(entry.inputs, leaves):
                if isinstance(x, torch.Tensor) and x is not buf:
                    buf.copy_(x, non_blocking=True)
        with trace.span("graph.replay"):
            entry.graph.replay()
        self.replays += 1
        trace.count("graph.replays")
        _add(counters(), entry.counts)
        if not clone:
            return entry.output
        with trace.span("graph.clone_out"):
            return pytree.tree_map(
                lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                entry.output)

    def _capture(self, key, pre, leaves, spec, device, generators, clone):
        # the pool of the one graph whose outputs this one reads, if any
        owners = {id(o): o for o in map(_owner, leaves) if o is not None}
        pool = {"pool": next(iter(owners.values())).pool()} if len(
            owners) == 1 else {}
        if pool and not clone:
            raise ValueError("a graph captured in another graph's memory "
                             "pool returns clones only")
        # dead Python cycles may hold other graphs and their memory pools; a
        # capture that runs short of memory cannot release cached blocks
        # without invalidating itself, so collect them first
        gc.collect()
        inputs = [x.to(device, copy=True)
                  if isinstance(x, torch.Tensor) and not _in_place(x)
                  else x for x in leaves]
        args = (*pre, *pytree.tree_unflatten(inputs, spec))
        main = torch.cuda.current_stream(device)
        side = side_stream(device.index)
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
            with CAPTURING, torch.cuda.device(device), torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local",
                    **pool):
                output = self.fn(*args)
            counts = [a - b for a, b in zip(_read(cs), before)]
        finally:
            if collecting:
                gc.enable()
            for (_, obj, attr), n in zip(cs, before):
                setattr(obj, attr, n)      # a capture executes nothing
        self._graphs[key] = _Capture(graph, inputs,
                                     read_in_place(output, graph), counts,
                                     bool(pool))
        self.captures += 1
        trace.count("graph.captures")
        return result


class InferenceGraphed(Graphed):
    """Graphed with the whole call under torch.inference_mode(), the copy-in
    as well as the capture and the replay: a buffer an inference-mode
    capture made is an inference tensor, which cannot be written in place
    outside that mode, and whether a replay works must not depend on the
    caller's mode.  What the eval factories (parallel/train_step.py),
    generate's decode and the harness's batch graphs are."""

    def __call__(self, *args, generators=(), clone: bool = True):
        with torch.inference_mode():
            return super().__call__(*args, generators=generators, clone=clone)
