"""Training: the port's graphed multi-step dispatch fed by its loader, as
`train.py --steps_per_dispatch G` runs it (on a data axis as torchrun
runs it, one process a rank).

Set-up builds one train step object (make_multistep_train_fn) over the
state made from the seed and drives it through its first dispatch, on the
loader's first G batches: the call that captures the graph, whose result
is an eager run's (the capture itself executes nothing).  The checked
steps are a replay, as every dispatch of the window is one: the start
weights are copied back into the state's tensors (the graph's donated
buffers), the moments zeroed, the step count and the dropout generator
reset, and the same G batches dispatched again.  Their losses, and the
params and Adam moments after them, are kept, and after the window the
reference follows the same G steps from the same weights
(reference/steps.py).  Two more dispatches warm the replay on the next
batches, then the same object trains through the window:
whole dispatches, the host at most two dispatches ahead of the device,
until the window's seconds have passed (on a data axis, the count of
dispatches the ranks agreed on from their warm-up, so that every rank
issues the same collectives).  The rate is every round trained (over all
ranks) over the window's time, which ends when the device does.

Traffic file keys: steps_per_dispatch (G), trace_dispatches (the traced
stretch), ranks (the data axis: the configuration's batch_size is each
rank's, the global batch that times the ranks).
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from .. import compare, trace, traffic, weights, work
from ..reference import data as ref_data
from ..reference import steps as ref_steps
from . import RunArgs, Spans, free, port_config, profiler, sync


def _leaves(state) -> list:
    return [t for tree in (state.params, state.opt.m, state.opt.v)
            for t in weights.flatten(tree).values()]


def _host(tree) -> dict:
    return {k: v.detach().cpu().clone() for k, v in weights.flatten(tree).items()}


def _planted(fn, fault: str | None, per_rank: int):
    """The train function with a fault planted under it, or fn itself."""
    if fault is None or fault == "exchange":
        return fn
    if fault == "frozen":            # a step that returns its state unchanged
        def frozen(state, batch):
            kept = [t.clone() for t in _leaves(state)]
            new, m = fn(state, batch)
            for t, k in zip(_leaves(new), kept):
                t.copy_(k)
            return new, m
        return frozen
    if fault == "half":              # half the batch left out
        def half(state, batch):
            return fn(state, {k: v[:, :per_rank // 2]
                              if v.dim() > 1 and v.shape[1] == per_rank else v
                              for k, v in batch.items()})
        return half
    raise ValueError(f"no fault {fault!r} for training")


def run(args: RunArgs) -> dict:
    from visdial_tpu_torch.data.dataset import VisDialSplit, Vocabulary
    from visdial_tpu_torch.data.loader import TrainLoader
    from visdial_tpu_torch.models.model import batch_to_device
    from visdial_tpu_torch.parallel.optim import OptState
    from visdial_tpu_torch.parallel.train_step import (
        TrainState, make_multistep_train_fn, shard_train_state)

    cell, log = args.cell, args.log
    conf, mix = cell.config, cell.traffic
    ranks = int(mix.get("ranks", 1))
    G = int(mix["steps_per_dispatch"])
    per_rank = conf["batch_size"]                  # a card's dialogs a step
    cfg = port_config(dict(conf, batch_size=per_rank * ranks))
    mesh, rank = None, 0
    if ranks > 1:
        from visdial_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(ranks, 1, args.device)
        device, rank = mesh.device, mesh.rank
    else:
        device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    B, R = cfg.batch_size, cfg.num_rounds          # the global batch

    arrays = traffic.make_split(mix, conf, args.seed,
                                options=conf["decoder"] == "disc")
    split = VisDialSplit(**arrays)
    vocab = Vocabulary(word2ind=traffic.vocab_words(conf))
    flat = weights.make(conf, traffic.seed_for(args.seed, 1), device)
    start = {k: v.detach().cpu().clone() for k, v in flat.items()}
    zeros = lambda: weights.nest({k: torch.zeros_like(v) for k, v in flat.items()})
    drop_seed = traffic.seed_for(args.seed, 2)
    state = TrainState(weights.nest(flat), OptState(0, zeros(), zeros()),
                       torch.Generator().manual_seed(drop_seed))
    if mesh is not None:
        state = shard_train_state(state, cfg, mesh)
    fn = make_multistep_train_fn(
        cfg, None if args.fault == "exchange" else mesh)
    fn = _planted(fn, args.fault, per_rank)
    loader = TrainLoader(split, vocab, cfg.replace(compute_dtype="float32"))
    e0 = traffic.seed_for(args.seed, 3)
    lo = rank * per_rank
    spans = Spans()

    def feed():
        epoch = 0
        while True:
            it = loader.epoch(seed=e0 + epoch,
                              shard=None if mesh is None else mesh.data_shard)
            order = ref_data.epoch_order(e0 + epoch, split.num_dialogs)
            for j in range(loader.steps_per_epoch // G):
                with spans("loader_wait"):
                    group = [next(it).as_dict() for _ in range(G)]
                with spans("upload"):
                    stacked = batch_to_device(
                        {k: np.stack([b[k] for b in group]) for k in group[0]},
                        device)
                yield stacked, order[j * G * B:(j + 1) * G * B].reshape(G, B)
            for _ in it:             # the epoch's tail, so its thread ends
                pass
            epoch += 1

    batches = feed()
    first, first_ids = next(batches)
    state, m = fn(state, first)                    # the capture (eager run)
    sync(device)
    eager = (m["loss"].double().cpu(), _host(state.params))
    with torch.no_grad():                          # back to the seed's state
        for k, t in weights.flatten(state.params).items():
            t.copy_(start[k])
        for tree in (state.opt.m, state.opt.v):
            for t in weights.flatten(tree).values():
                t.zero_()
    state = TrainState(state.params, OptState(0, state.opt.m, state.opt.v),
                       torch.Generator().manual_seed(drop_seed))
    state, m = fn(state, first)                    # the checked steps: a replay
    sync(device)
    prog = {"loss": m["loss"].double().cpu().tolist(),
            "params": _host(state.params), "m": _host(state.opt.m)}
    log(f"[vdbench] rank {rank}: checked dispatch {prog['loss'][0]:.5f} .. "
        f"{prog['loss'][-1]:.5f}; replay against the capturing call: loss "
        f"{float((torch.tensor(prog['loss']) - eager[0]).abs().max()):.3g}, "
        f"params {max(float((v - eager[1][k]).abs().max()) for k, v in prog['params'].items()):.3g}")
    del eager, first
    for _ in range(2):                             # replays warm
        stacked, _ = next(batches)
        t = time.perf_counter()
        state, m = fn(state, stacked)
        sync(device)
        per_dispatch = time.perf_counter() - t
    plan = None
    if mesh is not None:                           # one count for every rank
        n = torch.tensor([math.ceil(args.seconds / per_dispatch)],
                         device=device)
        torch.distributed.all_reduce(n, op=torch.distributed.ReduceOp.MAX)
        plan = int(n.item())
    trace_len = int(mix["trace_dispatches"])
    trace_at = None if plan is None else max(1, plan // 3)

    spans.seconds.clear()
    losses, pending = [], collections.deque()
    traced, summary, prof, n = work.Work(), None, None, 0
    sync(device)
    t0 = time.perf_counter()
    setup_s = time.time() - args.t0
    while True:
        elapsed = time.perf_counter() - t0
        tracing = prof is not None and summary is None
        done = (n >= plan) if plan is not None else elapsed >= args.seconds
        if done and not tracing:
            break
        if args.trace and prof is None and (
                n == trace_at if plan is not None
                else elapsed >= args.seconds / 3):
            sync(device)
            prof = profiler(device)
            prof.start()
            t_trace, left = time.perf_counter(), trace_len
        stacked, ids = next(batches)
        with spans("dispatch"):
            state, m = fn(state, stacked)
        losses.append(m["loss"])
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
        n += 1
        if prof is not None and summary is None:
            for g in range(G):
                traced.add(work.train_step(conf, arrays,
                                           ids[g, lo:lo + per_rank]))
            left -= 1
            if left == 0:
                sync(device)
                wall = time.perf_counter() - t_trace
                prof.stop()
                summary = trace.summarize(prof, wall)
                prof = True
    sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    window_losses = torch.cat([x.reshape(-1) for x in losses]).double().cpu()
    failed = int((~torch.isfinite(window_losses)).sum())
    log(f"[vdbench] rank {rank}: {n} dispatches in {window_s:.3f} s")
    del state, fn, m, stacked, losses, pending, batches, flat
    free(device)

    out = {"attempted": n * G, "failed": failed, "memory_peak_bytes": int(peak),
           "readings": {"kind": "train", "setup_s": setup_s,
                        "window_s": window_s, "rounds": n * G * B * R,
                        "peak_reserved_bytes": int(peak),
                        "spans": spans.seconds, "trace": summary,
                        "work": traced.__dict__ if summary else None}}
    if rank != 0:
        return {**out, "correct": True, "compared": {}}
    ref = ref_steps.train(conf, arrays, start, list(first_ids), drop_seed,
                          ranks=ranks, device=device,
                          tokens=(vocab.start, vocab.end))
    numbers = compare.train_numbers(prog, ref, start)
    ok, shown = compare.judge(numbers, cell.limits)
    if args.detail:
        out["detail"] = compare.train_detail(prog, ref, start)
    return {**out, "correct": ok and failed == 0, "compared": shown}
