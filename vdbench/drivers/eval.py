"""Retrieval evaluation: the port's `evaluate_split`, resident (the evaluate
CLI's default), through the disc option table's graphed factories, over
the whole split, as a researcher evaluates a checkpoint.

Set-up makes the split and the weights from the seed, builds the factories
once, and runs one pass (the resident upload, the captures) and a second
(the replays warm).  The window is whole passes, repeated until its
seconds have passed; the rate is every round ranked over the window's
time, each pass's option-table build included.  After the window every
pass's ranks are compared with the reference's (reference/steps.py).  A
traced run also records the port's own spans and counters over set-up and
over the window's passes before the traced ones (ProgramRecords); an
untraced run leaves them off.

Traffic file keys: passes_traced (passes under the profiler).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, trace, traffic, weights, work
from ..reference import steps as ref_steps
from . import ProgramRecords, RunArgs, Spans, free, port_config, profiler, sync


def _planted(ranks: np.ndarray, fault: str | None, K: int) -> np.ndarray:
    if fault is None:
        return ranks
    if fault == "token":           # one answer altered where it is made
        ranks = ranks.copy()
        ranks[0] = 1 if ranks[0] > K // 2 else K
        return ranks
    if fault == "half":            # half the rounds left out
        return ranks[:len(ranks) // 2]
    raise ValueError(f"no fault {fault!r} for evaluation")


def run(args: RunArgs) -> dict:
    from visdial_tpu_torch.data.dataset import VisDialSplit, Vocabulary
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.parallel.train_step import make_disc_table_eval_fns

    program = ProgramRecords(args.trace)
    cell, log = args.cell, args.log
    conf, mix = cell.config, cell.traffic
    cfg = port_config(conf)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    K = cfg.num_options
    arrays = traffic.make_split(mix, conf, args.seed)
    split = VisDialSplit(**arrays)
    vocab = Vocabulary(word2ind=traffic.vocab_words(conf))
    fam = cell.family
    flat = weights.make(conf, fam, traffic.seed_for(args.seed, 1), device)
    params = weights.nest(flat)
    fns = make_disc_table_eval_fns(cfg)
    spans = Spans()

    def one_pass():
        with spans("eval_pass"):
            metrics, ranks = evaluate_split(params, split, vocab, cfg, device,
                                            table_fns=fns, resident=True,
                                            return_ranks=True)
        return _planted(np.asarray(ranks), args.fault, K)

    one_pass()                                  # upload, captures
    one_pass()                                  # replays warm
    spans.seconds.clear()
    passes, summary, traced, untraced = [], None, None, 0
    program.cut("setup")
    sync(device)
    t0 = time.perf_counter()
    setup_s = time.time() - args.t0
    while time.perf_counter() - t0 < args.seconds or (
            args.trace and summary is None):
        if args.trace and summary is None and passes:
            sync(device)
            program.cut("window")
            untraced = len(passes)
            prof = profiler(device)
            prof.start()
            t = time.perf_counter()
            for _ in range(int(mix["passes_traced"])):
                passes.append(one_pass())
            sync(device)
            wall = time.perf_counter() - t
            program.stop()
            prof.stop()
            summary = trace.summarize(prof, wall)
            traced = work.Work()
            for _ in range(int(mix["passes_traced"])):
                traced.add(work.eval_pass(conf, fam, arrays))
            continue
        passes.append(one_pass())
    sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0
    rounds = sum(len(r) for r in passes)
    log(f"[vdbench] {len(passes)} passes in {window_s:.3f} s")
    del fns, params, split, flat
    free(device)

    band = cell.limits["out_of_band"]["band"]
    bands = tuple(sorted({band, *compare.BANDS})) if args.detail else (band,)
    ref, ref_bands = ref_steps.ranks(conf, fam, arrays, weights.make(
        conf, fam, traffic.seed_for(args.seed, 1), device), device=device,
        bands=bands)
    numbers, failed = compare.eval_numbers(passes, ref, ref_bands[band])
    ok, shown = compare.judge(numbers, cell.limits)
    detail = ({"detail": compare.eval_detail(passes, ref, ref_bands)}
              if args.detail else {})
    return {**detail, "correct": ok and failed == 0,
            "attempted": len(passes) * len(ref),
            "failed": failed * len(ref), "compared": shown,
            "memory_peak_bytes": int(peak),
            "readings": {"kind": "eval", "setup_s": setup_s,
                         "window_s": window_s, "rounds": rounds,
                         "peak_reserved_bytes": int(peak),
                         "spans": spans.seconds, "trace": summary,
                         "work": traced.__dict__ if traced else None,
                         **program.readings(untraced)}}
