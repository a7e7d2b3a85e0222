"""Profile the flagship training step on one GPU with torch.profiler.

    python -m visdial_tpu_torch.profile_train [--steps 3] [--warmup 3] \
        [--dropout 0.5] [--decoder disc|gen] [--encoder mn-ques-im-hist] \
        [--img_spatial] [--compute_dtype float32|bfloat16] [--batch_size 32] \
        [--trace train_trace.json]

The workload is chip_smoke.py's `train` phase (`gen_train` with --decoder
gen, `train_lf` with --encoder lf-ques-im-hist): MN-QIH by default at full
width (E 300, H 512, 2 layers, fc7 4096 or with --img_spatial pool5 49 x
512, batch 32 dialogs, f32; --compute_dtype and --batch_size set those
Config fields, as bench.py's bf16 points take them: batch 32 disc, 64
gen), random weights from seed 0, batches from TrainLoader over
make_random_split(num_dialogs=64, num_unique_answers=100_000, seed=0)
(vocab 8,804; disc batches carry deduplicated candidate rows, gen batches
the teacher-forced answers).  After the warm-up steps it times --steps
train steps one at a time (`step_ms`, the median), then traces as many and
prints one JSON line: the peak device memory, wall ms per traced step, the
device's busy share of the traced wall time, kernel launches per step, and
the kernels with the most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from .config import Config
from .data.loader import TrainLoader
from .data.synthetic import make_random_split

from .models.model import batch_to_device
from .parallel.train_step import init_train_state, train_step


def flagship_setup(device, steps: int, dropout: float = 0.0,
                   decoder: str = "disc", encoder: str = "mn-ques-im-hist",
                   img_spatial: bool = False, shard=None, **overrides):
    """(cfg, `steps` device batches cycling the epochs, fresh TrainState)
    for `encoder` at the flagship widths; img_spatial takes the 49 x 512
    pool5 map in place of fc7; shard=(d, data) gives data rank d's shard of
    each batch (data/loader.py::TrainLoader.epoch); `overrides` are further
    Config fields."""
    spatial = {"img_spatial": True, "img_feat_size": 49 * 512} if img_spatial else {}
    base = Config(encoder=encoder, decoder=decoder, dropout=dropout,
                  **spatial, **overrides)
    split, vocab = make_random_split(base, num_dialogs=64,
                                     num_unique_answers=100_000, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    loader = TrainLoader(split, vocab, cfg)
    batches = []
    epoch = 0
    while len(batches) < steps:
        batches += [batch_to_device(b.as_dict(), device)
                    for b in loader.epoch(seed=epoch, shard=shard)]
        epoch += 1
    return cfg, batches[:steps], init_train_state(cfg, device=device, seed=0)


def device_time_summary(prof, steps: int, wall_s: float, top: int = 8) -> dict:
    """Busy share, launches per step and the top kernels from a profile."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = 0.0
    end = -1.0
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))
        end = max(end, t)
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_busy_share": busy_us / 1e6 / wall_s,
            "device_busy_ms_per_step": busy_us / 1e3 / steps,
            "launches_per_step": len(kernels) / steps,
            "top_kernels": [{"name": n[:80], "calls_per_step": c / steps,
                             "ms_per_step": us / 1e3 / steps}
                            for n, (c, us) in ranked]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--decoder", choices=("disc", "gen"), default="disc")
    p.add_argument("--encoder", type=str, default="mn-ques-im-hist")
    p.add_argument("--img_spatial", action="store_true")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"),
                   default="float32")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--trace", type=str, default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    dev = torch.device("cuda:0")
    cfg, batches, state = flagship_setup(dev, args.warmup + args.steps,
                                         args.dropout, args.decoder,
                                         args.encoder, args.img_spatial,
                                         compute_dtype=args.compute_dtype,
                                         batch_size=args.batch_size)
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:args.warmup]:
        state, _ = train_step(state, b, cfg)
    torch.cuda.synchronize()
    times = []                 # the same steps untraced, one at a time
    for b in batches[args.warmup:]:
        t0 = time.perf_counter()
        state, _ = train_step(state, b, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[args.warmup:]:
            state, m = train_step(state, b, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({"phase": "train_profile", "steps": args.steps,
                      "model": f"{cfg.encoder}-{cfg.decoder}",
                      "dropout": args.dropout,
                      "compute_dtype": cfg.compute_dtype,
                      "batch_size": cfg.batch_size,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "step_ms": statistics.median(times),
                      "wall_ms_per_step": wall * 1e3 / args.steps,
                      **device_time_summary(prof, args.steps, wall, top=12)}), flush=True)


if __name__ == "__main__":
    main()
