#!/usr/bin/env python3
"""A/B of the streaming eval's feed on one GPU.

    python scripts/eval_feed_ab.py [--variants thread,inline,...] [--reps 8]

evaluate_split's streaming path (no resident cache) for flagship
MN-QIH-disc (the parameters outside the LSTMs times 4) and MN-QIH-gen over
gen_eval's 256-dialog split (seed 1), f32, TF32 off, kernels on, with the
feed swapped in this process:

  thread         the harness as it is: the staging thread (_staged)
                 assembles and uploads batch i+1 while batch i computes;
  inline         the same pinned copies on the copy stream and the same
                 one-batch-late readback, but batch i+1 assembled and
                 uploaded by the main thread after batch i is enqueued;
  switch1e-4     thread, with the interpreter's switch interval at 0.1 ms
                 (default 5 ms) for the call;
  thread_packed  thread, each dtype's arrays packed into one pinned buffer
                 and copied once (2 copies a batch in place of ~8);
  inline_packed  inline and packed.

The variants run in turn, --reps rounds (the first is a warm-up); prints one
JSON line per model with the median and every run's evals_per_sec, the
median host time of a call, and the host seconds the last run spent in
_Transfer.upload.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variants", type=str,
                   default="thread,inline,switch1e-4,thread_packed,inline_packed")
    p.add_argument("--reps", type=int, default=8)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("eval_feed_ab: needs a CUDA device")
    from visdial_tpu_torch import eval_harness as eh
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.models.model import batch_to_device, model_init
    from visdial_tpu_torch.utils.params import flatten, unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    real_staged, real_upload = eh._staged, eh._Transfer.upload
    spent: dict = {}

    def upload_packed(self, arrays):
        host = batch_to_device(arrays, "cpu")
        groups: dict = {}
        for k, v in host.items():
            groups.setdefault(v.dtype, []).append((k, v))
        out = {}
        with torch.cuda.stream(self.copy):
            for dt, items in groups.items():
                buf = torch.empty(sum(v.numel() for _, v in items), dtype=dt,
                                  pin_memory=True)
                torch.cat([v.reshape(-1) for _, v in items], out=buf)
                on_dev = buf.to(self.device, non_blocking=True)
                on_dev.record_stream(self.compute)
                off = 0
                for k, v in items:
                    out[k] = on_dev[off:off + v.numel()].view(v.shape)
                    off += v.numel()
            done = torch.cuda.Event()
            done.record(self.copy)
        return out, done

    def inline():
        eh._staged = lambda it, stage: (stage(x) for x in it)

    def packed():
        eh._Transfer.upload = upload_packed

    setups = {"thread": lambda: None, "inline": inline,
              "switch1e-4": lambda: sys.setswitchinterval(1e-4),
              "thread_packed": packed,
              "inline_packed": lambda: (inline(), packed())}
    variants = {v: setups[v] for v in args.variants.split(",")}
    switch = sys.getswitchinterval()
    for decoder in ("disc", "gen"):
        base = Config(encoder="mn-ques-im-hist", decoder=decoder, dropout=0.0)
        split, vocab = make_random_split(base, num_dialogs=256, seed=1)
        cfg = base.replace(vocab_size=vocab.size)
        params = model_init(cfg, seed=0, device=dev)
        if decoder == "disc":
            params = unflatten({n: v if "lstm" in n else v * 4.0
                                for n, v in flatten(params).items()})
        rates = {v: [] for v in variants}
        call_ms = {v: [] for v in variants}
        host = {}
        for rep in range(args.reps):
            for name, setup in variants.items():
                setup()
                upload = eh._Transfer.upload

                def timed(self, arrays, _upload=upload):
                    t = time.perf_counter()
                    out = _upload(self, arrays)
                    spent["upload"] = (spent.get("upload", 0.0)
                                       + time.perf_counter() - t)
                    return out

                eh._Transfer.upload = timed
                spent.clear()
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = eh.evaluate_split(params, split, vocab, cfg, dev)
                    call_ms[name].append((time.perf_counter() - t0) * 1e3)
                finally:
                    eh._staged, eh._Transfer.upload = real_staged, real_upload
                    sys.setswitchinterval(switch)
                if rep:
                    rates[name].append(m["evals_per_sec"])
                host[name] = dict(spent)
        print(json.dumps({
            "model": f"mn-ques-im-hist-{decoder}",
            "rates": {k: statistics.median(v) for k, v in rates.items()},
            "runs": rates,
            "call_ms": {k: statistics.median(v) for k, v in call_ms.items()},
            "host_s_last_run": host}), flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
