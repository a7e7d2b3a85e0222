"""The first check of K3 and K4 (csrc/attention_fusion.cu) on a card after a
change to their sources, and their times: build the kernels, print K3's and
K4's resources (chip_smoke.kernel_report), then run K3 (masked_slot_attention)
and K4 (attention_fusion) against their plain versions under chip_smoke's
limits, f32 and bf16, with the mask as the encoder hands it over (an
expanded view, batch stride 0).  On one GPU:

    python scripts/attention_check.py                  # check and time
    python scripts/attention_check.py --sweep          # K4's routes by rows
    python scripts/attention_check.py --clusters       # cluster sizes
    python scripts/attention_check.py --no_report --label parent  # another checkout

Run from the scripts/ of another checkout (--no_report where its
chip_smoke.py does not report K3 and K4), it checks and times that
checkout's kernels.  Each row is one JSON line; the columns:

  ms          median of single wrapper calls, each between its own pair of
              CUDA events: for a kernel of a few microseconds this is the
              host's time (the wrapper, ctypes, its tensor allocations);
  launch_ms   LAUNCH_REPS wrapper calls back to back between one pair of
              events, over the count: the rate the card can be fed at;
  graph_ms    the card's time a call without the host: GRAPH_CALLS calls
              captured in one CUDA graph, replayed back to back (kernels
              that overlap count once, the gaps between them count);
  device_ms   the card's own kernel time a call, from torch.profiler over
              PROFILE_REPS calls (every kernel the wrapper launched, summed:
              two that overlap count twice, as the tensor-core route's
              attention and product may), with device_kernels the same
              split by kernel name;
  plain_ms    the plain PyTorch version, as `ms`;
  library_ms  K3 only: one scaled_dot_product_attention call (as `ms`);
  pack_ms     K4 where its wrapper packs Wf for the tensor-core route;
  bound_ms    chip_smoke.attention_bound: bytes at 3.35 TB/s or operations
              at the operand type's peak, whichever is larger.

K3 runs with the encoder's mask at 32 dialogs, with all-masked rows at 4,
and at img_spatial's 49 pool5 locations with that pathway's all-ones mask;
K4 with all-masked rows at 7.  K4 rows name the route the wrapper took
(attention_cuda.fusion_route); --sweep adds K4 on each route at 1 to 32
dialogs of 10 rounds, which is how FUSION_STREAM_ROWS was set; --clusters
adds K3 at 1, 2, 4 and 8 blocks a dialog and K4 at 2, 4 and 8 k-slices, in
place of the wrapper's rules (attention_cuda.attention_blocks,
stream_blocks and fusion_splits).  Fails at the first miss.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from visdial_tpu_torch.ops import _build, attention_cuda  # noqa: E402
from visdial_tpu_torch.ops.attention import (attention_fusion_ref,  # noqa: E402
                                             attention_plain)

LAUNCH_REPS = 200
PROFILE_REPS = 50
GRAPH_CALLS, GRAPH_REPS = 20, 10
# K3: the training batch, all-masked rows, img_spatial's 49 slots, the limit
K3_SHAPES = [(32, 10, 10, 512), (4, 10, 10, 512), (32, 10, 49, 512),
             (32, 10, 64, 512)]
# K4: serving, the eval batch, ragged rows (the threshold's sides are added)
K4_SHAPES = [(1, 10, 10, 512), (32, 10, 10, 512), (7, 10, 10, 512)]
SWEEP_DIALOGS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]


def case(gen, dev, B, R, S, H, masked: bool):
    """q, slots (on the CPU), the mask on `dev` as the encoder builds it,
    an expanded view of one (R, S) mask: causal, or all ones at S = 49 (the
    img_spatial pathway's pool5 locations); with `masked`, a materialised
    one with two all-masked rows.  Wf and b (on the CPU)."""
    q = torch.randn(B, R, H, generator=gen) * 0.5
    s = torch.randn(B, S, H, generator=gen) * 0.5
    if S == cs.SPATIAL_SLOTS:
        valid = torch.ones(R, S)
    else:
        valid = (torch.arange(S)[None, :] <= torch.arange(R)[:, None]).float()
    valid = valid.to(dev)[None].expand(B, R, S)
    if masked:
        valid = valid.contiguous()
        valid[1, 3] = 0.0
        valid[3, 0] = 0.0
    fw = torch.empty(2 * H, H).uniform_(-0.08, 0.08, generator=gen)
    fb = torch.empty(H).uniform_(-0.08, 0.08, generator=gen)
    return q, s, valid, fw, fb


def launch_ms(fn, n: int = LAUNCH_REPS) -> float:
    """n calls back to back between one pair of CUDA events, over n."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = PROFILE_REPS):
    """(ms a call of all device kernels, {kernel name: ms a call}) from
    torch.profiler over n calls; (None, {}) where it saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(2):   # the profiler has been seen to return no events once
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        if by_name:
            break
    if not by_name:
        return None, {}
    return (sum(by_name.values()) / n / 1e3,
            {k[:80]: v / n / 1e3 for k, v in by_name.items()})


def graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = GRAPH_REPS):
    """The card's time a call with the host out of the way: `calls` calls
    captured in one CUDA graph, replayed `reps` times back to back between
    one pair of events, over calls x reps; a string saying why where the
    capture failed."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (calls * reps)
    except RuntimeError as e:
        return f"not measured: {str(e)[:160]}"


def timings(fn) -> dict:
    dev, kernels = device_ms(fn)
    return {"ms": cs.time_ms(fn, 50), "launch_ms": launch_ms(fn),
            "graph_ms": graph_ms(fn),
            "device_ms": dev if dev is not None else "not measured",
            "device_kernels": kernels}


@contextlib.contextmanager
def forced(**counts):
    """attention_cuda's cluster rules (attention_blocks, stream_blocks,
    fusion_splits) replaced by fixed counts for the duration."""
    rules = {name: getattr(attention_cuda, name) for name in counts}
    for name, n in counts.items():
        setattr(attention_cuda, name, lambda *_, n=n: n)
    try:
        yield
    finally:
        for name, rule in rules.items():
            setattr(attention_cuda, name, rule)


def k3_row(label, gen, dev, B, R, S, H, dt) -> dict:
    q, s, valid, _, _ = case(gen, dev, B, R, S, H, masked=B == 4)
    name = str(dt).split(".")[1]
    args = (q.to(dev, dt), s.to(dev, dt), valid)
    got = attention_cuda.masked_slot_attention(*args)
    want = attention_plain(*args)
    torch.cuda.synchronize()
    err = cs.rel_err([got], [want])
    row = {"label": label, "kernel": "attention", "shape": [B, R, S, H],
           "dtype": name, "max_rel_err": err, "tol": cs.TOL[name],
           **timings(lambda: attention_cuda.masked_slot_attention(*args)),
           "plain_ms": cs.time_ms(lambda: attention_plain(*args), 50),
           "library_ms": cs.time_ms(lambda: cs.sdpa_attention(*args), 50),
           **cs.attention_bound(B, R, S, H, name)}
    cs.check(bool(torch.isfinite(got.float()).all()) and err <= cs.TOL[name],
             f"attention {(B, R, S, H)} {name}: {row}")
    return row


def k4_row(label, gen, dev, B, R, S, H, dt, route=None) -> dict:
    """K4 at one shape; `route` forces the product's route (the change's
    wrapper only)."""
    q, s, valid, fw, fb = case(gen, dev, B, R, S, H, masked=B == 7)
    name = str(dt).split(".")[1]
    args = (q.to(dev, dt), s.to(dev, dt), valid, fw.to(dev), fb.to(dev))
    rule = getattr(attention_cuda, "fusion_route", None)
    if route is not None:
        attention_cuda.fusion_route = lambda *_: route
    try:
        got = attention_cuda.attention_fusion(*args)
        want = attention_fusion_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        taken = rule(B, R, S, H, dt) if route is None and rule else route
        row = {"label": label, "kernel": "attention_fusion", "shape": [B, R, S, H],
               "dtype": name, "route": taken, "max_abs_err": err, "tol": cs.TOL[name],
               **timings(lambda: attention_cuda.attention_fusion(*args))}
    finally:
        if rule is not None:
            attention_cuda.fusion_route = rule
    if route is None:
        row["plain_ms"] = cs.time_ms(lambda: attention_fusion_ref(*args), 50)
        if hasattr(attention_cuda, "pack_fusion_weight"):
            row["pack_ms"] = cs.time_ms(
                lambda: attention_cuda.pack_fusion_weight(args[3], dt), 50)
    row.update(cs.attention_bound(B, R, S, H, name, fusion=True))
    cs.check(bool(torch.isfinite(got.float()).all()) and err <= cs.TOL[name],
             f"attention_fusion {(B, R, S, H)} {name}: {row}")
    return row


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label", default="")
    p.add_argument("--no_report", action="store_true")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--clusters", action="store_true",
                   help="K3 at each cluster size (blocks a dialog)")
    p.add_argument("--heads", action="store_true",
                   help="only K3 at 32,10,10,512 and K4 at 1 and 32 dialogs")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("attention_check: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.time()
    _build.library()
    print(json.dumps({"label": args.label, "build_s": time.time() - t0,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)
    if not args.no_report:
        cs.kernel_report()
    gen = torch.Generator().manual_seed(0)
    k3_shapes, k4_shapes = K3_SHAPES, list(K4_SHAPES)
    if args.heads:
        k3_shapes, k4_shapes = K3_SHAPES[:1], K4_SHAPES[:2]
    elif hasattr(attention_cuda, "FUSION_STREAM_ROWS"):
        sides = {b for t in attention_cuda.FUSION_STREAM_ROWS.values()
                 for b in (t // 10, t // 10 + 1)}   # the threshold's sides
        k4_shapes += [(b, 10, 10, 512) for b in sorted(sides - {7})]
    for dt in (torch.float32, torch.bfloat16):
        for shape in k3_shapes:
            print(json.dumps(k3_row(args.label, gen, dev, *shape, dt)), flush=True)
        for shape in k4_shapes:
            print(json.dumps(k4_row(args.label, gen, dev, *shape, dt)), flush=True)
        if args.sweep:
            for B in SWEEP_DIALOGS:
                fits = attention_cuda.stream_fits(B, 10, 10, 512, dt)
                for route in ("stream", "tiles")[not fits:]:
                    row = k4_row(args.label, gen, dev, B, 10, 10, 512, dt, route)
                    print(json.dumps({k: row[k] for k in (
                        "label", "shape", "dtype", "route", "max_abs_err", "ms",
                        "launch_ms", "graph_ms", "device_ms")}), flush=True)
        if args.clusters:
            for shape in (K3_SHAPES[0], K3_SHAPES[2]):
                for cl in (1, 2, 4, 8):
                    with forced(attention_blocks=cl):
                        row = k3_row(args.label, gen, dev, *shape, dt)
                    print(json.dumps({"cluster": cl, **{k: row[k] for k in (
                        "label", "shape", "dtype", "max_rel_err", "ms", "launch_ms",
                        "graph_ms", "device_ms")}}), flush=True)
            for shape in K4_SHAPES[:2]:       # each on its route
                for split in (2, 4, 8):
                    with forced(stream_blocks=split, fusion_splits=split):
                        row = k4_row(args.label, gen, dev, *shape, dt)
                    print(json.dumps({"split": split, **{k: row[k] for k in (
                        "label", "shape", "dtype", "route", "max_abs_err", "ms",
                        "launch_ms", "graph_ms", "device_ms", "device_kernels")}}),
                          flush=True)


if __name__ == "__main__":
    main()
