"""Per-launch device time of K1 (LSTM forward) and of K2's two phases
(gates, dh) on each tile the kernels have, and of the dh phase at each
K-split S, at the row counts the benchmark's cells run: the disc encoders'
320 rows, gen's 640, the eval table's last 1,696-row chunk and its
8,192-row chunks, the candidate LSTM's 32,000; E 300 and 512, H 512, bf16
and f32, every step real.  The basis of ops/lstm_cuda.py::lstm_tile and
dh_splits.  On one GPU:

    python scripts/lstm_tile_sweep.py [--rows 320,640] [--reps 10]

First each tile and S at 640 and 1,696 rows is held to the plain version
(chip_smoke's limits).  Then one JSON line per (shape, dtype, tile, S):
`k1_us`, `gates_us`, `dh_us`, each kernel's mean duration over the
launches of `--reps` calls in the profiler's trace; `k1_graph_us`,
`k2_graph_us`, a call replayed from a CUDA graph, per step (the kernels
and the gaps between them, as the graphed steps run them); `rule` is true
on the tile and S that lstm_tile and dh_splits pick.
"""

import argparse
import contextlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from visdial_tpu_torch.ops import lstm_cuda  # noqa: E402
from visdial_tpu_torch.ops.lstm import lstm_layer_bwd_plain, lstm_layer_plain  # noqa: E402

KERNELS = {"k1_us": "lstm_fwd_step_kernel", "gates_us": "lstm_bwd_gates_kernel",
           "dh_us": "lstm_bwd_dh_kernel"}
ROWS = (320, 640, 1696, 8192, 32000)
CHECK_ROWS = (640, 1696)


@contextlib.contextmanager
def forced(tile, S):
    """lstm_tile and dh_splits replaced by constants."""
    saved = lstm_cuda.lstm_tile, lstm_cuda.dh_splits
    lstm_cuda.lstm_tile = lambda *a: tile
    lstm_cuda.dh_splits = lambda *a: S
    try:
        yield
    finally:
        lstm_cuda.lstm_tile, lstm_cuda.dh_splits = saved


def kernel_us(fn, reps: int) -> dict:
    """Each K1/K2 kernel's mean duration in µs over fn's launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key, name in KERNELS.items():
            if name in e.name:
                total[key] = total.get(key, 0.0) + e.time_range.elapsed_us()
                count[key] = count.get(key, 0) + 1
    return {k: total[k] / count[k] for k in total}


def graph_us(fn, steps: int, reps: int) -> float:
    """fn captured in a CUDA graph, replayed reps times: µs a step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) * 1e3 / (reps * steps)


def inputs(N, T, E, H, dt, align="ones"):
    gen = torch.Generator().manual_seed(N + E)
    w, b, x, mask, h0, c0 = cs.lstm_case(gen, N, T, E, H, align)
    g_hs = torch.randn(N, T, H, generator=gen)
    g_ht, g_ct = torch.randn(2, N, H, generator=gen)
    fwd = [t.cuda() for t in (w, b, x.to(dt), mask, h0, c0)]
    hs, cs_, _, _ = lstm_layer_plain(*fwd, save_cell=True)
    h_prev = torch.cat([fwd[4].to(dt)[:, None], hs[:, :-1]], dim=1)
    c_prev = torch.cat([fwd[5].to(dt)[:, None], cs_[:, :-1]], dim=1)
    bwd = (*fwd[:4], h_prev, c_prev, g_hs.cuda().to(dt), g_ht.cuda(), g_ct.cuda())
    return fwd, bwd


def choices(dt):
    return [(tile, S) for tile in lstm_cuda.TILES[dt] for S in lstm_cuda.DH_SPLITS]


def check_all(dt, H=512) -> None:
    """Every tile and S against the plain version, ragged rows."""
    name = str(dt).split(".")[1]
    for N in CHECK_ROWS:
        fwd, bwd = inputs(N, 9, 300, H, dt, align="mixed")
        want = lstm_layer_plain(*fwd, save_cell=True)
        want_b = lstm_layer_bwd_plain(*bwd)
        for tile, S in choices(dt):
            with forced(tile, S):
                got = lstm_cuda.lstm_layer(*fwd, save_cell=True)
                got_b = lstm_cuda.lstm_layer_bwd(*bwd)
            torch.cuda.synchronize()
            err, b_err = cs.abs_err(got, want), cs.rel_err(got_b, want_b)
            print(json.dumps({"check": [N, 9, 300, H], "dtype": name,
                              "tile": tile, "S": S, "k1_max_abs_err": err,
                              "k2_max_rel_err": b_err}), flush=True)
            cs.check(err <= cs.TOL[name] and b_err <= cs.GRAD_TOL[name],
                     f"tile {tile} S {S} at {N} rows {name}: {err}, {b_err}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rows", default=",".join(map(str, ROWS)))
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_tile_sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = lstm_cuda.sm_count(0)
    gpu = torch.cuda.get_device_name(0)
    for dt in (torch.bfloat16, torch.float32):
        check_all(dt)
    H = 512
    for N in map(int, args.rows.split(",")):
        T = 8 if N > 2000 else 16
        for E in (300, 512):
            for dt in (torch.bfloat16, torch.float32):
                fwd, bwd = inputs(N, T, E, H, dt)
                rule_tile = lstm_cuda.lstm_tile(N, H, dt, sms)
                rule_S = lstm_cuda.dh_splits(N, H, dt, rule_tile, sms)
                for tile, S in choices(dt):
                    row = {"shape": [N, T, E, H], "dtype": str(dt).split(".")[1],
                           "tile": tile, "S": S, "sms": sms, "gpu": gpu,
                           "rule": (tile, S) == (rule_tile, rule_S)}
                    with forced(tile, S):
                        if S == 1:   # K1 is the same at every S
                            row.update(kernel_us(
                                lambda: lstm_cuda.lstm_layer(*fwd), args.reps))
                            row["k1_graph_us"] = graph_us(
                                lambda: lstm_cuda.lstm_layer(*fwd), T, args.reps)
                        row.update(kernel_us(
                            lambda: lstm_cuda.lstm_layer_bwd(*bwd), args.reps))
                        row["k2_graph_us"] = graph_us(
                            lambda: lstm_cuda.lstm_layer_bwd(*bwd), T, args.reps)
                    print(json.dumps(row), flush=True)
                del fwd, bwd
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
