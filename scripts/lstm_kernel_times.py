"""Device times of K1 (LSTM forward) and K2 (LSTM backward) at the head
shape and the 320-row question and fact shapes, f32 and bf16, for the
checkout it is run from (CUDA events, median of 10 calls, chip_smoke's
inputs), and of LSTMLayerFn's whole backward (K2, then the dW, db and dx
contractions; `bwd_ms`, median of 5) with the peak device memory of those
calls (`bwd_peak_gb`).  To compare two commits on one card, unpack each
and run this script from each in turn in one session:

    python scripts/lstm_kernel_times.py --label parent

Prints one JSON line per shape and dtype.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from visdial_tpu_torch.ops.lstm_cuda import (LSTMLayerFn, lstm_layer,  # noqa: E402
                                            lstm_layer_bwd)

SHAPES = [(32000, 8, 300, 512), (320, 40, 300, 512), (320, 16, 300, 512)]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lstm_kernel_times: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    for N, T, E, H in SHAPES:
        case = chip_smoke.lstm_case(gen, N, T, E, H)
        g_hs = torch.randn(N, T, H, generator=gen)
        g_ht, g_ct = torch.randn(2, N, H, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            w, b, x, mask, h0, c0 = (t.cuda() for t in case)
            x = x.to(dt)
            hs, cs, _, _ = lstm_layer(w, b, x, mask, h0, c0, save_cell=True)
            h_prev = torch.cat([h0.to(dt)[:, None], hs[:, :-1]], dim=1)
            c_prev = torch.cat([c0.to(dt)[:, None], cs[:, :-1]], dim=1)
            bwd = (w, b, x, mask, h_prev, c_prev, g_hs.cuda().to(dt), g_ht.cuda(),
                   g_ct.cuda())
            row = {"label": args.label, "shape": [N, T, E, H],
                   "dtype": str(dt).split(".")[1],
                   "gpu": torch.cuda.get_device_name(0),
                   "k1_ms": chip_smoke.time_ms(lambda: lstm_layer(w, b, x, mask, h0, c0)),
                   "k2_ms": chip_smoke.time_ms(lambda: lstm_layer_bwd(*bwd))}
            del hs, cs, h_prev, c_prev, bwd
            ins = [t.clone().requires_grad_() for t in (w, b, x, h0, c0)]
            outs = LSTMLayerFn.apply(*ins[:3], mask, *ins[3:])
            cot = [g_hs.cuda().to(dt), g_ht.cuda(), g_ct.cuda()]
            torch.cuda.reset_peak_memory_stats()
            row["bwd_ms"] = chip_smoke.time_ms(lambda: torch.autograd.grad(
                outs, ins, cot, retain_graph=True), reps=5, warmup=1)
            row["bwd_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
            del outs, ins
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
