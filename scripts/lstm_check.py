"""The first check of K1 and K2 on a card after a change to their sources:
build the kernels, print each K1/K2 kernel's resources and HGMMA count
(chip_smoke.kernel_report), then run K1 and K2 once at small ragged
shapes, the 10-, 320- and 330-row shapes (K1's resident route in bf16,
ops/lstm_cuda.py::layer_plan; 330 rows a block past a multiple of 64),
the 640- and 1,696-row shapes (each on another tile or K-split,
lstm_tile) and the head shape, f32 and bf16, against their plain
versions, and stop.  Stops at the first shape that
raises.  On one GPU:

    python scripts/lstm_check.py

Prints one JSON line per shape and dtype: K1's max abs error over
(hs, cs, hT, cT), K2's max error relative to the largest reference value
over (dgp, dh0, dc0), K1's route and each kernel's median ms over 3
calls.
"""

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from visdial_tpu_torch.ops import _build  # noqa: E402
from visdial_tpu_torch.ops.lstm import lstm_layer_bwd_plain, lstm_layer_plain  # noqa: E402
from visdial_tpu_torch.ops.lstm_cuda import lstm_layer, lstm_layer_bwd  # noqa: E402

SHAPES = [(70, 3, 33, 40), (5, 7, 10, 12), (600, 5, 20, 36), (10, 16, 300, 512),
          (320, 16, 300, 512), (330, 40, 512, 512), (640, 16, 300, 512),
          (1696, 8, 300, 512), (32000, 8, 300, 512)]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lstm_check: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.library()
    print(json.dumps({"build_s": time.time() - t0}), flush=True)
    cs.kernel_report()
    gen = torch.Generator().manual_seed(0)
    for N, T, E, H in SHAPES:
        w, b, x, mask, h0, c0 = cs.lstm_case(gen, N, T, E, H)
        g_hs = torch.randn(N, T, H, generator=gen)
        g_ht, g_ct = torch.randn(2, N, H, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            args = [t.cuda() for t in (w, b, x.to(dt), mask, h0, c0)]
            got, moved = cs.counted_choice(
                lstm_layer, lambda: lstm_layer(*args, save_cell=True))
            want = lstm_layer_plain(*args, save_cell=True)
            h_prev = torch.cat([args[4].to(dt)[:, None], want[0][:, :-1]], dim=1)
            c_prev = torch.cat([args[5].to(dt)[:, None], want[1][:, :-1]], dim=1)
            bwd = (*args[:4], h_prev, c_prev, g_hs.cuda().to(dt), g_ht.cuda(),
                   g_ct.cuda())
            k2, k2_plain = lstm_layer_bwd(*bwd), lstm_layer_bwd_plain(*bwd)
            torch.cuda.synchronize()
            print(json.dumps({
                "shape": [N, T, E, H], "dtype": str(dt).split(".")[1],
                "route": [k for k in moved if k.startswith("route_")],
                "k1_max_abs_err": cs.abs_err(got, want),
                "k2_max_rel_err": cs.rel_err(k2, k2_plain),
                "k1_ms": cs.time_ms(lambda: lstm_layer(*args), reps=3, warmup=1),
                "k2_ms": cs.time_ms(lambda: lstm_layer_bwd(*bwd), reps=3, warmup=1)}),
                flush=True)


if __name__ == "__main__":
    main()
