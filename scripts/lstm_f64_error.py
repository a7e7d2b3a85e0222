"""How far K1's float32 states are from an f64 reference, beside how far
the plain version (cuBLAS's f32 path, TF32 off) is: the kernel's 3xTF32
products with round-to-nearest k-tile sums against cuBLAS's FMA chain.
Data as tests/test_torch_cuda.py draws it at the real width (weights at
the model's init scale).  On one GPU:

    python scripts/lstm_f64_error.py

Prints one JSON line per shape: max |error| of hs, cs, hT, cT.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from visdial_tpu_torch.ops.lstm import INIT_SCALE, lstm_layer_plain  # noqa: E402
from visdial_tpu_torch.ops.lstm_cuda import lstm_layer  # noqa: E402


def lstm_f64(w, b, x, mask, h0, c0):
    """The masked LSTM layer in float64: (hs, cs, hT, cT)."""
    h, c = h0.double(), c0.double()
    hs, cs = [], []
    for t in range(x.shape[1]):
        z = torch.cat([x[:, t].double(), h], -1) @ w.double() + b.double()
        i, f, g, o = z.chunk(4, -1)
        c_new = f.sigmoid() * c + i.sigmoid() * g.tanh()
        h_new = o.sigmoid() * c_new.tanh()
        m = mask[:, t].double()[:, None]
        h, c = m * h_new + (1 - m) * h, m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1), h, c


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lstm_f64_error: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for N, T, E, H in [(320, 16, 300, 512), (8192, 8, 300, 512)]:
        g = torch.Generator().manual_seed(N)
        w = torch.empty(E + H, 4 * H).uniform_(-INIT_SCALE, INIT_SCALE, generator=g)
        b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=g)
        x = torch.randn(N, T, E, generator=g)
        mask = (torch.rand(N, T, generator=g) < 0.6).float()
        mask[::3] = 0.0
        h0, c0 = torch.randn(2, N, H, generator=g)
        args = [t.cuda() for t in (w, b, x, mask, h0, c0)]
        ref = lstm_f64(*args)

        def err(got):
            return [float((a.double() - r).abs().max()) for a, r in zip(got, ref)]

        print(json.dumps({"shape": [N, T, E, H], "gpu": torch.cuda.get_device_name(0),
                          "kernel_vs_f64": err(lstm_layer(*args, save_cell=True)),
                          "plain_vs_f64": err(lstm_layer_plain(*args, save_cell=True))}),
              flush=True)


if __name__ == "__main__":
    main()
