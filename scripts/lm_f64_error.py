"""How far K5's and K6's float32 logits are from an f64 reference, beside
how far the plain version's (cuBLAS's f32 path, TF32 off) are: the
kernels' 3xTF32 products with round-to-nearest k-tile sums against
cuBLAS's FMA chain.  K6 gives the logits back: with g = 1 and lse the f64
row logsumexp rounded to f32, a non-target entry is -exp(logit - lse), so
logit = log(-dlog) + lse (read where -dlog > 1e-30).  Data as
chip_smoke.py draws it (LSTM states, W at 0.1) and as
tests/test_torch_cuda.py does (x and W at 0.3 standard normal).  On one
GPU:

    python scripts/lm_f64_error.py

Prints one JSON line per data set and shape: max and rms |error| of each
side's logits against f64, max |kernel - plain| and the largest
|kernel - plain| / (1e-5 |plain d-logit|) (chip_smoke's f32 K6 limit
without its floor), and K5's max |error| of logp and lse against f64.
"""

import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,  # noqa: E402
                                            lm_token_logprobs_lse_plain)
from visdial_tpu_torch.ops.lm_score_cuda import (lm_dlogits,  # noqa: E402
                                                 lm_token_logprobs_lse)

CASES = [("smoke", 2880, 512, 8804), ("smoke", 73728, 512, 8804),
         ("test", 257, 520, 8804), ("test", 257, 200, 8804)]
CHUNK = 8192


def data(kind, NT, H, V, gen):
    if kind == "smoke":
        x = torch.tanh(torch.randn(NT, H, generator=gen))
        w = torch.randn(H, V, generator=gen) * 0.1
    else:
        x = torch.randn(NT, H, generator=gen)
        w = torch.randn(H, V, generator=gen) * 0.3
    b = torch.randn(V, generator=gen) * 0.1
    tgt = torch.randint(0, V, (NT,), generator=gen)
    return [t.cuda() for t in (x, w, b, tgt)]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("lm_f64_error: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, NT, H, V in CASES:
        x, w, b, tgt = data(kind, NT, H, V, torch.Generator().manual_seed(NT + H))
        acc = {k: 0.0 for k in ("k_max", "k_sq", "p_max", "p_sq", "diff_max",
                                "over", "n", "k5_logp", "k5_lse", "p5_logp",
                                "p5_lse")}
        for lo in range(0, NT, CHUNK):
            a = (x[lo:lo + CHUNK], w, b, tgt[lo:lo + CHUNK])
            logits = a[0].double() @ w.double() + b.double()
            lse = torch.logsumexp(logits, -1)
            logp = logits.gather(1, a[3][:, None])[:, 0] - lse
            for side, fn in (("k5", lm_token_logprobs_lse),
                             ("p5", lm_token_logprobs_lse_plain)):
                lp, ls = fn(*a)
                acc[side + "_logp"] = max(acc[side + "_logp"],
                                          float((lp.double() - logp).abs().max()))
                acc[side + "_lse"] = max(acc[side + "_lse"],
                                         float((ls.double() - lse).abs().max()))
            lse32, ones = lse.float(), torch.ones(a[0].shape[0], device=x.device)
            got = lm_dlogits(*a, lse32, ones)
            ref = lm_dlogits_plain(*a, lse32, ones)
            keep = (-ref > 1e-30) & (-got > 1e-30)
            keep.scatter_(1, a[3][:, None], False)
            over = (got - ref).abs() / (1e-5 * ref.abs())
            acc["over"] = max(acc["over"], float(over[ref != 0].max()))
            lk = torch.log(-got.double()) + lse32.double()[:, None]
            lp_ = torch.log(-ref.double()) + lse32.double()[:, None]
            ek, ep = (lk - logits)[keep], (lp_ - logits)[keep]
            acc["k_max"] = max(acc["k_max"], float(ek.abs().max()))
            acc["p_max"] = max(acc["p_max"], float(ep.abs().max()))
            acc["k_sq"] += float((ek * ek).sum())
            acc["p_sq"] += float((ep * ep).sum())
            acc["diff_max"] = max(acc["diff_max"], float((lk - lp_)[keep].abs().max()))
            acc["n"] += int(keep.sum())
            del logits, got, ref, keep, over, lk, lp_, ek, ep
            torch.cuda.empty_cache()
        n = acc.pop("n")
        print(json.dumps({
            "data": kind, "shape": [NT, H, V], "gpu": torch.cuda.get_device_name(0),
            "kernel_logit_max_err": acc["k_max"],
            "kernel_logit_rms_err": math.sqrt(acc["k_sq"] / n),
            "plain_logit_max_err": acc["p_max"],
            "plain_logit_rms_err": math.sqrt(acc["p_sq"] / n),
            "kernel_vs_plain_logit_max": acc["diff_max"],
            "k6_over_rtol": acc["over"],
            "k5_logp_max_err": acc["k5_logp"], "k5_lse_max_err": acc["k5_lse"],
            "plain_logp_max_err": acc["p5_logp"], "plain_lse_max_err": acc["p5_lse"],
            "entries": n}), flush=True)


if __name__ == "__main__":
    main()
