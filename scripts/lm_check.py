"""The first check of K5 and K6 (csrc/lm_score.cu) on a card after a change
to their sources, and their times: build the kernels, print each
tensor-core kernel's resources and HGMMA count (chip_smoke.kernel_report),
then run K5 and K6 at ragged shapes, the training shape and one gen-eval
chunk, f32 and bf16, against their plain versions under chip_smoke's
limits (K6 in f32 against chip_smoke.dlogits_ref), with the median ms of
each wrapper and of its plain version, the kernels' own device ms and the
time of packing W.  On one GPU:

    python scripts/lm_check.py                 # check and time
    python scripts/lm_check.py --splits        # also K5 at forced splits
    python scripts/lm_check.py --no_report --label parent   # another checkout

Run from the scripts/ of another checkout (--no_report where its
chip_smoke.py has no kernel_report), it checks and times that checkout's
kernels (the parent of the tensor-core K5/K6 included).
Prints one JSON line per shape and dtype; fails at the first miss.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from visdial_tpu_torch.ops import _build, lm_score_cuda  # noqa: E402
from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,  # noqa: E402
                                            lm_token_logprobs_lse_plain)
from visdial_tpu_torch.ops.lm_score_cuda import (lm_dlogits,  # noqa: E402
                                                 lm_token_logprobs_lse)

# rows around the 128-row tile, depths off the k-tiles (33, 48, 72, 520), odd
# and narrow vocabularies, then the training shape and one gen-eval chunk
SHAPES = [(1, 8, 10), (127, 48, 1030), (128, 33, 129), (129, 72, 2001),
          (257, 520, 8804), (2880, 512, 8804), (73728, 512, 8804)]
SPLITS = {2880: [1, 3, 5, 10, 23, 69], 73728: [1, 2, 5, 10, 23, 69]}


def case(gen, NT, H, V, dev):
    x = torch.tanh(torch.randn(NT, H, generator=gen))
    w = torch.randn(H, V, generator=gen) * 0.1
    b = torch.randn(V, generator=gen) * 0.1
    tgt = torch.randint(0, V, (NT,), generator=gen)
    tgt[::4] = 0
    g = torch.randn(NT, generator=gen)
    g[tgt == 0] = 0.0
    return [t.to(dev) for t in (x, w, b, tgt, g)]


def kernel_ms(x, w, b, tgt, lse, g, reps=20):
    """Device ms of K5's two launches and of K6's launch alone: operands
    prepared once as the wrappers prepare them, then `reps` calls of each C
    entry back to back between two CUDA events."""
    lib = _build.library()
    xp, wk = lm_score_cuda.pad_lm_input(x), lm_score_cuda.pack_lm_weight(w, x.dtype)
    bp, t32 = lm_score_cuda.pad_lm_bias(b), tgt.to(torch.int32)
    (NT, Hp), V = xp.shape, w.shape[1]
    splits, per = lm_score_cuda.vocab_splits(
        NT, V, torch.cuda.get_device_properties(x.device).multi_processor_count,
        lm_score_cuda.BLOCKS_PER_SM[x.dtype])
    part = torch.empty((splits, NT, 3), device=x.device)
    logp, ls = torch.empty(NT, device=x.device), torch.empty(NT, device=x.device)
    dlog = torch.empty((NT, V), dtype=x.dtype, device=x.device)
    code, stream = _build.DTYPE_CODE[x.dtype], _build.stream_of(x)
    ptr = [t.data_ptr() for t in (xp, wk, bp, t32)]

    def k5():
        return lib.vd_lm_score(code, *ptr, part.data_ptr(), logp.data_ptr(),
                               ls.data_ptr(), NT, Hp, V, per, splits, stream)

    def k6():
        return lib.vd_lm_dlogits(code, *ptr, lse.data_ptr(), g.data_ptr(),
                                 dlog.data_ptr(), NT, Hp, V, stream)

    out = []
    for fn in (k5, k6):
        _build.check(fn(), "lm_check")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label", default="")
    p.add_argument("--no_report", action="store_true")
    p.add_argument("--splits", action="store_true")
    p.add_argument("--heads", action="store_true",
                   help="only the training shape and the gen-eval chunk")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lm_check: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.time()
    _build.library()
    print(json.dumps({"build_s": time.time() - t0,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)
    if not args.no_report:
        cs.kernel_report()
    # an older checkout's chip_smoke.py holds K6 to its plain version, and
    # its wrappers prepare no operands to time apart
    ref_fn = getattr(cs, "dlogits_ref", lm_dlogits_plain)
    packs = hasattr(lm_score_cuda, "pack_lm_weight")
    gen = torch.Generator().manual_seed(0)
    for NT, H, V in SHAPES[-2:] if args.heads else SHAPES:
        x, w, b, tgt, g = case(gen, NT, H, V, dev)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            a = (x.to(dt), w, b, tgt)
            got, want = lm_token_logprobs_lse(*a), lm_token_logprobs_lse_plain(*a)
            d_got = lm_dlogits(*a, want[1], g)
            d_ref = ref_fn(*a, want[1], g)
            torch.cuda.synchronize()
            tol = cs.LM_TOL * max(1.0, float(want[0].abs().max()))
            row = {"label": args.label, "shape": [NT, H, V], "dtype": name,
                   "k5_err": cs.abs_err(got, want), "k5_tol": tol,
                   "k6_over_limit": cs.dlogits_over_limit(d_got, d_ref, g, dt)}
            del d_got, d_ref
            reps = 10 if NT < 10_000 else 5
            row.update({
                "k5_ms": cs.time_ms(lambda: lm_token_logprobs_lse(*a), reps),
                "k5_plain_ms": cs.time_ms(lambda: lm_token_logprobs_lse_plain(*a),
                                          reps),
                "k6_ms": cs.time_ms(lambda: lm_dlogits(*a, want[1], g), reps),
                "k6_plain_ms": cs.time_ms(lambda: lm_dlogits_plain(*a, want[1], g),
                                          reps),
                "bound_ms": cs.lm_bound(NT, H, V, name)["bound_ms"]})
            if packs:
                row["k5_kernel_ms"], row["k6_kernel_ms"] = kernel_ms(
                    *a, want[1], g, reps=20 if NT < 10_000 else 5)
                row["pack_ms"] = cs.time_ms(
                    lambda: lm_score_cuda.pack_lm_weight(w, dt))
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
            cs.check(row["k5_err"] <= tol and row["k6_over_limit"] <= 1.0,
                     f"lm_check {(NT, H, V)} {name}: {row}")
            if args.splits and NT in SPLITS:
                rule = lm_score_cuda.vocab_splits
                ms = {}
                n_vt = -(-V // lm_score_cuda.VOCAB_TILE)
                for s in SPLITS[NT]:
                    per = -(-n_vt // s)
                    lm_score_cuda.vocab_splits = lambda *_, s=s, per=per: (
                        -(-n_vt // per), per)
                    ms[s] = cs.time_ms(lambda: lm_token_logprobs_lse(*a), 5)
                lm_score_cuda.vocab_splits = rule
                print(json.dumps({"label": args.label, "shape": [NT, H, V],
                                  "dtype": name, "rule": rule(
                                      NT, V, torch.cuda.get_device_properties(0)
                                      .multi_processor_count,
                                      lm_score_cuda.BLOCKS_PER_SM[dt]),
                                  "k5_ms_by_splits": ms}), flush=True)


if __name__ == "__main__":
    main()
