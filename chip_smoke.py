#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (visdial_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and holds each against its plain
PyTorch version on the card at the shapes the serving, training and
evaluation paths give it: K1 (LSTM forward, with and without cell states),
K2 (LSTM backward, through LSTMLayerFn), K3 (slot attention, through
AttentionFn), K4 (attention + fusion), K5 (LM-head log-probs and row
logsumexp) and K6 (LM-head d-logits, and TokenLogprobFn's gradients).  Then
it drives the main paths of the flagship MN-QIH models (random weights from
a seed, full width): disc served over a 50,000-answer pool through
InferenceEngine and the JSON-lines CLI, disc trained through train_step
(kernel path against the plain path at dropout 0 and 0.5, then 20 steps),
gen trained the same way, gen evaluated through evaluate_split over 100
candidates a round, gen served (greedy and beam 5), and the train CLI for
both decoders with a resume.  Each path must have gone through its kernels
and agree with a run of the plain versions on the same card.

Each phase prints one JSON line.  Then come the raw nvidia-smi line (card
name, power limit), the kernel summary line (each kernel's launches on its
main path, error, time, plain time, bound and library time), and, last, the
result line {"ok": true, "device": {...}}.  Any failed check raises, and the
exit code is non-zero.  Without a CUDA device the script exits non-zero at
once.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# f32: both sides sum K <= 812 products of f32 operands in another order over
# up to 40 recurrent steps; bf16: outputs are rounded to bf16 (one ulp is
# 2^-8 at |h| < 1), and an order-dependent flip of h's rounding feeds the
# next step.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Gradients, relative to the largest reference value: f32 as above; bf16
# also rounds dgp (and both sides' residuals) to bf16 at every step, and
# that rounding feeds dh through T steps and dW through N*T-row sums.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SCORE_TOL = 1e-3   # served scores: 512-term dot products of f32 LSTM states
LSTM_SHAPES = [(8192, 8, 300, 512), (8192, 8, 512, 512),
               (10, 40, 300, 512), (10, 16, 300, 512),
               (320, 40, 300, 512), (320, 16, 300, 512),
               (32000, 8, 300, 512), (32000, 8, 512, 512)]   # N, T, E, H
# the head shape of K1 and K2, where the single-pass TF32 control runs
LSTM_HEAD = (32000, 8, 300, 512)
# the training path: the option LSTM's 32,000 candidate rows (both layers),
# the question and fact LSTMs' 320 rows (first layers)
BWD_SHAPES = [(32000, 8, 300, 512), (32000, 8, 512, 512),
              (320, 40, 300, 512), (320, 16, 300, 512)]
ATTN_SHAPES = [(1, 10, 10, 512), (32, 10, 10, 512)]       # B, R, S, H
# K3: the training batch, one dialog, and a batch with all-masked rows
ATTN3_SHAPES = [(32, 10, 10, 512), (1, 10, 10, 512), (4, 10, 10, 512)]
# train: loss is a mean of 320 f32 NLLs; grad_norm and the gradients are
# sums in another order (K2 and the f32 contractions vs autograd + cuBLAS)
LOSS_TOL, GNORM_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-4
TRAIN_STEPS = 20
# gen eval's rate: runs of each path over 8 full 32-dialog batches
EVAL_DIALOGS, EVAL_REPS = 256, 3
# K5 / K6 (NT, H, V): gen training's 320 x 9 tokens, one 8,192-row scoring
# chunk of gen eval (x 9 steps), ragged rows with the flagship vocab's
# ragged tail, and one row over a vocab narrower than a tile
LM_SHAPES = [(2880, 512, 8804), (73728, 512, 8804), (513, 512, 8848),
             (1, 512, 10)]
# K5, relative to the largest |logp|, in either dtype: the products are exact
# in f32 on both sides (bf16 operands widened) and accumulated in f32, so only
# the order of the 512-term sums and of the vocab's logsumexp differs
LM_TOL = 1e-5
# K6, per element: f32 within 1e-5 of |ref|; bf16 within one bf16 ulp of ref
# (both sides round the same f32 value, up to a sum-order difference, to
# bf16); plus DLOG_FLOOR x |g_i| / V for entries whose p underflows
DLOG_RTOL, DLOG_FLOOR = 1e-5, {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# the planted control: logits whose running sum over H is rounded to bf16
# after every 16 products (K5/K6's shared-tile depth), as a kernel that kept
# its accumulator in bf16 would give; the limits above must refuse it
CONTROL_DEPTH = 16
# the least time of a call: operations at the card's peak for the operand
# type or bytes at its memory rate, whichever is larger (H100 SXM data
# sheet, at 700 W).  bfloat16: the tensor cores' 989 TFLOP/s.  float32: an
# f32-accurate product on the tensor cores takes three TF32 products a term
# (3xTF32, as K1 and K2 compute it), so 495 / 3 = 165 TFLOP/s, above the
# CUDA cores' 67; a kernel that beat this bound would not be f32-accurate.
PEAK_OPS = {"float32": 165e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
SIZE = {"float32": 4, "bfloat16": 2}
REQUESTS = [
    ("is it sunny ?", "a park photo", []),
    ("what color is it ?", "w101 w202 w303", [("is there a dog ?", "yes")]),
    ("w017 w018 ?", "w005 w006 w007", [("w001 ?", "w002"), ("w003", "w004")]),
    ("how many people are there ?", "a street",
     [("is it day ?", "yes"), ("is it busy ?", "no"), ("any cars ?", "2")]),
    ("w400 w401 w402 ?", "", [("w403", "w404 w405")] * 4),
    ("can you see the sky ?", "a man on a horse",
     [("is the man old ?", "no"), ("is he wearing a hat ?", "yes , a red one")]),
    ("w600 ?", "w601 w602", [("w603 ?", "w604")] * 9),
    ("what is he holding ?", "w010 w020 w030 w040", [("w050 ?", "w060")] * 12),
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lstm_case(gen, N, T, E, H):
    """w, b, x, mask, h0, c0 on the CPU: mixed right- and left-aligned rows,
    an eighth of them all-pad."""
    w = torch.empty(E + H, 4 * H).uniform_(-0.08, 0.08, generator=gen)
    b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=gen)
    x = torch.randn(N, T, E, generator=gen) * 0.5
    lens = torch.randint(0, T + 1, (N,), generator=gen)
    lens[: max(N // 8, 1)] = 0                     # all-pad rows
    steps = torch.arange(T)
    right = steps[None] >= (T - lens)[:, None]     # right-aligned rows
    left = steps[None] < lens[:, None]             # left-aligned rows
    mask = torch.where((torch.arange(N) % 2 == 0)[:, None], right, left)
    h0 = torch.randn(N, H, generator=gen) * 0.5
    c0 = torch.randn(N, H, generator=gen) * 0.5
    return w, b, x, mask.float(), h0, c0


def abs_err(got, want) -> float:
    """max |got - want| over a sequence of tensor pairs."""
    return max(float((g.float() - r.float()).abs().max())
               for g, r in zip(got, want))


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over a sequence of tensor pairs."""
    return max(float((g.float() - r.float()).abs().max())
               / max(float(r.float().abs().max()), 1e-30)
               for g, r in zip(got, want))


def bound(ops: float, nbytes: float, dtype: str) -> dict:
    """bound_ms and what bounds it, for `ops` operations on `dtype`
    operands that must move `nbytes` bytes (each input read once, each
    output written once)."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lstm_bound(mask, N, T, E, H, dtype, save_cell=False, backward=False):
    """K1 (K2 with backward): the gate products of the real steps only (the
    kernels skip a row tile's all-pad steps; a pad step carries its state),
    plus K2's dh product; the bytes of x, mask, W, b, the states and the
    outputs."""
    real = float(mask.sum())
    G, sz = 4 * H, SIZE[dtype]
    if backward:
        ops = real * (2 * (E + H) * G + 2 * G * H)
        nbytes = sz * (N * T * (E + 3 * H) + N * T * G) + 4 * (
            (E + H) * G + G + N * T + 4 * N * H)
    else:
        ops = real * 2 * (E + H) * G
        nbytes = sz * N * T * (E + H * (2 if save_cell else 1)) + 4 * (
            (E + H) * G + G + N * T + 4 * N * H)
    return bound(ops, nbytes, dtype)


def attention_bound(B, R, S, H, dtype, fusion=False):
    """K3 (K4 with fusion): scores and the weighted sum over S slots, plus
    K4's (2H, H) fusion product; the bytes of q, slots, valid, out (and
    K4's Wf and bias)."""
    sz = SIZE[dtype]
    ops = 4 * B * R * S * H + (4 * B * R * H * H if fusion else 0)
    nbytes = sz * (2 * B * R * H + B * S * H) + 4 * B * R * S + (
        4 * (2 * H * H + H) if fusion else 0)
    return bound(ops, nbytes, dtype)


def lm_bound(NT, H, V, dtype, dlogits=False):
    """K5 (K6 with dlogits): the (NT, H) x (H, V) logits product; the bytes
    of x, W, b, tgt and the outputs (K5's logp and lse, K6's lse and g in
    and its (NT, V) d-logits out)."""
    sz = SIZE[dtype]
    nbytes = sz * NT * H + 4 * (H * V + V + NT) + (
        8 * NT + sz * NT * V if dlogits else 8 * NT)
    return bound(2 * NT * H * V, nbytes, dtype)


def tf32_control(fn, args, want, err_fn, limit: float, kernel: str,
                 shape) -> float:
    """The planted control: fn (a plain version) run once with single-pass
    TF32 matmuls, as a kernel that rounded its f32 products to TF32 would
    compute; its error against the full-f32 reference must exceed the f32
    limit.  allow_tf32 is restored to False afterwards."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err = err_fn(got, want)
    emit({"phase": "tf32_control", "kernel": kernel, "shape": list(shape),
          "err": err, "limit": limit, "over_limit": err > limit})
    check(err > limit, f"{kernel} {shape}: the single-pass TF32 control passes "
          f"the f32 limit ({err} <= {limit})")
    return err


def _demangle(names: list[str]) -> dict:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def lstm_kernel_report() -> list[dict]:
    """For each K1 / K2 kernel: registers, shared memory and spills, as
    ptxas -v wrote them into the build's nvcc.log (the dynamic shared memory
    from the tile configuration in its template arguments, as
    common.cuh::TileSmem sizes it), and the count of tensor-core
    instructions (HGMMA, HMMA) in its SASS, by cuobjdump -sass.  Each
    kernel's SASS must hold HGMMA where cuobjdump can tell."""
    from visdial_tpu_torch.ops import _build

    lib = _build.library_path()
    with open(os.path.join(os.path.dirname(lib), "nvcc.log")) as f:
        log = f.read()
    res, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"(\w+)", ln)
        if m:
            cur = m.group(1)
            res.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if cur and m:
            res[cur].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            s = re.search(r"(\d+) bytes smem", ln)
            res[cur].update(registers=int(m[1]), static_smem=int(s[1]) if s else 0)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass, why = {}, None
    if os.path.exists(tool):
        proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, timeout=300)
        cur = None
        for ln in proc.stdout.splitlines():
            m = re.match(r"\s*Function : (\S+)", ln)
            if m:
                cur = m.group(1)
                sass[cur] = {"hgmma": 0, "hmma": 0}
            elif cur and "HGMMA" in ln:
                sass[cur]["hgmma"] += 1
            elif cur and "HMMA" in ln:
                sass[cur]["hmma"] += 1
        if proc.returncode != 0 or not sass:
            why = f"cuobjdump -sass exited {proc.returncode}: {proc.stderr[-300:]}"
    else:
        why = "no cuobjdump in the CUDA toolkit"
    names = sorted(n for n in res if "lstm_" in n)
    plain = _demangle(names)
    rows = []
    for n in names:
        row = {"phase": "kernel_resources", "kernel": plain[n], **res[n]}
        m = re.search(r"<(float|__nv_bfloat16), (\d+), (\d+), (\d+)>", plain[n])
        if m:
            f32, bm, bn, stages = m[1] == "float", int(m[2]), int(m[3]), int(m[4])
            ring = (stages + (2 if f32 else 0)) * (bm + bn) * 128
            row["dynamic_smem"] = max(ring, bm * (bn + 8) * 4) + 1024
        if why:
            row["tensor_core_sass"] = f"not known: {why}"
        else:
            check(n in sass, f"{plain[n]} not in cuobjdump's SASS")
            row.update(sass[n])
            check(sass[n]["hgmma"] > 0, f"{plain[n]}: no HGMMA in its SASS")
        emit(row)
        rows.append(row)
    check(len(rows) >= 6, f"ptxas reported {len(rows)} K1/K2 kernels")
    return rows


def lstm_checks(dev, gen) -> list[dict]:
    from visdial_tpu_torch.ops.lstm import lstm_layer_plain
    from visdial_tpu_torch.ops.lstm_cuda import lstm_layer

    rows = []
    for N, T, E, H in LSTM_SHAPES:
        w, b, x, mask, h0, c0 = lstm_case(gen, N, T, E, H)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            args = [t.to(dev) for t in (w, b, x.to(dt), mask, h0, c0)]
            got = lstm_layer(*args)
            torch.cuda.synchronize()
            want = lstm_layer_plain(*args)
            torch.cuda.synchronize()
            err = abs_err(got, want)
            check(all(torch.isfinite(g.float()).all() for g in got),
                  f"lstm_layer non-finite at {(N, T, E, H)} {name}")
            check(err <= TOL[name], f"lstm_layer {(N, T, E, H)} {name}: "
                  f"max abs err {err} > {TOL[name]}")
            # the training forward: cs (and the rest) against the plain one
            got_cs = lstm_layer(*args, save_cell=True)
            want_cs = lstm_layer_plain(*args, save_cell=True)
            torch.cuda.synchronize()
            cs_err = abs_err(got_cs, want_cs)
            check(cs_err <= TOL[name], f"lstm_layer save_cell {(N, T, E, H)} "
                  f"{name}: max abs err {cs_err} > {TOL[name]}")
            del got_cs, want_cs
            row = {"phase": "lstm_layer", "shape": [N, T, E, H], "dtype": name,
                   "max_abs_err": err, "cs_max_abs_err": cs_err,
                   "tol": TOL[name],
                   "ms": time_ms(lambda: lstm_layer(*args)),
                   "plain_ms": time_ms(lambda: lstm_layer_plain(*args)),
                   "cs_ms": time_ms(lambda: lstm_layer(*args, save_cell=True)),
                   "cs_plain_ms": time_ms(
                       lambda: lstm_layer_plain(*args, save_cell=True)),
                   **lstm_bound(mask, N, T, E, H, name)}
            if (N, T, E, H) == LSTM_HEAD and dt == torch.float32:
                row["tf32_control_err"] = tf32_control(
                    lstm_layer_plain, args, want, abs_err, TOL[name],
                    "lstm_layer", (N, T, E, H))
            emit(row)
            rows.append(row)
    return rows


def attention_checks(dev, gen) -> list[dict]:
    from visdial_tpu_torch.ops.attention import attention_fusion_ref
    from visdial_tpu_torch.ops.attention_cuda import attention_fusion

    rows = []
    for B, R, S, H in ATTN_SHAPES:
        q = torch.randn(B, R, H, generator=gen) * 0.5
        s = torch.randn(B, S, H, generator=gen) * 0.5
        slot = torch.arange(S)
        valid = (slot[None, :] <= torch.arange(R)[:, None]).float()
        valid = valid[None].expand(B, R, S).contiguous()    # causal
        fw = torch.empty(2 * H, H).uniform_(-0.08, 0.08, generator=gen)
        fb = torch.empty(H).uniform_(-0.08, 0.08, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            args = [q.to(dev, dt), s.to(dev, dt), valid.to(dev), fw.to(dev),
                    fb.to(dev)]
            got = attention_fusion(*args)
            torch.cuda.synchronize()
            want = attention_fusion_ref(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()),
                  f"attention_fusion non-finite at {(B, R, S, H)} {name}")
            check(err <= TOL[name], f"attention_fusion {(B, R, S, H)} {name}: "
                  f"max abs err {err} > {TOL[name]}")
            row = {"phase": "attention_fusion", "shape": [B, R, S, H],
                   "dtype": name, "max_abs_err": err, "tol": TOL[name],
                   "ms": time_ms(lambda: attention_fusion(*args), 50),
                   "plain_ms": time_ms(
                                       lambda: attention_fusion_ref(*args), 50),
                   **attention_bound(B, R, S, H, name, fusion=True)}
            emit(row)
            rows.append(row)
    return rows


def lstm_bwd_checks(dev, gen) -> list[dict]:
    """K2 through LSTMLayerFn against autograd through the plain forward,
    and K2 alone against its plain version on the same residuals."""
    from visdial_tpu_torch.ops.lstm import lstm_layer_bwd_plain, lstm_layer_plain
    from visdial_tpu_torch.ops.lstm_cuda import (LSTMLayerFn, lstm_layer,
                                                 lstm_layer_bwd)

    rows = []
    for N, T, E, H in BWD_SHAPES:
        case = lstm_case(gen, N, T, E, H)
        g_hs = torch.randn(N, T, H, generator=gen)
        g_ht, g_ct = torch.randn(2, N, H, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            w, b, x, mask, h0, c0 = (t.to(dev) for t in case)
            x = x.to(dt)
            cot = [g_hs.to(dev, dt), g_ht.to(dev), g_ct.to(dev)]
            grads, ms = [], []
            for fn in (LSTMLayerFn.apply, lstm_layer_plain):
                ins = [t.clone().requires_grad_() for t in (w, b, x, h0, c0)]
                outs = fn(*ins[:3], mask, *ins[3:])
                grads.append(torch.autograd.grad(outs, ins, cot,
                                                 retain_graph=True))
                torch.cuda.synchronize()
                ms.append(time_ms(lambda: torch.autograd.grad(
                    outs, ins, cot, retain_graph=True), reps=5, warmup=1))
                del outs, ins
            err = rel_err(*grads)
            check(all(bool(torch.isfinite(g.float()).all()) for g in grads[0]),
                  f"LSTMLayerFn grads non-finite at {(N, T, E, H)} {name}")
            check(err <= GRAD_TOL[name], f"lstm_layer_bwd {(N, T, E, H)} {name}: "
                  f"grad rel err {err} > {GRAD_TOL[name]}")
            del grads
            # K2 alone on the forward's residuals
            hs, cs, _, _ = lstm_layer(w, b, x, mask, h0, c0, save_cell=True)
            h_prev = torch.cat([h0.to(dt)[:, None], hs[:, :-1]], dim=1)
            c_prev = torch.cat([c0.to(dt)[:, None], cs[:, :-1]], dim=1)
            args = (w, b, x, mask, h_prev, c_prev, *cot)
            k2 = lstm_layer_bwd(*args)
            k2_plain = lstm_layer_bwd_plain(*args)
            torch.cuda.synchronize()
            k2_err, k2_abs = rel_err(k2, k2_plain), abs_err(k2, k2_plain)
            check(k2_err <= GRAD_TOL[name], f"K2 {(N, T, E, H)} {name}: "
                  f"rel err {k2_err} > {GRAD_TOL[name]}")
            extra = {}
            if (N, T, E, H) == LSTM_HEAD and dt == torch.float32:
                extra["tf32_control_err"] = tf32_control(
                    lstm_layer_bwd_plain, args, k2_plain, rel_err,
                    GRAD_TOL[name], "lstm_layer_bwd", (N, T, E, H))
            del k2, k2_plain
            row = {**extra, "phase": "lstm_layer_bwd", "shape": [N, T, E, H],
                   "dtype": name, "grad_max_rel_err": err,
                   "k2_max_rel_err": k2_err, "max_abs_err": k2_abs,
                   "tol": GRAD_TOL[name],
                   "bwd_ms": ms[0], "bwd_plain_ms": ms[1],
                   "ms": time_ms(lambda: lstm_layer_bwd(*args), reps=5),
                   "plain_ms": time_ms(lambda: lstm_layer_bwd_plain(*args),
                                       reps=5),
                   **lstm_bound(mask, N, T, E, H, name, backward=True)}
            del args, hs, cs, h_prev, c_prev
            emit(row)
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


def sdpa_attention(q, s, valid):
    """K3's function as one PyTorch call, the yardstick `library_ms` (the
    port never calls it): unscaled softmax over the slots with an additive
    -1e30 mask, one head."""
    mask = torch.where(valid > 0, 0.0, -1e30).to(q.dtype)[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, None], s[:, None], s[:, None], attn_mask=mask, scale=1.0)[:, 0]


def attention_only_checks(dev, gen) -> list[dict]:
    """K3 forward against attention_plain and AttentionFn's grads against
    autograd through attention_plain (relative to the largest reference)."""
    from visdial_tpu_torch.ops.attention import attention_plain
    from visdial_tpu_torch.ops.attention_cuda import (AttentionFn,
                                                      masked_slot_attention)

    rows = []
    for B, R, S, H in ATTN3_SHAPES:
        q = torch.randn(B, R, H, generator=gen) * 0.5
        s = torch.randn(B, S, H, generator=gen) * 0.5
        slot = torch.arange(S)
        valid = (slot[None, :] <= torch.arange(R)[:, None]).float()
        valid = valid[None].expand(B, R, S).contiguous()    # causal
        if B == 4:
            valid[1, 3] = 0.0                                # all-masked rows
            valid[3, 0] = 0.0
        g = torch.randn(B, R, H, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            outs, grads = [], []
            for fn in (AttentionFn.apply, attention_plain):
                qq = q.to(dev, dt).requires_grad_()
                ss = s.to(dev, dt).requires_grad_()
                out = fn(qq, ss, valid.to(dev))
                grads.append(torch.autograd.grad(out, (qq, ss), g.to(dev, dt)))
                outs.append(out.detach())
            torch.cuda.synchronize()
            err = rel_err(outs[:1], outs[1:])
            grad_err = rel_err(*grads)
            check(bool(torch.isfinite(outs[0].float()).all()),
                  f"attention non-finite at {(B, R, S, H)} {name}")
            check(err <= TOL[name] and grad_err <= GRAD_TOL[name],
                  f"attention {(B, R, S, H)} {name}: rel err {err} (tol "
                  f"{TOL[name]}), grad rel err {grad_err} (tol {GRAD_TOL[name]})")
            args = (q.to(dev, dt), s.to(dev, dt), valid.to(dev))
            row = {"phase": "attention", "shape": [B, R, S, H], "dtype": name,
                   "max_rel_err": err, "max_abs_err": abs_err(outs[:1], outs[1:]),
                   "grad_max_rel_err": grad_err,
                   "tol": TOL[name], "grad_tol": GRAD_TOL[name],
                   "ms": time_ms(lambda: masked_slot_attention(*args), 50),
                   "plain_ms": time_ms(lambda: attention_plain(*args), 50),
                   "library_ms": time_ms(lambda: sdpa_attention(*args), 50),
                   **attention_bound(B, R, S, H, name)}
            emit(row)
            rows.append(row)
    return rows


def bf16_accum_logits(x, w, b):
    """The planted control's (NT, V) logits: products exact in f32, but the
    running sum over H rounded to bf16 after every CONTROL_DEPTH of them."""
    xf, wf = x.float(), w.to(x.dtype).float()
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.bfloat16,
                      device=x.device)
    for k in range(0, x.shape[1], CONTROL_DEPTH):
        acc = (acc.float() + xf[:, k:k + CONTROL_DEPTH]
               @ wf[k:k + CONTROL_DEPTH]).bfloat16()
    return acc.float() + b.float()


def dlogits_over_limit(got, ref, g, dtype) -> float:
    """The largest ratio of K6's per-element error to its limit (<= 1
    passes): DLOG_RTOL x |ref| in f32, one bf16 ulp of ref in bf16, plus
    DLOG_FLOOR x |g_i| / V; g = 0 rows must give exact zeros."""
    r = ref.float().abs()
    if dtype == torch.bfloat16:
        ulp = torch.exp2((torch.frexp(r).exponent - 8).float())
        lim = torch.where(r > 0, ulp, 0.0)
    else:
        lim = DLOG_RTOL * r
    lim += DLOG_FLOOR[str(dtype).split(".")[1]] * g.abs()[:, None] / r.shape[1]
    err = (got.float() - ref.float()).abs()
    return float(torch.where(err > 0, err / lim, 0.0).max())


def lm_checks(dev, gen) -> tuple[list[dict], list[dict]]:
    """K5 and K6 against their plain versions at LM_SHAPES, f32 and bf16,
    each beside the planted bf16-accumulation control, which its limit must
    refuse (at more than one row), and TokenLogprobFn's dx / dW / db against
    autograd through the plain masked NLL at the training shape."""
    from visdial_tpu_torch.ops.lm_loss import masked_nll_fused, masked_nll_ref
    from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,
                                                lm_token_logprobs_lse_plain)
    from visdial_tpu_torch.ops.lm_score_cuda import (lm_dlogits,
                                                     lm_token_logprobs_lse)

    k5, k6 = [], []
    for NT, H, V in LM_SHAPES:
        x = torch.tanh(torch.randn(NT, H, generator=gen))   # LSTM states
        w = torch.randn(H, V, generator=gen) * 0.1
        b = torch.randn(V, generator=gen) * 0.1
        tgt = torch.randint(0, V, (NT,), generator=gen)
        tgt[::4] = 0                                        # pad targets
        g = torch.randn(NT, generator=gen)
        g[tgt == 0] = 0.0                                   # as the loss gives
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            args = [x.to(dev, dt), w.to(dev), b.to(dev), tgt.to(dev)]
            got = lm_token_logprobs_lse(*args)
            want = lm_token_logprobs_lse_plain(*args)
            logits_c = bf16_accum_logits(*args[:3])
            lse_c = torch.logsumexp(logits_c, dim=-1)
            control = (logits_c.gather(1, args[3][:, None])[:, 0] - lse_c, lse_c)
            torch.cuda.synchronize()
            tol = LM_TOL * max(1.0, float(want[0].abs().max()))
            err, control_err = abs_err(got, want), abs_err(control, want)
            del control
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"lm_score non-finite at {(NT, H, V)} {name}")
            check(err <= tol, f"lm_score {(NT, H, V)} {name}: max abs err "
                  f"{err} > {tol}")
            check(NT == 1 or control_err > tol, f"lm_score {(NT, H, V)} "
                  f"{name}: the bf16-accumulation control passes ({control_err}"
                  f" <= {tol})")
            row = {"phase": "lm_score", "shape": [NT, H, V], "dtype": name,
                   "max_abs_err": err, "tol": tol, "control_err": control_err,
                   "ms": time_ms(lambda: lm_token_logprobs_lse(*args)),
                   "plain_ms": time_ms(lambda: lm_token_logprobs_lse_plain(*args)),
                   **lm_bound(NT, H, V, name)}
            emit(row)
            k5.append(row)
            lse, gd = want[1], g.to(dev)
            got = lm_dlogits(*args, lse, gd)
            ref = lm_dlogits_plain(*args, lse, gd)
            d_c = -torch.exp(logits_c - lse[:, None])
            d_c.scatter_add_(1, args[3][:, None], torch.ones_like(d_c[:, :1]))
            d_c = (gd[:, None] * d_c).to(dt)
            del logits_c
            torch.cuda.synchronize()
            err = abs_err([got], [ref])
            over = dlogits_over_limit(got, ref, gd, dt)
            control_over = dlogits_over_limit(d_c, ref, gd, dt)
            check(bool(torch.isfinite(got.float()).all()) and got.dtype == dt,
                  f"lm_dlogits non-finite or not {name} at {(NT, H, V)}")
            check(over <= 1.0, f"lm_dlogits {(NT, H, V)} {name}: an error "
                  f"{over} x its per-element limit (max abs err {err})")
            check(NT == 1 or control_over > 1.0, f"lm_dlogits {(NT, H, V)} "
                  f"{name}: the bf16-accumulation control passes ({control_over}"
                  " x the limit)")
            del got, ref, d_c
            row = {"phase": "lm_dlogits", "shape": [NT, H, V], "dtype": name,
                   "max_abs_err": err, "err_over_limit": over,
                   "control_over_limit": control_over,
                   "ms": time_ms(lambda: lm_dlogits(*args, lse, gd), reps=5),
                   "plain_ms": time_ms(lambda: lm_dlogits_plain(*args, lse, gd),
                                       reps=5),
                   **lm_bound(NT, H, V, name, dlogits=True)}
            torch.cuda.empty_cache()
            emit(row)
            k6.append(row)
    # the training loss head: 320 rows x 9 steps, ragged targets
    N, T, (_, H, V) = 320, 9, LM_SHAPES[0]
    outs = torch.tanh(torch.randn(N, T, H, generator=gen))
    w = torch.randn(H, V, generator=gen) * 0.1
    b = torch.randn(V, generator=gen) * 0.1
    tgt = torch.randint(1, V, (N, T), generator=gen)
    tgt *= torch.arange(T)[None] < torch.randint(1, T + 1, (N, 1), generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        vals, grads = [], []
        for fn in (masked_nll_fused, masked_nll_ref):
            ins = [t.to(dev).requires_grad_() for t in (outs.to(dt), w, b)]
            v = fn(*ins, tgt.to(dev))
            grads.append(torch.autograd.grad(v, ins))
            vals.append(float(v.detach()))
        err, loss_err = rel_err(*grads), abs(vals[0] - vals[1])
        check(loss_err <= LOSS_TOL * max(1.0, abs(vals[1]))
              and err <= GRAD_TOL[name], f"TokenLogprobFn {name}: loss "
              f"{vals[0]} vs {vals[1]}, grad rel err {err} > {GRAD_TOL[name]}")
        emit({"phase": "lm_head_grads", "shape": [N, T, H, V], "dtype": name,
              "loss": vals[0], "loss_err": loss_err, "grad_max_rel_err": err,
              "tol": GRAD_TOL[name]})
    return k5, k6


def _wrappers() -> dict:
    from visdial_tpu_torch.ops.attention_cuda import (attention_fusion,
                                                      masked_slot_attention)
    from visdial_tpu_torch.ops.lm_score_cuda import (lm_dlogits,
                                                     lm_token_logprobs_lse)
    from visdial_tpu_torch.ops.lstm_cuda import lstm_layer, lstm_layer_bwd

    return {"lstm_layer": lstm_layer, "lstm_layer_bwd": lstm_layer_bwd,
            "attention": masked_slot_attention,
            "attention_fusion": attention_fusion,
            "lm_score": lm_token_logprobs_lse, "lm_dlogits": lm_dlogits}


def kernel_launches() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def compare_steps(cfg, state0, batch, seed: int) -> dict:
    """One train_step and the gradients on the kernel path and the plain
    path from the same params, batch and generator seed."""
    from visdial_tpu_torch.parallel.optim import clip_by_global_norm
    from visdial_tpu_torch.parallel.train_step import (TrainState,
                                                       loss_and_grads,
                                                       train_step)
    from visdial_tpu_torch.utils.params import flatten

    out = {}
    for impl in ("cuda", "plain"):
        st = TrainState(state0.params, state0.opt,
                        torch.Generator().manual_seed(seed))
        new, m = train_step(st, batch, cfg, impl=impl)
        _, grads = loss_and_grads(state0.params, batch, cfg,
                                  torch.Generator().manual_seed(seed), impl)
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        out[impl] = (flatten(new.params), m, flatten(grads))
    (pk, mk, gk), (pp, mp, gp) = out["cuda"], out["plain"]
    loss_err = abs(float(mk["loss"]) - float(mp["loss"]))
    gnorm_err = abs(float(mk["grad_norm"]) / float(mp["grad_norm"]) - 1)
    grad_err = max(rel_err([gk[k]], [gp[k]]) for k in gp)
    # Adam's first update lr*g/(|g| + eps) moves by at most lr/eps times a
    # change of g, so the params are held to that bound, element-wise
    lr = mk["lr"]
    param_err, param_excess = 0.0, 0.0
    for k in pp:
        d = (pk[k] - pp[k]).abs()
        bound = lr / cfg.adam_eps * (gk[k] - gp[k]).abs() + 1e-6
        param_err = max(param_err, float(d.max()))
        param_excess = max(param_excess, float((d - bound).max()))
    check(bool(torch.isfinite(mk["loss"])), "train_step loss non-finite")
    check(loss_err <= LOSS_TOL and gnorm_err <= GNORM_RTOL
          and grad_err <= TRAIN_GRAD_TOL and param_excess <= 0.0,
          f"train_step kernel vs plain (dropout {cfg.dropout}): loss err "
          f"{loss_err} (tol {LOSS_TOL}), grad_norm rel err {gnorm_err} (tol "
          f"{GNORM_RTOL}), grad rel err {grad_err} (tol {TRAIN_GRAD_TOL}), "
          f"param err {param_err} exceeding its bound by {param_excess}")
    return {"loss": float(mk["loss"]), "loss_err": loss_err,
            "grad_norm": float(mk["grad_norm"]), "grad_norm_rel_err": gnorm_err,
            "grad_max_rel_err": grad_err, "param_max_abs_err": param_err}


def train(dev, decoder: str = "disc") -> dict:
    """A training path: flagship MN-QIH-<decoder> at full width, f32."""
    from visdial_tpu_torch.parallel.train_step import train_step
    from visdial_tpu_torch.profile_train import flagship_setup

    cfg, batches, state0 = flagship_setup(dev, TRAIN_STEPS, decoder=decoder)
    row = {"phase": "train" if decoder == "disc" else "gen_train",
           "model": f"mn-ques-im-hist-{decoder}", "vocab": cfg.vocab_size,
           "batch_dialogs": cfg.batch_size}
    if decoder == "disc":
        check(cfg.vocab_size == 8804 and "opt_uniq" in batches[0],
              "train batches: vocab 8,804 and the dedup layout")
        row.update({"candidate_rows": int(batches[0]["opt_uniq"].shape[0]),
                    "unique_rows": int((batches[0]["opt_uniq"] != 0).any(1).sum())})
        kernels = ("lstm_layer", "lstm_layer_bwd", "attention")
    else:
        check(cfg.vocab_size == 8804 and "ans_out" in batches[0]
              and "opt" not in batches[0], "gen train batches: vocab 8,804 and "
              "teacher-forced answers without candidates")
        row["lm_tokens"] = int(batches[0]["ans_out"].numel())
        kernels = ("lstm_layer", "lstm_layer_bwd", "attention", "lm_score",
                   "lm_dlogits")
    row["dropout0"] = compare_steps(cfg, state0, batches[0], seed=1)
    cfg = cfg.replace(dropout=0.5)
    row["dropout05"] = compare_steps(cfg, state0, batches[0], seed=2)

    def run(state, impl, n):
        times, losses = [], []
        for b in batches[:n]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(state, b, cfg, impl=impl)
            losses.append(float(m["loss"]))       # reads back: synchronises
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, statistics.median(times)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, step_ms = run(state0, "cuda", TRAIN_STEPS)
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(all(launches[k] > 0 for k in kernels),
          f"a kernel of the {row['phase']} path never launched: {launches}")
    torch.cuda.reset_peak_memory_stats(dev)
    _, plain_ms = run(state0, "plain", 5)
    rounds = cfg.batch_size * cfg.num_rounds
    row.update({"steps": TRAIN_STEPS, "dropout": cfg.dropout,
                "launches": launches, "loss_first": losses[0],
                "loss_last": losses[-1], "step_ms": step_ms,
                "rounds_per_s": rounds / step_ms * 1e3,
                "plain_step_ms": plain_ms,
                "plain_rounds_per_s": rounds / plain_ms * 1e3,
                "peak_mem_gb": peak / 2 ** 30,
                "plain_peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30})
    emit(row)
    return row


def gen_eval(dev) -> dict:
    """The gen evaluation path: evaluate_split (width-bucketed) of the
    flagship MN-QIH-gen over 48 dialogs x 10 rounds x 100 candidates, the
    kernel path against the plain path (ranks equal; this run also warms
    both paths up).  Then the rate: EVAL_REPS runs of each path, in turn,
    over EVAL_DIALOGS dialogs (full 32-dialog batches)."""
    import numpy as np

    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.models.model import model_init

    base = Config(encoder="mn-ques-im-hist", decoder="gen", dropout=0.0)
    split, vocab = make_random_split(base, num_dialogs=48, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    check(cfg.gen_eval_bucketed, "gen eval takes the bucketed path")
    params = model_init(cfg, seed=0, device=dev)
    reset_launches()
    mk, rk = evaluate_split(params, split, vocab, cfg, dev, impl="cuda",
                            return_ranks=True)
    launches = kernel_launches()
    check(all(launches[k] > 0 for k in ("lstm_layer", "attention_fusion",
                                        "lm_score")),
          f"a kernel of the gen eval path never launched: {launches}")
    check(launches["lstm_layer_bwd"] == launches["lm_dlogits"] == 0,
          f"gen eval launched a training kernel: {launches}")
    mp, rp = evaluate_split(params, split, vocab, cfg, dev, impl="plain",
                            return_ranks=True)
    check(len(rk) == 48 * cfg.num_rounds and math.isfinite(mk["mrr"]),
          f"gen eval ranked {len(rk)} rounds, mrr {mk['mrr']}")
    mismatched = int((rk != rp).sum())
    check(mismatched == 0, f"gen eval: {mismatched} ranks differ from the "
          "plain path's")
    row = {"phase": "gen_eval", "model": "mn-ques-im-hist-gen",
           "vocab": cfg.vocab_size, "dialogs": 48, "rounds": int(len(rk)),
           "candidates": cfg.num_options, "launches": launches,
           "mrr": mk["mrr"], "mean_rank": mk["mean_rank"],
           "ranks_equal": bool(np.array_equal(rk, rp))}
    split, _ = make_random_split(base, num_dialogs=EVAL_DIALOGS, seed=1)
    runs = {"cuda": [], "plain": []}
    for _ in range(EVAL_REPS):
        for impl in runs:
            runs[impl].append(evaluate_split(params, split, vocab, cfg, dev,
                                             impl=impl, return_ranks=True))
    rounds = len(runs["cuda"][0][1])
    check(rounds == EVAL_DIALOGS * cfg.num_rounds, f"gen eval timed {rounds} "
          "rounds")
    for impl, rs in runs.items():
        check(all(np.array_equal(r, rs[0][1]) for _, r in rs),
              f"gen eval ({impl}): ranks differ between repeated runs")
    # an unchecked near tie may move a rank by one; the 48-dialog run above
    # holds the ranks equal
    diff = np.abs(runs["cuda"][0][1] - runs["plain"][0][1])
    check(diff.max() <= 1 and (diff > 0).sum() <= rounds // 1000,
          f"gen eval: ranks of {int((diff > 0).sum())} of {rounds} timed "
          f"rounds differ from the plain path's, by up to {diff.max()}")
    rates = {impl: [m["evals_per_sec"] for m, _ in rs] for impl, rs in runs.items()}
    row.update({"timed_dialogs": EVAL_DIALOGS, "timed_rounds": rounds,
                "timed_reps": EVAL_REPS, "timed_rank_mismatches": int((diff > 0).sum()),
                "timed_mrr": runs["cuda"][0][0]["mrr"],
                "evals_per_sec": statistics.median(rates["cuda"]),
                "plain_evals_per_sec": statistics.median(rates["plain"]),
                "evals_per_sec_runs": rates["cuda"],
                "plain_evals_per_sec_runs": rates["plain"]})
    emit(row)
    return row


def gen_serve(dev) -> dict:
    """The gen serving path: InferenceEngine on flagship MN-QIH-gen weights
    answers REQUESTS greedily and by beam search (5); tokens equal the
    plain path's on the card."""
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.infer import InferenceEngine
    from visdial_tpu_torch.models.model import model_init

    base = Config(encoder="mn-ques-im-hist", decoder="gen", dropout=0.0)
    split, vocab = make_random_split(base, num_dialogs=8,
                                     num_unique_answers=50_000, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=0, device=dev)
    reset_launches()
    eng = InferenceEngine(params=params, cfg=cfg, data=split, vocab=vocab,
                          device=dev)
    eng.generate_answer("is it sunny ?")                         # warm-up
    answers, lat_ms = {0: [], 5: []}, {0: [], 5: []}
    for beam in (0, 5):
        for question, caption, history in REQUESTS:
            t0 = time.perf_counter()
            answers[beam].append(eng.generate_answer(question, caption, history,
                                                     beam_size=beam))
            lat_ms[beam].append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    check(launches["lstm_layer"] > 0 and launches["attention_fusion"] > 0,
          f"a kernel of the gen serving path never launched: {launches}")
    plain = InferenceEngine(params=params, cfg=cfg.replace(use_pallas=False),
                            data=split, vocab=vocab, device=dev)
    check(plain.impl == "plain" and eng.impl == "cuda", "impl routing")
    lp_err = 0.0
    for beam in (0, 5):
        for (question, caption, history), got in zip(REQUESTS, answers[beam]):
            want = plain.generate_answer(question, caption, history,
                                         beam_size=beam)
            # decoded words carry no spaces: equal answers, equal tokens
            check(got["answer"] == want["answer"], f"gen answer (beam {beam}) "
                  f"differs from the plain path's: {got} vs {want}")
            check(math.isfinite(got["log_prob"]),
                  f"non-finite log-prob {got['log_prob']}")
            lp_err = max(lp_err, abs(got["log_prob"] - want["log_prob"]))
    check(lp_err <= SCORE_TOL, f"gen log-prob err {lp_err} > {SCORE_TOL}")
    row = {"phase": "gen_serve", "model": "mn-ques-im-hist-gen",
           "vocab": cfg.vocab_size, "requests": len(REQUESTS),
           "launches": launches, "log_prob_max_abs_err": lp_err}
    for beam, name in ((0, "greedy"), (5, "beam5")):
        lat = sorted(lat_ms[beam])
        row[name] = {"p50_ms": lat[len(lat) // 2], "max_ms": lat[-1],
                     "answer0": answers[beam][0]["answer"],
                     "log_prob0": answers[beam][0]["log_prob"]}
    emit(row)
    return row


def read_jsonl(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def train_cli() -> dict:
    """Train 4 steps through the CLI (eval and checkpoints on the way), then
    resume to step 6."""
    save = os.path.join(ROOT, "build", "visdial_tpu_torch", "smoke_train")
    shutil.rmtree(save, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "visdial_tpu_torch.train", "--synthetic", "64",
            "--encoder", "mn-ques-im-hist", "--decoder", "disc",
            "--eval_every", "4", "--save_every", "2", "--log_every", "1",
            "--save_path", save, "--run_name", "smoke"]
    runs = []
    for extra in (["--max_steps", "4"], ["--max_steps", "6", "--resume"]):
        proc = subprocess.run(base + extra, capture_output=True, text=True,
                              timeout=600, cwd=ROOT, env=env)
        check(proc.returncode == 0, f"train CLI {extra} exited "
              f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        runs.append(read_jsonl(proc.stdout))
    first, second = runs
    kinds = {e["event"] for e in first}
    check({"config", "train", "eval", "checkpoint", "done"} <= kinds,
          f"train CLI events: {sorted(kinds)}")
    evals = [e for e in first if e["event"] == "eval"]
    check(len(evals) == 1 and math.isfinite(evals[0]["mrr"])
          and evals[0]["step"] == 4, f"train CLI eval: {evals}")
    check([e["step"] for e in first if e["event"] == "checkpoint"] == [2, 4],
          "train CLI checkpoints at steps 2 and 4")
    check(first[-1]["event"] == "done" and first[-1]["step"] == 4,
          f"train CLI done: {first[-1]}")
    resumed = [e for e in second if e["event"] == "resumed"]
    steps = [e["step"] for e in second if e["event"] == "train"]
    check(len(resumed) == 1 and resumed[0]["from"].endswith("step_00000004")
          and steps == [5, 6] and second[-1]["event"] == "done"
          and second[-1]["step"] == 6,
          f"train CLI resume: {resumed} train steps {steps}")
    # gen: 2 steps with an eval at the end
    gen = [a if a != "disc" else "gen" for a in base]
    gen[gen.index("smoke")] = "smoke_gen"
    proc = subprocess.run(gen + ["--max_steps", "2", "--eval_every", "2"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env=env)
    check(proc.returncode == 0, f"gen train CLI exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    gen_events = read_jsonl(proc.stdout)
    gen_evals = [e for e in gen_events if e["event"] == "eval"]
    check(len(gen_evals) == 1 and gen_evals[0]["step"] == 2
          and math.isfinite(gen_evals[0]["mrr"])
          and gen_events[-1]["event"] == "done",
          f"gen train CLI: {gen_evals} {gen_events[-1:]}")
    row = {"phase": "train_cli", "losses": [e["loss"] for e in first + second
                                            if e["event"] == "train"],
           "mrr": evals[0]["mrr"], "resumed_from": 4,
           "final_step": second[-1]["step"], "final_mrr": second[-1]["final_mrr"],
           "gen_losses": [e["loss"] for e in gen_events if e["event"] == "train"],
           "gen_mrr": gen_evals[0]["mrr"]}
    emit(row)
    return row


def serve(dev) -> dict:
    """The main path: flagship MN-QIH-disc served over a 50k-answer pool."""
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.infer import InferenceEngine
    from visdial_tpu_torch.models.model import model_init

    base = Config(encoder="mn-ques-im-hist", decoder="disc", dropout=0.0)
    split, vocab = make_random_split(base, num_dialogs=8,
                                     num_unique_answers=50_000, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=0, device=dev)

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = InferenceEngine(params=params, cfg=cfg, data=split, vocab=vocab,
                          device=dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    answers, lat_ms = [], []
    eng.rank_answers("is it sunny ?")                            # warm-up
    for question, caption, history in REQUESTS:
        t0 = time.perf_counter()
        answers.append(eng.rank_answers(question, caption, history, top_k=5))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    check(launches["lstm_layer"] > 0 and launches["attention_fusion"] > 0,
          f"a kernel of the serving path never launched: {launches}")
    check(launches["lstm_layer_bwd"] == launches["attention"] == 0,
          f"serving launched a training kernel: {launches}")

    # the same requests through the plain versions on the same card
    plain = InferenceEngine(params=params, cfg=cfg.replace(use_pallas=False),
                            data=split, vocab=vocab, device=dev)
    check(plain.impl == "plain" and eng.impl == "cuda", "impl routing")
    check(tuple(eng.table.shape) == (50_000, cfg.rnn_hidden_size)
          and bool(torch.isfinite(eng.table).all()), "answer table shape/finite")
    table_err = float((eng.table - plain.table).abs().max())
    check(table_err <= TOL["float32"], f"answer table err {table_err}")
    score_err, near_ties = 0.0, 0
    for (question, caption, history), got in zip(REQUESTS, answers):
        s_k = eng.pool_scores(question, caption, history)
        s_p = plain.pool_scores(question, caption, history)
        check(bool(torch.isfinite(s_k).all()), "non-finite served scores")
        score_err = max(score_err, float((s_k - s_p).abs().max()))
        top_k = torch.topk(s_k, 5).indices.tolist()
        top_p = torch.topk(s_p, 5).indices.tolist()
        check([a["answer"] for a in got]
              == [" ".join(vocab.decode(split.opt_list[i])) for i in top_k],
              "rank_answers disagrees with its own pool scores")
        for i, j in zip(top_k, top_p):
            if i != j:   # allowed only where the plain scores tie within tol
                near_ties += 1
                check(abs(float(s_p[i] - s_p[j])) <= SCORE_TOL,
                      f"top-k differs from the plain run: {top_k} vs {top_p}")
    check(score_err <= SCORE_TOL, f"served score err {score_err} > {SCORE_TOL}")
    lat_ms.sort()
    row = {"phase": "serve", "model": "mn-ques-im-hist-disc",
           "vocab": cfg.vocab_size, "pool": int(split.opt_list.shape[0]),
           "requests": len(REQUESTS), "launches": launches,
           "table_build_s": table_s, "p50_ms": lat_ms[len(lat_ms) // 2],
           "max_ms": lat_ms[-1], "table_max_abs_err": table_err,
           "score_max_abs_err": score_err, "score_tol": SCORE_TOL,
           "topk_near_ties": near_ties, "top1": answers[0][0]["answer"]}
    emit(row)
    return {"row": row, "params": params, "cfg": cfg}


def serve_cli(params, cfg) -> dict:
    """Write a checkpoint with the port's writer and drive the CLI on it."""
    from visdial_tpu_torch.utils.checkpoint import save_checkpoint

    path = save_checkpoint(os.path.join(ROOT, "build", "visdial_tpu_torch",
                                        "smoke_ckpt"), params, cfg)
    queries = [{"question": "is it sunny ?", "caption": "a park",
                "history": [["is there a dog ?", "yes"]]},
               {"question": "what color is the car ?"}]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "visdial_tpu_torch.infer", "--load_path", path,
         "--synthetic", "8", "--top_k", "5"],
        input="".join(json.dumps(q) + "\n" for q in queries),
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    check(proc.returncode == 0, f"infer CLI exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    check(len(lines) == 3 and lines[0].get("event") == "ready",
          f"infer CLI output: {proc.stdout[-2000:]}")
    check(all(len(ln.get("answers", [])) == 5 for ln in lines[1:]),
          f"infer CLI answers: {lines[1:]}")
    row = {"phase": "serve_cli", "answer_lines": len(lines) - 1,
           "top1": [ln["answers"][0]["answer"] for ln in lines[1:]]}
    emit(row)
    return row


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "check runs on a GPU only")
    sys.path.insert(0, ROOT)
    from visdial_tpu_torch.ops import _build

    # f32 references must be full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "allow_tf32": False})

    lstm_kernel_report()
    gen = torch.Generator().manual_seed(0)
    k5, k6 = lm_checks(dev, gen)
    k1 = lstm_checks(dev, gen)
    k2 = lstm_bwd_checks(dev, gen)
    k3 = attention_only_checks(dev, gen)
    k4 = attention_checks(dev, gen)
    served = serve(dev)
    serve_cli(served["params"], served["cfg"])
    del served["params"]
    trained = train(dev)
    gen_trained = train(dev, "gen")
    gen_evaluated = gen_eval(dev)
    gen_served = gen_serve(dev)
    train_cli()

    # launches: each kernel's count from the run of the main path it is
    # listed under (training for K1-K3, serving for K4, gen training for K5
    # and K6), and from every path's run in launches_by_path
    by_path = {"serve": served["row"]["launches"], "train": trained["launches"],
               "gen_train": gen_trained["launches"],
               "gen_eval": gen_evaluated["launches"],
               "gen_serve": gen_served["launches"]}

    def summary(rows, head_shape, path, **fixed):
        head = next(r for r in rows if r["shape"] == head_shape
                    and r["dtype"] == "float32")
        return {**fixed, "route": "cuda",
                "launches": by_path[path][fixed["name"]],
                "launches_by_path": {p: n[fixed["name"]] for p, n in by_path.items()},
                "max_abs_err": max(r["max_abs_err"] for r in rows
                                   if r["dtype"] == "float32"),
                "max_abs_err_bf16": max(r["max_abs_err"] for r in rows
                                        if r["dtype"] == "bfloat16"),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head.get("library_ms"),
                "shape": head_shape, "dtype": "float32"}

    print(smi, flush=True)
    emit({"kernels": [
        summary(k1, [32000, 8, 300, 512], "train", name="lstm_layer",
                source="visdial_tpu_torch/csrc/lstm_fwd.cu",
                replaces="visdial_tpu/ops/lstm_pallas.py:99"),
        summary(k2, [32000, 8, 300, 512], "train", name="lstm_layer_bwd",
                source="visdial_tpu_torch/csrc/lstm_bwd.cu",
                replaces="visdial_tpu/ops/lstm_pallas.py:305"),
        summary(k3, [32, 10, 10, 512], "train", name="attention",
                source="visdial_tpu_torch/csrc/attention_fusion.cu",
                replaces="visdial_tpu/ops/attention_pallas.py:24"),
        summary(k4, [1, 10, 10, 512], "serve", name="attention_fusion",
                source="visdial_tpu_torch/csrc/attention_fusion.cu",
                replaces="visdial_tpu/ops/attention_pallas.py:115"),
        summary(k5, [2880, 512, 8804], "gen_train", name="lm_score",
                source="visdial_tpu_torch/csrc/lm_score.cu",
                replaces="visdial_tpu/ops/lm_score_pallas.py:37"),
        summary(k6, [2880, 512, 8804], "gen_train", name="lm_dlogits",
                source="visdial_tpu_torch/csrc/lm_score.cu",
                replaces="visdial_tpu/ops/lm_score_pallas.py:161"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
