#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (visdial_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and holds each against its plain
PyTorch version on the card at the shapes the serving and training paths
give it: K1 (LSTM forward, with and without cell states), K2 (LSTM
backward, through LSTMLayerFn), K3 (slot attention, through AttentionFn)
and K4 (attention + fusion).  Then it drives both main paths of the
flagship MN-QIH-disc model (random weights from a seed, full width):
serving over a 50,000-answer pool through InferenceEngine and the
JSON-lines CLI, and training through train_step (kernel path against the
plain path at dropout 0 and 0.5, then 20 steps) and the train CLI with a
resume.  Each path must have gone through its kernels and agree with a run
of the plain versions on the same card.

Each phase prints one JSON line.  Then come the raw nvidia-smi line (card
name, power limit), the kernel summary line, and, last, the result line
{"ok": true, "device": {...}}.  Any failed check raises, and the exit code
is non-zero.  Without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
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
               (32000, 8, 300, 512), (32000, 8, 512, 512)]   # N, T, E, H
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
                       lambda: lstm_layer_plain(*args, save_cell=True))}
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
                                       lambda: attention_fusion_ref(*args), 50)}
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
            del k2, k2_plain
            row = {"phase": "lstm_layer_bwd", "shape": [N, T, E, H],
                   "dtype": name, "grad_max_rel_err": err,
                   "k2_max_rel_err": k2_err, "max_abs_err": k2_abs,
                   "tol": GRAD_TOL[name],
                   "bwd_ms": ms[0], "bwd_plain_ms": ms[1],
                   "ms": time_ms(lambda: lstm_layer_bwd(*args), reps=5),
                   "plain_ms": time_ms(lambda: lstm_layer_bwd_plain(*args),
                                       reps=5)}
            del args, hs, cs, h_prev, c_prev
            emit(row)
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


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
                   "plain_ms": time_ms(lambda: attention_plain(*args), 50)}
            emit(row)
            rows.append(row)
    return rows


def kernel_launches() -> dict:
    from visdial_tpu_torch.ops.attention_cuda import (attention_fusion,
                                                      masked_slot_attention)
    from visdial_tpu_torch.ops.lstm_cuda import lstm_layer, lstm_layer_bwd

    return {"lstm_layer": lstm_layer.launches,
            "lstm_layer_bwd": lstm_layer_bwd.launches,
            "attention": masked_slot_attention.launches,
            "attention_fusion": attention_fusion.launches}


def reset_launches() -> None:
    from visdial_tpu_torch.ops.attention_cuda import (attention_fusion,
                                                      masked_slot_attention)
    from visdial_tpu_torch.ops.lstm_cuda import lstm_layer, lstm_layer_bwd

    lstm_layer.launches = lstm_layer_bwd.launches = 0
    masked_slot_attention.launches = attention_fusion.launches = 0


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


def train(dev) -> dict:
    """The training path: flagship MN-QIH-disc at full width, f32."""
    from visdial_tpu_torch.parallel.train_step import train_step
    from visdial_tpu_torch.profile_train import flagship_setup

    cfg, batches, state0 = flagship_setup(dev, TRAIN_STEPS)
    check(cfg.vocab_size == 8804 and "opt_uniq" in batches[0],
          "train batches: vocab 8,804 and the dedup layout")
    row = {"phase": "train", "model": "mn-ques-im-hist-disc",
           "vocab": cfg.vocab_size, "batch_dialogs": cfg.batch_size,
           "candidate_rows": int(batches[0]["opt_uniq"].shape[0]),
           "unique_rows": int((batches[0]["opt_uniq"] != 0).any(1).sum())}
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
    check(all(launches[k] > 0 for k in ("lstm_layer", "lstm_layer_bwd",
                                        "attention")),
          f"a kernel of the training path never launched: {launches}")
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
    row = {"phase": "train_cli", "losses": [e["loss"] for e in first + second
                                            if e["event"] == "train"],
           "mrr": evals[0]["mrr"], "resumed_from": 4,
           "final_step": second[-1]["step"], "final_mrr": second[-1]["final_mrr"]}
    emit(row)
    return row


def serve(dev) -> dict:
    """The main path: flagship MN-QIH-disc served over a 50k-answer pool."""
    from visdial_tpu.config import Config
    from visdial_tpu.data.synthetic import make_random_split
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

    gen = torch.Generator().manual_seed(0)
    k1 = lstm_checks(dev, gen)
    k2 = lstm_bwd_checks(dev, gen)
    k3 = attention_only_checks(dev, gen)
    k4 = attention_checks(dev, gen)
    served = serve(dev)
    serve_cli(served["params"], served["cfg"])
    del served["params"]
    trained = train(dev)
    train_cli()

    # launches: each kernel's count from the run of the main path it
    # belongs to (training for K1-K3, serving for K4), both listed
    by_path = {"serve": served["row"]["launches"], "train": trained["launches"]}

    def summary(rows, head_shape, path, **fixed):
        head = next(r for r in rows if r["shape"] == head_shape
                    and r["dtype"] == "float32")
        return {**fixed, "route": "cuda",
                "launches": by_path[path][fixed["name"]],
                "launches_by_path": {p: n[fixed["name"]] for p, n in by_path.items()
                                     if fixed["name"] in n},
                "max_abs_err": max(r["max_abs_err"] for r in rows
                                   if r["dtype"] == "float32"),
                "max_abs_err_bf16": max(r["max_abs_err"] for r in rows
                                        if r["dtype"] == "bfloat16"),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
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
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
