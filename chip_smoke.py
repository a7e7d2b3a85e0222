#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (visdial_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card at the shapes the serving path gives it, then
serves the flagship MN-QIH-disc model (random weights from a seed, full
width, 50,000-answer pool) through InferenceEngine and through the
JSON-lines CLI, and checks that the served requests went through the
kernels and agree with a run of the plain versions on the same card.

Each phase prints one JSON line.  Then come the raw nvidia-smi line (card
name, power limit), the kernel summary line, and, last, the result line
{"ok": true, "device": {...}}.  Any failed check raises, and the exit code
is non-zero.  Without a CUDA device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import os
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
SCORE_TOL = 1e-3   # served scores: 512-term dot products of f32 LSTM states
LSTM_SHAPES = [(8192, 8, 300, 512), (8192, 8, 512, 512),
               (10, 40, 300, 512), (10, 16, 300, 512)]   # N, T, E, H
ATTN_SHAPES = [(1, 10, 10, 512), (32, 10, 10, 512)]       # B, R, S, H
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


def lstm_checks(dev, gen) -> list[dict]:
    from visdial_tpu_torch.ops.lstm import lstm_layer_plain
    from visdial_tpu_torch.ops.lstm_cuda import lstm_layer

    rows = []
    for N, T, E, H in LSTM_SHAPES:
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
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            args = [t.to(dev) for t in (w, b, x.to(dt), mask.float(), h0, c0)]
            got = lstm_layer(*args)
            torch.cuda.synchronize()
            want = lstm_layer_plain(*args)
            torch.cuda.synchronize()
            err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(got, want))
            check(all(torch.isfinite(g.float()).all() for g in got),
                  f"lstm_layer non-finite at {(N, T, E, H)} {name}")
            check(err <= TOL[name], f"lstm_layer {(N, T, E, H)} {name}: "
                  f"max abs err {err} > {TOL[name]}")
            row = {"phase": "lstm_layer", "shape": [N, T, E, H], "dtype": name,
                   "max_abs_err": err, "tol": TOL[name],
                   "ms": time_ms(lambda: lstm_layer(*args)),
                   "plain_ms": time_ms(lambda: lstm_layer_plain(*args))}
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


def serve(dev) -> dict:
    """The main path: flagship MN-QIH-disc served over a 50k-answer pool."""
    from visdial_tpu.config import Config
    from visdial_tpu.data.synthetic import make_random_split
    from visdial_tpu_torch.infer import InferenceEngine
    from visdial_tpu_torch.models.model import model_init
    from visdial_tpu_torch.ops.attention_cuda import attention_fusion
    from visdial_tpu_torch.ops.lstm_cuda import lstm_layer

    base = Config(encoder="mn-ques-im-hist", decoder="disc", dropout=0.0)
    split, vocab = make_random_split(base, num_dialogs=8,
                                     num_unique_answers=50_000, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=0, device=dev)

    lstm_layer.launches = attention_fusion.launches = 0
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
    launches = {"lstm_layer": lstm_layer.launches,
                "attention_fusion": attention_fusion.launches}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the serving path never launched: {launches}")

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
    k4 = attention_checks(dev, gen)
    served = serve(dev)
    serve_cli(served["params"], served["cfg"])

    def summary(rows, head_shape, **fixed):
        head = next(r for r in rows if r["shape"] == head_shape
                    and r["dtype"] == "float32")
        return {**fixed, "route": "cuda",
                "launches": served["row"]["launches"][fixed["name"]],
                "max_abs_err": max(r["max_abs_err"] for r in rows
                                   if r["dtype"] == "float32"),
                "max_abs_err_bf16": max(r["max_abs_err"] for r in rows
                                        if r["dtype"] == "bfloat16"),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "shape": head_shape, "dtype": "float32"}

    print(smi, flush=True)
    emit({"kernels": [
        summary(k1, [8192, 8, 300, 512], name="lstm_layer",
                source="visdial_tpu_torch/csrc/lstm_fwd.cu",
                replaces="visdial_tpu/ops/lstm_pallas.py:99"),
        summary(k4, [1, 10, 10, 512], name="attention_fusion",
                source="visdial_tpu_torch/csrc/attention_fusion.cu",
                replaces="visdial_tpu/ops/attention_pallas.py:115"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
