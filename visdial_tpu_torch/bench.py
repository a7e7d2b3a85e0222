"""Benchmark of the port on one GPU (port of the root bench.py): train,
eval and serving throughput against the Torch-CPU baseline.

Prints ONE JSON line on stdout, with the JAX bench's keys:
    {"metric": "train_rounds_per_sec_per_chip", "value": N,
     "unit": "rounds/s/chip", "vs_baseline": N, ...extra keys...}

    python -m visdial_tpu_torch.bench                          # MN-QIH-disc, bf16
    python -m visdial_tpu_torch.bench --compute_dtype float32 --no_gen \
        --no_dedup --no_realistic                              # f32 ablation
    python -m visdial_tpu_torch.bench --device cpu ...         # plain versions

The headline is dialog rounds/s on one card training MN-QIH-disc at the full
VisDial shapes (vocab 8,848, batch 32 dialogs x 10 rounds, 100 candidates),
bf16 by default.  The gate comes first: visdial_tpu_torch.verify's flagship
checks (every kernel against its plain version on this card); a failed gate
prints the gate block alone and exits 1.  Then, in the JAX bench's order:
training (8 steps a dispatch, one CUDA graph, through
parallel/train_step.py::make_multistep_train_fn, as the JAX bench's one
jitted lax.scan), the direct and option-table evals through the eval
factories (make_eval_fn, make_disc_table_eval_fns), evaluate_split
streaming and resident for both decoders with the factories passed (each
one CUDA graph a batch, or a batch graph replayed per batch), serving
latency through
InferenceEngine, the gen decoder's rows at batch 64, the candidate-dedup
rows over TrainLoader batches and the realistic-lengths block.  Per chip
means per card; the bench runs on one.

`train_mfu` divides the achieved operations by the card's dense peak for
the compute dtype (PEAK_FLOPS).  The operations are counted, not modelled:
torch.utils.flop_counter over one train step of the plain path in float32
on the same batch (the kernels are ctypes launches the counter cannot see,
and the count does not depend on the dtype).  It counts the matmuls only,
so it sits below XLA's count of the same step, which the JAX bench uses.

`vs_baseline` is the speedup over the same model's step in PyTorch on this
host's CPU (the JAX bench's twin).  The JAX bench's cache,
bench_baseline_torch.json at the repository's root, is read and never
written; a host it does not match measures anew (up to 240 s) and caches
under build/visdial_tpu_torch/.  Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from itertools import islice

import numpy as np
import torch

from .config import Config
from .data.loader import TrainLoader
from .data.synthetic import make_random_split, random_batch, zipf_redraw_options
from .eval_harness import evaluate_split
from .infer import InferenceEngine
from .models.model import batch_to_device, model_init
from .ops import kernel_wrappers
from .parallel.train_step import (init_train_state, make_disc_table_eval_fns,
                                  make_eval_fn, make_gen_bucket_eval_fns,
                                  make_multistep_train_fn, train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX bench's cache (read only) and the port's own
BASELINE_CACHE = os.path.join(REPO, "bench_baseline_torch.json")
BASELINE_BUILD_CACHE = os.path.join(REPO, "build", "visdial_tpu_torch",
                                    "bench_baseline_torch.json")

# Per-card dense peak FLOP/s by device-name prefix (NVIDIA's data sheet,
# H100 SXM): bf16 on the tensor cores; float32 at the 3xTF32 rate (495 / 3)
# that K1, K2, K5 and K6 use for f32 operands.
PEAK_FLOPS = {
    "NVIDIA H100": {"bfloat16": 989e12, "float32": 165e12},
}

TRAIN_DISPATCH_GROUP = 8   # steps per dispatch (train.py --steps_per_dispatch)
# the JAX bench's split sizes
TABLE_ROWS = 100_000       # disc option table: ~unique answers in a v0.9 split
DEDUP_ANSWERS = 100_000
HARNESS_DIALOGS = 512
HARNESS_ANSWERS = 50_000
SERVING_DIALOGS = 8
SERVING_ANSWERS = 50_000
# gen's committed operating point: at batch 32 its step moves 320 LSTM rows
# a time step
GEN_BATCH = 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def median_rate(window, n: int = 3) -> float:
    """Median of n timed measurement windows (each returns units/second):
    one window that meets a host stall does not move the number."""
    return statistics.median(window() for _ in range(n))


def flagship_config(encoder: str = "mn-ques-im-hist", decoder: str = "disc",
                    batch_size: int = 32, compute_dtype: str = "bfloat16",
                    img_spatial: bool = False) -> Config:
    kw = {}
    if img_spatial:
        # the flattened 7x7 pool5 map, attended with the question state
        kw = dict(img_spatial=True, img_feat_size=49 * 512)
    return Config(encoder=encoder, decoder=decoder, vocab_size=8848,
                  batch_size=batch_size, dropout=0.5,
                  compute_dtype=compute_dtype, **kw)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read(t: torch.Tensor) -> float:
    """One element to the host: waits for the work that made t."""
    return float(t.reshape(-1)[-1])


def kernel_launches() -> dict:
    """Each hand-written kernel's launch count so far in this process."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def power_limit_w(device: torch.device) -> float | None:
    """The card's power limit from nvidia-smi; None off the card or where
    nvidia-smi does not answer."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as e:
        log(f"[bench] power limit not read ({type(e).__name__}: {e})")
        return None


def device_info(device: torch.device) -> dict:
    return {"backend": device.type,
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "n_chips": 1,
            "power_limit_w": power_limit_w(device),
            "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32)}


def peak_flops(device: torch.device, compute_dtype: str) -> float | None:
    """The card's dense peak for compute_dtype; None for any other device
    (then the line has no *_mfu key, as the JAX bench's for an unknown
    kind)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, peaks in PEAK_FLOPS.items():
        if name.startswith(prefix):
            return peaks.get(compute_dtype)
    return None


def step_flops(cfg: Config, batch: dict) -> float:
    """Operations of one train step on `batch`: torch's FlopCounterMode
    (matmuls, not elementwise work) over the plain path in float32 from a
    fresh state on the batch's device, so the timed state is untouched."""
    from torch.utils.flop_counter import FlopCounterMode

    ccfg = cfg.replace(use_pallas=False, compute_dtype="float32")
    device = batch["ques"].device
    state = init_train_state(ccfg, device=device)
    with FlopCounterMode(display=False) as counter:
        train_step(state, batch, ccfg)
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return float(counter.get_total_flops())


def bench_train(cfg: Config, device, steps: int = 16, warmup: int = 3,
                full_lengths: bool = True, host_batches=None) -> dict:
    """Train throughput (+ achieved TFLOP/s + MFU) for one model config,
    through the multi-step dispatch (TRAIN_DISPATCH_GROUP steps a call of
    make_multistep_train_fn, one CUDA graph, over a stack of batches moved
    to the device once).
    Returns the rows plus "_state" and "_batch" (the stack's first batch)
    for the evals."""
    if warmup < 1:
        # the first dispatch's losses are the fingerprint and the warm-up's
        # last loss its sync (bench.py:235-239 crashes without one)
        raise ValueError(f"bench_train: warmup must be >= 1, got {warmup}")
    device = torch.device(device)
    group = TRAIN_DISPATCH_GROUP
    log(f"[bench] train {cfg.encoder}-{cfg.decoder} batch={cfg.batch_size} "
        f"dtype={cfg.compute_dtype} device={device} steps_per_dispatch={group}")
    host = host_batches if host_batches is not None else [
        random_batch(cfg, seed=s, full_lengths=full_lengths)
        for s in range(group)]
    batches = batch_to_device({k: np.stack([b[k] for b in host])
                               for k in host[0]}, device)
    state = init_train_state(cfg, device=device)
    train_fn = make_multistep_train_fn(cfg)

    t0 = time.perf_counter()
    first_m = None
    for _ in range(warmup):
        state, m = train_fn(state, batches)
        first_m = first_m if first_m is not None else m
    _sync(device)
    _read(m["loss"])
    log(f"[bench] warmup {time.perf_counter() - t0:.1f}s")

    first = {k: v[0] for k, v in batches.items()}
    flops = step_flops(cfg, first)

    dispatches = max(steps // group, 2)
    steps = dispatches * group
    rounds = steps * cfg.batch_size * cfg.num_rounds

    def window():
        nonlocal state, m
        t0 = time.perf_counter()
        for _ in range(dispatches):
            state, m = train_fn(state, batches)
        _sync(device)
        _read(m["loss"])
        return rounds / (time.perf_counter() - t0)

    train_rps = median_rate(window)
    log(f"[bench] train: {steps}-step windows x3 -> median "
        f"{train_rps:.1f} rounds/s")
    out = {
        "train_rounds_per_sec": train_rps,
        "train_rounds_per_sec_per_chip": train_rps,
        # the first dispatch's losses at fixed seeds: the port's own
        # fingerprint (torch dropout streams), not comparable to JAX's
        "loss_fingerprint": [round(float(x), 5) for x in first_m["loss"].cpu()],
        "train_flops_per_step": flops,
        "_state": state, "_batch": first,
    }
    # flops is per optimizer step; steps/s = rounds/s / rounds-per-step
    achieved = flops * train_rps / (cfg.batch_size * cfg.num_rounds)
    out["train_achieved_tflops_per_sec_per_chip"] = achieved / 1e12
    peak = peak_flops(device, cfg.compute_dtype)
    if peak:
        out["train_mfu"] = achieved / peak
        log(f"[bench] {achieved / 1e12:.1f} TFLOP/s achieved (counted) -> "
            f"MFU {achieved / peak:.3f} vs {peak / 1e12:.0f} TFLOP/s "
            f"{cfg.compute_dtype} peak")
    return out


def bench_eval(cfg: Config, params, batch: dict, steps: int = 8,
               with_table: bool = True) -> dict:
    """Ranking-eval throughput of `params` on one device batch, through the
    eval factories as the JAX bench jits them (one CUDA graph a call): the
    direct eval (make_eval_fn) and, for disc, the option table over
    TABLE_ROWS answers (make_disc_table_eval_fns' table_fn) then scoring by
    gather (its score_fn).  As the JAX bench passes its device params to
    the jitted functions, the calls pass the factories' own params copy
    (`.held`, loaded once) and score_fn reads the table where table_fn's
    graph wrote it (clone=False): a call copies only its batch in."""
    device = batch["ques"].device
    rounds = steps * cfg.batch_size * cfg.num_rounds
    out = {}
    eval_fn = make_eval_fn(cfg)
    params = eval_fn.held.load(params)
    _read(eval_fn(params, batch))

    def window():
        t0 = time.perf_counter()
        for _ in range(steps):
            s = eval_fn(params, batch)
        _read(s)
        return rounds / (time.perf_counter() - t0)

    eps = median_rate(window)
    key = ("eval_100cand_per_sec" if cfg.decoder == "disc"
           else "gen_eval_100cand_per_sec")
    log(f"[bench] {cfg.decoder} eval: {eps:.1f} 100-cand evals/s")
    out[key] = eps
    out[key + "_per_chip"] = eps
    if cfg.decoder != "disc" or not with_table:
        return out

    rng = np.random.default_rng(0)
    opt_list = torch.from_numpy(rng.integers(
        1, cfg.vocab_size - 3, size=(TABLE_ROWS, cfg.max_ans_len))).to(device)
    table_fn, score_fn = make_disc_table_eval_fns(cfg)
    params = table_fn.held.load(params)
    _read(table_fn(params, opt_list, clone=False))       # capture
    _sync(device)
    k1 = kernel_launches()["lstm_layer"]
    t0 = time.perf_counter()
    table = table_fn(params, opt_list, clone=False)
    _read(table)
    t_table = time.perf_counter() - t0
    k1 = kernel_launches()["lstm_layer"] - k1
    _read(score_fn(params, table, batch))

    def table_window():
        t0 = time.perf_counter()
        for _ in range(steps):
            s = score_fn(params, table, batch)
        _read(s)
        return rounds / (time.perf_counter() - t0)

    table_eps = median_rate(table_window)
    log(f"[bench] disc table eval: {table_eps:.1f} evals/s per batch "
        f"(+{t_table:.2f}s one-time {TABLE_ROWS}-row table, {k1} K1 "
        f"launches)")
    out["disc_table_eval_per_sec_per_chip"] = table_eps
    out["disc_table_build_seconds"] = t_table
    return out


def bench_dedup(cfg: Config, device, steps: int = 16) -> dict:
    """Disc training over TrainLoader batches of a v0.9-scale random split
    (DEDUP_ANSWERS shared answers, uniform [1, La] lengths): the expanded
    candidate rows (plain), the deduplicated ones (dedup) and the same
    under zipf(1.2) answer popularity (dedup_zipf, through
    zipf_redraw_options with the reference's tie fault).  rounds/s only:
    the counted step prices the skipped rows."""
    group = TRAIN_DISPATCH_GROUP
    split, vocab = make_random_split(cfg, num_dialogs=group * cfg.batch_size,
                                     num_unique_answers=DEDUP_ANSWERS, seed=0)
    out = {}
    for key, dedup, zipf_a in (("plain", False, None),
                               ("dedup", True, None),
                               ("dedup_zipf", True, 1.2)):
        if zipf_a is not None:
            zipf_redraw_options(split, zipf_a)
        dcfg = cfg.replace(vocab_size=vocab.size, disc_dedup_options=dedup)
        host = [b.as_dict() for b in
                islice(TrainLoader(split, vocab, dcfg).epoch(seed=0), group)]
        t = bench_train(dcfg, device, steps=steps, host_batches=host)
        out[f"disc_train_{key}_rounds_per_sec_per_chip"] = \
            t["train_rounds_per_sec_per_chip"]
        log(f"[bench] disc train ({key}, loader batches): "
            f"{t['train_rounds_per_sec']:.1f} rounds/s")
    return out


def bench_harness_e2e(cfg: Config, device, decoders=("disc", "gen")) -> dict:
    """End-to-end eval throughput through evaluate_split (loader assembly,
    host-to-device staging, scoring, ranks, metrics) over a v0.9-shaped
    random split: streaming (the median of 3 after a warm pass), then
    resident (built and warmed once, the median of 3)."""
    split, vocab = make_random_split(cfg, num_dialogs=HARNESS_DIALOGS,
                                     num_unique_answers=HARNESS_ANSWERS, seed=0)
    out = {}
    for decoder in decoders:
        dcfg = cfg.replace(decoder=decoder, vocab_size=vocab.size)
        params = model_init(dcfg, seed=dcfg.seed, device=device)
        fns = (dict(table_fns=make_disc_table_eval_fns(dcfg))
               if decoder == "disc"
               else dict(gen_fns=make_gen_bucket_eval_fns(dcfg)))
        evaluate_split(params, split, vocab, dcfg, device, **fns)  # capture
        e2e = median_rate(lambda: evaluate_split(
            params, split, vocab, dcfg, device, **fns)["evals_per_sec"])
        out[f"{decoder}_eval_e2e_per_sec_per_chip"] = e2e
        log(f"[bench] {decoder} eval end-to-end (harness): "
            f"{e2e:.0f} evals/s (median of 3 passes)")
        m2 = evaluate_split(params, split, vocab, dcfg, device,
                            resident=True, **fns)                # build + warm
        res = median_rate(lambda: evaluate_split(
            params, split, vocab, dcfg, device, resident=True,
            **fns)["evals_per_sec"])
        out[f"{decoder}_eval_resident_per_sec_per_chip"] = res
        out[f"{decoder}_eval_resident_cache_seconds"] = \
            m2["resident_cache_seconds"]
        log(f"[bench] {decoder} eval resident (warm): {res:.0f} evals/s "
            f"(one-time cache {m2['resident_cache_seconds']:.2f}s, "
            f"{m2['resident_cache_bytes'] / 1e6:.0f} MB)")
    return out


def bench_serving(cfg: Config, device, n_calls: int = 30) -> dict:
    """Serving latency through InferenceEngine, one request at a time, each
    ending in its own device-to-host read: disc ranks the whole answer
    pool (top 5), gen decodes greedily."""
    split, vocab = make_random_split(cfg, num_dialogs=SERVING_DIALOGS,
                                     num_unique_answers=SERVING_ANSWERS, seed=0)
    scfg = cfg.replace(vocab_size=vocab.size, dropout=0.0)
    eng = InferenceEngine(params=model_init(scfg, seed=scfg.seed, device=device),
                          cfg=scfg, data=split, vocab=vocab, device=device)
    hist = [("is there a dog ?", "yes"), ("what color is it ?", "red")]

    def call():
        if scfg.decoder == "disc":
            return eng.rank_answers("is it sunny ?", caption="a park photo",
                                    history=hist, top_k=5)
        return eng.generate_answer("is it sunny ?", caption="a park photo",
                                   history=hist)

    call()
    call()                              # warm
    lat = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        call()
        lat.append(time.perf_counter() - t0)
    lat.sort()
    p50 = lat[len(lat) // 2] * 1e3
    p95 = lat[int(len(lat) * 0.95)] * 1e3
    log(f"[bench] serving ({scfg.decoder}): p50 {p50:.1f} ms, "
        f"p95 {p95:.1f} ms per request ({n_calls} calls)")
    return {f"serving_{scfg.decoder}_p50_ms": round(p50, 2),
            f"serving_{scfg.decoder}_p95_ms": round(p95, 2)}


def kernel_check(args, device) -> dict:
    """The verify gate (visdial_tpu_torch.verify): every kernel against its
    plain version at flagship shapes on this card, hard tolerances.  A
    number measured behind a failing kernel means nothing, so main() exits
    1 when this block is not ok."""
    if args.no_kernel_check:
        return {}
    from .verify import run_checks

    log("[bench] kernel gate (kernels against plain, flagship shapes)")
    t0 = time.perf_counter()
    kc = run_checks("flagship", log=log, device=device)
    log(f"[bench] kernel gate {'OK' if kc['ok'] else 'FAILED'} "
        f"({time.perf_counter() - t0:.0f}s)")
    return {"kernel_check": kc}


def bench_port(args) -> dict:
    """The gate, then every row in the JAX bench's order; `args` are
    main()'s flags.  `kernel_launches` counts each kernel's launches after
    the gate."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to "
                         "run the plain versions on the CPU)")
    cfg = flagship_config(args.encoder, args.decoder, args.batch_size,
                          args.compute_dtype, img_spatial=args.img_spatial)
    kc = kernel_check(args, device)
    stats = {**device_info(device), **kc,
             "lengths": "realistic-uniform" if args.realistic_lengths else "max",
             "model": f"{cfg.encoder}-{cfg.decoder}",
             "compute_dtype": cfg.compute_dtype,
             "batch_size": cfg.batch_size}
    if kc and not kc["kernel_check"]["ok"]:
        return stats               # main() prints the gate block and exits 1
    if args.img_spatial:
        stats["img_spatial"] = True
    launched = kernel_launches()

    t = bench_train(cfg, device, steps=args.steps,
                    full_lengths=not args.realistic_lengths)
    state, batch = t.pop("_state"), t.pop("_batch")
    stats.update(t)
    stats.update(bench_eval(cfg, state.params, batch,
                            steps=max(args.steps // 2, 4)))
    del state, batch

    stats.update(bench_harness_e2e(
        cfg, device, decoders=(cfg.decoder,) if args.no_gen else ("disc", "gen")))
    stats.update(bench_serving(cfg, device))
    ride_along = cfg.decoder == "disc" and not args.no_gen
    if ride_along:
        stats.update(bench_serving(cfg.replace(decoder="gen"), device))
        # the other decoder's training and eval rows at its batch
        gcfg = cfg.replace(decoder="gen", batch_size=GEN_BATCH)
        stats["gen_batch_size"] = gcfg.batch_size
        g = bench_train(gcfg, device, steps=max(args.steps * 2, 32),
                        full_lengths=not args.realistic_lengths)
        stats["gen_train_rounds_per_sec_per_chip"] = \
            g["train_rounds_per_sec_per_chip"]
        stats["gen_loss_fingerprint"] = g["loss_fingerprint"]
        stats["gen_train_flops_per_step"] = g["train_flops_per_step"]
        if "train_mfu" in g:
            stats["gen_train_mfu"] = g["train_mfu"]
        stats.update(bench_eval(gcfg, g["_state"].params, g["_batch"], steps=4))
        del g

    if cfg.decoder == "disc" and not args.no_dedup:
        log("[bench] candidate-dedup operating point (loader batches)")
        stats.update(bench_dedup(cfg, device, steps=args.steps))

    if not args.realistic_lengths and not args.no_realistic:
        # uniform [1, max] lengths, what real VisDial data has; rounds/s
        # only: the counted step is the padded one
        log("[bench] realistic-lengths operating point")
        r = {}
        rt = bench_train(cfg, device, steps=args.steps, full_lengths=False)
        r["train_rounds_per_sec_per_chip"] = rt["train_rounds_per_sec_per_chip"]
        r.update(bench_eval(cfg, rt["_state"].params, rt["_batch"],
                            steps=max(args.steps // 2, 4), with_table=False))
        del rt
        if ride_along:
            gr = bench_train(gcfg, device, steps=max(args.steps * 2, 32),
                             full_lengths=False)
            r["gen_train_rounds_per_sec_per_chip"] = \
                gr["train_rounds_per_sec_per_chip"]
            r.update(bench_eval(gcfg, gr["_state"].params, gr["_batch"],
                                steps=4, with_table=False))
            del gr
        stats["realistic"] = r
    stats["kernel_launches"] = {k: n - launched[k]
                                for k, n in kernel_launches().items()}
    return stats


# ---------------------------------------------------------------------------
# Torch-CPU baseline twin (same model, same step, same shapes-per-round)
# ---------------------------------------------------------------------------

TORCH_BASELINE_BATCH = 8
TORCH_BASELINE_TARGET_STEPS = 16   # measured if the time budget allows
TORCH_BASELINE_MIN_STEPS = 8       # cache-validity bar


def bench_torch_cpu(batch_size: int = TORCH_BASELINE_BATCH,
                    max_seconds: float = 240.0) -> dict:
    """Rounds/sec of the MN-QIH-disc train step in PyTorch on CPU.

    Smaller batch than the card's run (CPU-sized); throughput is normalized
    per dialog round.  Returns the measurement with its shapes so the
    cached headline is self-describing, and the seconds it took."""
    import torch.nn as nn

    t_start = time.time()
    torch.manual_seed(0)
    torch.set_num_threads(os.cpu_count() or 8)
    cfg = flagship_config(batch_size=batch_size)
    V, E, H, F = cfg.vocab_size, cfg.embed_size, cfg.rnn_hidden_size, cfg.img_feat_size
    B, R, K = cfg.batch_size, cfg.num_rounds, cfg.num_options
    Lq, La, Lf = cfg.max_ques_len, cfg.max_ans_len, cfg.max_fact_len

    class MNDisc(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, E, padding_idx=0)
            self.ques_lstm = nn.LSTM(E, H, 2, batch_first=True)
            self.fact_lstm = nn.LSTM(E, H, 2, batch_first=True)
            self.opt_lstm = nn.LSTM(E, H, 2, batch_first=True)
            self.img_proj = nn.Linear(F, H)
            self.query_fusion = nn.Linear(2 * H, H)
            self.fusion = nn.Linear(2 * H, H)

        def forward(self, ques, facts, img, opt):
            q = self.ques_lstm(self.embed(ques.view(B * R, Lq)))[0][:, -1]
            f = self.fact_lstm(self.embed(facts.view(B * R, Lf)))[0][:, -1]
            f = f.view(B, R, H)
            im = self.img_proj(img).repeat_interleave(R, dim=0)
            query = torch.tanh(self.query_fusion(torch.cat([q, im], -1)))
            qr = query.view(B, R, H)
            att = torch.einsum("brh,bsh->brs", qr, f)
            valid = torch.tril(torch.ones(R, R, dtype=torch.bool))
            att = att.masked_fill(~valid, -1e30).softmax(-1)
            mem = torch.einsum("brs,bsh->brh", att, f).reshape(B * R, H)
            joint = torch.tanh(self.fusion(torch.cat([query, mem], -1)))
            o = self.opt_lstm(self.embed(opt.view(B * R * K, La)))[0][:, -1]
            return torch.einsum("nh,nkh->nk", joint, o.view(B * R, K, H))

    model = MNDisc()
    optim = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    ques = torch.randint(1, V - 3, (B, R, Lq), generator=gen)
    facts = torch.randint(1, V - 3, (B, R, Lf), generator=gen)
    img = torch.randn(B, F, generator=gen)
    opt = torch.randint(1, V - 3, (B, R, K, La), generator=gen)
    gt = torch.randint(0, K, (B * R,), generator=gen)
    loss_fn = nn.CrossEntropyLoss()

    def step():
        optim.zero_grad()
        loss = loss_fn(model(ques, facts, img, opt), gt)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 5.0)
        optim.step()

    step()  # warmup (allocator, thread pool)
    n, t0 = 0, time.time()
    while n < TORCH_BASELINE_TARGET_STEPS and time.time() - t0 < max_seconds:
        step()
        n += 1
    rps = n * B * R / (time.time() - t0)
    log(f"[torch-cpu] {n} steps at batch {B}, {rps:.2f} rounds/s "
        f"({torch.get_num_threads()} threads, {time.time() - t_start:.1f}s)")
    return {"rounds_per_sec": rps, "model": "mn-ques-im-hist-disc",
            "batch_size": B, "steps_measured": n,
            "threads": torch.get_num_threads(), "host_cpus": os.cpu_count(),
            "masked_lstm": False,  # plain nn.LSTM: favors the baseline
            "estimated": False, "seconds": time.time() - t_start}


def _cached_baseline(path: str) -> dict | None:
    """The record at `path` when it was measured on a host with this CPU
    count over enough steps, else None."""
    try:
        with open(path) as f:
            cached = json.load(f)
    except FileNotFoundError:
        return None
    if (cached.get("host_cpus") == os.cpu_count()
            and cached.get("steps_measured", 0) >= TORCH_BASELINE_MIN_STEPS
            and not cached.get("estimated", False)):
        return cached
    return None


def torch_baseline() -> dict:
    for path in (BASELINE_CACHE, BASELINE_BUILD_CACHE):
        cached = _cached_baseline(path)
        if cached is not None:
            log(f"[torch-cpu] cached baseline {cached['rounds_per_sec']:.2f} "
                f"rounds/s ({path})")
            return cached
    log("[torch-cpu] no cached baseline for this host; measuring")
    try:
        measured = bench_torch_cpu()
    except Exception as e:  # a broken baseline must not lose the card's rows
        log(f"[torch-cpu] baseline measurement failed ({e}); using an "
            "ESTIMATE — not persisted, re-measured next run")
        return {"rounds_per_sec": 5.0, "estimated": True}
    os.makedirs(os.path.dirname(BASELINE_BUILD_CACHE), exist_ok=True)
    with open(BASELINE_BUILD_CACHE, "w") as f:  # persist ONLY measurements
        json.dump(measured, f)
    return measured


def _rounded(v):
    if isinstance(v, float):
        return round(v, 4)
    if isinstance(v, dict):
        return {k: round(x, 4) if isinstance(x, float) else x
                for k, x in v.items()}
    return v


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--encoder", default="mn-ques-im-hist")
    p.add_argument("--decoder", default="disc", choices=("disc", "gen"))
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--realistic_lengths", action="store_true",
                   help="train/direct-eval batches at uniform [1, L] "
                        "sequence lengths instead of the maximum")
    p.add_argument("--no_gen", action="store_true",
                   help="skip the ride-along gen-decoder measurements")
    p.add_argument("--no_realistic", action="store_true",
                   help="skip the ride-along realistic-lengths block")
    p.add_argument("--no_dedup", action="store_true",
                   help="skip the candidate-dedup ride-along rows")
    p.add_argument("--no_kernel_check", action="store_true",
                   help="skip the kernel gate (iteration convenience; a "
                        "recorded line carries the kernel_check block)")
    p.add_argument("--img_spatial", action="store_true",
                   help="the flattened 7x7 pool5 map with per-question "
                        "attention over the 49 slots instead of fc7")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    # the f32 rows and the gate's f32 plain versions are full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    stats = bench_port(args)
    kc = stats.get("kernel_check")
    if kc is not None and not kc.get("ok"):
        # the gate failed before any row was measured: print the gate block
        # (per-check errors included) as the record and fail the run
        failed = [c["name"] for c in kc.get("checks", []) if not c["ok"]]
        result = {"metric": "train_rounds_per_sec_per_chip", "value": 0.0,
                  "unit": "rounds/s/chip", "vs_baseline": 0.0,
                  "kernel_gate_failed": failed, **stats}
        print(json.dumps(result), flush=True)
        log(f"[bench] KERNEL GATE FAILED: {failed}")
        sys.exit(1)
    baseline = torch_baseline()
    value = stats["train_rounds_per_sec_per_chip"]
    result = {
        "metric": "train_rounds_per_sec_per_chip",
        "value": round(value, 2),
        "unit": "rounds/s/chip",
        "vs_baseline": round(value / baseline["rounds_per_sec"], 2),
        "baseline_torch_cpu": {k: (round(v, 2) if isinstance(v, float) else v)
                               for k, v in baseline.items()},
        **{k: _rounded(v) for k, v in stats.items()},
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
