"""On-card kernel-against-plain-version gate (port of visdial_tpu/verify.py).

Every CUDA kernel of the port (csrc/, K1-K6) has a plain PyTorch version,
and the CPU tests hold the plain versions to the JAX package.  A kernel
that builds but computes wrong on the card (a bad tile index, a clobbered
carry, a mask slip) would otherwise be caught by nothing but drifting
training.  This module runs every kernel AND its plain version at the
flagship shapes on the card and reports each check's error; a measurement
script runs it first and reports nothing for a failing kernel.

    python -m visdial_tpu_torch.verify [--scale flagship|tiny] [--include P ...]

prints one JSON line ({"ok", "backend": "cuda", "device_name", "scale",
"checks": [...]}) and exits 1 on any failure.

Checks (kernel route against plain version; value and/or gradient):
  * the masked-LSTM forward (K1) at the 32,000-row option LSTM (bf16) and
    f32 at a tenth of the rows;
  * the LSTM backward (K2 through LSTMLayerFn, the dW/dx products beside it)
    against autograd of the plain forward at 32,000 and 640 rows, f32 and
    bf16;
  * slot attention (K3) and attention + fusion (K4), f32 and bf16;
  * the LM head's log-probs and row logsumexp (K5) and d-logits (K6), f32
    and bf16;
  * one whole train-step gradient, kernel path against plain path, both
    decoders, at flagship widths with realistic lengths (the length sort
    and per-tile bounds engage), f32 and bf16;
  * the deduplicated disc-train layout (opt_uniq + gather map + all-pad
    filler rows) against the expanded layout on the same candidates, both
    through the kernels;
  * K5 and K6 on two vocab shards, combined as the model axis combines them
    (ops/lm_loss.py), against the whole-vocab kernels.

A check's error is relative to its plain side's largest |value| per leaf;
a NaN or Inf on either side, or a shape mismatch, fails the leaf, and a
check that raises fails.  The kernel routes refuse a CPU tensor
(_require_card), so on a machine without a card every check fails; the CPU
tests rehearse the gate by substituting that guard.
"""

from __future__ import annotations

import json
from typing import Callable

import numpy as np
import torch

from .config import Config
from .data.loader import dedup_option_rows
from .data.synthetic import random_batch
from .models.model import batch_to_device, model_init, model_loss
from .ops import attention_cuda, lm_score_cuda, lstm_cuda
from .ops.attention import attention_fusion_ref, attention_plain
from .ops.lm_loss import combine_shards, target_logit
from .ops.lm_score import lm_dlogits_plain, lm_token_logprobs_lse_plain
from .ops.lstm import lstm_layer_plain
from .parallel.mesh import VocabShard
from .utils.params import flatten, unflatten


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, np.float64)


def _leaf_err(got, want):
    got, want = _np(got), _np(want)
    if got.shape != want.shape:
        return float("inf"), float("inf")
    # non-finite on EITHER side fails the leaf: a NaN on the plain side
    # would otherwise make np.max return NaN, and max(0.0, nan) keeps 0.0,
    # masking real mismatches on the finite elements
    if not (np.all(np.isfinite(got)) and np.all(np.isfinite(want))):
        return float("inf"), float("inf")
    abs_err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    return abs_err, abs_err / max(scale, 1e-12)


def _leaves(tree) -> list:
    """A tree's leaves: dicts in sorted key order, lists and tuples in
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _record(name: str, got, want, rel_tol: float) -> dict:
    """Compare two trees (tensors, arrays, nested dicts / lists / tuples);
    the worst per-leaf relative error decides."""
    gl, wl = _leaves(got), _leaves(want)
    if len(gl) != len(wl):
        return {"name": name, "max_abs_err": float("inf"),
                "max_rel_err": float("inf"), "rel_tol": rel_tol, "ok": False}
    max_abs = max_rel = 0.0
    for g, w in zip(gl, wl):
        a, r = _leaf_err(g, w)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
    return {"name": name, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "rel_tol": rel_tol, "ok": bool(max_rel <= rel_tol)}


def _aggregate(checks: list[dict]) -> dict:
    return {"ok": all(c["ok"] for c in checks), "checks": checks}


# ---------------------------------------------------------------------------
# shape scales and tolerances
# ---------------------------------------------------------------------------

# flagship: the JAX gate's shapes (verify.py:100-104) -- the 32,000-row
# option LSTM (disc train batch 32 x 10 rounds x 100 candidates), the
# 640-row gen train tile, V 8,848, H 512; tiny: the CPU rehearsal
SCALES = {
    "flagship": dict(N_big=32000, N_small=640, T=9, E=300, H=512,
                     V=8848, B_att=320, R=10, NT_lm=18432, B_step=8,
                     cfg_overrides={}),
    "tiny": dict(N_big=64, N_small=16, T=5, E=12, H=16,
                 V=64, B_att=8, R=4, NT_lm=96, B_step=2,
                 cfg_overrides=dict(num_rounds=3, num_options=4,
                                    max_ques_len=5, max_ans_len=4,
                                    max_cap_len=6, img_feat_size=32,
                                    img_embed_size=16)),
}

# Relative tolerances per check family, the card's own: 5-10x the largest
# error of the family measured on an NVIDIA H100 80GB HBM3 at 700.00 W
# (nvidia-smi) at the flagship scale, TF32 off, written beside each
# (`python -m visdial_tpu_torch.verify`, the same run as chip_smoke.py's
# `verify` phase; the inputs are seeded, so a rerun measures the same).  The
# JAX values were pinned on a v5e and are not carried over.  A miscompile
# gives O(1) errors, far past these.
TOLS = {
    "lstm_fwd_f32": 5e-6,                  # 9.1e-7
    "lstm_fwd_bf16": 2e-2,                 # 2.6e-3
    "lstm_bwd_f32": 2e-5,                  # 3.0e-6 @big, 8.8e-7 @small
    "lstm_bwd_bf16": 4e-2,                 # 5.4e-3 @big, 3.1e-3 @small
    "attention_f32": 1e-5,                 # 1.7e-6
    "attention_bf16": 2e-2,                # 2.7e-3
    "attention_fusion_f32": 2e-5,          # 2.3e-6
    "attention_fusion_bf16": 3e-2,         # 4.0e-3
    "lm_logprobs_f32": 1e-6,               # 1.8e-7
    "lm_logprobs_bf16": 1.5e-6,            # 2.1e-7
    "lm_dlogits_f32": 1.5e-7,              # 1.8e-8
    "lm_dlogits_bf16": 1e-5,               # 1.2e-6
    "train_grads_disc_f32": 3e-5,          # 3.4e-6
    "train_grads_disc_bf16": 5e-2,         # 5.9e-3
    "train_grads_gen_f32": 2e-5,           # 2.5e-6
    "train_grads_gen_bf16": 6e-2,          # 8.0e-3
    "train_grads_disc_dedup_f32": 5e-5,    # 6.9e-6
    "train_grads_disc_dedup_bf16": 1e-1,   # 1.6e-2
    "lm_vocab_shards_f32": 3e-5,           # 3.6e-6
    "lm_vocab_shards_bf16": 3e-5,          # 4.0e-6
}

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _require_card(t: torch.Tensor) -> None:
    """The kernel routes run on the card only: on a CPU tensor a wrapper
    would take its plain version, and the check would compare the plain
    version with itself."""
    if t.device.type != "cuda":
        raise RuntimeError(f"verify: the kernel route needs a CUDA tensor, "
                           f"got one on {t.device}")


def _tol(name: str) -> float:
    return TOLS[name.rsplit("@", 1)[0]]


def _lengths_mask(rng, N: int, T: int):
    """Left-aligned length mask with the hard cases: full rows, short rows,
    and a few all-pad rows (the carry-through/empty-span path)."""
    lens = rng.integers(0, T + 1, size=N)
    lens[: max(N // 8, 1)] = T
    lens[N // 2: N // 2 + max(N // 16, 1)] = 0
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)


# ---------------------------------------------------------------------------
# individual checks
# ---------------------------------------------------------------------------

def _lstm_args(s, N: int, dtype, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    T, E, H = s["T"], s["E"], s["H"]
    w = _t(rng.standard_normal((E + H, 4 * H)) * 0.08, device)
    b = _t(rng.standard_normal(4 * H) * 0.05, device)
    x = _t(rng.standard_normal((N, T, E)) * 0.5, device, dtype)
    mask = _t(_lengths_mask(rng, N, T), device)
    h0 = _t(rng.standard_normal((N, H)) * 0.3, device)
    c0 = _t(rng.standard_normal((N, H)) * 0.3, device)
    return w, b, x, mask, h0, c0


def check_lstm_fwd(s, dt: str, name: str, device) -> dict:
    dtype = DTYPES[dt]
    N = s["N_big"] if dt == "bf16" else max(s["N_big"] // 10, 8)
    args = _lstm_args(s, N, dtype, device)
    _require_card(args[2])
    with torch.no_grad():
        got = lstm_cuda.lstm_layer(*args)
        want = lstm_layer_plain(*args)
    return _record(name, got, want, _tol(name))


def check_lstm_bwd(s, N: int, dt: str, name: str, device) -> dict:
    """Grads of w, b, x, h0, c0 through LSTMLayerFn (K1 saving the cell
    states, K2 and the dW/dx products) against autograd of the plain
    forward, for fixed cotangents of every output."""
    w, b, x, mask, h0, c0 = _lstm_args(s, N, DTYPES[dt], device, seed=1)
    _require_card(x)
    rng = np.random.default_rng(2)
    T, H = s["T"], s["H"]
    ghs = _t(rng.standard_normal((N, T, H)) * 0.1, device)
    ght = _t(rng.standard_normal((N, H)) * 0.1, device)
    gct = _t(rng.standard_normal((N, H)) * 0.1, device)

    def grads(fn):
        ins = [t.detach().requires_grad_() for t in (w, b, x, h0, c0)]
        hs, ht, ct = fn(ins[0], ins[1], ins[2], mask, ins[3], ins[4])
        total = ((hs.float() * ghs).sum() + (ht.float() * ght).sum()
                 + (ct.float() * gct).sum())
        return torch.autograd.grad(total, ins)

    got = grads(lstm_cuda.LSTMLayerFn.apply)
    want = grads(lstm_layer_plain)
    return _record(name, got, want, _tol(name))


def _attention_args(s, dtype, device, seed: int):
    rng = np.random.default_rng(seed)
    B, R, H = s["B_att"], s["R"], s["H"]
    q = _t(rng.standard_normal((B, R, H)) * 0.3, device, dtype)
    slots = _t(rng.standard_normal((B, R, H)) * 0.3, device, dtype)
    valid = _t(np.tril(np.ones((R, R), np.float32))[None]
               * np.ones((B, 1, 1), np.float32), device)
    return rng, q, slots, valid


def check_attention(s, dt: str, device) -> dict:
    name = f"attention_{dt}"
    _, q, slots, valid = _attention_args(s, DTYPES[dt], device, 3)
    _require_card(q)
    got = attention_cuda.masked_slot_attention(q, slots, valid)
    want = attention_plain(q, slots, valid)
    return _record(name, got, want, _tol(name))


def check_attention_fusion(s, dt: str, device) -> dict:
    name = f"attention_fusion_{dt}"
    rng, q, slots, valid = _attention_args(s, DTYPES[dt], device, 4)
    _require_card(q)
    H = s["H"]
    fw = _t(rng.standard_normal((2 * H, H)) * 0.05, device)
    fb = _t(rng.standard_normal(H) * 0.05, device)
    got = attention_cuda.attention_fusion(q, slots, valid, fw, fb)
    want = attention_fusion_ref(q, slots, valid, fw, fb)
    return _record(name, got, want, _tol(name))


def _lm_args(s, dtype, device, seed: int = 5):
    rng = np.random.default_rng(seed)
    NT, H, V = s["NT_lm"], s["H"], s["V"]
    x = _t(rng.standard_normal((NT, H)) * 0.3, device, dtype)
    w = _t(rng.standard_normal((H, V)) * 0.05, device)
    b = _t(rng.standard_normal(V) * 0.05, device)
    tgt = torch.from_numpy(rng.integers(0, V, NT)).to(device)
    return x, w, b, tgt


def check_lm_logprobs(s, dt: str, device) -> dict:
    name = f"lm_logprobs_{dt}"
    x, w, b, tgt = _lm_args(s, DTYPES[dt], device)
    _require_card(x)
    got = lm_score_cuda.lm_token_logprobs_lse(x, w, b, tgt)
    want = lm_token_logprobs_lse_plain(x, w, b, tgt)
    return _record(name, got, want, _tol(name))


def check_lm_dlogits(s, dt: str, device) -> dict:
    name = f"lm_dlogits_{dt}"
    x, w, b, tgt = _lm_args(s, DTYPES[dt], device, seed=6)
    _require_card(x)
    g = _t(np.random.default_rng(7).standard_normal(x.shape[0]) * 0.1, device)
    _, lse = lm_token_logprobs_lse_plain(x, w, b, tgt)
    got = lm_score_cuda.lm_dlogits(x, w, b, tgt, lse, g)
    want = lm_dlogits_plain(x, w, b, tgt, lse, g)
    return _record(name, got, want, _tol(name))


def check_lm_vocab_shards(s, dt: str, device, shards: int = 2) -> dict:
    """K5 and K6 on `shards` column shards of the LM head, targets re-based
    to each shard and -1 outside it, combined as the model axis combines
    them (ops/lm_loss.py: the global logsumexp of the shards', the target
    logit from its owner; K6 with the global logsumexp; dx summed), against
    the whole-vocab kernels: logp, lse, d-logits and dx."""
    name = f"lm_vocab_shards_{dt}"
    x, w, b, tgt = _lm_args(s, DTYPES[dt], device, seed=8)
    _require_card(x)
    V = w.shape[1]
    if V % shards:
        raise ValueError(f"{shards} shards do not divide the vocab {V}")
    g = _t(np.random.default_rng(9).standard_normal(x.shape[0]) * 0.1, device)
    parts = []
    for m in range(shards):
        shard = VocabShard(m, shards, V // shards, None)
        cols = slice(shard.lo, shard.lo + shard.size)
        local = shard.local_ids(tgt)
        ws, bs = w[:, cols].contiguous(), b[cols].contiguous()
        logp, lse = lm_score_cuda.lm_token_logprobs_lse(x, ws, bs, local)
        parts.append((ws, bs, local, lse, target_logit(logp, lse, local)))
    logp, lse = combine_shards(torch.stack([p[3] for p in parts]),
                               torch.stack([p[4] for p in parts]))
    dlog = [lm_score_cuda.lm_dlogits(x, ws, bs, local, lse, g).float()
            for ws, bs, local, _, _ in parts]
    dx = sum(d @ p[0].to(x.dtype).float().T for d, p in zip(dlog, parts))
    whole_logp, whole_lse = lm_score_cuda.lm_token_logprobs_lse(x, w, b, tgt)
    whole_dlog = lm_score_cuda.lm_dlogits(x, w, b, tgt, whole_lse, g).float()
    want = (whole_logp, whole_lse, whole_dlog,
            whole_dlog @ w.to(x.dtype).float().T)
    return _record(name, (logp, lse, torch.cat(dlog, dim=1), dx), want,
                   _tol(name))


def _step_config(s, decoder: str, dt: str) -> Config:
    return Config(
        encoder="mn-ques-im-hist", decoder=decoder, vocab_size=s["V"],
        embed_size=300 if s["E"] >= 300 else s["E"],
        rnn_hidden_size=s["H"], batch_size=s["B_step"],
        dropout=0.0, compute_dtype={"f32": "float32", "bf16": "bfloat16"}[dt],
        use_pallas=True, **s["cfg_overrides"])


def _value_and_grad(params, batch, cfg, impl):
    """model_loss on the training path and its gradient by tree path.  No
    dropout generator, so no masks are drawn (the JAX gate takes
    train=False for that); the training path is the one with gradients
    (MN's attention through AttentionFn, not K4's forward-only eval
    tail)."""
    flat = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    loss = model_loss(unflatten(flat), batch, cfg, train=True, gen=None,
                      impl=impl)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


def check_train_grads(s, decoder: str, dt: str, device) -> dict:
    """The whole train-step gradient, kernel path against plain path, at
    realistic lengths (the candidate length sort and the per-tile bounds
    engage)."""
    name = f"train_grads_{decoder}_{dt}"
    cfg = _step_config(s, decoder, dt)
    params = model_init(cfg, seed=0, device=device)
    batch = batch_to_device(random_batch(cfg, seed=0, full_lengths=False),
                            device)
    _require_card(batch["ques"])
    got = _value_and_grad(params, batch, cfg, "cuda")
    want = _value_and_grad(params, batch, cfg, "plain")
    return _record(name, got, want, _tol(name))


def check_train_grads_dedup(s, dt: str, device) -> dict:
    """The deduplicated disc-train layout (opt_uniq + gather map + all-pad
    filler rows, Config.disc_dedup_options) against the expanded layout on
    the same candidate tokens, both through the kernels: the same math,
    only the duplicate rows' gradient summation order differs."""
    name = f"train_grads_disc_dedup_{dt}"
    cfg = _step_config(s, "disc", dt)
    params = model_init(cfg, seed=0, device=device)
    plain = random_batch(cfg, seed=0, full_lengths=False)
    # random_batch's candidates are ~all unique; redraw them from a small
    # pool so the batch carries heavy duplication and opt_uniq all-pad rows
    rng = np.random.default_rng(8)
    B, R, K = cfg.batch_size, cfg.num_rounds, cfg.num_options
    pool = plain["opt"].reshape(-1, cfg.max_ans_len)[: max(B * R * K // 4, 1)]
    sel = rng.integers(0, pool.shape[0], size=(B, R, K))
    plain["opt"] = pool[sel]
    dedup = dict(plain)
    del dedup["opt"]
    dedup["opt_uniq"], dedup["opt_row"] = dedup_option_rows(pool, sel)
    plain, dedup = (batch_to_device(b, device) for b in (plain, dedup))
    _require_card(plain["ques"])
    got = _value_and_grad(params, dedup, cfg, "cuda")
    want = _value_and_grad(params, plain, cfg, "cuda")
    return _record(name, got, want, _tol(name))


# ---------------------------------------------------------------------------
# running the checks
# ---------------------------------------------------------------------------

def _steps(s, device) -> list[tuple[str, Callable[[], dict]]]:
    steps = [
        ("lstm_fwd_f32", lambda: check_lstm_fwd(s, "f32", "lstm_fwd_f32",
                                                device)),
        ("lstm_fwd_bf16@big", lambda: check_lstm_fwd(
            s, "bf16", "lstm_fwd_bf16@big", device)),
    ]
    for dt in ("bf16", "f32"):
        for size, N in (("big", s["N_big"]), ("small", s["N_small"])):
            name = f"lstm_bwd_{dt}@{size}"
            steps.append((name, lambda N=N, dt=dt, name=name: check_lstm_bwd(
                s, N, dt, name, device)))
    for dt in ("bf16", "f32"):
        steps += [
            (f"attention_{dt}", lambda dt=dt: check_attention(s, dt, device)),
            (f"attention_fusion_{dt}",
             lambda dt=dt: check_attention_fusion(s, dt, device)),
            (f"lm_logprobs_{dt}", lambda dt=dt: check_lm_logprobs(s, dt, device)),
            (f"lm_dlogits_{dt}", lambda dt=dt: check_lm_dlogits(s, dt, device)),
        ]
    for dt in ("bf16", "f32"):
        steps += [
            (f"train_grads_disc_{dt}",
             lambda dt=dt: check_train_grads(s, "disc", dt, device)),
            (f"train_grads_gen_{dt}",
             lambda dt=dt: check_train_grads(s, "gen", dt, device)),
            (f"train_grads_disc_dedup_{dt}",
             lambda dt=dt: check_train_grads_dedup(s, dt, device)),
        ]
    for dt in ("bf16", "f32"):
        steps.append((f"lm_vocab_shards_{dt}",
                      lambda dt=dt: check_lm_vocab_shards(s, dt, device)))
    return steps


def run_checks(scale: str = "flagship", log: Callable[[str], None] = None,
               include: set[str] | None = None, device="cuda") -> dict:
    """Run every kernel-against-plain check on `device`.  Returns {"ok",
    "backend", "device_name", "scale", "checks": [...]}; `include` filters
    by check-name prefix."""
    s = SCALES[scale]
    device = torch.device(device)
    checks = []
    for name, fn in _steps(s, device):
        if include and not any(name.startswith(p) for p in include):
            continue
        try:
            rec = fn()
        except Exception as e:  # a crashing kernel is a failing check
            rec = {"name": name, "max_abs_err": float("inf"),
                   "max_rel_err": float("inf"), "rel_tol": _tol(name),
                   "ok": False, "error": f"{type(e).__name__}: {e}"}
        if log:
            log(f"[verify] {rec['name']}: rel {rec['max_rel_err']:.2e} "
                f"(tol {rec['rel_tol']:.0e}) abs {rec['max_abs_err']:.2e} "
                f"{'OK' if rec['ok'] else 'FAIL'}"
                + (f" [{rec['error']}]" if rec.get("error") else ""))
        checks.append(rec)
    out = _aggregate(checks)
    out["backend"] = device.type
    out["device_name"] = (torch.cuda.get_device_name(device)
                          if device.type == "cuda" and torch.cuda.is_available()
                          else str(device))
    out["scale"] = scale
    return out


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scale", default="flagship", choices=sorted(SCALES))
    p.add_argument("--include", nargs="*", default=None,
                   help="check-name prefixes to run (default: all)")
    args = p.parse_args(argv)
    # the f32 plain versions must be full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run_checks(args.scale, log=lambda m: print(m, file=sys.stderr),
                     include=set(args.include) if args.include else None)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
