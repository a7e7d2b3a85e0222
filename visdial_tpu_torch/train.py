"""Training CLI on one GPU or a mesh of them (port of visdial_tpu/train.py).

Usage:
    python -m visdial_tpu_torch.train --encoder mn-ques-im-hist --decoder disc \
        --data_dir data --num_epochs 15
    python -m visdial_tpu_torch.train --synthetic 64 --max_steps 20  # no data
    python -m visdial_tpu_torch.train --synthetic 64 --max_steps 20 --decoder gen
    torchrun --nproc_per_node 4 -m visdial_tpu_torch.train --synthetic 64 \
        --max_steps 20 --mesh_data 4          # data-parallel over 4 cards
    torchrun --nproc_per_node 2 -m visdial_tpu_torch.train --device cpu \
        --synthetic 64 --mesh_data 1 --mesh_model 2 --decoder gen  # gloo

--mesh_data / --mesh_model lay the torchrun processes out as the (data,
model) grid of parallel/mesh.py (-1 data fills the world; a grid that is
not the whole world exits).  Each data rank trains on its batch_size / data
dialogs of every global batch, so the data axis must divide batch_size;
rank 0 alone logs and writes checkpoints (whole arrays, gathered from the
model axis), and every rank takes part in the periodic eval.

The flags are the JAX CLI's (built from the Config fields) plus --device
(default cuda; there is no silent move to the CPU).  Every run writes JSONL
metrics (events config, train, eval, checkpoint, non_finite_loss, done, and
notice/resumed/step_time/profile/spans) to stdout and <save_path>/<run_name>/
metrics.jsonl, and full resumable checkpoints (params, optimizer moments,
step, dropout generator, config) in the JAX package's format.  Every
encoder (with or without img_spatial) trains with either decoder.

The steps go through parallel/train_step.py's factories, as the JAX CLI's
go through its jitted ones: on the card each call is one CUDA graph
(make_train_fn, and make_multistep_train_fn for --steps_per_dispatch > 1),
captured once for the run's batch shape, on one card or under torchrun
(the mesh's collectives inside the graph), with --remat true too (the
encoder's recomputation inside it); and its periodic evals through the
eval factories (make_disc_table_eval_fns, make_gen_bucket_eval_fns or
make_eval_fn), built once beside them.  --debug_nans runs the eager steps
(train_step, multi_train_step): anomaly detection reads every backward
output on the host, which a graph cannot.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from functools import partial

import numpy as np
import torch

from .config import (RESUME_OVERRIDABLE, Config, encoder_family,
                     encoder_uses_history, resume_config_mismatches)
from .data.dataset import load_split
from .data.loader import TrainLoader
from .data.synthetic import make_synthetic_split

from .eval_harness import evaluate_split
from .models.model import batch_to_device
from .parallel.mesh import make_mesh
from .parallel.train_step import (gather_train_state, init_train_state,
                                  make_disc_table_eval_fns, make_eval_fn,
                                  make_gen_bucket_eval_fns,
                                  make_multistep_train_fn, make_train_fn,
                                  multi_train_step, shard_train_state,
                                  train_step)
from .utils import trace
from .utils.checkpoint import latest_checkpoint, load_train_state, save_checkpoint
from .utils.logging import MetricsLogger


def _flag_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(name, type=_flag_bool, default=f.default)
        else:
            p.add_argument(name, type=type(f.default), default=f.default)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic dialogs instead of real data")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop after N steps (0 = run num_epochs)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in save_path")
    p.add_argument("--run_name", type=str, default="")
    p.add_argument("--profile_steps", type=str, default="",
                   help="'start,stop' step range traced with torch.profiler "
                        "and the port's spans (utils/trace.py): a Chrome "
                        "trace lands in the run directory; the spans of "
                        "set-up, of those steps and of each eval are "
                        "summed in 'spans' events")
    p.add_argument("--time_steps", type=int, default=0,
                   help="log per-step wall-clock ('step_time' events, the "
                        "device synchronised each step) for the first N steps")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="optimizer steps per call (>1 runs G steps in one "
                        "dispatch over a stacked batch group; "
                        "metrics/eval/checkpoint cadences quantize to group "
                        "boundaries)")
    p.add_argument("--eval_resident", type=_flag_bool, default=True,
                   help="run the periodic eval with the split's batches "
                        "resident on the device (up to 2 GiB of stacks, "
                        "else it streams)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly: raise with a "
                        "traceback at the op that makes a NaN in the backward")
    p.add_argument("--device", type=str, default="cuda")
    return p


def config_from_args(args) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in fields})


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    # --profile_steps records the port's spans over set-up (to the end of
    # the first dispatch: the mesh, the kernels, the host builds, the
    # captures) as well as over its steps and each eval
    setup_spans = bool(args.profile_steps)
    if setup_spans:
        trace.start()
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = config_from_args(args)
    mesh = make_mesh(cfg.mesh_data, cfg.mesh_model, args.device)
    device = mesh.device
    if cfg.batch_size % mesh.data:
        raise SystemExit(
            f"--batch_size {cfg.batch_size} is not divisible by the mesh data "
            f"axis ({mesh.data}); pick a multiple, or shrink the mesh with "
            f"--mesh_data")

    if args.synthetic:
        train_data, vocab = make_synthetic_split(cfg, num_dialogs=args.synthetic,
                                                 seed=cfg.seed)
        val_data, _ = make_synthetic_split(cfg, num_dialogs=max(8, args.synthetic // 4),
                                           vocab=vocab, seed=cfg.seed + 1)
    else:
        train_data, vocab = load_split(cfg.data_dir, "train")
        val_data, _ = load_split(cfg.data_dir, "val")
    cfg = cfg.replace(vocab_size=vocab.size).validate()

    run_name = args.run_name or f"{cfg.encoder}-{cfg.decoder}-{int(time.time())}"
    ckpt_dir = os.path.join(cfg.save_path, run_name)
    log = MetricsLogger(os.path.join(ckpt_dir, "metrics.jsonl")
                        if mesh.is_main else None, mirror=mesh.is_main)
    log.log({"event": "config", **dataclasses.asdict(cfg),
             "devices": mesh.world, "device": str(device),
             "device_name": (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")})
    if (encoder_family(cfg.encoder) == "lf" and encoder_uses_history(cfg.encoder)
            and cfg.lf_hist_incremental and cfg.dropout > 0):
        # the deterministic math is exactly the per-round re-encoding; only
        # the noise's shape differs (config.py, lf_hist_incremental)
        log.log({"event": "notice",
                 "msg": "LF incremental-history path: inter-layer dropout "
                        "masks are shared across a dialog's rounds (~10x "
                        "fewer token-steps); pass --lf_hist_incremental "
                        "false for reference-exact per-round noise"})
    if args.resume and (path := latest_checkpoint(ckpt_dir)):
        state, cfg_saved, _ = load_train_state(path, device)
        if diffs := resume_config_mismatches(cfg_saved, cfg):
            raise SystemExit(
                f"--resume config mismatch vs {path}: the checkpoint was "
                "trained under different structural settings — "
                + ", ".join(f"{k}: saved={a!r} flag={b!r}"
                            for k, (a, b) in sorted(diffs.items()))
                + ". Re-run with matching flags (only "
                + ", ".join(sorted(RESUME_OVERRIDABLE))
                + " may differ on resume).")
        log.log({"event": "resumed", "from": path})
    else:
        state = init_train_state(cfg, device=device)
    state = shard_train_state(state, cfg, mesh)

    # assembled in float32; the encoder casts on the device
    loader = TrainLoader(train_data, vocab, cfg.replace(compute_dtype="float32"))
    steps_per_epoch = loader.steps_per_epoch
    eval_every = cfg.eval_every or steps_per_epoch
    save_every = cfg.save_every or steps_per_epoch
    max_steps = args.max_steps or cfg.num_epochs * steps_per_epoch
    group = max(1, args.steps_per_dispatch)
    prof_range = (tuple(int(x) for x in args.profile_steps.split(","))
                  if args.profile_steps else None)
    prof = None

    if args.debug_nans:
        train_fn = partial(train_step, cfg=cfg, mesh=mesh)
        multi_fn = partial(multi_train_step, cfg=cfg, mesh=mesh)
    else:
        train_fn = make_train_fn(cfg, mesh)
        multi_fn = make_multistep_train_fn(cfg, mesh) if group > 1 else None
    # each decoder's eval path, built once and reused across evals: disc
    # the option table, gen the length buckets (or the direct path)
    eval_fn = table_fns = gen_fns = None
    if cfg.decoder == "disc":
        table_fns = make_disc_table_eval_fns(cfg, mesh)
    elif cfg.gen_eval_bucketed:
        gen_fns = make_gen_bucket_eval_fns(cfg, mesh)
    else:
        eval_fn, table_fns, gen_fns = make_eval_fn(cfg, mesh), False, False

    step = state.opt.step
    t_last, s_last = time.time(), step
    rounds_per_batch = cfg.batch_size * cfg.num_rounds
    running = None
    loss_buf: list = []
    last_eval: dict = {}
    epoch = step // steps_per_epoch
    # Deterministic mid-epoch resume: the epoch's batch order is a pure
    # function of (seed, epoch), so skipping the consumed prefix reproduces
    # the unbroken run's batches.
    skip = step % steps_per_epoch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def flush_losses():
        # losses stay on the device between log points (no per-step sync);
        # read before every checkpoint/eval so a NaN never reaches a
        # checkpoint unnoticed
        nonlocal running
        if not loss_buf:
            return None
        losses = torch.cat([x.reshape(-1) for x in loss_buf]).double().cpu().numpy()
        loss_buf.clear()
        for loss in losses:
            running = loss if running is None else 0.95 * running + 0.05 * loss
        bad = losses[~np.isfinite(losses)]
        if bad.size:
            log.log({"event": "non_finite_loss", "step": step,
                     "loss": float(bad[0])})
            raise FloatingPointError(
                f"non-finite loss {bad[0]} by step {step}; "
                "re-run with --debug_nans to locate the origin")
        return float(losses[-1])

    def crossed(every, prev):
        return prev // every != step // every

    def log_spans(phase, **at):
        log.log({"event": "spans", "phase": phase, **at,
                 **trace.summary(trace.stop())})

    while step < max_steps:
        batch_iter = (b for i, b in enumerate(
            loader.epoch(seed=cfg.seed + epoch, shard=mesh.data_shard))
            if i >= skip)
        while step < max_steps:
            # the profiled steps' stretch opens before their batches are
            # taken, so it holds the loader's gets for them
            want = min(group, max_steps - step)
            if prof_range and prof is None and step <= prof_range[0] < step + want:
                if setup_spans:
                    log_spans("setup", step=step)
                    setup_spans = False
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                trace.start()
            pending = []
            for b in batch_iter:
                pending.append(b.as_dict())
                if len(pending) >= want:
                    break
            if not pending:
                break                       # epoch exhausted
            timing = args.time_steps and step < args.time_steps
            if timing:
                sync()
                t0 = time.time()
            prev = step
            if len(pending) == group and group > 1:
                stacked = batch_to_device(
                    {k: np.stack([bd[k] for bd in pending]) for k in pending[0]},
                    device)
                state, m = multi_fn(state, stacked)
                step += len(pending)
                loss_buf.append(m["loss"])
            else:  # group == 1, epoch tail, or max_steps trim
                for bd in pending:
                    state, m = train_fn(state, batch_to_device(bd, device))
                    step += 1
                    loss_buf.append(m["loss"])
            if timing:
                sync()
                log.log({"event": "step_time", "step": step,
                         "seconds": (time.time() - t0) / len(pending),
                         "steps_per_dispatch": len(pending),
                         "loss": float(m["loss"].reshape(-1)[-1])})
            if setup_spans:
                sync()
                log_spans("setup", step=step)
                setup_spans = False
            if prof is not None and prev < prof_range[1] <= step:
                sync()
                record = trace.stop()
                prof.stop()
                path = os.path.join(ckpt_dir, "trace.json")
                prof.export_chrome_trace(path)
                log.log({"event": "profile", "steps": list(prof_range),
                         "path": path})
                log.log({"event": "spans", "phase": "steps",
                         "steps": list(prof_range), **trace.summary(record)})
                prof, prof_range = None, None

            if crossed(cfg.log_every, prev) or step >= max_steps:
                last_loss = flush_losses()
                dt = time.time() - t_last
                rps = (step - s_last) * rounds_per_batch / max(dt, 1e-9)
                log.log({"event": "train", "step": step, "epoch": epoch,
                         "loss": last_loss, "running_loss": running,
                         "lr": float(np.asarray(m["lr"]).reshape(-1)[-1]),
                         "grad_norm": float(m["grad_norm"].reshape(-1)[-1]),
                         "rounds_per_sec": rps,
                         "rounds_per_sec_per_chip": rps / mesh.world})
                t_last, s_last = time.time(), step
            if crossed(eval_every, prev) or step >= max_steps:
                flush_losses()
                # each eval outside the profiled steps is recorded on its own
                eval_spans = bool(args.profile_steps) and prof is None
                if eval_spans:
                    trace.start()
                metrics = evaluate_split(state.params, val_data, vocab, cfg,
                                         device, eval_fn=eval_fn,
                                         table_fns=table_fns, gen_fns=gen_fns,
                                         resident=args.eval_resident,
                                         resident_max_bytes=2 << 30, mesh=mesh)
                if eval_spans:
                    log_spans("eval", step=step)
                last_eval = metrics
                log.log({"event": "eval", "step": step, **metrics})
            if crossed(save_every, prev) or step >= max_steps:
                flush_losses()   # never checkpoint past an undetected NaN
                whole = gather_train_state(state, cfg, mesh)
                mesh.barrier()
                if mesh.is_main:
                    path = save_checkpoint(ckpt_dir, whole, cfg)
                    log.log({"event": "checkpoint", "step": step, "path": path})
                mesh.barrier()
        epoch += 1
        skip = 0
    log.log({"event": "done", "step": step, **{f"final_{k}": v
                                               for k, v in last_eval.items()}})
    log.close()
    return last_eval


if __name__ == "__main__":
    main()
