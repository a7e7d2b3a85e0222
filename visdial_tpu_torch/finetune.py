"""Dense-annotation fine-tuning CLI on one GPU or a mesh of them (port of
visdial_tpu/finetune.py), the VisDial v1.0 NDCG phase.

Loads a trained disc checkpoint of either package and fine-tunes it so its
candidate-score softmax matches the dense human gt_relevance annotations
(the `visdial_1.0_val_dense_annotations.json` schema) with
models/model.py::model_dense_loss, each step one CUDA graph on one card
(parallel/train_step.py::make_dense_train_fn).  The learning rate is
--learning_rate without decay; the optimizer state is fresh and the
dropout generator is seeded from --seed.  Progress is JSONL: `ndcg` on the
annotated rounds at step 0, every --eval_every steps and at the end (the
resident eval's candidate rankings), `finetune` per step (read back every
--log_every steps), then `checkpoint`.

Usage:
    python -m visdial_tpu_torch.finetune --load_path checkpoints/run/step_N \
        --dense_json dense_annotations.json [--data_dir data | --synthetic N] \
        --steps 200 --learning_rate 1e-4 --save_path checkpoints/ft \
        [--device cuda | --device cpu]

--device cuda (the default) runs the kernels; --device cpu the plain
versions.  Under torchrun, --mesh_data / --mesh_model lay the processes out
as the train CLI does (parallel/mesh.py): each data rank fine-tunes on its
dialogs of every batch, every rank takes part in the NDCG evals, and rank
0 alone prints and writes the checkpoint.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .data.dataset import load_split
from .data.loader import DenseLoader
from .data.synthetic import make_synthetic_split
from .eval_harness import evaluate_split
from .evaluate import ndcg_from_dense
from .models.model import batch_to_device
from .parallel.mesh import add_mesh_args, make_mesh
from .parallel.optim import init_opt_state
from .parallel.train_step import (TrainState, gather_train_state,
                                  make_dense_train_fn, shard_train_state)
from .utils.checkpoint import load_checkpoint, save_checkpoint


def ndcg_on_entries(params, data, vocab, cfg, device, dense_entries,
                    mesh=None) -> dict:
    """NDCG over the annotated rounds (the resident eval's rankings)."""
    _, cand = evaluate_split(params, data, vocab, cfg, device,
                             collect_rankings=True, resident=True, mesh=mesh)
    return ndcg_from_dense(cand, data.img_ids, dense_entries)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True)
    p.add_argument("--dense_json", required=True)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--split", type=str, default="val",
                   help="split the dense annotations cover (v1.0: val)")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--eval_every", type=int, default=0,
                   help="NDCG on the annotated rounds every N steps "
                        "(0 = only before/after)")
    p.add_argument("--log_every", type=int, default=10,
                   help="steps between buffered loss readbacks/records")
    p.add_argument("--save_path", type=str, default="checkpoints/finetune")
    p.add_argument("--run_name", type=str, default="dense")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    add_mesh_args(p)
    args = p.parse_args(argv)

    mesh = make_mesh(args.mesh_data, args.mesh_model, args.device)
    device = mesh.device
    params, cfg, _ = load_checkpoint(args.load_path, device)
    if cfg.decoder != "disc":
        raise SystemExit(f"checkpoint is {cfg.decoder!r}; dense fine-tuning "
                         "targets disc models")
    cfg = cfg.replace(learning_rate=args.learning_rate, lr_decay_rate=1.0)
    if args.data_dir:
        cfg = cfg.replace(data_dir=args.data_dir)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if cfg.batch_size % mesh.data:
        raise SystemExit(f"--batch_size {cfg.batch_size} is not divisible by "
                         f"the mesh data axis ({mesh.data})")
    if args.synthetic:
        data, vocab = make_synthetic_split(cfg, num_dialogs=args.synthetic,
                                           seed=cfg.seed + 1)
    else:
        data, vocab = load_split(cfg.data_dir, args.split)
    if vocab.size != cfg.vocab_size:
        raise SystemExit(f"checkpoint/vocab mismatch: the checkpoint has "
                         f"vocab_size {cfg.vocab_size}, the data {vocab.size}")
    with open(args.dense_json) as f:
        dense = json.load(f)

    loader = DenseLoader(data, vocab, cfg, dense)
    if len(loader) == 0:
        raise SystemExit("no usable dense annotations for this split")
    # fresh optimizer over the new objective; keep the trained params
    state = shard_train_state(
        TrainState(params, init_opt_state(params, cfg),
                   torch.Generator().manual_seed(args.seed)), cfg, mesh)

    train_fn = make_dense_train_fn(cfg, mesh)

    def emit(event: str, **kw) -> None:
        if mesh.is_main:
            print(json.dumps({"event": event, **kw}), flush=True)

    def ndcg():
        return ndcg_on_entries(state.params, data, vocab, cfg, device, dense,
                               mesh)

    before = ndcg()
    emit("ndcg", step=0, **before)

    step, epoch, t0 = 0, 0, time.time()
    losses: list[float] = []
    buf: list = []      # device scalars; read back only at flush points

    def flush():
        # one stacked readback per flush, not one per step
        if not buf:
            return
        vals = torch.stack([torch.stack([m["loss"].float(),
                                         m["grad_norm"].float()])
                            for m in buf]).cpu()                 # (n, 2)
        for m, (loss, gnorm) in zip(buf, vals.tolist()):
            losses.append(loss)
            emit("finetune", step=m["step"], loss=loss, lr=float(m["lr"]),
                 grad_norm=gnorm)
        buf.clear()

    while step < args.steps:
        for batch in loader.epoch(seed=args.seed + epoch,
                                  shard=mesh.data_shard):
            state, m = train_fn(state, batch_to_device(batch, device))
            step += 1
            buf.append({**m, "step": step})
            if step % args.log_every == 0 or step >= args.steps:
                flush()
            if args.eval_every and step % args.eval_every == 0:
                flush()
                emit("ndcg", step=step, **ndcg())
            if step >= args.steps:
                break
        epoch += 1
    flush()

    after = ndcg()
    emit("ndcg", step=step, **after)
    whole = gather_train_state(state, cfg, mesh)
    mesh.barrier()
    path = (save_checkpoint(f"{args.save_path}/{args.run_name}", whole, cfg)
            if mesh.is_main else None)
    mesh.barrier()
    emit("checkpoint", step=step, path=path, seconds=time.time() - t0)
    return {"ndcg_before": before["ndcg"], "ndcg_after": after["ndcg"],
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps": step, "checkpoint": path}


if __name__ == "__main__":
    main()
