"""The training step (port of visdial_tpu/parallel/train_step.py): loss and
gradients, global clip, optimizer update, LR decay, on one device or over a
(data, model) mesh (parallel/mesh.py).

The state carries a CPU torch.Generator in place of the JAX key; each step
draws its dropout seeds from it (models/model.py::model_loss), so the
generator advances in place and the returned state holds the same object.

On a mesh (what JAX's make_train_fn gets from XLA's partitioner, written
out): each data rank's batch is its shard of the global batch, and every
loss divides its shard's sum by the global batch's count (one small
all-reduce of the count), so the shards' losses and gradients SUM to the
global batch's.  The gradients are summed over the data group in flat
buckets before the global-norm clip, which sees the global gradient; a
vocab-sharded leaf's squared norm is summed over the model group and a
replicated leaf counted once.  The CPU generator draws the step's seeds
identically on every rank (the ranks stay in lockstep) and each rank offsets
them by its data coordinate, so the ranks of one data row draw the same
masks and different rows draw their own: a mesh step equals the one-device
step over the global batch at dropout 0 only.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..config import Config

from ..models.decoders import gen_score_rows
from ..models.model import model_init, model_loss
from ..utils.params import flatten, unflatten
from .mesh import (Mesh, all_reduce_grads, broadcast_tree, gather_tree,
                   param_layouts, shard_tree, sum_sharded_squares,
                   vocab_parallel)
from .optim import OptState, apply_updates, init_opt_state, lr_at_step


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    gen: torch.Generator     # CPU generator of the dropout seeds


def init_train_state(cfg: Config, device="cpu", seed: int | None = None) -> TrainState:
    """Fresh params from `seed` (default cfg.seed) on `device`, zero
    optimizer state, and the dropout generator seeded with seed + 1."""
    seed = cfg.seed if seed is None else seed
    params = model_init(cfg, seed=seed, device=device)
    return TrainState(params, init_opt_state(params, cfg),
                      torch.Generator().manual_seed(seed + 1))


def shard_train_state(state: TrainState, cfg: Config,
                      mesh: Mesh) -> TrainState:
    """The whole state (after init or resume) laid out on the mesh
    (train_step.py::shard_train_state): every leaf set to rank 0's, then
    each rank keeps its shard of the vocab-sharded leaves; the optimizer
    moments mirror their params.  The generator is each rank's own (the
    same on every rank after the same init or resume)."""
    trees = [broadcast_tree(t, mesh) for t in (state.params, state.opt.m,
                                               state.opt.v)]
    params, m, v = (shard_tree(t, cfg, mesh) for t in trees)
    return TrainState(params, OptState(state.opt.step, m, v), state.gen)


def gather_train_state(state: TrainState, cfg: Config,
                       mesh: Mesh) -> TrainState:
    """The whole state from the mesh's shards (every rank of a model group
    must call; a checkpoint writes what rank 0 gets)."""
    params, m, v = (gather_tree(t, cfg, mesh)
                    for t in (state.params, state.opt.m, state.opt.v))
    return TrainState(params, OptState(state.opt.step, m, v), state.gen)


def loss_and_grads(params: dict, batch: dict, cfg: Config,
                   gen: torch.Generator | None, impl: str | None = None,
                   loss_fn=model_loss, mesh: Mesh | None = None):
    """(loss, grads) of loss_fn (model_loss, or models/model.py::
    model_dense_loss for dense fine-tuning) in train mode; grads mirror
    params.  With a mesh, `batch` is this rank's shard of the global batch:
    the loss is the global batch's (each shard's sum over the global
    count) and the gradients are summed over the data group."""
    flat = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    if mesh is None:
        loss = loss_fn(unflatten(flat), batch, cfg, train=True, gen=gen,
                       impl=impl)
    else:
        with vocab_parallel(mesh.vocab_shard(cfg.vocab_size)):
            loss = loss_fn(unflatten(flat), batch, cfg, train=True, gen=gen,
                           impl=impl, denominator=mesh.count,
                           seed_offset=mesh.d)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    if mesh is not None:
        loss = mesh.sum_data(loss.detach().clone())
        grads = all_reduce_grads(grads, mesh)
    return loss.detach(), unflatten(grads)


def train_step(state: TrainState, batch: dict, cfg: Config,
               impl: str | None = None, loss_fn=model_loss,
               mesh: Mesh | None = None):
    """One optimizer step of loss_fn, on one device or (mesh) over the mesh
    with `batch` this rank's shard of the global batch.  Returns
    (new_state, metrics): loss (the global batch's), lr, grad_norm (device
    tensors or floats) and step."""
    loss, grads = loss_and_grads(state.params, batch, cfg, state.gen, impl,
                                 loss_fn, mesh)
    sq_sums = None if mesh is None or mesh.model == 1 else partial(
        sum_sharded_squares, sharded=param_layouts(cfg, mesh), mesh=mesh)
    lr = lr_at_step(state.opt.step, cfg)
    params, opt, gnorm = apply_updates(state.params, grads, state.opt, lr, cfg,
                                       sq_sums)
    metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, "step": opt.step}
    return TrainState(params, opt, state.gen), metrics


def multi_train_step(state: TrainState, batches: dict, cfg: Config,
                     impl: str | None = None, loss_fn=model_loss,
                     mesh: Mesh | None = None):
    """G optimizer steps in one call over a stack of G batches (leading
    axis of every array), the counterpart of the JAX lax.scan.  Returns
    (state, metrics) with every metric stacked to (G,)."""
    G = len(next(iter(batches.values())))
    rows = []
    for g in range(G):
        state, m = train_step(state, {k: v[g] for k, v in batches.items()},
                              cfg, impl, loss_fn, mesh)
        rows.append(m)
    metrics = {
        "loss": torch.stack([m["loss"] for m in rows]),
        "lr": torch.tensor([m["lr"] for m in rows], dtype=torch.float32),
        "grad_norm": torch.stack([m["grad_norm"] for m in rows]),
        "step": torch.tensor([m["step"] for m in rows], dtype=torch.int32),
    }
    return state, metrics


def gen_rows_score(params, joint, opt_list, opt_list_len, opt_rows, row_idx,
                   width: int, start_token: int, end_token: int, cfg: Config,
                   *, impl: str = "plain"):
    """Score candidate rows at `width` steps, their <START>/<END> rows built
    on the device from the split's opt_list (train_step.py::gen_rows_score;
    the same construction as the loader's _with_start_end).  opt_rows (C,)
    rows into opt_list (M, La), row_idx (C,) rows into joint (N, H).  Returns
    (C,) summed token log-probs.  The rows arrive width-bucketed by the
    eval harness and are not length-sorted again."""
    tok = opt_list[opt_rows][:, :width - 1]                      # (C, w-1)
    lens = opt_list_len[opt_rows]                                # (C,)
    start = torch.full_like(tok[:, :1], start_token)
    opt_in = torch.cat([start, tok], dim=1)                      # (C, w)
    base = torch.nn.functional.pad(tok, (0, 1))
    pos = torch.arange(width, device=tok.device)[None, :]
    opt_out = torch.where(pos == lens[:, None], end_token, base)
    return gen_score_rows(params["decoder"], params["embed"], joint[row_idx],
                          opt_in, opt_out, cfg, impl=impl, sort=False)
