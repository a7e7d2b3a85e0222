"""Rank functions for tests/test_torch_distributed.py, run by
visdial_tpu_torch.parallel.launch.run_ranks in spawned gloo processes.  They
import only the port (a spawned rank imports this module by name), take
numpy arrays and a Config, and return numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.parallel.mesh import make_mesh
from visdial_tpu_torch.parallel.optim import init_opt_state
from visdial_tpu_torch.parallel.train_step import (TrainState,
                                                   gather_train_state,
                                                   shard_train_state,
                                                   train_step)
from visdial_tpu_torch.utils.checkpoint import save_checkpoint
from visdial_tpu_torch.utils.params import params_from_numpy, params_to_numpy


def train(rank, cfg, params_np, shards, mesh_shape, steps, save_dir=None):
    """`steps` mesh steps from params_np, rank r on shards[d] (its data
    coordinate's dialogs).  Returns (losses, grad norms, whole params),
    and writes a checkpoint of the whole state into save_dir (rank 0)."""
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape, device="cpu")
    params = params_from_numpy(params_np, cfg, "cpu")
    state = shard_train_state(
        TrainState(params, init_opt_state(params, cfg),
                   torch.Generator().manual_seed(0)), cfg, mesh)
    local = {k: v.shape for k, v in params_to_numpy(state.params).items()}
    batch = batch_to_device(shards[mesh.d], "cpu")
    losses, norms = [], []
    for _ in range(steps):
        state, m = train_step(state, batch, cfg, mesh=mesh)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = gather_train_state(state, cfg, mesh)
    if save_dir and mesh.is_main:
        save_checkpoint(save_dir, whole, cfg)
    mesh.barrier()
    return losses, norms, params_to_numpy(whole.params), local


def evaluate(rank, cfg, params_np, split, vocab, mesh_shape, cases):
    """evaluate_split over the mesh for each (batch_size, resident) case:
    [(metrics, ranks, candidate rankings)]."""
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape, device="cpu")
    params = params_from_numpy(params_np, cfg, "cpu")
    state = shard_train_state(
        TrainState(params, init_opt_state(params, cfg), torch.Generator()),
        cfg, mesh)
    out = []
    for bs, resident in cases:
        metrics, ranks, cand = evaluate_split(
            state.params, split, vocab, cfg, "cpu", batch_size=bs,
            return_ranks=True, collect_rankings=True, resident=resident,
            mesh=mesh)
        out.append(({k: v for k, v in metrics.items()
                     if k in ("mrr", "r@1", "r@5", "r@10", "mean_rank")},
                    np.asarray(ranks), np.asarray(cand)))
    return out


def mesh_shape(rank, data, model):
    """make_mesh(data, model) on the CPU: (data, model, d, m), or the
    message it exits with."""
    try:
        mesh = make_mesh(data, model, device="cpu")
    except SystemExit as e:
        return str(e)
    return mesh.data, mesh.model, mesh.d, mesh.m
