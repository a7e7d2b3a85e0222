"""Rank functions for tests/test_torch_distributed.py, run by
visdial_tpu_torch.parallel.launch.run_ranks in spawned gloo processes.  They
import only the port (a spawned rank imports this module by name), take
numpy arrays and a Config, and return numpy arrays."""

from __future__ import annotations

import threading

import numpy as np
import torch

from visdial_tpu_torch import generate as generate_cli
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.model import (batch_to_device, model_generate,
                                            model_loss)
from visdial_tpu_torch.parallel.mesh import make_mesh, shard_tree, slice_dialogs
from visdial_tpu_torch.parallel.optim import init_opt_state
from visdial_tpu_torch.parallel.train_step import (TrainState,
                                                   gather_train_state,
                                                   shard_train_state,
                                                   train_step)
from visdial_tpu_torch.utils.checkpoint import save_checkpoint
from visdial_tpu_torch.utils.params import (flatten, params_from_numpy,
                                            params_to_numpy, unflatten)


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


def remat_grads(rank, cfg, params_np, batch_np, mesh_shape):
    """The gradients of model_loss (cfg.remat, this rank's vocab shard) with
    the backward, and so the encoder's recomputation, run on the calling
    thread and then on a fresh threading.Thread: (main, thread), each
    {path: this rank's gradient}."""
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape, device="cpu")
    params = shard_tree(params_from_numpy(params_np, cfg, "cpu"), cfg, mesh)
    batch = batch_to_device(batch_np, "cpu")
    shard = mesh.vocab_shard(cfg.vocab_size)
    assert shard is not None and cfg.remat

    def grads(on_thread: bool) -> dict:
        flat = {k: v.detach().requires_grad_()
                for k, v in flatten(params).items()}
        loss = model_loss(unflatten(flat), batch, cfg, train=True,
                          gen=torch.Generator().manual_seed(0),
                          denominator=mesh.count, shard=shard)
        out = {}

        def backward():
            out["g"] = torch.autograd.grad(loss, list(flat.values()))
            out["thread"] = threading.get_ident()

        if on_thread:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
            assert out["thread"] != threading.get_ident()
        else:
            backward()
        return {k: g.numpy() for k, g in zip(flat, out["g"])}

    return grads(False), grads(True)


def decode(rank, cfg, params_np, batch_np, mesh_shape, seed, tokens):
    """model_generate on this rank's dialogs of the batch with the params
    whole, as the generate CLI holds them: {mode: (tokens, log-probs)} for
    greedy, beam 5 and sampling (a generator seeded with seed + the data
    coordinate), and the rank's (d, m)."""
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape, device="cpu")
    params = params_from_numpy(params_np, cfg, "cpu")
    sl = mesh.dialog_slice(len(batch_np["ques"]))
    if sl is not None:
        batch_np = slice_dialogs(batch_np, *sl)
    batch = batch_to_device(batch_np, "cpu")
    out = {}
    with torch.inference_mode():
        for mode, kw in (("greedy", {}), ("beam", {"beam_size": 5}),
                         ("sample", {"greedy": False, "temperature": 1.5,
                                     "gen": torch.Generator().manual_seed(
                                         seed + mesh.d)})):
            toks, logp = model_generate(params, batch, cfg,
                                        start_token=tokens[0],
                                        end_token=tokens[1], **kw)
            out[mode] = (toks.numpy(), logp.numpy())
    return out, (mesh.d, mesh.m)


def generate(rank, argvs):
    """The generate CLI on this rank once for each argv (rank 0 writes the
    JSON)."""
    torch.set_num_threads(1)
    for argv in argvs:
        generate_cli.main(argv)
