"""Rank functions for tests/test_torch_distributed.py and
tests/test_torch_mesh_graphs.py, run by
visdial_tpu_torch.parallel.launch.run_ranks in spawned gloo processes.  They
import only the port (a spawned rank imports this module by name), take
numpy arrays and a Config, and return numpy arrays."""

from __future__ import annotations

import threading
from functools import partial

import numpy as np
import torch

from visdial_tpu_torch import generate as generate_cli
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.model import (batch_to_device, model_dense_loss,
                                            model_generate, model_loss)
from visdial_tpu_torch.parallel import mesh as mesh_mod
from visdial_tpu_torch.parallel.graph import Graphed
from visdial_tpu_torch.parallel.mesh import make_mesh, shard_tree, slice_dialogs
from visdial_tpu_torch.parallel.optim import init_opt_state
from visdial_tpu_torch.parallel.train_step import (GraphedTrainStep, TrainState,
                                                   gather_train_state,
                                                   make_dense_train_fn,
                                                   make_disc_table_eval_fns,
                                                   make_gen_bucket_eval_fns,
                                                   make_multistep_train_fn,
                                                   make_train_fn,
                                                   multi_train_step,
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


def _mesh_state(cfg, params_np, mesh, seed=0):
    params = params_from_numpy(params_np, cfg, "cpu")
    return shard_train_state(
        TrainState(params, init_opt_state(params, cfg),
                   torch.Generator().manual_seed(seed)), cfg, mesh)


def _same_state(a, b) -> bool:
    """Params, moments, step and CPU generator bit for bit."""
    trees = zip((a.params, a.opt.m, a.opt.v), (b.params, b.opt.m, b.opt.v))
    return (a.opt.step == b.opt.step
            and all(torch.equal(x, flatten(tb)[k]) for ta, tb in trees
                    for k, x in flatten(ta).items())
            and torch.equal(a.gen.get_state(), b.gen.get_state()))


def mesh_factories(rank, mesh_shape, cases, dropouts=(0.0, 0.5)):
    """Each case (name, cfg, params_np, shards, calls) through its factory
    over the mesh, rank r on shards[d]: `calls` calls of make_train_fn or
    make_dense_train_fn on the shard, or of make_multistep_train_fn on a
    stack of `calls` copies of it, from params_np; at each dropout, the same
    calls of the eager mesh step (train_step / multi_train_step) from the
    same state.  Returns {(name, dropout): (losses, equal, whole params)}:
    the factory's losses, whether every metric, the collectives issued, the
    params, moments and CPU generator equal the eager step's bit for bit
    (and the factory is a GraphedTrainStep over this mesh), and at dropout
    0 the whole params after the factory's calls."""
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape, device="cpu")
    out = {}
    for name, cfg, params_np, shards, calls in cases:
        batch = batch_to_device(shards[mesh.d], "cpu")
        if name == "make_multistep_train_fn":
            args = [{k: torch.stack([v] * calls) for k, v in batch.items()}]
            eager = multi_train_step
        else:
            args = [batch] * calls
            eager = (partial(train_step, loss_fn=model_dense_loss)
                     if name == "make_dense_train_fn" else train_step)
        make = {"make_train_fn": make_train_fn,
                "make_multistep_train_fn": make_multistep_train_fn,
                "make_dense_train_fn": make_dense_train_fn}[name]
        for dropout in dropouts:
            c = cfg.replace(dropout=dropout)
            fn = make(c, mesh)
            equal = isinstance(fn, GraphedTrainStep) and fn.steps.mesh is mesh
            graphed = _mesh_state(c, params_np, mesh)
            ref = _mesh_state(c, params_np, mesh)
            losses = []
            for b in args:
                n0 = mesh_mod.collectives
                graphed, gm = fn(graphed, b)
                n1 = mesh_mod.collectives
                ref, em = eager(ref, b, c, mesh=mesh)
                equal &= n1 - n0 == mesh_mod.collectives - n1 > 0
                equal &= all(torch.equal(torch.as_tensor(gm[k]),
                                         torch.as_tensor(em[k]))
                             for k in ("loss", "grad_norm", "lr", "step"))
                losses += np.asarray(gm["loss"]).reshape(-1).tolist()
            equal &= _same_state(graphed, ref)
            whole = gather_train_state(graphed, c, mesh)
            out[(name, dropout)] = (losses, bool(equal),
                                    params_to_numpy(whole.params)
                                    if dropout == 0 else None)
    return out


def evaluate_factories(rank, mesh_shape, cases):
    """evaluate_split over the mesh through factories made for it and
    passed (make_disc_table_eval_fns / make_gen_bucket_eval_fns, Graphed),
    streaming and resident, for each case (cfg, params_np, split, vocab,
    batch_size): [(metrics, ranks, candidate rankings)] for each case and
    residency."""
    torch.set_num_threads(1)
    mesh = make_mesh(*mesh_shape, device="cpu")
    out = []
    for cfg, params_np, split, vocab, bs in cases:
        state = _mesh_state(cfg, params_np, mesh)
        disc = cfg.decoder == "disc"
        fns = (make_disc_table_eval_fns if disc
               else make_gen_bucket_eval_fns)(cfg, mesh)
        assert all(isinstance(f, Graphed) for f in fns)
        for resident in (False, True):
            metrics, ranks, cand = evaluate_split(
                state.params, split, vocab, cfg, "cpu", batch_size=bs,
                return_ranks=True, collect_rankings=True, resident=resident,
                mesh=mesh, **{"table_fns" if disc else "gen_fns": fns})
            out.append(({k: v for k, v in metrics.items()
                         if k in ("mrr", "r@1", "r@5", "r@10", "mean_rank")},
                        np.asarray(ranks), np.asarray(cand)))
    return out


def cuda_mesh_graph_steps(rank, mesh_shape, decoder, remat, dispatches=2):
    """On cuda:LOCAL_RANK of a NCCL world laid out as mesh_shape:
    make_multistep_train_fn's graph over the mesh against
    multi_train_step(..., mesh=) at the bench's point (bf16, dropout 0.5,
    the global batch split over the data axis, 2 steps a dispatch):
    (every dispatch's metrics, the collectives and the params, moments
    and CPU generator bit for bit, the graph's captures)."""
    from visdial_tpu_torch.bench import flagship_config
    from visdial_tpu_torch.data.synthetic import random_batch
    from visdial_tpu_torch.parallel.train_step import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(*mesh_shape, device="cuda")
    dev = mesh.device
    bs = (32 if decoder == "disc" else 64) // mesh.data
    cfg = flagship_config(decoder=decoder, batch_size=bs).replace(remat=remat)
    host = [random_batch(cfg, seed=10 * mesh.d + s) for s in range(2)]
    stack = batch_to_device({k: np.stack([b[k] for b in host])
                             for k in host[0]}, dev)
    states = [shard_train_state(init_train_state(cfg, device=dev, seed=0),
                                cfg, mesh) for _ in range(2)]
    fn = make_multistep_train_fn(cfg, mesh)
    equal = True
    for _ in range(dispatches):
        n0 = mesh_mod.collectives
        states[0], mg = fn(states[0], stack)
        n1 = mesh_mod.collectives
        states[1], me = multi_train_step(states[1], stack, cfg, mesh=mesh)
        equal &= n1 - n0 == mesh_mod.collectives - n1 > 0
        equal &= all(torch.equal(mg[k], me[k])
                     for k in ("loss", "grad_norm", "lr", "step"))
    equal &= _same_state(states[0], states[1])
    torch.cuda.synchronize(dev)
    mesh.barrier()
    return bool(equal), fn.captures
