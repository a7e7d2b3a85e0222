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

make_train_fn, make_multistep_train_fn and make_dense_train_fn are the JAX
package's compiled dispatch: on the card each call is one CUDA graph
(parallel/graph.py), G steps of multistep included, as jax.jit of the step
or of its lax.scan is one device program there; on a mesh the graph holds
the step's NCCL collectives (the count's and loss's all-reduces, the
gradient buckets, the model group's squared norms, the vocab shard's
reductions), and under cfg.remat the encoder's recomputation.  train_step
and multi_train_step stay eager; they are the reference the graphs are
held to.  The eval factories (make_eval_fn, make_disc_table_eval_fns,
make_gen_bucket_eval_fns) are the same for scoring: each function they
return is one CUDA graph a signature under inference mode
(graph.py::InferenceGraphed), its `.fn` the eager function, and a
factory's functions share one device copy of the params (`.held`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..config import Config

from ..models.core import StepGenerators, split_seeds
from ..models.decoders import gen_score_rows
from ..models.encoders import encoder_apply
from ..models.model import (_impl, model_dense_loss, model_init, model_loss,
                            model_option_table, model_scores,
                            model_scores_with_table)
from ..utils.params import flatten, unflatten
from .graph import Graphed, Held, InferenceGraphed, copy_into
from .mesh import (Mesh, all_reduce_grads, broadcast_tree, gather_tree,
                   param_layouts, shard_tree, sum_sharded_squares)
from .optim import (OptState, apply_updates, init_opt_state, lr_at_step,
                    step_scalars)


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
        loss = loss_fn(unflatten(flat), batch, cfg, train=True, gen=gen,
                       impl=impl, denominator=mesh.count, seed_offset=mesh.d,
                       shard=mesh.vocab_shard(cfg.vocab_size))
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
    lr = lr_at_step(state.opt.step, cfg)
    params, opt, gnorm = apply_updates(state.params, grads, state.opt, lr, cfg,
                                       _sq_sums(cfg, mesh))
    metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, "step": opt.step}
    return TrainState(params, opt, state.gen), metrics


def multi_train_step(state: TrainState, batches: dict, cfg: Config,
                     impl: str | None = None, loss_fn=model_loss,
                     mesh: Mesh | None = None):
    """G optimizer steps in one call over a stack of G batches (leading
    axis of every array), eagerly: the reference that
    make_multistep_train_fn's graph (the JAX lax.scan's counterpart) is
    held to.  Returns (state, metrics) with every metric stacked to (G,)."""
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


def _sq_sums(cfg: Config, mesh: Mesh | None):
    """The global norm's squared-norm sums over the model group
    (apply_updates' sq_sums), or None without a model axis."""
    if mesh is None or mesh.model == 1:
        return None
    return partial(sum_sharded_squares, sharded=param_layouts(cfg, mesh),
                   mesh=mesh)


def step_seeds(gen: torch.Generator, steps: int) -> list[tuple[int, int]]:
    """The (encoder, decoder) dropout seeds of `steps` train steps, drawn
    from the state's CPU generator as that many eager steps draw them
    (models/model.py::_train_encode), which leaves it in the same state."""
    return [tuple(split_seeds(gen)) for _ in range(steps)]


class _TrainSteps:
    """The graphs' body: G steps from the buffers (params, m, v), written
    back into them at the end, over the mesh where given; it refers to
    nothing that holds its graphs, so a dropped factory frees them (and
    their memory pools) at once."""

    def __init__(self, cfg: Config, impl: str | None, loss_fn, stacked: bool,
                 mesh: Mesh | None):
        self.cfg, self.impl, self.loss_fn, self.stacked = (cfg, impl, loss_fn,
                                                           stacked)
        self.mesh, self.sq_sums = mesh, _sq_sums(cfg, mesh)
        self.buffers: tuple | None = None    # (params, m, v) the graphs use
        self._gens: dict = {}                # (G, device) -> [StepGenerators]

    def generators(self, G: int, device) -> list:
        """The G steps' dropout generators on `device`, made once (under
        cfg.remat three a step: the recomputation's too)."""
        key = (G, torch.device(device))
        if key not in self._gens:
            n = 3 if self.cfg.remat else 2
            self._gens[key] = [
                StepGenerators(*(torch.Generator(device=device)
                                 for _ in range(n)))
                for _ in range(G)]
        return self._gens[key]

    def __call__(self, batch: dict, scalars: torch.Tensor):
        """Returns the (G,) losses and grad norms."""
        G = scalars.shape[0]
        params, m, v = self.buffers
        opt = OptState(0, m, v)
        losses, gnorms = [], []
        for g, gens in enumerate(self.generators(G, scalars.device)):
            b = {k: x[g] for k, x in batch.items()} if self.stacked else batch
            loss, grads = loss_and_grads(params, b, self.cfg, gens, self.impl,
                                         self.loss_fn, self.mesh)
            params, opt, gnorm = apply_updates(
                params, grads, opt, scalars[g, 0], self.cfg, self.sq_sums,
                scales=(scalars[g, 1], scalars[g, 2]))
            losses.append(loss)
            gnorms.append(gnorm)
        copy_into(self.buffers, (params, opt.m, opt.v))
        return torch.stack(losses), torch.stack(gnorms)


class GraphedTrainStep:
    """G optimizer steps of loss_fn a call as one CUDA graph per batch
    signature (parallel/graph.py::Graphed), on one device or over a mesh
    (its collectives captured in the graph): what make_train_fn,
    make_multistep_train_fn and make_dense_train_fn return.

    The state's tensors are the graph's buffers: the first call adopts the
    state it is given, the steps write the new params and moments into them
    in place at the end of the graph (jax.jit's donate_argnums=(0,)), and a
    later call with a state whose tensors are not those copies it in first
    (a resume, a state from elsewhere).  The step count stays on the host;
    before each call the host writes the steps' lr and Adam scales into a
    device buffer (optim.py::step_scalars) and seeds the device generators,
    registered with the graphs, from the state's CPU generator in the eager
    order (step_seeds) plus the rank's data coordinate (the eager step's
    seed_offset), so a replay computes the eager steps bit for bit, dropout
    masks included; under cfg.remat a third generator a step, seeded as the
    encoder's, serves the recomputation.  On CPU tensors the same steps run
    eagerly."""

    def __init__(self, cfg: Config, impl: str | None, loss_fn, stacked: bool,
                 mesh: Mesh | None = None):
        self.steps = _TrainSteps(cfg, impl, loss_fn, stacked, mesh)
        self.graph = Graphed(self.steps)

    @property
    def captures(self) -> int:
        return self.graph.captures

    def __call__(self, state: TrainState, batch: dict):
        first = next(iter(batch.values()))
        G = len(first) if self.steps.stacked else 1
        self._donate(state)
        gens = self.steps.generators(G, first.device)
        offset = 0 if self.steps.mesh is None else self.steps.mesh.d
        for g, (enc, dec) in zip(gens, step_seeds(state.gen, G)):
            g.encoder.manual_seed(enc + offset)
            g.decoder.manual_seed(dec + offset)
            if g.recompute is not None:
                g.recompute.manual_seed(enc + offset)
        scalars = step_scalars(state.opt.step, G, self.steps.cfg)
        losses, gnorms = self.graph(
            batch, scalars.to(first.device),
            generators=[x for g in gens for x in g if x is not None])
        step = state.opt.step + G
        params, m, v = self.steps.buffers
        new = TrainState(params, OptState(step, m, v), state.gen)
        if self.steps.stacked:
            return new, {"loss": losses, "lr": scalars[:, 0].clone(),
                         "grad_norm": gnorms,
                         "step": torch.arange(state.opt.step + 1, step + 1,
                                              dtype=torch.int32)}
        return new, {"loss": losses[0], "lr": float(scalars[0, 0]),
                     "grad_norm": gnorms[0], "step": step}

    def _donate(self, state: TrainState) -> None:
        trees = (state.params, state.opt.m, state.opt.v)
        if self.steps.buffers is None:
            self.steps.buffers = trees
        else:
            copy_into(self.steps.buffers, trees)


def _factory(cfg: Config, mesh: Mesh | None, impl, loss_fn, stacked: bool):
    # a mesh made without a process group has no collective to issue: its
    # step is the one-device step (the mean, not a sum over a count)
    if mesh is not None and mesh.data_group is None \
            and mesh.model_group is None:
        mesh = None
    return GraphedTrainStep(cfg, impl, loss_fn, stacked, mesh)


def make_train_fn(cfg: Config, mesh: Mesh | None = None,
                  impl: str | None = None):
    """train_step as one CUDA graph a call (train_step.py::make_train_fn):
    fn(state, batch) -> (state, metrics) as train_step returns them, the
    state donated (GraphedTrainStep).  Over a mesh with a process group it
    is train_step(..., mesh=mesh), `batch` this rank's shard, the
    collectives in the graph; a mesh without one is the one-device
    step."""
    return _factory(cfg, mesh, impl, model_loss, stacked=False)


def make_multistep_train_fn(cfg: Config, mesh: Mesh | None = None,
                            impl: str | None = None, loss_fn=model_loss):
    """multi_train_step as one CUDA graph a call
    (train_step.py::make_multistep_train_fn, jit of the lax.scan): G steps
    over a stack of G batches, one dispatch from the host, metrics stacked
    to (G,); the state donated.  The mesh as in make_train_fn."""
    return _factory(cfg, mesh, impl, loss_fn, stacked=True)


def make_dense_train_fn(cfg: Config, mesh: Mesh | None = None,
                        impl: str | None = None):
    """make_train_fn over the dense fine-tuning loss
    (train_step.py::make_dense_train_fn, models/model.py::
    model_dense_loss)."""
    return _factory(cfg, mesh, impl, model_dense_loss, stacked=False)


def _eval_graphs(impl: str | None, *fns) -> tuple:
    """Each fn as one CUDA graph a signature (InferenceGraphed), all of them
    reading the params from one shared device copy (graph.py::Held, their
    `.held`: loaded on each call unless the params passed are those
    buffers), a vocab shard's reductions over the model group inside; or,
    with impl="plain" (the kernels' reference, chosen up front), each fn
    itself under inference mode."""
    if impl == "plain":
        return tuple(torch.inference_mode()(fn) for fn in fns)
    held = Held()
    return tuple(InferenceGraphed(fn, held=held) for fn in fns)


def _shard(cfg: Config, mesh: Mesh | None):
    return None if mesh is None else mesh.vocab_shard(cfg.vocab_size)


def make_eval_fn(cfg: Config, mesh: Mesh | None = None,
                 impl: str | None = None):
    """model_scores as one CUDA graph a batch signature
    (train_step.py::make_eval_fn): score(params, batch) -> (B, R, K).  The
    params are graph arguments, copied into the graph's buffers on each
    call unless they are those buffers (`score.held.tree`).  On a mesh it
    scores with this rank's vocab shard; with impl="plain" it is the eager
    function (_eval_graphs)."""
    shard = _shard(cfg, mesh)

    def score(params, batch):
        return model_scores(params, batch, cfg, impl=impl, shard=shard)

    return _eval_graphs(impl, score)[0]


def make_disc_table_eval_fns(cfg: Config, mesh: Mesh | None = None,
                             impl: str | None = None):
    """The disc eval's table path (train_step.py::make_disc_table_eval_fns):
    (table_fn, score_fn), table_fn(params, opt_list) -> (M, H) the
    deduplicated option list embedded once (model_option_table),
    score_fn(params, table, batch) -> (B, R, K) the encoder and a table
    gather (model_scores_with_table); each one CUDA graph a signature, as
    make_eval_fn, the two sharing one params copy.  score_fn over the table
    table_fn returns with clone=False reads it in place, in the table
    graph's memory pool (graph.py)."""
    shard = _shard(cfg, mesh)

    def table(params, opt_list):
        return model_option_table(params, opt_list, cfg, impl=impl,
                                  shard=shard)

    def score(params, table, batch):
        return model_scores_with_table(params, batch, table, cfg, impl=impl,
                                       shard=shard)

    return _eval_graphs(impl, table, score)


def make_gen_bucket_eval_fns(cfg: Config, mesh: Mesh | None = None,
                             impl: str | None = None):
    """The gen eval's length-bucketed path
    (train_step.py::make_gen_bucket_eval_fns): (encoder_fn, row_score_fn),
    encoder_fn(params, batch) -> (N, H) and row_score_fn(params, joint,
    opt_list, opt_list_len, opt_rows, row_idx, width, start_token,
    end_token) -> (C,) (gen_rows_score; width and the two tokens are
    static, part of the signature, as JAX's static_argnums=(6, 7, 8)); each
    one CUDA graph a signature, as make_disc_table_eval_fns: row_score_fn
    over the joint encoder_fn returns with clone=False reads it in place."""
    shard = _shard(cfg, mesh)

    def encode(params, batch):
        return encoder_apply(params["encoder"], params["embed"], batch, cfg,
                             impl=impl or _impl(cfg, batch["ques"].device),
                             shard=shard)

    def score(params, joint, opt_list, opt_list_len, opt_rows, row_idx,
              width, start_token, end_token):
        return gen_rows_score(params, joint, opt_list, opt_list_len, opt_rows,
                              row_idx, width, start_token, end_token, cfg,
                              impl=impl or _impl(cfg, joint.device),
                              shard=shard)

    return _eval_graphs(impl, encode, score)


def gen_rows_score(params, joint, opt_list, opt_list_len, opt_rows, row_idx,
                   width: int, start_token: int, end_token: int, cfg: Config,
                   *, impl: str = "plain", shard=None):
    """Score candidate rows at `width` steps, their <START>/<END> rows built
    on the device from the split's opt_list (train_step.py::gen_rows_score;
    the same construction as the loader's _with_start_end).  opt_rows (C,)
    rows into opt_list (M, La), row_idx (C,) rows into joint (N, H).  Returns
    (C,) summed token log-probs.  The rows arrive width-bucketed by the
    eval harness and are not length-sorted again.  `shard` as in
    models/model.py::model_loss."""
    tok = opt_list[opt_rows][:, :width - 1]                      # (C, w-1)
    lens = opt_list_len[opt_rows]                                # (C,)
    start = torch.full_like(tok[:, :1], start_token)
    opt_in = torch.cat([start, tok], dim=1)                      # (C, w)
    base = torch.nn.functional.pad(tok, (0, 1))
    pos = torch.arange(width, device=tok.device)[None, :]
    opt_out = torch.where(pos == lens[:, None], end_token, base)
    return gen_score_rows(params["decoder"], params["embed"], joint[row_idx],
                          opt_in, opt_out, cfg, impl=impl, sort=False,
                          shard=shard)
