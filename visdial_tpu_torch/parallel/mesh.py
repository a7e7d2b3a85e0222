"""The process grid of multi-GPU training and evaluation (port of
visdial_tpu/parallel/mesh.py) over torch.distributed.

One process per card, launched by torchrun (it sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT): a rank on `--device cuda` uses
cuda:LOCAL_RANK over NCCL, on `--device cpu` the CPU over gloo.  With no
WORLD_SIZE above 1 in the environment, and no process group made by the
caller, the world is one process and no group exists: every collective
below is then the identity.

The ('data', 'model') grid is data-major, as JAX's
np.reshape(devices, (data, model)): rank = d * model + m.  The ranks of one
data row (same d) hold the same dialogs; those of one model column (same m)
hold the same parameter shards.

Layout of record (param_layout, the rule of JAX's param_pspec and
tree_shardings): the vocab-dimensioned leaves are split over 'model' --
embed/table by rows, the gen decoder's out_proj/w by columns and out_proj/b
by entries -- and every other leaf is replicated; a vocab the model axis
does not divide leaves those leaves replicated.  Batches are split over
'data' by dialogs: a training rank assembles its own contiguous
batch_size / data dialogs of the global batch (the loaders' `shard`), so
the deduplicated candidate rows (opt_uniq, opt_row) are built per shard and
never sliced; slice_dialogs refuses them.

Each collective of the steps and evals (Mesh.sum_data / count /
gather_data, VocabShard.sum / gather, all_reduce_grads,
sum_sharded_squares, gather_tree) adds one to the module's `collectives`
count where it is issued; graph.py::counters registers it beside the
kernels' launch counts, so a CUDA graph that captured some adds them again
on each replay.  make_mesh makes each group's communicator with one small
collective, since a NCCL communicator is made at a group's first
collective and a capture cannot make one.

A deliberate divergence: the JAX mesh may leave devices idle; a process
group cannot leave a rank idle usefully, so a mesh smaller than the world
exits.  Resume on fewer cards by launching fewer processes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..utils import trace

# the flat gradient buckets' size (DistributedDataParallel's default)
BUCKET_BYTES = 25 << 20
# train batch keys that lead with the batch's candidate rows, not its dialogs
NO_DIALOG_AXIS = ("opt_uniq", "opt_row")
# the collectives this module has issued (module docstring)
collectives = 0


def _issued() -> None:
    global collectives
    collectives += 1


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over group, in place."""
    dist.all_reduce(t, group=group)
    _issued()
    return t


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *t.shape): every rank of group's t, in group rank order."""
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t.contiguous(), group=group)
    _issued()
    return torch.stack(out)


@dataclass(frozen=True)
class VocabShard:
    """This rank's slice of the vocab on the model axis: ids [lo, lo + size)
    of every vocab-dimensioned leaf, and the model group that sums over the
    slices (the vocab-parallel embedding in models/core.py, the LM head in
    ops/lm_loss.py).  The caller that owns the mesh makes it
    (Mesh.vocab_shard) and passes it down as the model functions' `shard`
    argument; None reads the leaves whole."""

    m: int
    model: int
    size: int
    group: object

    @property
    def lo(self) -> int:
        return self.m * self.size

    def local_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """ids re-based to this shard, -1 for an id in another shard."""
        local = ids.long() - self.lo
        return torch.where((local >= 0) & (local < self.size), local, -1)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the model group, in place."""
        return _all_reduce(t, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(model, *t.shape): every shard's t, in shard order."""
        return _all_gather(t, self.group, self.model)


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; the backward passes the (replicated)
    gradient through to each rank's own part."""

    @staticmethod
    def forward(ctx, x, shard):
        return shard.sum(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(x: torch.Tensor, shard: VocabShard) -> torch.Tensor:
    return _ReduceFromModel.apply(x, shard)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid and its two groups (None
    without a process group)."""

    data: int
    model: int
    d: int
    m: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.d * self.model + self.m

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def vocab_shard(self, vocab_size: int) -> VocabShard | None:
        """This rank's vocab shard, or None where the vocab leaves are
        replicated (model axis 1, or a vocab it does not divide)."""
        if self.model == 1 or vocab_size % self.model:
            return None
        return VocabShard(self.m, self.model, vocab_size // self.model,
                          self.model_group)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the data group, in place."""
        if self.data_group is not None:
            _all_reduce(t, self.data_group)
        return t

    def count(self, c: torch.Tensor) -> torch.Tensor:
        """The global batch's count of which c is this rank's share: the
        `denominator` of the losses (models/model.py)."""
        return self.sum_data(c.detach().clone())

    def gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """(data, *t.shape): every data rank's t, in data order."""
        if self.data_group is None:
            return t[None]
        return _all_gather(t, self.data_group, self.data)

    @property
    def data_shard(self) -> tuple[int, int] | None:
        """(d, data), the loaders' `shard` of this rank; None without a data
        axis."""
        return (self.d, self.data) if self.data > 1 else None

    def dialog_slice(self, dialogs: int) -> tuple[int, int] | None:
        """This data rank's dialogs [lo, hi) of an assembled batch, or None
        without a data axis or where it does not divide the batch (the
        batch is then scored whole on every rank)."""
        if self.data == 1 or dialogs % self.data:
            return None
        n = dialogs // self.data
        return self.d * n, (self.d + 1) * n

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()


def add_mesh_args(p) -> None:
    """The CLIs' --mesh_data / --mesh_model (the train CLI has them as
    Config fields)."""
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="data axis of the process grid (-1 fills the world)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model axis (the vocab-sharded leaves)")


def init_world(device="cuda") -> torch.device:
    """Join the process group torchrun describes (WORLD_SIZE > 1), unless
    the caller made one; returns this rank's device: cuda:LOCAL_RANK in a
    group on the card, else `device` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to "
                         "run the plain versions on the CPU)")
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized() and dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def make_mesh(data: int = -1, model: int = 1, device="cuda") -> Mesh:
    """The (data, model) grid over the world (mesh.py::make_mesh): data=-1
    fills it.  A model axis that does not divide the world fails fast, and
    a grid that is not the whole world exits, naming the torchrun launch
    that fits it."""
    with trace.span("mesh.init"):              # the process group
        dev = init_world(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model < 1:
        raise SystemExit(f"mesh_model={model}: the model axis needs >= 1 rank")
    if data == -1:
        if world % model:
            raise SystemExit(f"model={model} does not divide the {world} "
                             f"processes; pass an explicit --mesh_data")
        data = world // model
    n = data * model
    if n != world:
        raise SystemExit(
            f"mesh {data}x{model} needs {n} processes and {world} run: launch "
            f"it with torchrun --nproc_per_node {n} (a process group cannot "
            f"leave a rank idle; to resume on fewer cards, launch fewer "
            f"processes)")
    d, m = divmod(rank, model)
    data_group = model_group = None
    if dist.is_initialized():
        with trace.span("mesh.init"):          # the groups, communicators
            # every rank makes every group, in the same order
            for mm in range(model):
                g = dist.new_group([dd * model + mm for dd in range(data)])
                data_group = g if mm == m else data_group
            for dd in range(data):
                g = dist.new_group([dd * model + mm for mm in range(model)])
                model_group = g if dd == d else model_group
            # each group's communicator, made before any graph captures one
            # of its collectives (every data group first, then every model
            # group: no rank waits on a group whose members wait on it)
            for g in (data_group, model_group):
                dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return Mesh(data, model, d, m, dev, data_group, model_group)


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------

def param_pspec(path: str, ndim: int) -> tuple:
    """The sharding rule of one leaf by tree path (mesh.py::param_pspec):
    the axis name per dimension, () for replicated."""
    if path.endswith("embed/table") and ndim == 2:
        return ("model", None)
    if path.endswith("out_proj/w") and ndim == 2:
        return (None, "model")
    if path.endswith("out_proj/b") and ndim == 1:
        return ("model",)
    return ()


def param_layout(path: str, shape: tuple, mesh: Mesh) -> int | None:
    """The dimension of a leaf of `shape` (its whole shape) split over the
    model axis, or None where it is replicated: by param_pspec, degraded
    to replicated where the model axis does not divide the dimension
    (mesh.py::tree_shardings)."""
    for dim, axis in enumerate(param_pspec(path, len(shape))):
        if axis == "model" and mesh.model > 1 and shape[dim] % mesh.model == 0:
            return dim
    return None


def param_layouts(cfg, mesh: Mesh) -> dict[str, int]:
    """{tree path: split dimension} of cfg's model's sharded leaves."""
    from ..utils.params import param_shapes

    out = {}
    for path, shape in param_shapes(cfg).items():
        dim = param_layout(path, shape, mesh)
        if dim is not None:
            out[path] = dim
    return out


def shard_tree(tree, cfg, mesh: Mesh):
    """Whole leaves -> this rank's shards of the sharded ones (params, or
    optimizer moments that mirror them)."""
    from ..utils.params import flatten, unflatten

    lay = param_layouts(cfg, mesh)
    flat = flatten(tree)
    return unflatten({k: (v.chunk(mesh.model, lay[k])[mesh.m].contiguous()
                          if k in lay and v.numel() else v)
                      for k, v in flat.items()})


def gather_tree(tree, cfg, mesh: Mesh):
    """This rank's shards -> whole leaves, gathered over the model group
    (every rank of it must call)."""
    from ..utils.params import flatten, unflatten

    lay = param_layouts(cfg, mesh)
    return unflatten({k: (torch.cat(_all_gather(v, mesh.model_group,
                                                mesh.model).unbind(), dim=lay[k])
                          if k in lay and v.numel() else v)
                      for k, v in flatten(tree).items()})


def broadcast_tree(tree, mesh: Mesh):
    """Every leaf set to rank 0's, in place (no-op without a group)."""
    from ..utils.params import flatten

    if dist.is_initialized():
        for k in sorted(flat := flatten(tree)):
            dist.broadcast(flat[k], src=0)
    return tree


# ---------------------------------------------------------------------------
# gradients and batches
# ---------------------------------------------------------------------------

def all_reduce_grads(flat: dict, mesh: Mesh) -> dict:
    """{path: gradient} summed over the data group in flat buckets of about
    BUCKET_BYTES, leaves in sorted path order."""
    if mesh.data_group is None:
        return flat
    out, bucket, size = {}, [], 0

    def flush():
        buf = _all_reduce(torch.cat([flat[k].reshape(-1) for k in bucket]),
                          mesh.data_group)
        for k, piece in zip(bucket, buf.split([flat[k].numel() for k in bucket])):
            out[k] = piece.view_as(flat[k])
        bucket.clear()

    for k in sorted(flat):
        bucket.append(k)
        size += flat[k].numel() * flat[k].element_size()
        if size >= BUCKET_BYTES:
            flush()
            size = 0
    if bucket:
        flush()
    return out


def sum_sharded_squares(sq: dict, sharded, mesh: Mesh) -> dict:
    """Per-leaf squared gradient norms with each sharded leaf's summed over
    the model group, so the global norm counts every shard once and every
    replicated leaf once."""
    keys = [k for k in sorted(sq) if k in sharded]
    if not keys or mesh.model_group is None:
        return sq
    buf = _all_reduce(torch.stack([sq[k] for k in keys]), mesh.model_group)
    return {**sq, **dict(zip(keys, buf.unbind()))}


def slice_dialogs(batch: dict, lo: int, hi: int) -> dict:
    """Dialogs [lo, hi) of an assembled batch.  Every key must lead with the
    dialog axis: opt_uniq and opt_row (the deduplicated candidate rows and
    their gather map into them) are refused, since a slice of the gather
    map points into rows another slice holds -- a data rank assembles its
    own shard of a train batch instead (the loaders' `shard`)."""
    dialogs = None
    for k, v in batch.items():
        if k in NO_DIALOG_AXIS:
            raise ValueError(f"slice_dialogs: {k!r} does not lead with the "
                             "dialog axis; assemble the shard instead")
        n = np.shape(v)[0]
        if dialogs is not None and n != dialogs:
            raise ValueError(f"slice_dialogs: {k!r} leads with {n}, the "
                             f"batch's other keys with {dialogs} dialogs")
        dialogs = n
    return {k: v[lo:hi] for k, v in batch.items()}
