"""Parameter initialization and elementary modules (port of
visdial_tpu/models/core.py).

Params are nested dicts of tensors keyed like the JAX pytree, so that
checkpoints cross between the packages by tree path (utils/params.py).
Init: uniform(-0.08, 0.08) everywhere from a seeded CPU torch.Generator
(the JAX package draws from jax.random, so the two inits agree in
distribution, not in values), LSTM forget-gate bias 1.0, embedding row 0
zero.

Dropout draws its masks from an explicit torch.Generator on the tensor's
device, never from the global generators, and always outside the kernels
(the kernels take the drawn masks' effect as their input), so the kernel
path and the plain path draw the same masks from the same generator state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.contract import mm_f32
from ..ops.lstm import keep_mask, uniform
from ..parallel.mesh import VocabShard, reduce_from_model


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                device="cpu") -> dict:
    return {"w": uniform(gen, (in_dim, out_dim), device),
            "b": torch.zeros(out_dim, device=device)}


def linear(params: dict, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Mixed-precision linear (core.py::linear): weights cast to the
    activation dtype, f32 accumulation (ops/contract.py), output in
    `out_dtype` (default: the activation dtype)."""
    y = mm_f32(x, params["w"].to(x.dtype)) + params["b"].float()
    return y.to(out_dtype or x.dtype)


def embedding_init(gen: torch.Generator, vocab_size: int, embed_size: int,
                   device="cpu") -> dict:
    table = uniform(gen, (vocab_size, embed_size), device)
    table[0] = 0.0   # pad row (lookups mask it to zero regardless)
    return {"table": table}


def embed(params: dict, tokens: torch.Tensor,
          shard: VocabShard | None = None) -> torch.Tensor:
    """Zero-masked lookup (core.py::embed): pad token 0 embeds to zero.

    With a vocab shard (parallel/mesh.py::VocabShard) the table holds this
    rank's rows only: ids in another shard look up zero rows, and the rows
    are summed over the model group, whose backward keeps each rank's own
    rows' gradient."""
    if shard is None:
        vecs = F.embedding(tokens, params["table"])
        return vecs * (tokens != 0)[..., None].to(vecs.dtype)
    local = shard.local_ids(tokens)
    vecs = F.embedding(local.clamp(min=0), params["table"])
    vecs = vecs * ((local >= 0) & (tokens != 0))[..., None].to(vecs.dtype)
    return reduce_from_model(vecs, shard)


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator | None,
            train: bool = True) -> torch.Tensor:
    """Inverted dropout (core.py::dropout): where(keep, x / keep_prob, 0),
    the mask drawn from `gen` (a generator on x's device)."""
    if not train or rate <= 0.0 or gen is None:
        return x
    return torch.where(keep_mask(gen, x.shape, rate), x / (1.0 - rate), 0.0)


def split_seeds(gen: torch.Generator, n: int = 2) -> list[int]:
    """n seeds drawn from the CPU generator `gen` (the role of
    jax.random.split): each seeds a generator made where it is used, so a
    recomputation (remat) can rebuild the same draws."""
    return torch.randint(0, 2 ** 62, (n,), generator=gen).tolist()


def seeded(seed: int | None, device) -> torch.Generator | None:
    """A generator on `device` seeded with `seed` (None for None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


class StepGenerators(NamedTuple):
    """A train step's dropout generators on the device, made and seeded
    already, which models/model.py::model_loss takes in place of the CPU
    generator whose seeds would make them (`seeded`).  Under cfg.remat the
    encoder's recomputation draws from `recompute`, seeded with the
    encoder's seed, so it redraws the forward's masks.  A captured step
    (parallel/train_step.py) keeps them across replays and re-seeds them
    from the state's generator before each."""
    encoder: torch.Generator
    decoder: torch.Generator
    recompute: torch.Generator | None = None
