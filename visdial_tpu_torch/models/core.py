"""Parameter initialization and elementary modules (port of
visdial_tpu/models/core.py).

Params are nested dicts of tensors keyed like the JAX pytree, so that
checkpoints cross between the packages by tree path (utils/params.py).
Init: uniform(-0.08, 0.08) everywhere from a seeded CPU torch.Generator
(the JAX package draws from jax.random, so the two inits agree in
distribution, not in values), LSTM forget-gate bias 1.0, embedding row 0
zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.lstm import uniform


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                device="cpu") -> dict:
    return {"w": uniform(gen, (in_dim, out_dim), device),
            "b": torch.zeros(out_dim, device=device)}


def linear(params: dict, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Mixed-precision linear (core.py::linear): weights cast to the
    activation dtype, f32 accumulation, output in `out_dtype` (default: the
    activation dtype)."""
    y = x.float() @ params["w"].to(x.dtype).float() + params["b"].float()
    return y.to(out_dtype or x.dtype)


def embedding_init(gen: torch.Generator, vocab_size: int, embed_size: int,
                   device="cpu") -> dict:
    table = uniform(gen, (vocab_size, embed_size), device)
    table[0] = 0.0   # pad row (lookups mask it to zero regardless)
    return {"table": table}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Zero-masked lookup (core.py::embed): pad token 0 embeds to zero."""
    vecs = F.embedding(tokens, params["table"])
    return vecs * (tokens != 0)[..., None].to(vecs.dtype)
