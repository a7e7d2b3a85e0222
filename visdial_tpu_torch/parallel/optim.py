"""Optimizers as functions over the params tree (port of
visdial_tpu/parallel/optim.py).

State mirrors the params: nested dicts of tensors keyed like the JAX tree,
so a checkpoint stores the moments by tree path exactly as the JAX package
does (which is why torch.optim is not used).  Updates are functional: new
tensors, never in place.  Step-dependent scalars (the learning rate, Adam's
bias corrections) are computed in float32, as JAX computes them, on the host;
a captured step (parallel/train_step.py's factories) reads the same floats
from a device buffer (step_scalars), since a graph would freeze a Python
number at its capture value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config

from ..utils.params import flatten, unflatten


class OptState(NamedTuple):
    step: int        # optimizer steps taken
    m: dict          # first moment / momentum, mirrors params
    v: dict          # second moment, mirrors params ((0,) leaves for sgd)


def tree_map(fn, *trees):
    """fn over the leaves of trees of one structure (nested dicts/lists)."""
    flats = [flatten(t) for t in trees]
    return unflatten({k: fn(*(f[k] for f in flats)) for k in flats[0]})


def init_opt_state(params: dict, cfg: Config) -> OptState:
    zeros = tree_map(torch.zeros_like, params)
    if cfg.optimizer == "sgd":
        return OptState(0, zeros, tree_map(
            lambda p: torch.zeros((0,), device=p.device), params))
    return OptState(0, zeros, tree_map(torch.zeros_like, params))


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def clip_by_global_norm(grads: dict, max_norm: float, sq_sums=None):
    """Scale every leaf (the embedding table's dense gradient included) so
    the global L2 norm is at most max_norm.  Returns (grads, norm), the norm
    a 0-dim float32 tensor on the grads' device.  sq_sums, where given, maps
    {path: the leaf's squared norm} to the whole model's (a sharded leaf's
    summed over its shards: parallel/mesh.py::sum_sharded_squares)."""
    flat = flatten(grads)
    sq = {k: torch.sum(torch.square(flat[k])) for k in sorted(flat)}
    if sq_sums is not None:
        sq = sq_sums(sq)
    gnorm = torch.sqrt(sum(sq[k] for k in sorted(sq)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def adam_scales(step: int, cfg: Config) -> tuple[float, float]:
    """Adam's bias corrections (1 / (1 - b1^t), 1 / (1 - b2^t)) at the
    post-increment step t, in float32."""
    t = _f32(float(step))
    return (float(1.0 / (1.0 - _f32(cfg.adam_beta1) ** t)),
            float(1.0 / (1.0 - _f32(cfg.adam_beta2) ** t)))


def apply_updates(params: dict, grads: dict, state: OptState, lr,
                  cfg: Config, sq_sums=None, scales=None):
    """One optimizer step.  Returns (new_params, new_state, grad_norm);
    sq_sums as in clip_by_global_norm.  lr is a float or a 0-dim float32
    tensor on the params' device; `scales`, where given, are Adam's
    (mhat_scale, vhat_scale) as such tensors (a captured step's, from
    step_scalars), else adam_scales of the step."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, sq_sums)
    step = state.step + 1

    if cfg.optimizer == "adam":
        b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_eps
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state.v, grads)
        mhat_scale, vhat_scale = (adam_scales(step, cfg) if scales is None
                                  else scales)
        new_params = tree_map(
            lambda p, m_, v_: p - lr * (m_ * mhat_scale)
            / (torch.sqrt(v_ * vhat_scale) + eps),
            params, m, v)
        return new_params, OptState(step, m, v), gnorm

    if cfg.optimizer == "rmsprop":
        alpha, eps = 0.99, 1e-8
        v = tree_map(lambda v_, g: alpha * v_ + (1 - alpha) * g * g,
                     state.v, grads)
        new_params = tree_map(lambda p, g, v_: p - lr * g / (torch.sqrt(v_) + eps),
                              params, grads, v)
        return new_params, OptState(step, state.m, v), gnorm

    # sgd with momentum 0.9 (the JAX package's documented choice)
    m = tree_map(lambda m_, g: 0.9 * m_ + g, state.m, grads)
    new_params = tree_map(lambda p, m_: p - lr * m_, params, m)
    return new_params, OptState(step, m, state.v), gnorm


def lr_at_step(step: int, cfg: Config) -> float:
    """Multiplicative per-step decay with a floor, in float32, at the
    pre-increment step (optim.py::lr_at_step)."""
    lr = _f32(cfg.learning_rate) * _f32(cfg.lr_decay_rate) ** _f32(float(step))
    return float(torch.maximum(lr, _f32(cfg.min_lr)))


def step_scalars(step: int, count: int, cfg: Config) -> torch.Tensor:
    """(count, 3) float32: [lr_at_step, mhat_scale, vhat_scale] of the
    `count` optimizer steps from `step` (the pre-increment count), the
    floats the eager step computes (lr_at_step, adam_scales), which float32
    holds exactly.  A captured step reads them from the device, so its
    updates are the eager step's bit for bit."""
    return torch.tensor([[lr_at_step(step + g, cfg), *adam_scales(step + g + 1, cfg)]
                         for g in range(count)], dtype=torch.float32)
