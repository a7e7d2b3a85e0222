"""The training step (port of visdial_tpu/parallel/train_step.py, one
device): loss and gradients, global clip, optimizer update, LR decay.

The state carries a CPU torch.Generator in place of the JAX key; each step
draws its dropout seeds from it (models/model.py::model_loss), so the
generator advances in place and the returned state holds the same object.
Mesh sharding and the batch-adaptive jit are multi-device and not ported
yet (ROADMAP.md, M10).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config

from ..models.decoders import gen_score_rows
from ..models.model import model_init, model_loss
from ..utils.params import flatten, unflatten
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


def loss_and_grads(params: dict, batch: dict, cfg: Config,
                   gen: torch.Generator | None, impl: str | None = None,
                   loss_fn=model_loss):
    """(loss, grads) of loss_fn (model_loss, or models/model.py::
    model_dense_loss for dense fine-tuning) in train mode; grads mirror
    params."""
    flat = {k: v.detach().requires_grad_() for k, v in flatten(params).items()}
    loss = loss_fn(unflatten(flat), batch, cfg, train=True, gen=gen,
                   impl=impl)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), unflatten(dict(zip(flat, grads)))


def train_step(state: TrainState, batch: dict, cfg: Config,
               impl: str | None = None, loss_fn=model_loss):
    """One optimizer step of loss_fn.  Returns (new_state, metrics): loss,
    lr, grad_norm (device tensors or floats) and step."""
    loss, grads = loss_and_grads(state.params, batch, cfg, state.gen, impl,
                                 loss_fn)
    lr = lr_at_step(state.opt.step, cfg)
    params, opt, gnorm = apply_updates(state.params, grads, state.opt, lr, cfg)
    metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, "step": opt.step}
    return TrainState(params, opt, state.gen), metrics


def multi_train_step(state: TrainState, batches: dict, cfg: Config,
                     impl: str | None = None, loss_fn=model_loss):
    """G optimizer steps in one call over a stack of G batches (leading
    axis of every array), the counterpart of the JAX lax.scan.  Returns
    (state, metrics) with every metric stacked to (G,)."""
    G = len(next(iter(batches.values())))
    rows = []
    for g in range(G):
        state, m = train_step(state, {k: v[g] for k, v in batches.items()},
                              cfg, impl, loss_fn)
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
