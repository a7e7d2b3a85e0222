"""Training steps and retrieval ranks of the reference.

`train` follows the program's first steps: the same weights, dialogs and
dropout seeds, each step's loss over the global batch (on a data axis of D
ranks the sum of each rank's shard, its own masks, over the global count),
its gradients by autograd, the global-norm clip, then Adam at the step's
decayed learning rate.  `ranks` scores every round of a split against its
100 candidates through the option table and returns each ground truth's
rank, ties counted in its favour (1 + the candidates that score higher).
"""

from __future__ import annotations

import numpy as np
import torch

from ..weights import nest
from . import data, dropout, model


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a, device):
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int64)).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def step_loss(ops, p, config, split, idx, enc_seed, dec_seed, ranks, device,
              tokens):
    """The global batch's loss (a 0-dim tensor) over dialogs idx."""
    rate = config["dropout"]
    R, K, La = (config["num_rounds"], config["num_options"],
                config["max_ans_len"])
    per = len(idx) // ranks
    total, count = 0.0, 0.0
    for d in range(ranks):
        sidx = idx[d * per:(d + 1) * per]
        n = per * R
        b = {k: _t(v, device) for k, v in
             data.encoder_batch(split, sidx, config).items()}
        masks = (dropout.encoder_masks(enc_seed + d, n, config, device)
                 if rate > 0 else None)
        joint = model.encode(ops, p, b, rate, masks)
        if config["decoder"] == "disc":
            if config.get("disc_dedup_options", True):
                uniq, rows = data.disc_candidates(split, sidx)
            else:                      # every candidate its own row
                uniq = split["opt_list"][split["opt_inds"][sidx].reshape(-1)]
                rows = np.arange(n * K).reshape(n, K)
            keep = (dropout.decoder_mask(dec_seed + d, n * K, La, config,
                                         device)[:len(uniq)]
                    if rate > 0 else None)
            emb = model.option_states(ops, p, _t(uniq, device), keep, rate)
            gt = _t(split["gt_ind"][sidx].reshape(-1), device)
            total = total + model.disc_nll(ops, joint, emb, _t(rows, device),
                                           gt).sum()
            count += n
        else:
            ans_in, ans_out = data.gen_targets(split, sidx, *tokens)
            keep = (dropout.decoder_mask(dec_seed + d, n, La + 1, config,
                                         device) if rate > 0 else None)
            s, c = model.gen_nll(ops, p, joint, _t(ans_in, device),
                                 _t(ans_out, device), keep, rate)
            total, count = total + s, count + c
    return total / count


def train(config: dict, split: dict, params: dict, steps: list,
          dropout_seed: int, *, ranks: int = 1, precision: str = "f32",
          device="cpu", tokens=(0, 0)) -> dict:
    """Follow len(steps) optimizer steps, steps[s] the dialogs of step s.
    params: {path: tensor} at the start.  tokens: (<START>, <END>) for gen.
    Returns {"loss": [...], "params": {path: tensor}, "m": {path: tensor}}
    (the first moments: the clipped gradients as Adam accumulated them)."""
    _exact()
    ops = model.Ops(precision)
    flat = {k: v.detach().to(device, torch.float32).clone()
            for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    seeds = dropout.step_seeds(torch.Generator().manual_seed(dropout_seed),
                               len(steps))
    b1, b2, eps = config["adam_beta1"], config["adam_beta2"], config["adam_eps"]
    losses = []
    for s, idx in enumerate(steps):
        leaves = {k: x.requires_grad_() for k, x in flat.items()}
        loss = step_loss(ops, nest(leaves), config, split, np.asarray(idx),
                         *seeds[s], ranks, device, tokens)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(config["grad_clip"] / torch.clamp(norm, min=1e-12),
                                max=1.0)
            lr = float(torch.maximum(
                _f32(config["learning_rate"])
                * _f32(config["lr_decay_rate"]) ** _f32(float(s)),
                _f32(config["min_lr"])))
            t = _f32(float(s + 1))
            mh = float(1.0 / (1.0 - _f32(b1) ** t))
            vh = float(1.0 / (1.0 - _f32(b2) ** t))
            for k in flat:
                g = grads[k] * scale
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                flat[k] = (flat[k].detach() - lr * (m[k] * mh)
                           / (torch.sqrt(v2[k] * vh) + eps))
    return {"loss": losses, "params": flat, "m": m}


@torch.no_grad()
def ranks(config: dict, split: dict, params: dict, *, precision: str = "f32",
          device="cpu", block: int = 512, table_block: int = 16384,
          bands=()) -> tuple[np.ndarray, dict]:
    """Ground-truth rank of every round (N * R,) in dialog order, and for
    each fraction a in `bands` the band of ranks (lo, hi) the ground truth
    takes when every score may move by a times the round's largest score
    magnitude: lo counts the candidates above it by more than that, hi
    those not below it by more than that."""
    _exact()
    ops = model.Ops(precision)
    p = nest({k: v.to(device, torch.float32) for k, v in params.items()})
    opt_list = split["opt_list"]
    table = torch.cat([
        model.option_states(ops, p, _t(opt_list[lo:lo + table_block], device))
        for lo in range(0, len(opt_list), table_block)])
    out, band = [], {a: ([], []) for a in bands}
    n = len(split["gt_ind"])
    for lo in range(0, n, block):
        idx = np.arange(lo, min(lo + block, n))
        b = {k: _t(v, device) for k, v in
             data.encoder_batch(split, idx, config).items()}
        joint = model.encode(ops, p, b)
        cand = table[_t(split["opt_inds"][idx].reshape(len(idx) * config["num_rounds"], -1),
                        device)]
        scores = ops.bmm(cand, joint[:, :, None])[..., 0]
        gt = _t(split["gt_ind"][idx].reshape(-1), device)
        gt_score = scores.gather(1, gt[:, None])
        out.append((1 + (scores > gt_score).sum(dim=1)).cpu().numpy())
        tol = scores.abs().amax(dim=1, keepdim=True)
        for a in bands:
            lo = 1 + (scores > gt_score + a * tol).sum(dim=1)
            hi = (scores >= gt_score - a * tol).sum(dim=1)
            band[a][0].append(lo.cpu().numpy())
            band[a][1].append(hi.cpu().numpy())
    return np.concatenate(out), {a: (np.concatenate(lo), np.concatenate(hi))
                                 for a, (lo, hi) in band.items()}
