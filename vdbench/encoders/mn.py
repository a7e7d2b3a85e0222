"""The memory-network encoder family (MN; Das et al., "Visual Dialog",
CVPR 2017, MN-QIH with train.lua's options): its weights, the reference's
batches, dropout masks and forward, and the operations it feeds.

The encoder:
  * a stacked LSTM over each right-aligned question and each per-round
    fact (slot 0 the caption; slot j the question + answer of round j - 1,
    each cut to the fact width), its state carried through pad steps, the
    top layer's last state kept;
  * the fc7 image, L2-normalised, projected to H and fused with the
    question state: query = tanh(W [q; img] + b);
  * attention over the fact slots 0..t of round t: softmax of the
    unscaled dot products, then joint = tanh(W [query; memory] + b).
Dropout falls on the first LSTM layer's outputs of the question and fact
LSTMs and on [query; memory].
"""

from __future__ import annotations

import numpy as np
import torch

from vdbench import weights, work
from vdbench.reference import data, dropout, model

NEG = -1e30


def _fact_width(config: dict) -> int:
    return max(config["max_cap_len"],
               config["max_ques_len"] + config["max_ans_len"])


def weight_shapes(config: dict) -> dict:
    E, H, F = (config["embed_size"], config["rnn_hidden_size"],
               config["img_feat_size"])
    out = {**weights.lstm_shapes("encoder/ques_lstm", E, config),
           **weights.lstm_shapes("encoder/fact_lstm", E, config)}
    if "-im" in config["encoder"]:
        out.update(weights.linear_shapes("encoder/img_proj", F, H))
        out.update(weights.linear_shapes("encoder/query_fusion", 2 * H, H))
    out.update(weights.linear_shapes("encoder/fusion", 2 * H, H))
    return out


def facts(split: dict, idx: np.ndarray, width: int):
    """Per-dialog facts (B, R, width) right-aligned: slot 0 the caption,
    slot j the question and answer of round j - 1, each cut to width."""
    q, ql = split["ques"][idx], split["ques_len"][idx]
    a, al = split["ans"][idx], split["ans_len"][idx]
    B, R, Lq = q.shape
    La = a.shape[-1]
    qa = np.zeros((B, R - 1, Lq + La), np.int32)
    qa[..., :Lq] = q[:, :R - 1]
    pos = ql[:, :R - 1, None] + np.arange(La)
    real = np.arange(La) < al[:, :R - 1, None]
    b_i, r_i, k_i = np.nonzero(real)
    qa[b_i, r_i, pos[b_i, r_i, k_i]] = a[:, :R - 1][b_i, r_i, k_i]
    out = np.zeros((B, R, width), np.int32)
    lens = np.zeros((B, R), np.int32)
    cap, cl = split["cap"][idx], split["cap_len"][idx]
    w = min(width, cap.shape[1])
    out[:, 0, :w] = cap[:, :w]
    lens[:, 0] = np.minimum(cl, width)
    w = min(width, Lq + La)
    out[:, 1:, :w] = qa[..., :w]
    lens[:, 1:] = np.minimum(ql[:, :R - 1] + al[:, :R - 1], width)
    return data.right_align(out, lens), lens


def encoder_batch(split: dict, idx: np.ndarray, config: dict) -> dict:
    """The encoder's inputs of dialogs idx: ques and facts right-aligned,
    the image L2-normalised."""
    f, _ = facts(split, idx, _fact_width(config))
    return {"ques": data.right_align(split["ques"][idx], split["ques_len"][idx]),
            "facts": f, "img": data.image(split, idx, config)}


def encoder_masks(seed: int, n: int, config: dict, device) -> dict:
    """The question LSTM's (n, Lq, H), the fact LSTM's (n, Lf, H), then
    [query; memory]'s (n, 2H), from one generator seeded with `seed`."""
    H, rate = config["rnn_hidden_size"], config["dropout"]
    g = torch.Generator(device=device).manual_seed(seed)
    return {"ques": dropout.keep(g, (n, config["max_ques_len"], H), rate),
            "fact": dropout.keep(g, (n, _fact_width(config), H), rate),
            "cat": dropout.keep(g, (n, 2 * H), rate)}


def encode(ops: model.Ops, p: dict, b: dict, rate: float = 0.0,
           masks: dict | None = None) -> torch.Tensor:
    """joint (B * R, H); b holds ques (B, R, Lq) and facts (B, R, Lf)
    right-aligned, img (B, F) normalised; masks the keep masks "ques",
    "fact" (N, L, H) and "cat" (N, 2H) at `rate`."""
    enc = p["encoder"]
    B, R, Lq = b["ques"].shape
    N = B * R
    masks = masks or {}
    kq, kf = masks.get("ques"), masks.get("fact")
    q = model.last_state(ops, enc["ques_lstm"]["layers"], p,
                         b["ques"].reshape(N, Lq), model.inner_keep(kq), rate)
    slots = model.last_state(ops, enc["fact_lstm"]["layers"], p,
                             b["facts"].reshape(N, -1), model.inner_keep(kf),
                             rate).reshape(B, R, -1)
    img = model.linear(ops, enc["img_proj"], b["img"]).repeat_interleave(R, dim=0)
    query = torch.tanh(model.linear(ops, enc["query_fusion"],
                                    torch.cat([q, img], dim=-1)))
    qr = query.reshape(B, R, -1)
    scores = ops.bmm(qr, slots.transpose(1, 2))                 # (B, R, R)
    slot = torch.arange(R, device=qr.device)
    scores = torch.where(slot[None, :] <= slot[:, None], scores, NEG)
    mem = ops.bmm(torch.softmax(scores, dim=-1), slots).reshape(N, -1)
    cat = torch.cat([query, mem], dim=-1)
    if masks.get("cat") is not None:
        cat = torch.where(masks["cat"], cat / (1.0 - rate), 0.0)
    return torch.tanh(model.linear(ops, enc["fusion"], cat))


def fact_lengths(split: dict, idx: np.ndarray, config: dict) -> np.ndarray:
    width = _fact_width(config)
    R = config["num_rounds"]
    out = np.empty((len(idx), R), np.int64)
    out[:, 0] = np.minimum(split["cap_len"][idx], width)
    out[:, 1:] = np.minimum(split["ques_len"][idx][:, :R - 1]
                            + split["ans_len"][idx][:, :R - 1], width)
    return out


def encoder_work(config: dict, split: dict, idx: np.ndarray,
                 train: bool) -> work.Work:
    """The question and fact LSTMs (K1, and K2 in training); the model's
    operations besides: img_proj 2 B F H forward and 2 B F H backward (the
    weights' only: the image is data), query_fusion and fusion 2 N 2H H
    each, attention 2 N R H for its scores and 2 N R H for the weighted
    sum, each backward twice its forward."""
    E, H, F, R = (config["embed_size"], config["rnn_hidden_size"],
                  config["img_feat_size"], config["num_rounds"])
    B, N = len(idx), len(idx) * R
    w = work.Work()
    grad = 3.0 if train else 1.0
    for real in (float(split["ques_len"][idx].sum()),
                 float(fact_lengths(split, idx, config).sum())):
        f_ops, f_bytes = work.lstm_fwd(config, real, E)
        w.k1[0] += f_ops
        w.k1[1] += f_bytes
        if train:
            b_ops, b_bytes = work.lstm_bwd(config, real, E)
            w.k2[0] += b_ops
            w.k2[1] += b_bytes
        w.model += grad * f_ops
    dense = 2.0 * N * 2 * H * H * 2 + 4.0 * N * R * H      # fusions, attention
    w.model += grad * dense + (2.0 if train else 1.0) * 2.0 * B * F * H
    return w
