"""Dialog encoders: Late Fusion, HRE, HREA, Memory Network (port of
visdial_tpu/models/encoders.py).

All nine encoders, each with the fc7 image vector or (cfg.img_spatial) the
pool5 map, in eval and train mode.  Shapes as in the reference: B dialogs,
R rounds, N = B*R rows, H hidden, E embed.  The encoder name selects the
family and which inputs (image / history) are fused:
  * LF fuses [q; history; image] in one tanh linear; its history is one
    LSTM pass over the left-aligned dialog read at each round's prefix bound
    (hist_flat / hist_bounds, cfg.lf_hist_incremental) or an LSTM over each
    round's right-aligned history (hist_concat).
  * HRE, HREA and MN embed the facts (caption, QA_1, ...) once per dialog;
    the image fuses into the query.  MN attends over the fact slots 0..t,
    HRE takes a one-layer dialog LSTM's state after slot t, HREA attends
    over that LSTM's outputs 0..t.
"""

from __future__ import annotations

import torch

from ..config import (Config, encoder_family, encoder_uses_history,
                      encoder_uses_image)

from ..ops import attention_cuda
from ..ops.attention import masked_slot_attention
from ..ops.lstm import lstm_init, lstm_keep_masks, masked_lstm
from .core import dropout, embed, linear, linear_init


def _dt(cfg: Config) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _lstm_over(lstm_params, embed_params, tokens, cfg: Config, impl,
               train: bool = False, gen: torch.Generator | None = None,
               shard=None):
    """Embed tokens (N, L) (on `shard`'s rows of the table where given) and
    run the masked LSTM (inter-layer dropout in train mode, masks drawn
    from `gen`).  Returns the top layer's outputs (N, L, H) and the final
    states (h_fin, c_fin), each (layers, N, H), in the compute dtype."""
    vecs = embed(embed_params, tokens, shard).to(_dt(cfg))
    mask = (tokens != 0).to(vecs.dtype)
    rate = cfg.dropout if train and gen is not None else 0.0
    keep = None
    if rate > 0.0:
        H = lstm_params["layers"][0]["w"].shape[1] // 4
        keep = lstm_keep_masks(gen, len(lstm_params["layers"]),
                               tokens.shape + (H,), rate)
    return masked_lstm(lstm_params, vecs, mask, impl=impl, dropout_rate=rate,
                       keep_masks=keep)


def _run_lstm(lstm_params, embed_params, tokens, cfg: Config, impl,
              train: bool = False, gen: torch.Generator | None = None,
              shard=None):
    """_lstm_over on right-aligned tokens (N, L): the top layer's final h
    (N, H)."""
    _, (h_fin, _) = _lstm_over(lstm_params, embed_params, tokens, cfg, impl,
                               train, gen, shard)
    return h_fin[-1]


def _attend(query, slots, valid, impl: str, train: bool):
    """Masked slot attention (B, R, H): K3 through AttentionFn in training
    and alone in eval with impl='cuda', the plain version otherwise."""
    if impl != "cuda":
        return masked_slot_attention(query, slots, valid)
    query, slots = query.contiguous(), slots.contiguous()
    if train:
        return attention_cuda.AttentionFn.apply(query, slots, valid)
    return attention_cuda.masked_slot_attention(query, slots, valid)


def encoder_init(gen: torch.Generator, cfg: Config, device="cpu") -> dict:
    """Same tree as encoders.py::encoder_init, for every family."""
    fam = encoder_family(cfg.encoder)
    use_img = encoder_uses_image(cfg.encoder)
    use_hist = encoder_uses_history(cfg.encoder)
    H, E, L = cfg.rnn_hidden_size, cfg.embed_size, cfg.num_layers
    F = cfg.img_spatial_channels if cfg.img_spatial else cfg.img_feat_size
    p: dict = {"ques_lstm": lstm_init(gen, E, H, L, device)}
    if fam == "lf":
        fusion_in = H
        if use_hist:
            p["hist_lstm"] = lstm_init(gen, E, H, L, device)
            fusion_in += H
        if use_img:
            p["img_proj"] = linear_init(gen, F, H, device)
            fusion_in += H
        p["fusion"] = linear_init(gen, fusion_in, H, device)
    elif fam in ("hre", "hrea", "mn"):
        p["fact_lstm"] = lstm_init(gen, E, H, L, device)
        if fam in ("hre", "hrea"):
            p["dialog_lstm"] = lstm_init(gen, H, H, 1, device)
        if use_img:
            p["img_proj"] = linear_init(gen, F, H, device)
            p["query_fusion"] = linear_init(gen, 2 * H, H, device)
        p["fusion"] = linear_init(gen, 2 * H, H, device)
    else:
        raise ValueError(f"unknown encoder family {fam!r}")
    return p


def _image_pathway(params, batch, q, cfg: Config, B: int, R: int, impl: str,
                   train: bool) -> torch.Tensor:
    """Image feature -> one (N, H) vector per round (encoders.py::
    _image_pathway).  fc7: projected once per dialog and repeated per
    round.  img_spatial: each of the S pool5 locations projected to H and
    attended over with the question state q as the query, every location
    visible (K3 on the kernel path)."""
    dt = _dt(cfg)
    if not cfg.img_spatial:
        img = linear(params["img_proj"], batch["img"].to(dt))        # (B, H)
        return img.repeat_interleave(R, dim=0)                       # (N, H)
    S, C = cfg.img_spatial_slots, cfg.img_spatial_channels
    loc_h = linear(params["img_proj"], batch["img"].reshape(B, S, C).to(dt))
    valid = torch.ones((1, R, S), device=q.device).expand(B, R, S)
    att = _attend(q.reshape(B, R, -1), loc_h, valid, impl, train)    # (B,R,H)
    return att.reshape(B * R, -1)


def _lf_history(params, embed_params, batch, cfg: Config, impl, train, gen,
                B: int, R: int, shard=None) -> torch.Tensor:
    """LF's (N, H) history part.  hist_flat: ONE LSTM pass over each
    dialog's left-aligned concat (B, Lh); round r reads the top layer's
    output at its prefix bound (bounds - 1, clamped), and a round with no
    visible token (bound 0) gets zeros.  hist_concat: the LSTM over every
    round's right-aligned history (B*R, Lh)."""
    if "hist_flat" not in batch:
        return _run_lstm(params["hist_lstm"], embed_params,
                         batch["hist_concat"].reshape(B * R, -1), cfg, impl,
                         train, gen, shard)
    outs, _ = _lstm_over(params["hist_lstm"], embed_params, batch["hist_flat"],
                         cfg, impl, train, gen, shard)        # (B, Lh, H)
    bounds = batch["hist_bounds"]                                    # (B, R)
    idx = (bounds - 1).clamp(0, outs.shape[1] - 1).long()
    h = torch.gather(outs, 1, idx[..., None].expand(B, R, outs.shape[-1]))
    h = torch.where((bounds > 0)[..., None], h, 0.0)
    return h.reshape(B * R, -1)


def encoder_apply(params: dict, embed_params: dict, batch: dict, cfg: Config,
                  *, train: bool = False, gen: torch.Generator | None = None,
                  impl: str = "plain", shard=None) -> torch.Tensor:
    """Encode a batch to joint embeddings (N, H), N = B*R
    (encoders.py::encoder_apply).  The token lookups read `shard`'s rows of
    the embedding table where given (parallel/mesh.py::VocabShard).

    Dropout (train with a generator `gen` on the batch's device) is drawn
    from `gen` in this order, as the JAX encoder consumes its rngs: the
    question LSTM's inter-layer masks; then the history LSTM's (LF) or the
    fact LSTM's (HRE, HREA, MN); then the final concat's mask.  HRE/HREA's
    dialog LSTM takes no dropout, as in the JAX encoder.

    impl='cuda' runs the LSTMs through kernel K1 (and K2 in the backward);
    the attention over fact slots, dialog-LSTM outputs or pool5 locations
    through K3 (AttentionFn in train mode), followed by the unfused concat,
    fusion and tanh; and in eval mode MN's and HREA's attention + fusion
    tail through K4.  impl='plain' runs the plain versions with the unfused
    chain attention -> concat -> fusion -> tanh."""
    fam = encoder_family(cfg.encoder)
    use_img = encoder_uses_image(cfg.encoder)
    B, R = batch["ques"].shape[:2]

    q = _run_lstm(params["ques_lstm"], embed_params,
                  batch["ques"].reshape(B * R, -1), cfg, impl, train,
                  gen, shard)                                        # (N, H)

    if fam == "lf":
        parts = [q]
        if encoder_uses_history(cfg.encoder):
            parts.append(_lf_history(params, embed_params, batch, cfg, impl,
                                     train, gen, B, R, shard).to(q.dtype))
        if use_img:
            parts.append(_image_pathway(params, batch, q, cfg, B, R, impl,
                                        train))
        cat = torch.cat(parts, dim=-1) if len(parts) > 1 else q
        cat = dropout(cat, cfg.dropout, gen, train)
        return torch.tanh(linear(params["fusion"], cat))

    facts = _run_lstm(params["fact_lstm"], embed_params,
                      batch["facts"].reshape(B * R, -1), cfg, impl, train,
                      gen, shard).reshape(B, R, -1)                  # (B, R, H)

    if use_img:
        img = _image_pathway(params, batch, q, cfg, B, R, impl, train)
        query = torch.tanh(linear(params["query_fusion"],
                                  torch.cat([q, img], dim=-1)))
    else:
        query = q
    query_r = query.reshape(B, R, -1)

    if fam == "mn":
        slots = facts
    else:   # hre / hrea: a one-layer dialog LSTM over the fact slots
        ones = torch.ones((B, R), dtype=facts.dtype, device=facts.device)
        slots, _ = masked_lstm(params["dialog_lstm"], facts, ones, impl=impl)
    if fam == "hre":
        # round t's history representation = the dialog state after slot t
        ctx = slots.reshape(B * R, -1)
    else:
        # causal slot mask: round t sees slots 0..t
        slot = torch.arange(R, device=query.device)
        valid = (slot[None, :] <= slot[:, None]).to(slots.dtype)
        valid = valid[None].expand(B, R, R)
        if impl == "cuda" and not train:
            joint = attention_cuda.attention_fusion(
                query_r.contiguous(), slots.contiguous(), valid,
                params["fusion"]["w"], params["fusion"]["b"])
            return joint.reshape(B * R, -1)
        ctx = _attend(query_r, slots, valid, impl, train).reshape(B * R, -1)
    cat = torch.cat([query, ctx], dim=-1)
    cat = dropout(cat, cfg.dropout, gen, train)
    return torch.tanh(linear(params["fusion"], cat))
