"""Dialog encoders (port of visdial_tpu/models/encoders.py).

Ported: the Memory Network family (mn-ques-im-hist, mn-ques-hist) with the
fc7 image feature, in eval and train mode.  Shapes as in the reference:
B dialogs, R rounds, N = B*R rows, H hidden, E embed.  Facts (caption,
QA_1, ...) are embedded once per dialog and every round attends over slots
0..t of them.  init covers every family, so checkpoints of any encoder load;
the other families' forward passes raise NotImplementedError.
"""

from __future__ import annotations

import torch

from ..config import (Config, encoder_family, encoder_uses_history,
                      encoder_uses_image)

from ..ops.attention import masked_slot_attention
from ..ops.attention_cuda import AttentionFn, attention_fusion
from ..ops.lstm import lstm_init, lstm_keep_masks, masked_lstm
from .core import dropout, embed, linear, linear_init


def _dt(cfg: Config) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _run_lstm(lstm_params, embed_params, tokens, cfg: Config, impl,
              train: bool = False, gen: torch.Generator | None = None):
    """Embed right-aligned tokens (N, L), run the masked LSTM (inter-layer
    dropout in train mode, masks drawn from `gen`), return the top layer's
    final h (N, H) in the compute dtype."""
    vecs = embed(embed_params, tokens).to(_dt(cfg))
    mask = (tokens != 0).to(vecs.dtype)
    rate = cfg.dropout if train and gen is not None else 0.0
    keep = None
    if rate > 0.0:
        H = lstm_params["layers"][0]["w"].shape[1] // 4
        keep = lstm_keep_masks(gen, len(lstm_params["layers"]),
                               tokens.shape + (H,), rate)
    _, (h_fin, _) = masked_lstm(lstm_params, vecs, mask, impl=impl,
                                dropout_rate=rate, keep_masks=keep)
    return h_fin[-1]


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


def check_ported(cfg: Config) -> None:
    """Raise NotImplementedError for an encoder this port cannot run yet."""
    if encoder_family(cfg.encoder) != "mn" or cfg.img_spatial:
        raise NotImplementedError(
            f"encoder {cfg.encoder!r}{' with img_spatial' if cfg.img_spatial else ''}"
            " is not ported yet: only the MN family with fc7 image features "
            "is (see ROADMAP.md, queue 1)")


def encoder_apply(params: dict, embed_params: dict, batch: dict, cfg: Config,
                  *, train: bool = False, gen: torch.Generator | None = None,
                  impl: str = "plain") -> torch.Tensor:
    """Encode a batch to joint embeddings (N, H), N = B*R
    (encoders.py::encoder_apply).  With train and a generator `gen` (on the
    batch's device) dropout is drawn from it in this order: the question
    LSTM's inter-layer masks, the fact LSTM's, then the [query; ctx] concat
    mask.  impl='cuda' runs the LSTMs through kernels K1 (and K2 in the
    backward), the attention through K3 followed by the unfused fusion in
    train mode, and the attention + fusion tail through K4 in eval mode;
    impl='plain' runs the plain versions with the unfused chain attention
    -> concat -> fusion -> tanh."""
    check_ported(cfg)
    B, R = batch["ques"].shape[:2]
    dt = _dt(cfg)

    q = _run_lstm(params["ques_lstm"], embed_params,
                  batch["ques"].reshape(B * R, -1), cfg, impl, train,
                  gen)                                               # (N, H)
    facts = _run_lstm(params["fact_lstm"], embed_params,
                      batch["facts"].reshape(B * R, -1), cfg, impl, train,
                      gen).reshape(B, R, -1)                         # (B, R, H)

    if encoder_uses_image(cfg.encoder):
        img = linear(params["img_proj"], batch["img"].to(dt))        # (B, H)
        img = img.repeat_interleave(R, dim=0)                        # (N, H)
        query = torch.tanh(linear(params["query_fusion"],
                                  torch.cat([q, img], dim=-1)))
    else:
        query = q
    query_r = query.reshape(B, R, -1)

    # causal slot mask: round t sees fact slots 0..t
    slot = torch.arange(R, device=query.device)
    valid = (slot[None, :] <= slot[:, None]).to(facts.dtype)
    valid = valid[None].expand(B, R, R)

    if impl == "cuda" and not train:
        joint = attention_fusion(query_r.contiguous(), facts.contiguous(), valid,
                                 params["fusion"]["w"], params["fusion"]["b"])
        return joint.reshape(B * R, -1)
    if impl == "cuda":
        mem = AttentionFn.apply(query_r.contiguous(), facts.contiguous(), valid)
    else:
        mem = masked_slot_attention(query_r, facts, valid)
    cat = torch.cat([query, mem.reshape(B * R, -1)], dim=-1)
    cat = dropout(cat, cfg.dropout, gen, train)
    return torch.tanh(linear(params["fusion"], cat))
