"""Answer decoders (port of visdial_tpu/models/decoders.py).

Ported: the discriminative decoder — candidate answers through a shared
option LSTM, score_k = dot(option_k embedding, joint embedding), the 100-way
NLL loss in both batch layouts — and the once-per-pool option-embedding
table the serving path ranks with.
init covers the gen decoder too, so gen checkpoints load; its LM and
decoding are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from visdial_tpu.config import Config

from ..ops.lstm import lstm_init, lstm_keep_masks, masked_lstm
from .core import embed, linear_init

SCORE_CHUNK_ROWS = 8192     # option-table rows per LSTM call

# Row count from which candidate rows are length-sorted before the kernel
# path's LSTM: sorted rows make K1's row tiles length-homogeneous, so its
# per-tile skip of all-pad steps removes most of the pad work.
LENGTH_SORT_MIN_ROWS = 2048


def decoder_init(gen: torch.Generator, cfg: Config, device="cpu") -> dict:
    """Same tree as decoders.py::decoder_init."""
    H, E = cfg.rnn_hidden_size, cfg.embed_size
    if cfg.decoder == "gen":
        return {"lm_lstm": lstm_init(gen, E, H, cfg.num_layers, device),
                "out_proj": linear_init(gen, H, cfg.vocab_size, device)}
    return {"opt_lstm": lstm_init(gen, E, H, cfg.num_layers, device)}


def _length_sorted(tokens: torch.Tensor):
    """(order, rank): a stable permutation sorting rows by descending real
    length, and its inverse (decoders.py::_length_sorted)."""
    lens = (tokens != 0).sum(dim=-1)
    order = torch.argsort(-lens, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return order, rank


def disc_option_embeddings(params, embed_params, opt_tokens, cfg: Config,
                           *, train: bool = False,
                           gen: torch.Generator | None = None, impl="plain"):
    """(N, K, T) candidate tokens -> (N, K, H) final LSTM states.  On the
    kernel path, large row counts go through K1 length-sorted and come back
    in their original order.  In train mode the option LSTM's inter-layer
    dropout masks are drawn from `gen` in the rows' original order and
    sorted with them, so both paths apply the same mask to each row."""
    N, K, T = opt_tokens.shape
    flat = opt_tokens.reshape(N * K, T)
    rate = cfg.dropout if train and gen is not None else 0.0
    keep = None
    if rate > 0.0:
        H = params["opt_lstm"]["layers"][0]["w"].shape[1] // 4
        keep = lstm_keep_masks(gen, len(params["opt_lstm"]["layers"]),
                               (N * K, T, H), rate)
    rank = None
    if impl == "cuda" and N * K >= LENGTH_SORT_MIN_ROWS:
        order, rank = _length_sorted(flat)
        flat = flat[order]
        if keep is not None:
            keep = [m[order] for m in keep]
    vecs = embed(embed_params, flat).to(getattr(torch, cfg.compute_dtype))
    mask = (flat != 0).to(vecs.dtype)
    _, (h_fin, _) = masked_lstm(params["opt_lstm"], vecs, mask, impl=impl,
                                dropout_rate=rate, keep_masks=keep)
    h = h_fin[-1]
    if rank is not None:
        h = h[rank]
    return h.reshape(N, K, -1)


def disc_option_table(params, embed_params, opt_list, cfg: Config, *,
                      impl="plain", chunk: int = SCORE_CHUNK_ROWS):
    """Embed the deduplicated option list once: (M, La) -> (M, H), `chunk`
    rows per LSTM call (decoders.py::disc_option_table)."""
    return torch.cat([
        disc_option_embeddings(params, embed_params, rows[:, None], cfg,
                               impl=impl)[:, 0]
        for rows in torch.split(opt_list, chunk)])


def disc_scores_from_table(joint, table, opt_inds):
    """score_k = dot(table[opt_inds_k], joint): joint (N, H), table (M, H),
    opt_inds (N, K) -> (N, K) float32."""
    emb = table[opt_inds]
    return torch.einsum("nh,nkh->nk", joint.to(emb.dtype).float(), emb.float())


def disc_scores(params, embed_params, joint, opt_tokens, cfg: Config, *,
                train: bool = False, gen: torch.Generator | None = None,
                impl="plain"):
    """score_k = dot(option_k, joint) with the option LSTM run on the
    (N, K, T) candidate tokens."""
    opt_emb = disc_option_embeddings(params, embed_params, opt_tokens, cfg,
                                     train=train, gen=gen, impl=impl)
    return torch.einsum("nh,nkh->nk", joint.to(opt_emb.dtype).float(),
                        opt_emb.float())


def disc_loss(params, embed_params, joint, batch, cfg: Config, *,
              train: bool = False, gen: torch.Generator | None = None,
              impl="plain") -> torch.Tensor:
    """Mean 100-way NLL of the ground-truth candidate (decoders.py::
    disc_loss) over the rounds with round_valid set.  Takes the batch's
    unique candidate rows (opt_uniq) plus the gather map opt_row when the
    loader deduplicated them (Config.disc_dedup_options), else the expanded
    opt tokens."""
    N, K = joint.shape[0], cfg.num_options
    if "opt_uniq" in batch:
        emb = disc_option_embeddings(params, embed_params,
                                     batch["opt_uniq"][None], cfg,
                                     train=train, gen=gen, impl=impl)[0]
        scores = disc_scores_from_table(joint, emb,
                                        batch["opt_row"].reshape(N, K))
    else:
        scores = disc_scores(params, embed_params, joint,
                             batch["opt"].reshape(N, K, -1), cfg,
                             train=train, gen=gen, impl=impl)
    logp = torch.log_softmax(scores, dim=-1)
    nll = -logp.gather(1, batch["gt_ind"].reshape(N, 1))[:, 0]
    if "round_valid" not in batch:
        return nll.mean()
    v = batch["round_valid"].reshape(N).to(nll.dtype)
    return (nll * v).sum() / v.sum().clamp(min=1.0)
