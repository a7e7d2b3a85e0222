"""Answer decoders (port of visdial_tpu/models/decoders.py).

**gen** — a stacked LSTM language model over answer tokens, seeded by the
joint embedding (forwardConnect: every layer starts at h = joint, c = 0),
teacher-forced under a masked NLL loss; a candidate scores the sum of its
token log-probs; answers decode greedily, by temperature sampling or by beam
search.  On the kernel path the LM LSTM runs through K1 (K2 backward) and
the LM head through K5 (K6 backward), so the (rows, T, V) logits never
exist; the plain path materializes them, chunked over rows when scoring.

**disc** — candidate answers through a shared option LSTM, score_k =
dot(option_k embedding, joint embedding), the 100-way NLL loss in both batch
layouts, and the once-per-pool option-embedding table the serving path
ranks with.
"""

from __future__ import annotations

import torch

from ..config import Config

from ..ops.contract import scores_f32
from ..ops.lm_loss import masked_nll_fused, masked_nll_ref, token_logprobs
from ..ops.lstm import lstm_init, lstm_keep_masks, lstm_step, masked_lstm
from .core import embed, linear, linear_init

# rows per step of the plain path's candidate scoring (unchunked, the
# flagship eval batch's logits would be ~10 GB) and per option-table LSTM call
SCORE_CHUNK_ROWS = 8192
NEG = -1e30

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


def _dt(cfg: Config) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _joint_to_state(joint: torch.Tensor, num_layers: int):
    """forwardConnect: joint (N, H) -> (h0, c0), each (L, N, H)."""
    h0 = joint[None].expand((num_layers,) + tuple(joint.shape))
    return h0, torch.zeros_like(h0)


# ---------------------------------------------------------------------------
# gen
# ---------------------------------------------------------------------------

def _lm_hidden(params, embed_params, joint, tokens_in, cfg: Config, *,
               train: bool = False, gen: torch.Generator | None = None,
               impl="plain", shard=None):
    """Teacher-forced top-layer LSTM states (N, T, H) in the compute dtype;
    tokens_in (N, T) left-aligned.  In train mode the LM LSTM's inter-layer
    dropout masks are drawn from `gen` (lstm_keep_masks)."""
    vecs = embed(embed_params, tokens_in, shard).to(_dt(cfg))
    mask = (tokens_in != 0).to(vecs.dtype)
    h0, c0 = _joint_to_state(joint.to(vecs.dtype), cfg.num_layers)
    rate = cfg.dropout if train and gen is not None else 0.0
    keep = None
    if rate > 0.0:
        keep = lstm_keep_masks(gen, cfg.num_layers,
                               tuple(tokens_in.shape) + (h0.shape[-1],), rate)
    outs, _ = masked_lstm(params["lm_lstm"], vecs, mask, h0, c0, impl=impl,
                          dropout_rate=rate, keep_masks=keep)
    return outs


def gen_loss(params, embed_params, joint, batch, cfg: Config, *,
             train: bool = False, gen: torch.Generator | None = None,
             impl="plain", denominator=None, shard=None) -> torch.Tensor:
    """Teacher-forced masked NLL of the ground-truth answers.  The mask is
    "the round has an answer" (decoders.py:94-101), not round_valid: an
    answerless round has ans_in = [<START>, 0, ...] and its lone <END>
    target is zeroed.  The kernel path goes through masked_nll_fused (K5
    forward, K6 backward), the plain path through its materialized-logits
    twin masked_nll_ref (decoders.py::gen_logits + masked_nll); on a vocab
    shard (parallel/mesh.py::VocabShard: the embedding's rows and the
    head's columns are the shard's) both go through masked_nll_fused's
    sharded head (K5/K6 or their plain versions).  The mean divides by denominator(the non-pad target
    count) where given (models/model.py::model_loss)."""
    N = joint.shape[0]
    tokens_in = batch["ans_in"].reshape(N, -1)
    tokens_out = batch["ans_out"].reshape(N, -1)
    has_answer = (tokens_in[:, 1] != 0).to(tokens_out.dtype)
    tokens_out = tokens_out * has_answer[:, None]
    outs = _lm_hidden(params, embed_params, joint, tokens_in, cfg,
                      train=train, gen=gen, impl=impl, shard=shard)
    w, b = params["out_proj"]["w"], params["out_proj"]["b"]
    if shard is not None:
        return masked_nll_fused(outs, w, b, tokens_out, denominator, shard,
                                plain=impl != "cuda")
    nll = masked_nll_fused if impl == "cuda" else masked_nll_ref
    return nll(outs, w, b, tokens_out, denominator)


def _maybe_length_norm(scores, targets, cfg: Config):
    """Per-token normalization of summed candidate log-probs when
    cfg.gen_score_length_norm (the behavior of record is the raw sum)."""
    if not cfg.gen_score_length_norm:
        return scores
    return scores / (targets != 0).sum(dim=-1).clamp(min=1)


def gen_score_rows(params, embed_params, joint_rows, tokens_in, tgt,
                   cfg: Config, *, impl="plain", sort: bool = True,
                   shard=None):
    """Sum of token log-probs per candidate ROW (decoders.py::
    gen_score_rows): joint_rows (rows, H) the per-row conditioning,
    tokens_in / tgt (rows, T) at any width >= each row's length + 1 (masked
    steps add exactly zero).  Returns (rows,) float32.

    The kernel path length-sorts at >= LENGTH_SORT_MIN_ROWS rows (unless
    sort=False: rows that are already length-bucketed), runs K1 and K5 and
    puts the scores back in the rows' order.  The plain path scores
    SCORE_CHUNK_ROWS rows at a time through K5's plain version.  On a vocab
    shard K5 (or its plain version) scores the shard's columns and the
    shards combine (ops/lm_loss.py::token_logprobs)."""
    rows, T = tokens_in.shape
    rank = None
    if sort and impl == "cuda" and rows >= LENGTH_SORT_MIN_ROWS:
        order, rank = _length_sorted(tokens_in)
        tokens_in, tgt, joint_rows = tokens_in[order], tgt[order], joint_rows[order]
    vecs = embed(embed_params, tokens_in, shard).to(_dt(cfg))
    mask = (tokens_in != 0).to(vecs.dtype)
    h0, c0 = _joint_to_state(joint_rows.to(vecs.dtype), cfg.num_layers)
    outs, _ = masked_lstm(params["lm_lstm"], vecs, mask, h0, c0, impl=impl)
    w, b = params["out_proj"]["w"], params["out_proj"]["b"]
    plain = impl != "cuda"
    chunk = SCORE_CHUNK_ROWS if plain else rows
    tok_lp = torch.cat([
        token_logprobs(outs[lo:lo + chunk].reshape(-1, outs.shape[-1]), w, b,
                       tgt[lo:lo + chunk].reshape(-1), shard, plain)[0]
        for lo in range(0, rows, chunk)]).reshape(rows, T)
    s = _maybe_length_norm((tok_lp * (tgt != 0)).sum(dim=-1), tgt, cfg)
    return s[rank] if rank is not None else s


def gen_candidate_scores(params, embed_params, joint, opt_in, opt_out,
                         cfg: Config, *, impl="plain", shard=None):
    """Sum of token log-probs per candidate: joint (N, H), opt_in / opt_out
    (N, K, T).  Returns (N, K); the candidates fold into the rows."""
    N, K, T = opt_in.shape
    scores = gen_score_rows(params, embed_params,
                            joint.repeat_interleave(K, dim=0),
                            opt_in.reshape(N * K, T), opt_out.reshape(N * K, T),
                            cfg, impl=impl, shard=shard)
    return scores.reshape(N, K)


def _step_logp(params, embed_params, tok, h, c):
    """One decode step: feed tok (rows,) -> (log-softmax (rows, V) f32,
    logits, new h, new c)."""
    x_t = embed(embed_params, tok[:, None])[:, 0]
    top, h, c = lstm_step(params["lm_lstm"], x_t, h, c)
    logits = linear(params["out_proj"], top, out_dtype=torch.float32)
    return torch.log_softmax(logits, dim=-1), logits, h, c


def gen_decode(params, embed_params, joint, cfg: Config, *, start_token: int,
               end_token: int, max_len: int | None = None, greedy: bool = True,
               gen: torch.Generator | None = None, temperature: float = 1.0):
    """Token-by-token decoding (decoders.py::gen_decode): feed <START>, take
    the argmax (or sample at `temperature` from `gen`, a generator on
    joint's device), feed it back until <END> or pad.  joint (N, H).
    Returns tokens (N, max_len) int64 with 0 after the end, and the summed
    log-probs (N,) of the emitted tokens."""
    if not greedy and gen is None:
        raise ValueError("sampling needs a torch.Generator")
    N = joint.shape[0]
    max_len = max_len or cfg.max_ans_len
    h, c = _joint_to_state(joint, cfg.num_layers)
    tok = torch.full((N,), start_token, dtype=torch.long, device=joint.device)
    done = torch.zeros(N, dtype=torch.bool, device=joint.device)
    lp_sum = torch.zeros(N, device=joint.device)
    emitted = []
    for _ in range(max_len):
        logp, logits, h, c = _step_logp(params, embed_params, tok, h, c)
        if greedy:
            nxt = logits.argmax(dim=-1)
        else:
            probs = torch.softmax(logits / temperature, dim=-1)
            # torch.multinomial(probs, 1)'s draw, as its one-sample path
            # takes it (one exponential a class, the argmax of probs / e),
            # without its check of probs on the host, which a CUDA graph's
            # capture refuses
            e = torch.empty_like(probs).exponential_(1, generator=gen)
            nxt = (probs / e).argmax(dim=-1)
        tok_lp = logp.gather(1, nxt[:, None])[:, 0]
        # emitting <END> or pad (0, never a training target) ends the row
        stop = (nxt == end_token) | (nxt == 0)
        emit = torch.where(done | stop, 0, nxt)
        lp_sum = lp_sum + torch.where(done, 0.0, tok_lp)
        done = done | stop
        emitted.append(emit)
        tok = torch.where(emit == 0, end_token, emit)
    return torch.stack(emitted, dim=1), lp_sum


def gen_beam_decode(params, embed_params, joint, cfg: Config, *,
                    start_token: int, end_token: int, beam_size: int = 5,
                    max_len: int | None = None):
    """Batched beam search (decoders.py::gen_beam_decode): summed
    log-probs, no length normalization, ended beams frozen (they may only
    extend by pad at zero cost); the beams fold into the rows.  joint
    (N, H).  Returns the best beam's tokens (N, max_len) int64 and its
    summed log-prob (N,).  Among equal scores torch.topk does not promise
    lax.top_k's lower-index-first order."""
    N = joint.shape[0]
    W = beam_size
    V = params["out_proj"]["w"].shape[1]
    max_len = max_len or cfg.max_ans_len
    dev = joint.device
    h, c = _joint_to_state(joint, cfg.num_layers)
    h, c = h.repeat_interleave(W, dim=1), c.repeat_interleave(W, dim=1)
    tok = torch.full((N, W), start_token, dtype=torch.long, device=dev)
    done = torch.zeros((N, W), dtype=torch.bool, device=dev)
    beam_lp = torch.zeros((N, W), device=dev)
    seqs = torch.zeros((N, W, max_len), dtype=torch.long, device=dev)
    frozen = torch.full((V,), NEG, device=dev)
    frozen[:1].fill_(0.0)       # a fill on the device: no host copy to capture
    rows = torch.arange(N, device=dev)[:, None]
    for t in range(max_len):
        logp, _, h, c = _step_logp(params, embed_params, tok.reshape(N * W),
                                   h, c)
        logp = torch.where(done[..., None], frozen, logp.reshape(N, W, V))
        if t == 0:   # the beams are identical: expand beam 0 only
            logp = torch.cat([logp[:, :1],
                              torch.full_like(logp[:, 1:], NEG)], dim=1)
        new_lp, flat_idx = torch.topk((beam_lp[..., None] + logp).reshape(N, W * V),
                                      W, dim=1)
        src, new_tok = flat_idx // V, flat_idx % V
        gidx = (rows * W + src).reshape(-1)
        h, c = h[:, gidx], c[:, gidx]
        seqs = seqs.gather(1, src[..., None].expand(N, W, max_len))
        done = done.gather(1, src)
        stop = (new_tok == end_token) | (new_tok == 0)
        emit = torch.where(done | stop, 0, new_tok)
        seqs[:, :, t] = emit
        done = done | stop
        tok = torch.where(emit == 0, end_token, emit)
        beam_lp = new_lp
    best = beam_lp.argmax(dim=1)
    return seqs[rows[:, 0], best], beam_lp[rows[:, 0], best]


# ---------------------------------------------------------------------------
# disc
# ---------------------------------------------------------------------------

def disc_option_embeddings(params, embed_params, opt_tokens, cfg: Config,
                           *, train: bool = False,
                           gen: torch.Generator | None = None, impl="plain",
                           shard=None):
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
    vecs = embed(embed_params, flat, shard).to(_dt(cfg))
    mask = (flat != 0).to(vecs.dtype)
    _, (h_fin, _) = masked_lstm(params["opt_lstm"], vecs, mask, impl=impl,
                                dropout_rate=rate, keep_masks=keep)
    h = h_fin[-1]
    if rank is not None:
        h = h[rank]
    return h.reshape(N, K, -1)


def disc_option_table(params, embed_params, opt_list, cfg: Config, *,
                      impl="plain", chunk: int = SCORE_CHUNK_ROWS,
                      shard=None):
    """Embed the deduplicated option list once: (M, La) -> (M, H), `chunk`
    rows per LSTM call (decoders.py::disc_option_table)."""
    return torch.cat([
        disc_option_embeddings(params, embed_params, rows[:, None], cfg,
                               impl=impl, shard=shard)[:, 0]
        for rows in torch.split(opt_list, chunk)])


def disc_scores_from_table(joint, table, opt_inds):
    """score_k = dot(table[opt_inds_k], joint): joint (N, H), table (M, H),
    opt_inds (N, K) -> (N, K) float32."""
    emb = table[opt_inds]
    return scores_f32(joint.to(emb.dtype), emb)


def disc_scores(params, embed_params, joint, opt_tokens, cfg: Config, *,
                train: bool = False, gen: torch.Generator | None = None,
                impl="plain", shard=None):
    """score_k = dot(option_k, joint) with the option LSTM run on the
    (N, K, T) candidate tokens."""
    opt_emb = disc_option_embeddings(params, embed_params, opt_tokens, cfg,
                                     train=train, gen=gen, impl=impl,
                                     shard=shard)
    return scores_f32(joint.to(opt_emb.dtype), opt_emb)


def disc_loss(params, embed_params, joint, batch, cfg: Config, *,
              train: bool = False, gen: torch.Generator | None = None,
              impl="plain", denominator=None, shard=None) -> torch.Tensor:
    """Mean 100-way NLL of the ground-truth candidate (decoders.py::
    disc_loss) over the rounds with round_valid set.  Takes the batch's
    unique candidate rows (opt_uniq) plus the gather map opt_row when the
    loader deduplicated them (Config.disc_dedup_options), else the expanded
    opt tokens.  The mean divides by denominator(this batch's count) where
    given (models/model.py::model_loss)."""
    N, K = joint.shape[0], cfg.num_options
    if "opt_uniq" in batch:
        emb = disc_option_embeddings(params, embed_params,
                                     batch["opt_uniq"][None], cfg,
                                     train=train, gen=gen, impl=impl,
                                     shard=shard)[0]
        scores = disc_scores_from_table(joint, emb,
                                        batch["opt_row"].reshape(N, K))
    else:
        scores = disc_scores(params, embed_params, joint,
                             batch["opt"].reshape(N, K, -1), cfg,
                             train=train, gen=gen, impl=impl, shard=shard)
    logp = torch.log_softmax(scores, dim=-1)
    nll = -logp.gather(1, batch["gt_ind"].reshape(N, 1))[:, 0]
    if "round_valid" not in batch:
        if denominator is None:
            return nll.mean()
        # the count made on the device: a CUDA graph's capture refuses a
        # copy from the host
        return nll.sum() / denominator(
            torch.full((), float(N), dtype=torch.float32, device=nll.device))
    v = batch["round_valid"].reshape(N).to(nll.dtype)
    count = v.sum() if denominator is None else denominator(v.sum())
    return (nll * v).sum() / count.clamp(min=1.0)
