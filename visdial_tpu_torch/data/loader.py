"""Host-side batch assembly and the prefetching feed (the port's own copy
of visdial_tpu/data/loader.py; batches are byte-identical to the JAX
package's under a float32 config, tests/test_torch_data.py).

Divergence from the JAX package's loader: batches are always assembled in
float32 (its bfloat16 branch casts image features through ml_dtypes; the
port casts on the device instead).

The JAX package's loader replaces the reference's online Lua loader (reference: dataloader.lua
getTrainBatch/getTestBatch + utils.rightAlign).  Responsibilities:

  * right-align padded token sequences so the last timestep is the last
    word (reference: utils.rightAlign) — with zero initial state this makes
    "last hidden state" equal "state after last real token";
  * assemble dialog history two ways (reference: dataloader.lua history
    block): one *concatenated* sequence per round for LF encoders, and
    per-round *facts* (caption, QA_1, ..., QA_9) for HRE/MN encoders.
    Facts are emitted once per dialog, not once per round: fact j is shared
    by every round > j, and the hierarchical/memory encoders consume them
    with a per-round validity mask (slots 0..t valid at round t) — a 10x
    host and device saving over materializing history per round;
  * build teacher-forcing inputs  ans_in = <START>+ans, ans_out = ans+<END>
    (reference: dataloader.lua answerIn/answerOut);
  * gather the 100 candidate-answer token sequences per round from the
    deduplicated option list (reference: option index trick in prepro.py);
  * optionally L2-normalize image features (reference -imgNorm);
  * feed batches to device one step ahead (double buffering) with the
    batch dim laid out for the data-parallel mesh axis.

All assembly is vectorized numpy; a C++ core (native/loader_core.cpp) is
used for the right-align hot path when built, with this file as the
behavioral reference.
"""

from __future__ import annotations

import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

from ..config import Config, encoder_family, encoder_uses_history, encoder_uses_image
from ..utils import trace
from .dataset import VisDialSplit, Vocabulary


# ---------------------------------------------------------------------------
# right-align
# ---------------------------------------------------------------------------

def right_align(seq: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Move each row's tokens to the right edge.

    seq: (..., L) left-aligned, 0-padded; lengths: (...,).
    Equivalent of reference utils.rightAlign.
    """
    seq = np.asarray(seq)
    L = seq.shape[-1]
    flat = seq.reshape(-1, L)
    lens = np.asarray(lengths).reshape(-1)
    shift = L - lens  # how far right each row moves
    col = np.arange(L)[None, :]
    src = col - shift[:, None]          # source column for each output column
    valid = src >= 0
    src = np.clip(src, 0, L - 1)
    out = np.take_along_axis(flat, src, axis=1)
    out[~valid] = 0
    return out.reshape(seq.shape)

try:  # optional C++ fast path (behavior-identical; tests compare both)
    from . import native as _native
except Exception:  # pragma: no cover
    _native = None


def right_align_fast(seq: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    if _native is not None and _native.available():
        return _native.right_align(seq, lengths)
    return right_align(seq, lengths)


# ---------------------------------------------------------------------------
# batch container
# ---------------------------------------------------------------------------

@dataclass
class Batch:
    """One step's worth of data.  B dialogs x R rounds; all int32/float32.

    Fields are None when the encoder/decoder combination doesn't need them.
      ques        (B, R, Lq)       right-aligned question tokens
      hist_concat (B, R, Lh)       right-aligned concatenated history (LF,
                                   per-round legacy path)
      hist_flat   (B, Lh)          left-aligned full-dialog concat (LF
                                   incremental path: one LSTM pass, states
                                   read at hist_bounds)
      hist_bounds (B, R)           tokens visible to each round
      facts       (B, R, Lf)       right-aligned per-dialog facts (HRE/MN);
                                   slot 0 = caption, slot j = QA_j
      fact_len    (B, R)
      img         (B, F)
      ans_in      (B, R, La+1)     <START> + answer   (gen training)
      ans_out     (B, R, La+1)     answer + <END>     (gen training)
      opt         (B, R, K, La)    candidate tokens, left-aligned (disc)
      opt_inds    (B, R, K)        rows into the split's opt_list (disc
                                   eval fast path: table lookup scoring)
      opt_len     (B, R, K)
      opt_uniq    (B*R*K, La)      the batch's UNIQUE candidate rows, padded
                                   with all-zero rows (disc train dedup path
                                   — Config.disc_dedup_options; the fused
                                   LSTM's per-tile step bounds skip the
                                   all-pad filler's compute entirely)
      opt_row     (B, R, K)        rows into opt_uniq per candidate
      opt_in      (B, R, K, La+1)  <START>+cand       (gen eval)
      opt_out     (B, R, K, La+1)  cand+<END>         (gen eval)
      gt_ind      (B, R)
      dialog_valid (B,)            0/1 — padding rows in the final eval batch
      round_valid  (B, R)          0/1 — incompletely annotated rounds
                                   (v1.0 short/test dialogs); excluded from
                                   loss and metrics
      round_scoreable (B, R)       0/1 — rounds with a full candidate list
                                   (gt optional): what a --save_ranks dump
                                   includes (v1.0 test submission rounds)
    """

    ques: np.ndarray
    gt_ind: np.ndarray
    dialog_valid: np.ndarray
    round_valid: np.ndarray
    round_scoreable: np.ndarray | None = None
    hist_concat: np.ndarray | None = None
    hist_flat: np.ndarray | None = None
    hist_bounds: np.ndarray | None = None
    facts: np.ndarray | None = None
    fact_len: np.ndarray | None = None
    img: np.ndarray | None = None
    ans_in: np.ndarray | None = None
    ans_out: np.ndarray | None = None
    opt: np.ndarray | None = None
    opt_inds: np.ndarray | None = None
    opt_len: np.ndarray | None = None
    opt_in: np.ndarray | None = None
    opt_out: np.ndarray | None = None
    opt_uniq: np.ndarray | None = None
    opt_row: np.ndarray | None = None

    def as_dict(self) -> dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if v is not None}


def _with_start_end(tokens: np.ndarray, lengths: np.ndarray, start: int, end: int):
    """(..., L) left-aligned -> (in, out) of shape (..., L+1).

    in  = <START> t1..tk 0...      out = t1..tk <END> 0...
    (reference: dataloader.lua answerIn/answerOut construction)
    """
    shape = tokens.shape
    L = shape[-1]
    flat = tokens.reshape(-1, L)
    lens = np.asarray(lengths).reshape(-1)
    n = flat.shape[0]
    t_in = np.zeros((n, L + 1), np.int32)
    t_out = np.zeros((n, L + 1), np.int32)
    t_in[:, 0] = start
    t_in[:, 1:] = flat
    t_out[:, :L] = flat
    t_out[np.arange(n), lens] = end
    return t_in.reshape(*shape[:-1], L + 1), t_out.reshape(*shape[:-1], L + 1)


def dedup_option_rows(opt_list: np.ndarray,
                      sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The disc_dedup_options batch layout (Config.disc_dedup_options):
    unique candidate rows padded with all-pad filler to the static
    sel.size, plus the per-candidate gather map into them.  Shared by the
    train assembler, the driver's multichip dry run, and the on-chip
    equivalence gate so the layout cannot drift between them."""
    uniq, inv = np.unique(sel, return_inverse=True)
    opt_uniq = np.zeros((sel.size, opt_list.shape[1]), np.int32)
    opt_uniq[: uniq.size] = opt_list[uniq]
    return opt_uniq, inv.reshape(sel.shape).astype(np.int32)


# ---------------------------------------------------------------------------
# assembler
# ---------------------------------------------------------------------------

class BatchAssembler:
    """Turns dialog indices into model-ready Batches for one split."""

    def __init__(self, data: VisDialSplit, vocab: Vocabulary, config: Config):
        self.data = data
        self.vocab = vocab
        self.cfg = config
        self.family = encoder_family(config.encoder)
        self.need_img = encoder_uses_image(config.encoder)
        self.need_hist = encoder_uses_history(config.encoder)
        self.need_concat = self.family == "lf" and self.need_hist
        self.need_facts = self.family in ("hre", "hrea", "mn") and self.need_hist
        with trace.span("build.host"):
            if config.img_norm:
                feats = data.img_feat
                if config.img_spatial:
                    # spatial map (N, S*C): L2-normalize each LOCATION's
                    # C-dim vector (the per-feature analog of fc7 imgNorm; a
                    # whole-map norm would only rescale attention logits
                    # uniformly)
                    S, C = config.img_spatial_slots, config.img_spatial_channels
                    loc = feats.reshape(len(feats), S, C)
                    norm = np.linalg.norm(loc, axis=2, keepdims=True)
                    feats = (loc / np.maximum(norm, 1e-8)).reshape(feats.shape)
                    self.img_feat = feats.astype(np.float32)
                else:
                    norm = np.linalg.norm(feats, axis=1, keepdims=True)
                    self.img_feat = (feats / np.maximum(norm, 1e-8)).astype(
                        np.float32)
            else:
                self.img_feat = data.img_feat.astype(np.float32)
        # float32 under any compute_dtype: the encoder casts on the device

    # -- history --------------------------------------------------------
    def _hist_flat(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Single LEFT-aligned concat per dialog + per-round prefix lengths.

        LF's per-round histories are prefixes of one sequence (caption +
        QA_1 + ... ).  An LSTM is causal and (with zero init) the state
        after a right-aligned prefix equals the state at that boundary of
        the left-aligned full sequence — so ONE LSTM pass over (B, Lh) plus
        boundary readouts replaces R passes over (B*R, Lh): ~10x fewer
        token-steps than the reference's per-round re-encoding.
        Returns (flat (B, Lh), bounds (B, R)) where bounds[b, r] = number of
        tokens visible to round r (state index bounds-1).

        Stays in numpy (no C++ twin): measured 1.5 ms/batch at flagship
        shapes vs an ~88 ms device step — 50x headroom, not a hot path.
        """
        d, cfg = self.data, self.cfg
        B, R = len(idx), cfg.num_rounds
        Lh = cfg.max_hist_concat_len
        out = np.zeros((B, Lh), np.int32)
        bounds = np.zeros((B, R), np.int32)
        cap, cap_len = d.cap[idx], d.cap_len[idx]
        ques, ques_len = d.ques[idx], d.ques_len[idx]
        ans, ans_len = d.ans[idx], d.ans_len[idx]
        for b in range(B):
            n = int(cap_len[b])
            out[b, :n] = cap[b, :n]
            for r in range(R):
                bounds[b, r] = n
                if r == R - 1:
                    break   # no round consumes QA_{R-1}; Lh excludes it
                ql, al = int(ques_len[b, r]), int(ans_len[b, r])
                out[b, n:n + ql] = ques[b, r, :ql]
                n += ql
                out[b, n:n + al] = ans[b, r, :al]
                n += al
        return out, bounds

    def _hist_concat(self, idx: np.ndarray) -> np.ndarray:
        """Concatenated history per round: caption + QA_1..QA_{t-1},
        right-aligned to the full static width (Config.max_hist_concat_len
        documents the no-truncation decision).  C++ fast path when built;
        the numpy body below is the behavioral reference."""
        d, cfg = self.data, self.cfg
        B, R = len(idx), cfg.num_rounds
        Lh = cfg.max_hist_concat_len
        if _native is not None and _native.available():
            return _native.hist_concat(
                d.cap[idx], d.cap_len[idx], d.ques[idx], d.ques_len[idx],
                d.ans[idx], d.ans_len[idx], Lh)
        out = np.zeros((B, R, Lh), np.int32)
        out_len = np.zeros((B, R), np.int32)
        cap, cap_len = d.cap[idx], d.cap_len[idx]
        ques, ques_len = d.ques[idx], d.ques_len[idx]
        ans, ans_len = d.ans[idx], d.ans_len[idx]
        for b in range(B):
            buf = list(cap[b, : cap_len[b]])
            for r in range(R):
                out[b, r, : len(buf)] = buf
                out_len[b, r] = len(buf)
                buf.extend(ques[b, r, : ques_len[b, r]])
                buf.extend(ans[b, r, : ans_len[b, r]])
        return right_align(out, out_len)

    def _facts(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Per-dialog facts: slot 0 = caption, slot j = QA_j (j=1..R-1).

        Round t consumes slots 0..t (masked downstream).  C++ fast path when
        built; the numpy body below is the behavioral reference.
        """
        d, cfg = self.data, self.cfg
        B, R, Lf = len(idx), cfg.num_rounds, cfg.max_fact_len
        if _native is not None and _native.available():
            return _native.facts(
                d.cap[idx], d.cap_len[idx], d.ques[idx], d.ques_len[idx],
                d.ans[idx], d.ans_len[idx], Lf)
        facts = np.zeros((B, R, Lf), np.int32)
        fact_len = np.zeros((B, R), np.int32)
        cap, cap_len = d.cap[idx], d.cap_len[idx]
        facts[:, 0, : cap.shape[1]] = cap[:, :Lf]
        fact_len[:, 0] = np.minimum(cap_len, Lf)
        ques, ques_len = d.ques[idx], d.ques_len[idx]
        ans, ans_len = d.ans[idx], d.ans_len[idx]
        for b in range(B):
            for r in range(R - 1):  # QA_r becomes fact slot r+1
                qa = np.concatenate(
                    [ques[b, r, : ques_len[b, r]], ans[b, r, : ans_len[b, r]]]
                )[:Lf]
                facts[b, r + 1, : len(qa)] = qa
                fact_len[b, r + 1] = len(qa)
        return right_align(facts, fact_len), fact_len

    # -- main entry ------------------------------------------------------
    def assemble(
        self,
        idx: np.ndarray,
        with_options: bool = True,
        with_gen_options: bool = False,
        with_option_tokens: bool = True,
        dedup_options: bool = False,
        pad_to: int | None = None,
    ) -> Batch:
        """with_option_tokens=False keeps only opt_inds/opt_len (the eval
        fast paths gather candidate tokens on device from the split's
        opt_list — expanding ~3 MB of rows per batch on the host and
        shipping them over is pure waste there).

        dedup_options=True (disc TRAIN path, Config.disc_dedup_options)
        emits the batch's unique candidate rows (opt_uniq, all-pad-padded
        to the static B*R*K) plus the per-candidate gather map (opt_row)
        instead of the expanded opt tokens — same bytes on the wire, ~14%
        (uniform) to ~10x (real answer-popularity skew) fewer live rows
        through the option LSTM."""
        d, cfg, v = self.data, self.cfg, self.vocab
        idx = np.asarray(idx)
        B = len(idx)
        valid = np.ones(B, np.int32)
        if pad_to is not None and B < pad_to:
            pad = pad_to - B
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            valid = np.concatenate([valid, np.zeros(pad, np.int32)])
            B = pad_to

        ques = right_align_fast(d.ques[idx], d.ques_len[idx])
        batch = Batch(ques=ques, gt_ind=d.gt_ind[idx].astype(np.int32),
                      dialog_valid=valid,
                      round_valid=d.round_valid[idx].astype(np.int32),
                      round_scoreable=d.round_scoreable[idx].astype(np.int32))

        if self.need_concat:
            if cfg.lf_hist_incremental:
                batch.hist_flat, batch.hist_bounds = self._hist_flat(idx)
            else:
                batch.hist_concat = self._hist_concat(idx)
        if self.need_facts:
            batch.facts, batch.fact_len = self._facts(idx)
        if self.need_img:
            batch.img = self.img_feat[idx]

        if cfg.decoder == "gen":
            batch.ans_in, batch.ans_out = _with_start_end(
                d.ans[idx], d.ans_len[idx], v.start, v.end
            )
        if with_options:
            sel = d.opt_inds[idx]                      # (B, R, K)
            batch.opt_inds = sel.astype(np.int32)
            batch.opt_len = d.opt_list_len[sel]
            if with_option_tokens and dedup_options and not with_gen_options:
                batch.opt_uniq, batch.opt_row = dedup_option_rows(
                    d.opt_list, sel)
            elif with_option_tokens:
                if _native is not None and _native.available():
                    batch.opt = _native.gather_options(d.opt_list, sel)
                else:
                    batch.opt = d.opt_list[sel]        # (B, R, K, La)
                if with_gen_options:
                    batch.opt_in, batch.opt_out = _with_start_end(
                        batch.opt, batch.opt_len, v.start, v.end
                    )
        return batch


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------

def _shard_bounds(batch_size: int, shard: tuple[int, int] | None):
    """[lo, hi) of data rank d's dialogs in a batch, shard = (d, data);
    the whole batch for None.  The data axis must divide the batch."""
    if shard is None:
        return 0, batch_size
    d, data = shard
    if batch_size % data:
        raise ValueError(f"batch_size {batch_size} is not divisible by the "
                         f"data axis ({data})")
    n = batch_size // data
    return d * n, (d + 1) * n


class TrainLoader:
    """Shuffled epoch iterator with background assembly (one step ahead).

    The reference fetches batches synchronously on the Lua main thread; here
    assembly overlaps device compute via a worker thread + queue, and the
    caller `device_put`s with a data-axis sharding (double buffering).
    """

    def __init__(self, data: VisDialSplit, vocab: Vocabulary, config: Config,
                 drop_remainder: bool = True, prefetch: int = 2):
        self.assembler = BatchAssembler(data, vocab, config)
        self.cfg = config
        self.n = data.num_dialogs
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.steps_per_epoch = (
            self.n // config.batch_size
            if drop_remainder
            else -(-self.n // config.batch_size)
        )

    def epoch(self, seed: int, shard: tuple[int, int] | None = None) -> Iterator[Batch]:
        """The epoch's batches in the order seed draws.  shard=(d, data):
        data rank d's contiguous batch_size / data dialogs of each global
        batch, assembled on their own (so a deduplicated candidate layout
        is the shard's), from the same permutation on every rank."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.n)
        bs = self.cfg.batch_size
        lo, hi = _shard_bounds(bs, shard)
        need_gen_opts = False  # training never scores options for gen
        need_opts = self.cfg.decoder == "disc"
        dedup = need_opts and self.cfg.disc_dedup_options

        def produce(q: queue_mod.Queue) -> None:
            try:
                for s in range(self.steps_per_epoch):
                    idx = order[s * bs : (s + 1) * bs]
                    # pad the global batch (a no-op under drop_remainder),
                    # then take this rank's dialogs of it
                    valid = np.arange(bs) < len(idx)
                    idx = np.concatenate(
                        [idx, np.repeat(idx[-1:], bs - len(idx))])
                    with trace.span("loader.assemble"):
                        batch = self.assembler.assemble(
                            idx[lo:hi], with_options=need_opts,
                            with_gen_options=need_gen_opts,
                            dedup_options=dedup)
                    batch.dialog_valid = valid[lo:hi].astype(np.int32)
                    q.put(batch)
            finally:
                q.put(None)

        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        while True:
            empty = q.empty()
            if empty:
                with trace.span("loader.wait"):
                    item = q.get()
            else:
                item = q.get()
            if item is None:
                return
            trace.count("loader.gets")
            trace.count("loader.empty_gets", empty)
            yield item


class EvalLoader:
    """Sequential iterator over a split with options for candidate scoring.

    option_tokens=False assembles only opt_inds/opt_len — for the eval fast
    paths that gather candidate tokens on device from the split's opt_list.
    """

    def __init__(self, data: VisDialSplit, vocab: Vocabulary, config: Config,
                 batch_size: int | None = None, option_tokens: bool = True):
        self.assembler = BatchAssembler(data, vocab, config)
        self.cfg = config
        self.bs = batch_size or config.batch_size
        self.n = data.num_dialogs
        self.num_batches = -(-self.n // self.bs)
        self.option_tokens = option_tokens

    def __iter__(self) -> Iterator[Batch]:
        gen_opts = self.cfg.decoder == "gen"
        for s in range(self.num_batches):
            idx = np.arange(s * self.bs, min((s + 1) * self.bs, self.n))
            yield self.assembler.assemble(
                idx, with_options=True, with_gen_options=gen_opts,
                with_option_tokens=self.option_tokens, pad_to=self.bs,
            )



class DenseLoader:
    """Shuffled batches for v1.0 dense-annotation fine-tuning
    (loader.py::DenseLoader).

    Iterates only the dialogs a dense-annotation file covers; each batch
    carries the full encoder inputs (history context up to the annotated
    round lives inside the encoder) plus the annotated round's candidate
    tokens and raw relevance:

      dense_opt   (B, K, La)   candidate tokens (gathered from opt_list)
      dense_round (B,)         0-indexed annotated round
      dense_rel   (B, K)       gt_relevance as released (raw, unnormalized)
      dense_valid (B,)         0 for rows padding the final batch

    Entries whose image is not in the split, whose round_id is out of
    range, whose relevance row is all-zero, or whose annotated round has
    no full candidate list are skipped (counted in .skipped).
    """

    def __init__(self, data: VisDialSplit, vocab: Vocabulary, config: Config,
                 dense_entries: list, batch_size: int | None = None):
        self.assembler = BatchAssembler(data, vocab, config)
        self.data, self.cfg = data, config
        self.bs = batch_size or config.batch_size
        by_img = {int(e["image_id"]): e for e in dense_entries}
        self.items: list[tuple[int, int, np.ndarray]] = []
        self.skipped = 0
        for i, img in enumerate(np.asarray(data.img_ids)):
            e = by_img.pop(int(img), None)
            if e is None:
                continue
            r = int(e["round_id"]) - 1
            rel = np.asarray(e["gt_relevance"], np.float32)
            if (not 0 <= r < config.num_rounds
                    or rel.shape != (config.num_options,)
                    or rel.sum() <= 0
                    or not data.round_scoreable[i, r]):
                self.skipped += 1
                continue
            self.items.append((i, r, rel))
        self.skipped += len(by_img)        # images not in this split

    def __len__(self) -> int:
        return len(self.items)

    def epoch(self, seed: int, shard: tuple[int, int] | None = None) -> Iterator[dict]:
        """shard=(d, data): data rank d's contiguous dialogs of each padded
        global batch, as TrainLoader.epoch."""
        d = self.data
        order = np.random.default_rng(seed).permutation(len(self.items))
        lo, hi = _shard_bounds(self.bs, shard)
        for s in range(0, len(order), self.bs):
            take = order[s : s + self.bs]
            valid = np.ones(len(take), np.int32)
            if len(take) < self.bs:                      # pad final batch
                pad = self.bs - len(take)
                take = np.concatenate([take, np.repeat(take[-1:], pad)])
                valid = np.concatenate([valid, np.zeros(pad, np.int32)])
            take, valid = take[lo:hi], valid[lo:hi]
            idx = np.array([self.items[t][0] for t in take])
            rounds = np.array([self.items[t][1] for t in take], np.int32)
            rel = np.stack([self.items[t][2] for t in take])
            out = self.assembler.assemble(idx, with_options=False).as_dict()
            rows = d.opt_inds[idx, rounds]               # (B, K)
            out["dense_opt"] = d.opt_list[rows].astype(np.int32)
            out["dense_round"] = rounds
            out["dense_rel"] = rel
            out["dense_valid"] = valid
            yield out
