"""Synthetic datasets for tests and benchmarks (the port's own copy of
visdial_tpu/data/synthetic.py: make_synthetic_split, random_batch,
make_random_split, synthetic_vocab and zipf_redraw_options; the same
arrays for the same seed, tests/test_torch_data.py and
tests/test_torch_verify.py).

The reference has no test fixtures (SURVEY.md §4); this generator plays the
role of the golden fixture: a deterministic, structured dataset small enough
for CPU, on which a model can actually learn (the ground-truth answer is a
deterministic function of the question tokens), so integration tests can
assert that loss decreases AND that retrieval metrics beat chance.
"""

from __future__ import annotations

import numpy as np

from ..config import Config
from .dataset import VisDialSplit, Vocabulary


def synthetic_vocab(num_words: int = 50) -> Vocabulary:
    words = [f"w{i:03d}" for i in range(num_words)]
    word2ind = {w: i + 1 for i, w in enumerate(sorted(words))}
    for special in ("<UNK>", "<START>", "<END>"):
        word2ind[special] = len(word2ind) + 1
    return Vocabulary(word2ind=word2ind)


def make_synthetic_split(
    config: Config,
    num_dialogs: int = 16,
    num_options: int | None = None,
    vocab: Vocabulary | None = None,
    seed: int = 0,
) -> tuple[VisDialSplit, Vocabulary]:
    """Learnable synthetic dialogs.

    Construction: every "answer" is a 3-token sequence determined by the
    question's first token (ans = [q0+1, q0+2, q0+3] mod plain-word range),
    so a model that attends to the question can rank the ground truth first.
    Option lists always contain the ground truth plus distractors.
    """
    rng = np.random.default_rng(seed)
    vocab = vocab or synthetic_vocab()
    cfg = config
    K = num_options or cfg.num_options
    N, R = num_dialogs, cfg.num_rounds
    Lq, La, Lc = cfg.max_ques_len, cfg.max_ans_len, cfg.max_cap_len
    # plain words occupy ids [1, W]; specials are the last 3 ids
    W = vocab.size - 1 - 3

    def answer_for(q0: int) -> np.ndarray:
        a = np.zeros(La, dtype=np.int32)
        a[:3] = [(q0 % W) + 1, ((q0 + 1) % W) + 1, ((q0 + 2) % W) + 1]
        return a

    # Deduplicated option list: one canonical answer per possible q0,
    # plus random distractors (mirrors the reference's dedup'd opt_list).
    opt_rows = [answer_for(q0) for q0 in range(1, W + 1)]
    num_distractors = max(2 * K, 256)
    for _ in range(num_distractors):
        length = int(rng.integers(1, La + 1))
        row = np.zeros(La, dtype=np.int32)
        row[:length] = rng.integers(1, W + 1, size=length)
        opt_rows.append(row)
    opt_list = np.stack(opt_rows)
    # dedup exactly like prepro does (answers keyed by token string)
    _, uniq_idx = np.unique(opt_list, axis=0, return_index=True)
    opt_list = opt_list[np.sort(uniq_idx)]
    opt_list_len = (opt_list != 0).sum(axis=1).astype(np.int32)
    M = opt_list.shape[0]

    # canonical row index of answer_for(q0) within the dedup'd list
    row_of = {opt_list[i].tobytes(): i for i in range(M)}

    ques = np.zeros((N, R, Lq), np.int32)
    ques_len = np.zeros((N, R), np.int32)
    ans = np.zeros((N, R, La), np.int32)
    ans_len = np.zeros((N, R), np.int32)
    cap = np.zeros((N, Lc), np.int32)
    cap_len = np.zeros(N, np.int32)
    opt_inds = np.zeros((N, R, K), np.int32)
    gt_ind = np.zeros((N, R), np.int32)

    for i in range(N):
        clen = int(rng.integers(3, min(8, Lc) + 1))
        cap[i, :clen] = rng.integers(1, W + 1, size=clen)
        cap_len[i] = clen
        for r in range(R):
            qlen = int(rng.integers(2, min(6, Lq) + 1))
            q = rng.integers(1, W + 1, size=qlen)
            ques[i, r, :qlen] = q
            ques_len[i, r] = qlen
            a = answer_for(int(q[0]))
            ans[i, r] = a
            ans_len[i, r] = int((a != 0).sum())
            gt_row = row_of[a.tobytes()]
            distractors = rng.choice(
                [m for m in range(M) if m != gt_row], size=K - 1, replace=False
            )
            slot = int(rng.integers(0, K))
            opts = np.insert(distractors, slot, gt_row)
            opt_inds[i, r] = opts
            gt_ind[i, r] = slot

    # Image features correlated with the caption's first word so the image
    # pathway carries signal too.
    img = rng.standard_normal((N, cfg.img_feat_size)).astype(np.float32) * 0.1
    img[np.arange(N), cap[:, 0] % cfg.img_feat_size] += 2.0

    split = VisDialSplit(
        ques=ques, ques_len=ques_len, ans=ans, ans_len=ans_len,
        cap=cap, cap_len=cap_len, opt_list=opt_list, opt_list_len=opt_list_len,
        opt_inds=opt_inds, gt_ind=gt_ind, img_feat=img,
        img_ids=np.arange(N, dtype=np.int64),
    ).validate()
    return split, vocab


def random_batch(cfg: Config, seed: int = 0, batch_size: int | None = None,
                 full_lengths: bool = True) -> dict:
    """Random model-ready batch arrays at the configured shapes.

    For compile checks and throughput benchmarks only (no learnable
    structure).  With full_lengths=True every sequence uses its maximum
    length — the compute worst case, which is what a throughput number
    should measure.  Includes every field any encoder/decoder pair reads;
    unused fields are ignored by the model.
    """
    rng = np.random.default_rng(seed)
    B = batch_size or cfg.batch_size
    R, K = cfg.num_rounds, cfg.num_options
    Lq, La = cfg.max_ques_len, cfg.max_ans_len
    V = max(cfg.vocab_size, 5)

    def toks(*shape):
        return rng.integers(1, V - 3, size=shape).astype(np.int32)

    ans = toks(B, R, La)
    opt = toks(B, R, K, La)
    start, end = V - 2, V - 1
    ans_in = np.concatenate([np.full((B, R, 1), start, np.int32), ans], axis=-1)
    ans_out = np.concatenate([ans, np.full((B, R, 1), end, np.int32)], axis=-1)
    opt_in = np.concatenate([np.full((B, R, K, 1), start, np.int32), opt], axis=-1)
    opt_out = np.concatenate([opt, np.full((B, R, K, 1), end, np.int32)], axis=-1)
    Lh = cfg.max_hist_concat_len
    # evenly spaced prefix boundaries for the incremental LF history path
    bounds = np.minimum(
        cfg.max_cap_len + np.arange(R) * (Lq + La), Lh).astype(np.int32)
    batch = {
        "ques": toks(B, R, Lq),
        "hist_concat": toks(B, R, cfg.max_hist_concat_len),
        "hist_flat": toks(B, Lh),
        "hist_bounds": np.broadcast_to(bounds, (B, R)).copy(),
        "facts": toks(B, R, cfg.max_fact_len),
        "fact_len": np.full((B, R), cfg.max_fact_len, np.int32),
        "img": rng.standard_normal((B, cfg.img_feat_size)).astype(np.float32),
        "ans_in": ans_in, "ans_out": ans_out,
        "opt": opt, "opt_len": np.full((B, R, K), La, np.int32),
        "opt_inds": rng.integers(0, 1024, size=(B, R, K)).astype(np.int32),
        "opt_in": opt_in, "opt_out": opt_out,
        "gt_ind": rng.integers(0, K, size=(B, R)).astype(np.int32),
        "dialog_valid": np.ones(B, np.int32),
        "round_valid": np.ones((B, R), np.int32),
    }
    if not full_lengths:
        for k in ("ques", "facts"):
            keep = rng.integers(1, batch[k].shape[-1] + 1, size=batch[k].shape[:-1])
            mask = np.arange(batch[k].shape[-1]) < keep[..., None]
            batch[k] = np.where(mask, batch[k], 0)

        # Candidate/answer rows at varying lengths too (uniform [1, La] —
        # the same convention as make_random_split's "realistic" splits),
        # with the loader-exact <START>/<END> construction for short rows.
        def shorten(tok):
            lens = rng.integers(1, La + 1, size=tok.shape[:-1])
            t = np.where(np.arange(La) < lens[..., None], tok, 0)
            tin = np.concatenate(
                [np.full(tok.shape[:-1] + (1,), start, np.int32), t], -1)
            base = np.concatenate(
                [t, np.zeros(tok.shape[:-1] + (1,), np.int32)], -1)
            tout = np.where(np.arange(La + 1) == lens[..., None], end, base)
            return t, tin.astype(np.int32), tout.astype(np.int32), lens

        _, batch["ans_in"], batch["ans_out"], _ = shorten(ans)
        batch["opt"], batch["opt_in"], batch["opt_out"], olens = shorten(opt)
        batch["opt_len"] = olens.astype(np.int32)
    return batch


def make_random_split(cfg: Config, num_dialogs: int,
                      num_unique_answers: int = 100_000,
                      seed: int = 0) -> tuple[VisDialSplit, Vocabulary]:
    """Fully vectorized random split at production scale (v0.9 is ~80k
    train dialogs, ~100k unique answers) — for pipeline/throughput
    rehearsals, not learnability (use make_synthetic_split for that)."""
    rng = np.random.default_rng(seed)
    vocab = synthetic_vocab(num_words=8800)
    N, R, K = num_dialogs, cfg.num_rounds, cfg.num_options
    Lq, La, Lc = cfg.max_ques_len, cfg.max_ans_len, cfg.max_cap_len
    W = vocab.size - 1 - 3
    M = num_unique_answers

    def rand_tokens(shape, L, lo=1):
        toks = rng.integers(1, W + 1, size=shape + (L,)).astype(np.int32)
        lens = rng.integers(lo, L + 1, size=shape).astype(np.int32)
        toks *= (np.arange(L) < lens[..., None])
        return toks, lens

    ques, ques_len = rand_tokens((N, R), Lq, lo=2)
    opt_list, opt_list_len = rand_tokens((M,), La)
    # answers ARE rows of the option list (as in real data)
    ans_rows = rng.integers(0, M, size=(N, R)).astype(np.int32)
    ans = opt_list[ans_rows]
    ans_len = opt_list_len[ans_rows]
    # 100 candidates: random rows, ground truth planted at a random slot
    opt_inds = rng.integers(0, M, size=(N, R, K)).astype(np.int32)
    gt_ind = rng.integers(0, K, size=(N, R)).astype(np.int32)
    np.put_along_axis(opt_inds, gt_ind[..., None], ans_rows[..., None], axis=2)
    cap, cap_len = rand_tokens((N,), Lc, lo=3)
    img = rng.standard_normal((N, cfg.img_feat_size)).astype(np.float32)
    split = VisDialSplit(
        ques=ques, ques_len=ques_len, ans=ans, ans_len=ans_len,
        cap=cap, cap_len=cap_len, opt_list=opt_list,
        opt_list_len=opt_list_len, opt_inds=opt_inds, gt_ind=gt_ind,
        img_feat=img, img_ids=np.arange(N, dtype=np.int64),
    ).validate()
    return split, vocab


def zipf_redraw_options(split, a: float, seed: int = 1) -> None:
    """In-place zipf(a) answer-popularity redraw of the split's candidate
    pools, keeping each round's planted ground-truth row where it is
    (visdial_tpu/data/synthetic.py::zipf_redraw_options, the same arrays
    for the same seed).

    make_random_split draws candidates uniformly from the option list; real
    VisDial answer options are heavily popularity-skewed (yes/no/counts
    dominate), so uniform duplication fractions are a lower bound.
    a ~ 1.2-1.5 approximates the real skew.

    Copied with the reference's fault: the redraw can put the ground
    truth's row in other slots of the same round too, which ties their
    scores with the ground truth's.  Use it for rate rows (how much the
    candidate rows deduplicate) only, never for metrics."""
    rng = np.random.default_rng(seed)
    M = split.opt_list.shape[0]
    pop = 1.0 / (1.0 + np.arange(M, dtype=np.float64)) ** a
    pop = pop[rng.permutation(M)] / pop.sum()
    redraw = rng.choice(M, size=split.opt_inds.shape, p=pop).astype(np.int32)
    gt = np.take_along_axis(split.opt_inds, split.gt_ind[..., None], axis=2)
    np.put_along_axis(redraw, split.gt_ind[..., None], gt, axis=2)
    split.opt_inds[:] = redraw
