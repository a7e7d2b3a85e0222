"""The one traffic generator: a VisDial split made in NumPy from a traffic
file's parameters and a seed.

A traffic file (traffic/<mix>.json) gives the split's scale and shape:

  dialogs, answers     dialogs in the split; answers in its shared pool
                       (every candidate and every ground-truth answer is a
                       row of the pool, as in VisDial's option list)
  zipf_a               answer popularity: the pool's items ranked by a
                       permutation drawn from the seed, item of rank k drawn
                       with probability proportional to 1 / k**zipf_a
  mean_lengths         question, answer and caption lengths: 1 + Poisson(
                       mean - 1), clipped to the configuration's caps
  kind, ...            what the driver does with the split (drivers/)

Each round holds 100 candidates drawn by popularity, with its ground-truth
answer (also drawn by popularity) planted in one slot drawn uniformly and
in no other slot.  Tokens are drawn uniformly over the configuration's
words; image features uniformly in [0, 1) (fc7 features are non-negative).
The same seed gives the same arrays; the sizes are the file's whatever the
seed.
"""

from __future__ import annotations

import numpy as np

GUIDE = 1 << 20        # buckets of the sampler's guide table


def seed_for(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose (data, weights, dropout, epochs) from
    the run's seed, whatever its size."""
    ss = np.random.SeedSequence([seed % (1 << 64), purpose])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Zipf:
    """Draws of n items with P(rank k) ~ 1 / k**a, the ranks a permutation
    of the items drawn from `rng`; exact inverse-CDF sampling through a
    guide table."""

    def __init__(self, rng: np.random.Generator, n: int, a: float):
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
        self.cdf = np.cumsum(w / w.sum())
        self.cdf[-1] = 1.0
        self.items = rng.permutation(n).astype(np.int32)   # rank -> item
        self.guide = np.searchsorted(self.cdf, np.arange(GUIDE) / GUIDE,
                                     side="right").astype(np.int32)

    def ranks(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """`size` popularity ranks (0 the most popular)."""
        u = rng.random(size)
        idx = self.guide[(u * GUIDE).astype(np.int32)]
        todo = np.nonzero(self.cdf[idx] <= u)[0]
        while todo.size:           # the first rank whose cdf passes u
            idx[todo] += 1
            todo = todo[self.cdf[idx[todo]] <= u[todo]]
        return idx

    def draw(self, rng: np.random.Generator, shape) -> np.ndarray:
        size = int(np.prod(shape))
        return self.items[self.ranks(rng, size)].reshape(shape)


def lengths(rng: np.random.Generator, shape, mean: float, cap: int) -> np.ndarray:
    return np.clip(1 + rng.poisson(mean - 1.0, size=shape), 1, cap).astype(np.int32)


def tokens(rng: np.random.Generator, lens: np.ndarray, width: int,
           words: int) -> np.ndarray:
    """Left-aligned tokens in [1, words], 0 past each row's length."""
    toks = rng.integers(1, words + 1, size=lens.shape + (width,),
                        dtype=np.int32)
    toks *= np.arange(width, dtype=np.int32) < lens[..., None]
    return toks


def make_split(traffic: dict, config: dict, seed: int,
               options: bool = True) -> dict:
    """The split's arrays (the fields of the port's VisDialSplit).  With
    options=False (a decoder that reads no candidates) the candidate rows
    are left unsampled: each round's slots all hold its ground truth."""
    rng = np.random.default_rng(seed_for(seed, 0))
    N, M = int(traffic["dialogs"]), int(traffic["answers"])
    R, K = config["num_rounds"], config["num_options"]
    Lq, La, Lc = (config["max_ques_len"], config["max_ans_len"],
                  config["max_cap_len"])
    words = config["vocab_size"] - 4     # pad 0, then words, UNK, START, END
    mean = traffic["mean_lengths"]
    pop = Zipf(rng, M, float(traffic["zipf_a"]))

    opt_list_len = lengths(rng, (M,), mean["answer"], La)
    opt_list = tokens(rng, opt_list_len, La, words)
    ques_len = lengths(rng, (N, R), mean["question"], Lq)
    ques = tokens(rng, ques_len, Lq, words)
    cap_len = lengths(rng, (N,), mean["caption"], Lc)
    cap = tokens(rng, cap_len, Lc, words)
    ans_rows = pop.draw(rng, (N, R))
    gt_ind = rng.integers(0, K, size=(N, R), dtype=np.int32)
    if options:
        opt_inds = pop.draw(rng, (N, R, K))
        flat = opt_inds.reshape(-1)
        gt_row = np.repeat(ans_rows.reshape(-1), K)
        gt_slot = (np.arange(N * R * K) % K) == np.repeat(gt_ind.reshape(-1), K)
        flat[gt_slot] = gt_row[gt_slot]
        dup = np.nonzero((flat == gt_row) & ~gt_slot)[0]
        while dup.size:            # the ground truth in one slot only
            flat[dup] = pop.draw(rng, (dup.size,))
            dup = dup[flat[dup] == gt_row[dup]]
    else:
        opt_inds = np.broadcast_to(ans_rows[..., None], (N, R, K))
    img = rng.random((N, config["img_feat_size"]), dtype=np.float32)
    return dict(ques=ques, ques_len=ques_len, ans=opt_list[ans_rows],
                ans_len=opt_list_len[ans_rows], cap=cap, cap_len=cap_len,
                opt_list=opt_list, opt_list_len=opt_list_len,
                opt_inds=opt_inds, gt_ind=gt_ind, img_feat=img,
                img_ids=np.arange(N, dtype=np.int64))


def vocab_words(config: dict) -> dict:
    """The word -> index map of the configuration's vocabulary: pad 0,
    vocab_size - 4 words, then <UNK>, <START>, <END>."""
    words = config["vocab_size"] - 4
    w2i = {f"w{i}": i for i in range(1, words + 1)}
    for k, special in enumerate(("<UNK>", "<START>", "<END>")):
        w2i[special] = words + 1 + k
    return w2i
