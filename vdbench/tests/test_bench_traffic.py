"""The traffic generator's statistics from a seed."""

import json
import os

import numpy as np
import pytest

from vdbench import spec, traffic

CONF = json.load(open(os.path.join(spec.HERE, "configs", "mn-qih-disc.json")))
MIX = dict(json.load(open(os.path.join(spec.HERE, "traffic", "val-zipf.json"))),
           dialogs=3000)
BIG_SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def split():
    return traffic.make_split(MIX, CONF, BIG_SEED)


def test_same_seed_same_arrays(split):
    again = traffic.make_split(MIX, CONF, BIG_SEED)
    for k in split:
        np.testing.assert_array_equal(split[k], again[k])
    other = traffic.make_split(MIX, CONF, BIG_SEED + 1)
    assert not np.array_equal(split["ques"], other["ques"])
    assert {k: v.shape for k, v in split.items()} == \
        {k: v.shape for k, v in other.items()}


@pytest.mark.parametrize("field,mean,cap", [
    ("ques_len", "question", "max_ques_len"),
    ("opt_list_len", "answer", "max_ans_len"),
    ("cap_len", "caption", "max_cap_len")])
def test_length_means(split, field, mean, cap):
    lens = split[field]
    assert lens.min() >= 1 and lens.max() <= CONF[cap]
    assert abs(lens.mean() - MIX["mean_lengths"][mean]) < 0.1


def test_tokens_real_up_to_length(split):
    toks, lens = split["ques"], split["ques_len"]
    real = toks != 0
    assert (real.sum(-1) == lens).all()
    assert (real == (np.arange(toks.shape[-1]) < lens[..., None])).all()
    assert toks.max() <= CONF["vocab_size"] - 4


def test_zipf_exponent():
    rng = np.random.default_rng(7)
    z = traffic.Zipf(rng, 100_000, 1.2)
    ranks = z.ranks(rng, 2_000_000)
    counts = np.bincount(ranks, minlength=100_000).astype(float)
    k = np.arange(1, 201)
    slope = np.polyfit(np.log(k), np.log(counts[:200]), 1)[0]
    assert abs(-slope - 1.2) < 0.05
    expected = (1.0 / k ** 1.2) / (1.0 / np.arange(1, 100_001) ** 1.2).sum()
    np.testing.assert_allclose(counts[:5] / 2_000_000, expected[:5], rtol=0.02)


def test_ground_truth_unique_among_candidates(split):
    opt, gt = split["opt_inds"], split["gt_ind"]
    gt_row = np.take_along_axis(opt, gt[..., None], 2)[..., 0]
    assert ((opt == gt_row[..., None]).sum(-1) == 1).all()
    np.testing.assert_array_equal(split["opt_list"][gt_row], split["ans"])
    # popularity skew: a batch's candidates repeat a lot
    batch = opt[:32]
    assert len(np.unique(batch)) < 0.3 * batch.size
