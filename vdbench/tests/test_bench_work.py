"""work.py's operation counts against torch's FLOP counter run over the
benchmark's own plain reference, at a small size on the CPU, every token
real (so the real steps are all the steps the reference runs)."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vdbench import encoders, traffic, weights, work
from vdbench.reference import model, steps

CONF = {
    "encoder": "mn-ques-im-hist", "decoder": "disc", "vocab_size": 40,
    "embed_size": 8, "rnn_hidden_size": 12, "num_layers": 2,
    "img_feat_size": 20, "img_norm": True, "dropout": 0.0,
    "max_ques_len": 4, "max_ans_len": 3, "max_cap_len": 7,
    "num_rounds": 3, "num_options": 5, "batch_size": 2,
    "grad_clip": 5.0, "learning_rate": 1e-3, "lr_decay_rate": 1.0,
    "min_lr": 0.0, "adam_beta1": 0.9, "adam_beta2": 0.999, "adam_eps": 1e-8,
}
FULL = {"dialogs": 6, "answers": 30, "zipf_a": 1.2,
        "mean_lengths": {"question": 100.0, "answer": 100.0, "caption": 100.0}}


def _split(conf):
    return traffic.make_split(FULL, conf, 11)


@pytest.mark.parametrize("decoder", ["disc", "gen", "disc-nodedup"])
def test_train_step_operations(decoder):
    conf = dict(CONF, decoder=decoder.split("-")[0],
                disc_dedup_options=not decoder.endswith("nodedup"))
    arrays = _split(conf)
    assert (arrays["ques_len"] == conf["max_ques_len"]).all()
    fam = encoders.load(conf)
    flat = weights.make(conf, fam, 3, "cpu")
    idx = np.array([1, 4])
    leaves = {k: v.requires_grad_() for k, v in flat.items()}
    with FlopCounterMode(display=False) as counter:
        loss = steps.step_loss(model.Ops(), weights.nest(leaves), conf, fam,
                               arrays, idx, 0, 0, 1, "cpu", (37, 38))
        torch.autograd.grad(loss, list(leaves.values()))
    counted = work.train_step(conf, fam, arrays, idx)
    assert counted.model == counter.get_total_flops()


def test_eval_pass_operations():
    arrays = _split(CONF)
    fam = encoders.load(CONF)
    flat = weights.make(CONF, fam, 3, "cpu")
    with FlopCounterMode(display=False) as counter:
        steps.ranks(CONF, fam, arrays, flat)
    assert work.eval_pass(CONF, fam, arrays).model == counter.get_total_flops()


def test_kernel_bounds_count_real_steps_only():
    conf = dict(CONF, max_ques_len=6)
    short = dict(FULL, mean_lengths={"question": 2.0, "answer": 100.0,
                                     "caption": 100.0})
    arrays = traffic.make_split(short, conf, 5)
    idx = np.arange(2)
    fam = encoders.load(conf)
    w = work.train_step(conf, fam, arrays, idx)
    full = dict(arrays, ques_len=np.full_like(arrays["ques_len"], 6))
    assert w.k1[0] < work.train_step(conf, fam, full, idx).k1[0]


def test_roofline_share():
    ops, nbytes = 989e12 * 1e-3, 3.35e12 * 1e-4
    assert work.roofline_pct((ops, nbytes), 2e-3) == pytest.approx(50.0)
    assert work.roofline_pct((ops, nbytes), None) is None
    assert work.roofline_pct((0.0, 0.0), 1.0) is None
