"""Decoding on a model axis (visdial_tpu_torch/generate.py with
--mesh_model 2, which decodes on the whole params on every rank): on gloo
(1, 2) and (2, 2) meshes, on a vocab that 2 divides (54: the JAX package
splits the embedding's rows and the head's columns over its model axis)
and on one it does not (51: replicated there too), greedy and beam-5 tokens
equal the one-device port run and the JAX generate CLI's strings on the
8-virtual-device CPU mesh at mesh_model 2; log-probs within 1e-5; sampled
tokens equal the one-device run with the same seed and data coordinate;
the CLI's JSON equals one device's (strings exactly, log-probs within
1e-5).  The LM head's weights are scaled 10x so that every step's argmax
leads by far more than the float error of the JAX package's sharded
product."""

import json
import os

import numpy as np
import pytest
import torch

from visdial_tpu import generate as jax_generate
from visdial_tpu_torch import generate
from visdial_tpu_torch.config import Config as PortConfig
from visdial_tpu_torch.data.loader import BatchAssembler
from visdial_tpu_torch.data.synthetic import (make_synthetic_split,
                                              synthetic_vocab)
from visdial_tpu_torch.models.model import (batch_to_device, model_generate,
                                            model_init)
from visdial_tpu_torch.parallel.launch import run_ranks
from visdial_tpu_torch.utils.checkpoint import save_checkpoint
from visdial_tpu_torch.utils.params import params_to_numpy

import torch_dist_workers as workers
from conftest import small_config

torch.set_num_threads(1)
TIMEOUT = 180
DIALOGS = 8
SEED = 5
MODES = {"greedy": [], "beam": ["--beam_size", "5"],
         "sample": ["--sample", "--temperature", "1.5", "--seed", str(SEED)]}


def _case(root, vocab_words: int):
    """(cfg, params, the split's one batch, data dir, checkpoint path) for
    MN-QIH-gen on a vocab of vocab_words + 4 ids; the checkpoint's config
    carries mesh_model 2, which the JAX CLI lays its mesh out by."""
    cfg = PortConfig(**{k: getattr(small_config(), k)
                        for k in PortConfig.__dataclass_fields__})
    data, vocab = make_synthetic_split(cfg, num_dialogs=DIALOGS, seed=4,
                                       vocab=synthetic_vocab(vocab_words))
    cfg = cfg.replace(encoder="mn-ques-im-hist", decoder="gen",
                      vocab_size=vocab.size, batch_size=DIALOGS, mesh_model=2)
    params = model_init(cfg, seed=3)
    params["decoder"]["out_proj"]["w"] *= 10.0
    data_dir = os.path.join(root, f"data{vocab.size}")
    os.makedirs(data_dir)
    data.save(os.path.join(data_dir, "visdial_data_val.npz"))
    vocab.save(os.path.join(data_dir, "visdial_params.json"))
    ckpt = save_checkpoint(os.path.join(root, f"ckpt{vocab.size}"), params,
                           cfg)
    batch = BatchAssembler(data, vocab, cfg).assemble(
        np.arange(DIALOGS)).as_dict()
    return cfg, params, batch, vocab, data_dir, ckpt


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gen_mesh"))
    return {w: _case(root, w) for w in (50, 47)}


def _one_device(cfg, params, batch, vocab, lo, hi, seed):
    dev = batch_to_device({k: v[lo:hi] for k, v in batch.items()}, "cpu")
    out = {}
    with torch.inference_mode():
        for mode, kw in (("greedy", {}), ("beam", {"beam_size": 5}),
                         ("sample", {"greedy": False, "temperature": 1.5,
                                     "gen": torch.Generator().manual_seed(
                                         seed)})):
            toks, logp = model_generate(params, dev, cfg,
                                        start_token=vocab.start,
                                        end_token=vocab.end, **kw)
            out[mode] = (toks.numpy(), logp.numpy())
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("vocab_words", [50, 47], ids=["v54", "v51"])
def test_model_axis_decodes_like_one_device(cases, shape, vocab_words):
    cfg, params, batch, vocab, _, _ = cases[vocab_words]
    assert (cfg.vocab_size % 2 == 0) == (vocab_words == 50)
    results = run_ranks(workers.decode, shape[0] * shape[1], cfg,
                        params_to_numpy(params), batch, shape, SEED,
                        (vocab.start, vocab.end), timeout=TIMEOUT)
    n = DIALOGS // shape[0]
    for got, (d, m) in results:
        want = _one_device(cfg, params, batch, vocab, d * n, (d + 1) * n,
                           SEED + d)
        for mode in ("greedy", "beam", "sample"):
            np.testing.assert_array_equal(got[mode][0], want[mode][0],
                                          err_msg=f"{mode} d={d} m={m}")
            np.testing.assert_allclose(got[mode][1], want[mode][1], atol=1e-5,
                                       err_msg=f"{mode} d={d} m={m}")
    # not a degenerate decode: answers of more than one token
    assert (results[0][0]["greedy"][0] != 0).sum(-1).max() > 1


def _load(path):
    with open(path) as f:
        return json.load(f)


def _assert_same_json(got, want):
    assert got["model"] == want["model"]
    assert len(got["dialogs"]) == len(want["dialogs"]) == DIALOGS
    for g, w in zip(got["dialogs"], want["dialogs"]):
        assert (g["image_id"], g["caption"]) == (w["image_id"], w["caption"])
        assert len(g["rounds"]) == len(w["rounds"]) > 0
        for gr, wr in zip(g["rounds"], w["rounds"]):
            for k in ("question", "gt_answer", "generated"):
                assert gr[k] == wr[k], k
            assert gr["log_prob"] == pytest.approx(wr["log_prob"], abs=1e-5)


@pytest.mark.parametrize("vocab_words", [50, 47], ids=["v54", "v51"])
def test_generate_cli_on_a_model_axis(cases, tmp_path, vocab_words):
    """The generate CLI at (1, 2) and (2, 2) under gloo against one device's
    CLI; greedy and beam 5 against the JAX CLI at mesh_model 2; sampled
    answers at (1, 2) (data coordinate 0) against one device's."""
    cfg, _, _, _, data_dir, ckpt = cases[vocab_words]
    base = ["--load_path", ckpt, "--data_dir", data_dir, "--num_dialogs", "0"]
    one = {}
    for mode, extra in MODES.items():
        out = str(tmp_path / f"one_{mode}.json")
        generate.main(base + ["--device", "cpu", "--out_path", out, *extra])
        one[mode] = _load(out)
    for shape in ((1, 2), (2, 2)):
        outs = {mode: str(tmp_path / f"{shape[0]}x2_{mode}.json")
                for mode in MODES}
        argvs = [base + ["--device", "cpu", "--mesh_data", str(shape[0]),
                         "--mesh_model", "2", "--out_path", outs[mode],
                         *extra]
                 for mode, extra in MODES.items()]
        run_ranks(workers.generate, shape[0] * 2, argvs, timeout=TIMEOUT)
        for mode in ("greedy", "beam"):
            _assert_same_json(_load(outs[mode]), one[mode])
        if shape[0] == 1:
            _assert_same_json(_load(outs["sample"]), one["sample"])
    for mode in ("greedy", "beam"):
        out = str(tmp_path / f"jax_{mode}.json")
        jax_generate.main(base + ["--out_path", out, *MODES[mode]])
        _assert_same_json(one[mode], _load(out))
