"""The weights bridge and checkpoints between the JAX package and the port
(visdial_tpu_torch/utils/{params,checkpoint}.py), and the port's own
init."""

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.models.model import model_init as jax_model_init
from visdial_tpu.parallel.train_step import init_train_state
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from visdial_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from visdial_tpu_torch.models.model import model_init
from visdial_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from visdial_tpu_torch.utils.params import (flatten, param_shapes,
                                            params_from_numpy,
                                            params_to_numpy)

from conftest import small_config

torch.set_num_threads(1)

COMBOS = [("mn-ques-im-hist", "disc"), ("mn-ques-hist", "disc"),
          ("lf-ques-im-hist", "gen"), ("hrea-ques-im-hist", "disc")]


def _cfg(encoder="mn-ques-im-hist", decoder="disc", **kw):
    return small_config(encoder=encoder, decoder=decoder, vocab_size=40, **kw)


@pytest.mark.parametrize("encoder,decoder", COMBOS)
def test_port_shapes_equal_jax(encoder, decoder):
    cfg = _cfg(encoder, decoder)
    jax_shapes = jax.eval_shape(lambda: jax_model_init(jax.random.PRNGKey(0),
                                                       cfg))
    want = {k: tuple(v.shape) for k, v in _tree_to_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax_shapes)).items()}
    assert param_shapes(cfg) == want
    got = {k: tuple(v.shape) for k, v in flatten(model_init(cfg)).items()}
    assert got == want


def test_numpy_round_trip_of_jax_params():
    cfg = _cfg()
    flat = _tree_to_dict(jax_model_init(jax.random.PRNGKey(3), cfg))
    back = params_to_numpy(params_from_numpy(flat, cfg, "cpu"))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_port_init_ranges_forget_bias_and_pad_row():
    cfg = _cfg()
    p = model_init(cfg, seed=5)
    flat = flatten(p)
    for k, v in flat.items():
        assert v.dtype == torch.float32
        if k.endswith("/w") or k.endswith("/table"):
            assert float(v.abs().max()) <= 0.08 and float(v.abs().max()) > 0.0
    H = cfg.rnn_hidden_size
    for k, v in flat.items():
        if "_lstm/layers/" in k and k.endswith("/b"):
            expect = torch.zeros(4 * H)
            expect[H:2 * H] = 1.0
            torch.testing.assert_close(v, expect, rtol=0, atol=0)
        elif k.endswith("/b"):
            assert not v.any()
    assert not p["embed"]["table"][0].any()
    again = flatten(model_init(cfg, seed=5))
    other = flatten(model_init(cfg, seed=6))
    assert all(torch.equal(v, again[k]) for k, v in flat.items())
    assert not torch.equal(flat["embed/table"], other["embed/table"])


def test_port_reads_jax_checkpoint(tmp_path):
    cfg = _cfg()
    state = init_train_state(cfg)
    path = jax_save_checkpoint(str(tmp_path), state, cfg)
    params, cfg2, _ = load_checkpoint(path, "cpu")
    assert cfg2.to_json() == cfg.to_json()   # the port's own Config class
    want = _tree_to_dict(state.params)
    got = params_to_numpy(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_jax_reads_port_checkpoint(tmp_path, optimizer):
    cfg = _cfg(optimizer=optimizer)
    params = model_init(cfg, seed=1)
    path = save_checkpoint(str(tmp_path), params, cfg, step=7)
    state, cfg2, _ = jax_load_checkpoint(path)
    assert (cfg2.to_json() == cfg.to_json()
            and int(np.asarray(state.opt.step)) == 7)
    got = _tree_to_dict(state.params)
    want = params_to_numpy(params)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert all(not np.asarray(m).any() for m in jax.tree.leaves(state.opt.m))


def test_bad_checkpoint_arrays_raise():
    cfg = _cfg()
    flat = params_to_numpy(model_init(cfg))
    missing = dict(flat)
    del missing["encoder/fusion/b"]
    with pytest.raises(ValueError, match="missing array 'encoder/fusion/b'"):
        params_from_numpy(missing, cfg, "cpu")
    wrong = dict(flat, **{"embed/table": flat["embed/table"][:-1]})
    with pytest.raises(ValueError, match="'embed/table' has shape"):
        params_from_numpy(wrong, cfg, "cpu")
