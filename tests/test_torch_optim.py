"""The port's optimizers (visdial_tpu_torch/parallel/optim.py) against the
JAX package's (visdial_tpu/parallel/optim.py): Adam, RMSprop and SGD with
momentum 0.9 over 3 steps from the same params and gradients, the global
clip, and lr_at_step.  Both compute in float32 with the same formulas;
atol 1e-6 on params and moments (a few f32 ulps of values ~1), rtol 1e-6
on the learning rate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visdial_tpu.parallel import optim as jax_optim
from visdial_tpu_torch.parallel import optim

from conftest import small_config

torch.set_num_threads(1)


def _tree(rng, scale=1.0):
    """A params-shaped tree with a list level, like the LSTM layers."""
    return {"embed": {"table": rng.standard_normal((7, 3)) * scale},
            "lstm": {"layers": [{"w": rng.standard_normal((5, 8)) * scale,
                                 "b": rng.standard_normal((8,)) * scale}
                                for _ in range(2)]}}


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _assert_tree_close(got, want, atol=1e-6):
    got = jax.tree.map(lambda t: t.numpy(), got)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop", "sgd"])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])   # below / above the clip
def test_three_steps_match_jax(optimizer, grad_scale):
    cfg = small_config(optimizer=optimizer, learning_rate=0.01,
                       lr_decay_rate=0.9)
    rng = np.random.default_rng(0)
    params = _np32(_tree(rng))
    grads = [_np32(_tree(rng, grad_scale)) for _ in range(3)]
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jax_optim.init_opt_state(jp, cfg)
    tp = _torch(params)
    ts = optim.init_opt_state(tp, cfg)
    for g in grads:
        jlr = jax_optim.lr_at_step(js.step, cfg)
        lr = optim.lr_at_step(ts.step, cfg)
        np.testing.assert_allclose(lr, float(jlr), rtol=1e-6)
        jp, js, jn = jax_optim.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                             js, jlr, cfg)
        tp, ts, tn = optim.apply_updates(tp, _torch(g), ts, lr, cfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts.m, js.m)
        _assert_tree_close(ts.v, js.v)
    assert ts.step == int(js.step) == 3
    if optimizer == "sgd":
        assert all(v.shape == (0,) for v in jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), ts.v)))


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    g = _np32(_tree(rng, 3.0))
    want, want_n = jax_optim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 5.0)
    got, n = optim.clip_by_global_norm(_torch(g), 5.0)
    assert float(n) > 5.0
    np.testing.assert_allclose(float(n), float(want_n), rtol=1e-6)
    _assert_tree_close(got, want)
    small, n_small = optim.clip_by_global_norm(_torch(g), 1e6)
    _assert_tree_close(small, g, atol=0)


@pytest.mark.parametrize("step", [0, 1, 7, 5000, 200000])
def test_lr_at_step_matches_jax(step):
    """Pre-increment step, float32 decay, floored at min_lr (the last two
    steps are past the floor)."""
    cfg = small_config(learning_rate=1e-3, lr_decay_rate=0.9997, min_lr=5e-5)
    want = jax_optim.lr_at_step(jnp.asarray(step, jnp.int32), cfg)
    got = optim.lr_at_step(step, cfg)
    assert got == float(np.float32(got))
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
