"""The port's mesh (visdial_tpu_torch/parallel/mesh.py, train_step.py's mesh
step, the sharded eval and checkpoints) on gloo process groups on the CPU,
against the JAX package's sharded step on the 8-virtual-device CPU mesh of
the same shape (tests/conftest.py), as tests/test_sharding.py holds the JAX
mesh to one device: loss rtol 1e-4, params atol 1e-4, 3 steps at dropout 0.

The global batch's two data shards hold different numbers of valid rounds
(disc) and answer tokens (gen), so a mean taken per shard and then averaged
would miss (the normalisation check).  Each world runs in spawned processes
(parallel/launch.py::run_ranks) with a timeout of its own."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from visdial_tpu.data.loader import BatchAssembler
from visdial_tpu.data.synthetic import make_synthetic_split, synthetic_vocab
from visdial_tpu.parallel.mesh import make_mesh as jax_make_mesh
from visdial_tpu.parallel.mesh import shard_batch
from visdial_tpu.parallel.train_step import init_train_state as jax_init
from visdial_tpu.parallel.train_step import make_train_fn
from visdial_tpu.parallel.train_step import shard_train_state as jax_shard
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu.utils.checkpoint import load_checkpoint as jax_load
from visdial_tpu_torch.config import Config as PortConfig
from visdial_tpu_torch.data.loader import BatchAssembler as PortAssembler
from visdial_tpu_torch.data.synthetic import (
    make_synthetic_split as port_synthetic_split)
from visdial_tpu_torch.data.synthetic import (
    synthetic_vocab as port_synthetic_vocab)
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.parallel.launch import run_ranks
from visdial_tpu_torch.parallel.train_step import train_step
from visdial_tpu_torch.utils.checkpoint import latest_checkpoint, load_train_state
from visdial_tpu_torch.utils.params import params_from_numpy, params_to_numpy

import torch_dist_workers as workers
from conftest import small_config

torch.set_num_threads(1)
TIMEOUT = 240
DIALOGS = 8


def _case(decoder: str, vocab_words: int = 50):
    """(JAX cfg, port cfg, the JAX global batch, the port's data shards per
    data-axis size) for MN-QIH-<decoder>.  Dialogs 0 and 1 (data rank 0's
    with 2 shards) lose two valid rounds (disc) or two rounds' answers
    (gen)."""
    cfg = small_config(encoder="mn-ques-im-hist", decoder=decoder,
                       batch_size=DIALOGS)
    split, vocab = make_synthetic_split(cfg, num_dialogs=DIALOGS, seed=3,
                                        vocab=synthetic_vocab(vocab_words))
    cfg = cfg.replace(vocab_size=vocab.size)
    pcfg = PortConfig.from_dict(dataclasses.asdict(cfg))
    psplit, pvocab = port_synthetic_split(
        pcfg, num_dialogs=DIALOGS, seed=3,
        vocab=port_synthetic_vocab(vocab_words))

    def perturb(b, lo):
        b = {k: np.array(v) for k, v in b.items()}
        for d in range(max(0, -lo), max(0, 2 - lo)):
            if decoder == "disc":
                b["round_valid"][d, 1:3] = 0
            else:
                b["ans_in"][d, 1:3, 1:] = 0
        return b

    batch = perturb(BatchAssembler(split, vocab, cfg).assemble(
        np.arange(DIALOGS)).as_dict(), 0)
    asm = PortAssembler(psplit, pvocab, pcfg)

    def shards(data):
        n = DIALOGS // data
        return [perturb(asm.assemble(np.arange(d * n, (d + 1) * n),
                                     dedup_options=decoder == "disc").as_dict(),
                        d * n) for d in range(data)]

    return cfg, pcfg, batch, shards, (psplit, pvocab)


def _counts(shard, decoder):
    if decoder == "disc":
        return int(shard["round_valid"].sum())
    has = shard["ans_in"][..., 1] != 0
    return int(((shard["ans_out"] != 0) & has[..., None]).sum())


def _jax_steps(cfg, batch, shape, steps=3):
    mesh = jax_make_mesh(*shape)
    state = jax_shard(jax_init(cfg), cfg, mesh)
    fn = make_train_fn(cfg, mesh)
    losses = []
    for _ in range(steps):
        state, m = fn(state, shard_batch(batch, mesh))
        losses.append(float(m["loss"]))
    return losses, _tree_to_dict(state.params)


@pytest.mark.parametrize("decoder,shape,vocab_words", [
    ("disc", (2, 1), 50),
    ("gen", (2, 1), 50),
    ("disc", (2, 2), 50),
    # vocab 54 on a 2-wide model axis: the embedding and LM head sharded
    ("gen", (2, 2), 50),
    # vocab 51, which 2 does not divide: those leaves degrade to replicated
    ("gen", (2, 2), 47),
], ids=["disc-2x1", "gen-2x1", "disc-2x2", "gen-2x2", "gen-2x2-ragged"])
def test_mesh_step_matches_jax_sharded_step(decoder, shape, vocab_words):
    cfg, pcfg, batch, shards, _ = _case(decoder, vocab_words)
    parts = shards(shape[0])
    assert _counts(parts[0], decoder) != _counts(parts[1], decoder)
    params_np = _tree_to_dict(jax_init(cfg).params)
    want_losses, want = _jax_steps(cfg, batch, shape)
    results = run_ranks(workers.train, shape[0] * shape[1], pcfg, params_np,
                        parts, shape, 3, timeout=TIMEOUT)
    for losses, _, params, local in results:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
        assert params.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(params[k], want[k], atol=1e-4,
                                       err_msg=k)
    sharded = shape[1] > 1 and pcfg.vocab_size % shape[1] == 0
    local = results[0][3]
    assert (local["embed/table"][0] < pcfg.vocab_size) == sharded
    if decoder == "gen":
        assert (local["decoder/out_proj/w"][1] < pcfg.vocab_size) == sharded


def test_mesh_step_sums_unequal_shards_like_one_device():
    """(2, 1) mesh against the port's own one-device step on the global
    batch: the shards' counts differ, and the mesh loss is the global
    batch's (a per-shard mean averaged over the shards is not).  The init
    is scaled 4x so that the rounds' losses differ."""
    cfg, pcfg, batch, shards, _ = _case("disc")
    parts = shards(2)
    params_np = {k: v * 4 for k, v in _tree_to_dict(jax_init(cfg).params).items()}
    mesh_losses = run_ranks(workers.train, 2, pcfg, params_np, parts, (2, 1),
                            1, timeout=TIMEOUT)[0][0]
    from visdial_tpu_torch.parallel.optim import init_opt_state
    from visdial_tpu_torch.parallel.train_step import TrainState

    params = params_from_numpy(params_np, pcfg, "cpu")
    state = TrainState(params, init_opt_state(params, pcfg), torch.Generator())
    _, m = train_step(state, batch_to_device(batch, "cpu"), pcfg)
    np.testing.assert_allclose(mesh_losses[0], float(m["loss"]), rtol=1e-5)
    per_shard = []
    for p in parts:
        st = TrainState(params, init_opt_state(params, pcfg), torch.Generator())
        per_shard.append(float(train_step(st, batch_to_device(p, "cpu"),
                                          pcfg)[1]["loss"]))
    assert abs(np.mean(per_shard) - float(m["loss"])) > 1e-4


@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_sharded_eval_matches_one_device(decoder):
    """Ranks, candidate rankings and metrics of the (2, 1) streaming and
    resident evals equal one device's, at a batch the data axis divides (4)
    and one it does not (3, replicated on both ranks)."""
    cfg, pcfg, _, _, (psplit, pvocab) = _case(decoder)
    params_np = _tree_to_dict(jax_init(cfg).params)
    cases = [(4, False), (4, True), (3, False), (3, True)]
    results = run_ranks(workers.evaluate, 2, pcfg, params_np, psplit, pvocab,
                        (2, 1), cases, timeout=TIMEOUT)
    params = params_from_numpy(params_np, pcfg, "cpu")
    for i, (bs, resident) in enumerate(cases):
        m, ranks, cand = evaluate_split(params, psplit, pvocab, pcfg, "cpu",
                                        batch_size=bs, return_ranks=True,
                                        collect_rankings=True,
                                        resident=resident)
        for rank_out in results:
            got_m, got_r, got_c = rank_out[i]
            np.testing.assert_array_equal(got_r, ranks)
            np.testing.assert_array_equal(got_c, cand)
            for k, v in got_m.items():
                assert v == pytest.approx(m[k], rel=1e-12), (bs, resident, k)


def test_checkpoint_crosses_from_2x2_to_one_device_and_jax(tmp_path):
    """A (2, 2) gen run's checkpoint (whole arrays gathered from the vocab
    shards) resumes on one device here and in the JAX package: the same
    params and moments, and the next step's loss equal in both."""
    cfg, pcfg, batch, shards, _ = _case("gen")
    params_np = _tree_to_dict(jax_init(cfg).params)
    save = str(tmp_path / "ckpt")
    results = run_ranks(workers.train, 4, pcfg, params_np, shards(2), (2, 2),
                        2, save, timeout=TIMEOUT)
    path = latest_checkpoint(save)
    assert path.endswith("step_00000002")
    state, cfg_saved, _ = load_train_state(path, "cpu")
    assert cfg_saved == pcfg
    got = params_to_numpy(state.params)
    for k, v in results[0][2].items():
        np.testing.assert_array_equal(got[k], v)
    jstate, _, _ = jax_load(path)
    jparams = _tree_to_dict(jstate.params)
    for k in got:
        np.testing.assert_array_equal(jparams[k], got[k])
    np.testing.assert_array_equal(_tree_to_dict(jstate.opt.m)["embed/table"],
                                  params_to_numpy(state.opt.m)["embed/table"])
    assert int(jstate.opt.step) == state.opt.step == 2
    _, m = train_step(state, batch_to_device(batch, "cpu"), pcfg)
    mesh1 = jax_make_mesh(1, 1, devices=jax.devices()[:1])
    _, jm = make_train_fn(cfg, mesh1)(jstate, shard_batch(batch, mesh1))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
