"""Dense fine-tuning in the port (data/loader.py::DenseLoader,
models/model.py::model_dense_loss, train_step's loss_fn, finetune.py)
against the JAX package: DenseLoader batches byte for byte with its skips;
the dense loss and every gradient at dropout 0 in f32 (loss atol 1e-5,
gradients atol 1e-4 and 1e-4 of each leaf's largest, the limits of
tests/test_torch_train.py); one dense train step against
make_dense_train_fn; the dropout and remat rules; and the finetune CLI
against the JAX test's bar (NDCG up by 0.05, loss down to 0.8x) with a
checkpoint both packages reload."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.data.loader import DenseLoader as JaxDenseLoader
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.models import model as jax_model
from visdial_tpu.parallel.mesh import make_mesh, shard_batch
from visdial_tpu.parallel.train_step import init_train_state as jax_init_state
from visdial_tpu.parallel.train_step import (make_dense_train_fn,
                                             shard_train_state)
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from visdial_tpu_torch.data.loader import DenseLoader
from visdial_tpu_torch.finetune import main as finetune_main
from visdial_tpu_torch.models.model import batch_to_device, model_dense_loss
from visdial_tpu_torch.parallel.optim import init_opt_state
from visdial_tpu_torch.parallel.train_step import (TrainState, loss_and_grads,
                                                   multi_train_step, train_step)
from visdial_tpu_torch.train import main as train_main
from visdial_tpu_torch.utils.checkpoint import load_train_state
from visdial_tpu_torch.utils.params import flatten, params_from_numpy

from conftest import small_config

torch.set_num_threads(1)


def _dense_entries(split, cfg, rng):
    """One annotated round per image with relevance in {0, 0.5, 1}, plus
    one entry for each skip: an image not in the split, a round_id out of
    range, an all-zero relevance, a round without a full candidate list,
    and a relevance row of the wrong length."""
    n = split.num_dialogs
    entries = [{"image_id": int(split.img_ids[i]),
                "round_id": int(rng.integers(1, cfg.num_rounds + 1)),
                "gt_relevance": (rng.integers(0, 3, cfg.num_options) / 2).tolist()}
               for i in range(n - 4)]
    for e in entries:
        e["gt_relevance"][0] = 1.0
    ones = [1.0] * cfg.num_options
    entries += [{"image_id": 10_000, "round_id": 1, "gt_relevance": ones},
                {"image_id": int(split.img_ids[n - 4]), "round_id": 0,
                 "gt_relevance": ones},
                {"image_id": int(split.img_ids[n - 3]), "round_id": 1,
                 "gt_relevance": [0.0] * cfg.num_options},
                {"image_id": int(split.img_ids[n - 2]), "round_id": 2,
                 "gt_relevance": ones},
                {"image_id": int(split.img_ids[n - 1]), "round_id": 1,
                 "gt_relevance": ones[:-1]}]
    split.round_scoreable[n - 2, 1] = 0
    return entries


def _case(encoder="mn-ques-im-hist", batch_size=4, num_dialogs=11, **kw):
    cfg = small_config(encoder=encoder, decoder="disc", batch_size=batch_size,
                       **kw)
    split, vocab = make_synthetic_split(cfg, num_dialogs=num_dialogs, seed=3)
    cfg = cfg.replace(vocab_size=vocab.size)
    dense = _dense_entries(split, cfg, np.random.default_rng(0))
    return cfg, split, vocab, dense


def test_dense_loader_matches_jax_byte_for_byte():
    """7 usable entries in batches of 4 (the last padded, dense_valid 0),
    5 skipped; every key, dtype and byte equal over two epochs' orders."""
    cfg, split, vocab, dense = _case()
    got = DenseLoader(split, vocab, cfg, dense)
    want = JaxDenseLoader(split, vocab, cfg, dense)
    assert len(got) == len(want) == 7
    assert got.skipped == want.skipped == 5
    for seed in (0, 1):
        gb, wb = list(got.epoch(seed)), list(want.epoch(seed))
        assert len(gb) == len(wb) == 2
        for g, w in zip(gb, wb):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert gb[-1]["dense_valid"].tolist() == [1, 1, 1, 0]


def _dense_batch(encoder):
    cfg, split, vocab, dense = _case(encoder)
    batch = next(JaxDenseLoader(split, vocab, cfg, dense).epoch(0))
    batch["dense_valid"] = np.array([1, 1, 0, 1], np.int32)
    batch["dense_rel"] = batch["dense_rel"].copy()
    batch["dense_rel"][3] = 0.0            # no relevance: masked out too
    jparams = jax.tree.map(lambda p: p * 4,
                           jax_init_state(cfg).params)
    return cfg, jparams, batch


@pytest.mark.parametrize("encoder", ["mn-ques-im-hist", "lf-ques-im-hist"])
def test_dense_loss_and_every_grad_match_jax(encoder):
    """impl='cuda' on CPU tensors: the kernel path's autograd glue
    (LSTMLayerFn, the length sort of the B x K rows) with the plain
    versions inside."""
    cfg, jparams, batch = _dense_batch(encoder)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_model.model_dense_loss(p, batch, cfg, train=True,
                                             impl="xla"))(jparams)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    for impl in ("plain", "cuda"):
        loss, grads = loss_and_grads(params, batch_to_device(batch, "cpu"),
                                     cfg, None, impl, loss_fn=model_dense_loss)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
        want = _tree_to_dict(jgrads)
        got = {k: v.numpy() for k, v in flatten(grads).items()}
        assert got.keys() == want.keys()
        for k in want:
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k],
                                       atol=max(1e-4 * scale, 1e-7),
                                       err_msg=(impl, k))
            np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                       err_msg=(impl, k))


def test_dense_train_step_matches_make_dense_train_fn():
    """train_step(loss_fn=model_dense_loss) from the same params and a
    fresh optimizer state: the loss and the updated params equal one step
    of the JAX make_dense_train_fn (atol 1e-5, as the five-step trajectory
    test)."""
    cfg, jparams, batch = _dense_batch("mn-ques-im-hist")
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jstate = shard_train_state(jax_init_state(cfg)._replace(params=jparams),
                               cfg, mesh)                       # donated
    jnew, jm = make_dense_train_fn(cfg, mesh)(jstate, shard_batch(batch, mesh))
    state = TrainState(params, init_opt_state(params, cfg),
                       torch.Generator().manual_seed(0))
    new, m = train_step(state, batch_to_device(batch, "cpu"), cfg,
                        loss_fn=model_dense_loss)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
    assert m["step"] == int(jm["step"]) == 1
    want = _tree_to_dict(jnew.params)
    for k, v in flatten(new.params).items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, err_msg=k)


def test_multi_train_step_takes_the_dense_loss():
    """multi_train_step(loss_fn=model_dense_loss) over a stack of two dense
    batches equals two train_steps (the same arithmetic: equal)."""
    cfg, split, vocab, dense = _case()
    batches = list(DenseLoader(split, vocab, cfg, dense).epoch(0))
    params = params_from_numpy(_tree_to_dict(jax_init_state(cfg).params), cfg,
                               "cpu")
    state = TrainState(params, init_opt_state(params, cfg),
                       torch.Generator().manual_seed(0))
    for b in batches:
        state, m = train_step(state, batch_to_device(b, "cpu"), cfg,
                              loss_fn=model_dense_loss)
    stacked = batch_to_device({k: np.stack([b[k] for b in batches])
                               for k in batches[0]}, "cpu")
    fresh = TrainState(params, init_opt_state(params, cfg),
                       torch.Generator().manual_seed(0))
    multi, mm = multi_train_step(fresh, stacked, cfg, loss_fn=model_dense_loss)
    assert mm["loss"].shape == (2,) and float(mm["loss"][1]) == float(m["loss"])
    assert multi.opt.step == state.opt.step == 2
    for k, v in flatten(multi.params).items():
        torch.testing.assert_close(v, flatten(state.params)[k], rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
def test_dense_loss_dropout_follows_model_loss_rules(impl):
    """At dropout 0.5 the loss draws two seeds from the generator: the same
    seed gives the same loss on either path, remat recomputes the encoder
    with the forward's masks (loss and grads equal, atol 1e-6), and another
    seed gives another loss."""
    cfg, jparams, batch = _dense_batch("mn-ques-im-hist")
    cfg = cfg.replace(dropout=0.5)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    dev = batch_to_device(batch, "cpu")

    def run(c, seed, how=impl):
        return loss_and_grads(params, dev, c, torch.Generator().manual_seed(seed),
                              how, loss_fn=model_dense_loss)

    loss, grads = run(cfg, 7)
    loss_r, grads_r = run(cfg.replace(remat=True), 7)
    assert float(loss) == float(loss_r)
    for k, g in flatten(grads).items():
        torch.testing.assert_close(flatten(grads_r)[k], g, rtol=0, atol=1e-6)
    other = run(cfg, 7, "plain" if impl == "cuda" else "cuda")[0]
    np.testing.assert_allclose(float(other), float(loss), atol=1e-5)
    assert float(run(cfg, 8)[0]) != float(loss)
    with pytest.raises(ValueError):
        model_dense_loss(params, dev, cfg.replace(decoder="gen"))


TRAIN_ARGS = [
    "--synthetic", "16", "--encoder", "lf-ques-im", "--decoder", "disc",
    "--embed_size", "8", "--rnn_hidden_size", "16", "--img_feat_size", "16",
    "--max_ques_len", "4", "--max_ans_len", "3", "--max_cap_len", "5",
    "--num_rounds", "3", "--num_options", "5", "--batch_size", "8",
    "--dropout", "0.0", "--log_every", "100", "--max_steps", "2",
    "--save_every", "2", "--device", "cpu",
]


def test_finetune_raises_ndcg_and_lowers_loss(tmp_path, capsys):
    """tests/test_finetune.py's bar through the port's CLIs: dense targets
    that disagree with the sparse ground truth (relevance 1.0 on a fixed
    non-gt slot of round 2) pull NDCG up by more than 0.05 and the loss
    below 0.8x its first value; the JSONL events are the JAX CLI's; the
    checkpoint reloads in both packages."""
    root = str(tmp_path)
    train_main(TRAIN_ARGS + ["--save_path", root, "--run_name", "base"])
    load = f"{root}/base/step_00000002"
    state, cfg, _ = load_train_state(load, "cpu")
    split, _ = make_synthetic_split(cfg, num_dialogs=16, seed=cfg.seed + 1)
    dense = []
    for i in range(16):
        slot = (int(split.gt_ind[i, 1]) + 2) % cfg.num_options
        rel = [0.0] * cfg.num_options
        rel[slot] = 1.0
        dense.append({"image_id": int(split.img_ids[i]), "round_id": 2,
                      "gt_relevance": rel})
    dense_path = f"{root}/dense.json"
    with open(dense_path, "w") as f:
        json.dump(dense, f)
    capsys.readouterr()

    out = finetune_main([
        "--load_path", load, "--dense_json", dense_path,
        "--synthetic", "16", "--steps", "30", "--learning_rate", "0.02",
        "--save_path", root, "--run_name", "ft", "--eval_every", "15",
        "--log_every", "10", "--device", "cpu",
    ])
    events = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("{")]
    assert out["ndcg_after"] > out["ndcg_before"] + 0.05, out
    assert out["last_loss"] < out["first_loss"] * 0.8, out
    assert out["steps"] == 30
    ndcg = [e for e in events if e["event"] == "ndcg"]
    assert [e["step"] for e in ndcg] == [0, 15, 30, 30]
    assert all(e["ndcg_rounds"] == 16 and e["ndcg_missing"] == 0 for e in ndcg)
    steps = [e for e in events if e["event"] == "finetune"]
    assert [e["step"] for e in steps] == list(range(1, 31))
    assert {"loss", "lr", "grad_norm"} <= set(steps[0])
    assert all(e["lr"] == pytest.approx(0.02) for e in steps)
    assert events[-1]["event"] == "checkpoint"

    state2, cfg2, _ = load_train_state(out["checkpoint"], "cpu")
    assert cfg2.decoder == "disc" and cfg2.learning_rate == 0.02
    assert state2.opt.step == 30
    jstate, jcfg, _ = jax_load_checkpoint(out["checkpoint"])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg2)
    want = _tree_to_dict(jstate.params)
    for k, v in flatten(state2.params).items():
        assert np.isfinite(v.numpy()).all()
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    moved = max(float((v - flatten(state.params)[k]).abs().max())
                for k, v in flatten(state2.params).items())
    assert moved > 0.0
