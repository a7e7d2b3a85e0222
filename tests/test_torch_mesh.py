"""The port's process grid (visdial_tpu_torch/parallel/mesh.py): make_mesh's
fill, fail-fast and smaller-mesh exit (gloo worlds of 2 and 4 processes),
param_layout for every leaf against the JAX package's param_pspec +
tree_shardings on the same tree (the ragged vocab included), the
dialog-axis rule of batch slicing and the loaders' shards, and the plain
versions of K5 and K6 on targets outside the vocab shard."""

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.data.synthetic import synthetic_vocab
from visdial_tpu.parallel.mesh import make_mesh as jax_make_mesh
from visdial_tpu.parallel.mesh import tree_shardings
from visdial_tpu.parallel.train_step import init_train_state as jax_init
from visdial_tpu.utils.tree import tree_path_str
from visdial_tpu_torch.config import Config as PortConfig
from visdial_tpu_torch.data.loader import (BatchAssembler, DenseLoader,
                                           TrainLoader)
from visdial_tpu_torch.data.synthetic import make_synthetic_split
from visdial_tpu_torch.ops.lm_loss import combine_shards, target_logit
from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,
                                            lm_token_logprobs_lse_plain)
from visdial_tpu_torch.parallel.launch import run_ranks
from visdial_tpu_torch.parallel.mesh import (Mesh, VocabShard, make_mesh,
                                             param_layout, slice_dialogs)
from visdial_tpu_torch.utils.params import param_shapes

import torch_dist_workers as workers
from conftest import small_config

torch.set_num_threads(1)


def _mesh(data, model):
    return Mesh(data, model, 0, 0, torch.device("cpu"))


def test_world_of_one_fills_and_fails_fast():
    mesh = make_mesh(-1, 1, device="cpu")
    assert (mesh.data, mesh.model, mesh.d, mesh.m, mesh.world) == (1, 1, 0, 0, 1)
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(SystemExit, match="model=2 does not divide the 1"):
        make_mesh(-1, 2, device="cpu")
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        make_mesh(2, 1, device="cpu")


def test_mesh_fills_a_world_of_four_data_major():
    got = run_ranks(workers.mesh_shape, 4, -1, 2, timeout=120)
    # rank = d * model + m, as np.reshape(devices, (data, model))
    assert got == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]


def test_smaller_mesh_than_the_world_exits():
    """A deliberate divergence from JAX, which idles the extra devices: a
    process group cannot, so the run exits naming the launch that fits."""
    got = run_ranks(workers.mesh_shape, 2, 1, 1, timeout=120)
    for msg in got:
        assert isinstance(msg, str) and "torchrun --nproc_per_node 1" in msg


@pytest.mark.parametrize("decoder,vocab_words,shape", [
    ("gen", 50, (4, 2)),     # vocab 54: sharded on a 2-wide model axis
    ("gen", 47, (4, 2)),     # vocab 51: ragged, those leaves replicated
    ("gen", 50, (2, 4)),     # vocab 54 on 4: ragged
    ("disc", 46, (2, 4)),    # vocab 50 on 4: ragged
    ("disc", 48, (2, 4)),    # vocab 52 on 4: the table sharded
    ("gen", 50, (8, 1)),     # no model axis: all replicated
])
def test_param_layout_matches_jax_tree_shardings(decoder, vocab_words, shape):
    cfg = small_config(encoder="mn-ques-im-hist", decoder=decoder,
                       vocab_size=synthetic_vocab(vocab_words).size)
    jmesh = jax_make_mesh(*shape)
    template = jax.eval_shape(lambda: jax_init(cfg).params)
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(
            tree_shardings(template, jmesh)):
        dims = [i for i, a in enumerate(sh.spec) if a == "model"]
        want[tree_path_str(path)] = (dims[0] if dims and shape[1] > 1
                                     else None)
    pcfg = PortConfig(**{k: getattr(cfg, k)
                         for k in PortConfig.__dataclass_fields__})
    shapes = param_shapes(pcfg)
    assert shapes.keys() == want.keys()
    got = {k: param_layout(k, s, _mesh(*shape)) for k, s in shapes.items()}
    assert got == want
    sharded = {k for k, v in got.items() if v is not None}
    if shape[1] > 1 and cfg.vocab_size % shape[1] == 0:
        assert "embed/table" in sharded


@pytest.fixture(scope="module")
def split():
    cfg = PortConfig(**{k: getattr(small_config(), k)
                        for k in PortConfig.__dataclass_fields__})
    data, vocab = make_synthetic_split(cfg, num_dialogs=10, seed=0)
    return data, vocab, cfg.replace(vocab_size=vocab.size, batch_size=4)


def test_slice_dialogs_takes_dialogs_and_refuses_other_leading_axes(split):
    data, vocab, cfg = split
    asm = BatchAssembler(data, vocab, cfg)
    whole = asm.assemble(np.arange(4)).as_dict()
    part = slice_dialogs(whole, 2, 4)
    want = asm.assemble(np.arange(2, 4)).as_dict()
    assert part.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(part[k], want[k], err_msg=k)
    dedup = asm.assemble(np.arange(4), dedup_options=True).as_dict()
    with pytest.raises(ValueError, match="opt_uniq"):
        slice_dialogs(dedup, 0, 2)
    with pytest.raises(ValueError, match="opt_row"):
        slice_dialogs({"opt_row": dedup["opt_row"]}, 0, 2)
    with pytest.raises(ValueError, match="leads with"):
        slice_dialogs({"ques": whole["ques"], "img": whole["img"][:3]}, 0, 2)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_train_loader_shards_assemble_their_own_dialogs(split, drop_remainder):
    """Rank d's shard is assembled alone from dialogs [2d, 2d + 2) of each
    global batch (the same permutation on every rank), its deduplicated
    candidate rows its own; the padded tail keeps dialog_valid 0."""
    data, vocab, cfg = split
    loader = TrainLoader(data, vocab, cfg, drop_remainder=drop_remainder,
                         prefetch=1)
    whole = [b.as_dict() for b in loader.epoch(seed=5)]
    shards = [[b.as_dict() for b in loader.epoch(seed=5, shard=(d, 2))]
              for d in range(2)]
    asm = BatchAssembler(data, vocab, cfg)
    order = np.random.default_rng(5).permutation(10)
    assert len(shards[0]) == len(shards[1]) == len(whole)
    for s, full in enumerate(whole):
        idx = order[4 * s: 4 * s + 4]
        idx = np.concatenate([idx, np.repeat(idx[-1:], 4 - len(idx))])
        for d in range(2):
            got = shards[d][s]
            want = asm.assemble(idx[2 * d: 2 * d + 2],
                                dedup_options=True).as_dict()
            for k in want:
                if k != "dialog_valid":
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(
                got["dialog_valid"], full["dialog_valid"][2 * d: 2 * d + 2])
            np.testing.assert_array_equal(got["ques"],
                                          full["ques"][2 * d: 2 * d + 2])
    with pytest.raises(ValueError, match="not divisible"):
        next(iter(loader.epoch(seed=5, shard=(0, 3))))


def test_dense_loader_shards_the_padded_batch(split):
    data, vocab, cfg = split
    dense = [{"image_id": int(data.img_ids[i]), "round_id": 1,
              "gt_relevance": list(np.linspace(0, 1, cfg.num_options))}
             for i in range(7)]
    loader = DenseLoader(data, vocab, cfg, dense)
    whole = list(loader.epoch(seed=1))
    for d in range(2):
        for full, got in zip(whole, loader.epoch(seed=1, shard=(d, 2))):
            for k in full:
                np.testing.assert_array_equal(got[k],
                                              full[k][2 * d: 2 * d + 2], k)


def test_plain_lm_versions_on_vocab_shards():
    """K5's and K6's plain versions on 2 column shards with re-based and -1
    targets, combined as the model axis combines them, equal the whole
    vocab's: a target outside a shard gives logp = -lse there and no one-hot
    term."""
    g = torch.Generator().manual_seed(0)
    NT, H, V = 40, 8, 30
    x, w = torch.randn(NT, H, generator=g), torch.randn(H, V, generator=g)
    b = torch.randn(V, generator=g)
    tgt = torch.randint(0, V, (NT,), generator=g)
    cot = torch.randn(NT, generator=g)
    logp, lse = lm_token_logprobs_lse_plain(x, w, b, tgt)
    lses, tls, dlog = [], [], []
    for m in range(2):
        shard = VocabShard(m, 2, V // 2, None)
        cols = slice(shard.lo, shard.lo + shard.size)
        local = shard.local_ids(tgt)
        assert bool(((local == -1) == ((tgt < shard.lo)
                                       | (tgt >= shard.lo + shard.size))).all())
        lp, ls = lm_token_logprobs_lse_plain(x, w[:, cols], b[cols], local)
        torch.testing.assert_close(lp[local < 0], -ls[local < 0])
        lses.append(ls)
        tls.append(target_logit(lp, ls, local))
    got_logp, got_lse = combine_shards(torch.stack(lses), torch.stack(tls))
    torch.testing.assert_close(got_logp, logp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_lse, lse, rtol=1e-6, atol=1e-6)
    for m in range(2):
        shard = VocabShard(m, 2, V // 2, None)
        cols = slice(shard.lo, shard.lo + shard.size)
        dlog.append(lm_dlogits_plain(x, w[:, cols], b[cols],
                                     shard.local_ids(tgt), lse, cot))
    torch.testing.assert_close(torch.cat(dlog, dim=1),
                               lm_dlogits_plain(x, w, b, tgt, lse, cot))
