"""The compiled dispatch over a mesh and under remat (the train and eval
factories of visdial_tpu_torch/parallel/train_step.py with a mesh, the
remat recomputation's generator) on the CPU, where each graph's function
runs eagerly: so these cases test the graphs' bodies with the mesh, on gloo
process groups (parallel/launch.py::run_ranks), at small_config widths:

- make_train_fn, make_multistep_train_fn and make_dense_train_fn on (2, 1),
  (2, 2) and (2, 2) with a vocab the model axis does not divide, against
  the JAX factories on the JAX sharded mesh of the same shape at dropout 0
  (loss rtol 1e-4, params atol 1e-4: tests/test_torch_distributed.py's
  limits), and against the port's eager mesh train_step / multi_train_step
  at dropout 0.5 bit for bit, with equal collectives (the data coordinate's
  seed offset: the two data ranks draw different masks);
- the factories under cfg.remat on one device and on (1, 2) (a vocab
  shard): bit for bit the eager remat step at dropout 0.5, and JAX's remat
  factory at dropout 0; on one device the remat step equals the step
  without remat bit for bit at dropout 0;
- evaluate_split through factories made for the mesh and passed, on (2, 1)
  and (2, 2): metrics, ranks and candidate rankings equal one device's;
- a disc mesh step over a batch without round_valid (its count made on the
  device) in a world of one: the factory equal to the eager mesh step, the
  loss the one-device step's;
- on test_torch_graphs.py's stand-ins for torch.cuda's graph API, in a gloo
  world of one: a mesh factory captures once for its signature and each
  replay adds the collectives its capture issued; under remat the
  recomputation's generators are registered and re-seeded from the
  encoder's seed;
- make_mesh's first collective on each of its groups, which makes a NCCL
  group's communicator before any capture.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from visdial_tpu.parallel.mesh import make_mesh as jax_make_mesh
from visdial_tpu.parallel.mesh import shard_batch, shard_batch_stack
from visdial_tpu.parallel.train_step import init_train_state as jax_init
from visdial_tpu.parallel.train_step import (
    make_dense_train_fn as jax_dense_fn,
    make_multistep_train_fn as jax_multi_fn,
    make_train_fn as jax_train_fn,
    shard_train_state as jax_shard)
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu_torch.config import Config as PortConfig
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.parallel import mesh as mesh_mod
from visdial_tpu_torch.parallel.launch import free_port, run_ranks
from visdial_tpu_torch.parallel.mesh import make_mesh, slice_dialogs
from visdial_tpu_torch.parallel.train_step import (GraphedTrainStep,
                                                   make_multistep_train_fn,
                                                   make_train_fn,
                                                   multi_train_step,
                                                   step_seeds, train_step)
from visdial_tpu_torch.utils.params import flatten, params_from_numpy

import torch_dist_workers as workers
from test_torch_distributed import _case
from test_torch_finetune import _dense_batch
from test_torch_graphs import _dropout_case, _fresh, fake_card  # noqa: F401

torch.set_num_threads(1)
TIMEOUT = 240
FACTORIES = ("make_train_fn", "make_multistep_train_fn", "make_dense_train_fn")


def _port(cfg):
    return PortConfig.from_dict(dataclasses.asdict(cfg))


def _jax_run(name, cfg, batch, shape, calls, params=None):
    """The JAX factory `name` on the (data, model) mesh: `calls` calls of
    make_train_fn / make_dense_train_fn on batch, or one call of
    make_multistep_train_fn on a stack of `calls` copies; (losses, whole
    params)."""
    mesh = jax_make_mesh(*shape)
    state = jax_init(cfg)
    if params is not None:
        state = state._replace(params=params)
    state = jax_shard(state, cfg, mesh)
    losses = []
    if name == "make_multistep_train_fn":
        state, m = jax_multi_fn(cfg, mesh)(
            state, shard_batch_stack([batch] * calls, mesh))
        losses = np.asarray(m["loss"]).tolist()
    else:
        fn = (jax_train_fn if name == "make_train_fn" else jax_dense_fn)(
            cfg, mesh)
        for _ in range(calls):
            state, m = fn(state, shard_batch(batch, mesh))
            losses.append(float(m["loss"]))
    return losses, _tree_to_dict(state.params)


def _cases(decoder, vocab_words, data, names, remat=False):
    """[(factory, JAX cfg, JAX batch, JAX params, the port's case)] for each
    factory of `names`: the train factories on _case's MN-QIH batch (two
    calls; multistep one call of two steps), the dense factory (disc) on
    one dense batch (its 4 dialogs split over the data axis, three of them
    annotated)."""
    cfg, pcfg, batch, shards, _ = _case(decoder, vocab_words)
    cfg, pcfg = cfg.replace(remat=remat), pcfg.replace(remat=remat)
    params_np = _tree_to_dict(jax_init(cfg).params)
    parts = shards(data)
    out = [(name, cfg, batch, None, (name, pcfg, params_np, parts, 2))
           for name in names if name != "make_dense_train_fn"]
    if "make_dense_train_fn" in names:
        dcfg, jparams, dense = _dense_batch("mn-ques-im-hist")
        dcfg = dcfg.replace(remat=remat)
        n = len(dense["ques"]) // data
        dparts = [slice_dialogs(dense, d * n, (d + 1) * n) for d in range(data)]
        out.append(("make_dense_train_fn", dcfg, dense, jparams,
                    ("make_dense_train_fn", _port(dcfg),
                     _tree_to_dict(jparams), dparts, 1)))
    return out


def _run_against_jax(cases, shape):
    """The port's cases on a gloo world of `shape` (mesh_factories) while a
    thread runs the JAX factories of the same cases (their compiles
    overlap the ranks' run), then each held to the other."""
    wants, failed = {}, []

    def jax_side():
        try:
            for name, cfg, batch, jparams, port in cases:
                wants[name] = _jax_run(name, cfg, batch, shape, port[-1],
                                       jparams)
        except BaseException as e:           # re-raised on the test's thread
            failed.append(e)

    thread = threading.Thread(target=jax_side)
    thread.start()
    try:
        results = run_ranks(workers.mesh_factories, shape[0] * shape[1],
                            shape, [c[-1] for c in cases], timeout=TIMEOUT)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    for name, *_ in cases:
        want_losses, want = wants[name]
        for got in results:
            losses, equal, params = got[(name, 0.0)]
            assert equal, name                 # the eager mesh step's bits
            np.testing.assert_allclose(losses, want_losses, rtol=1e-4,
                                       err_msg=name)
            assert params.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(params[k], want[k], atol=1e-4,
                                           err_msg=f"{name} {k}")
            losses5, equal5, _ = got[(name, 0.5)]
            assert equal5, name                # dropout 0.5 bit for bit
            assert losses5 != losses, name     # the masks did something


@pytest.mark.parametrize("decoder,shape,vocab_words,names", [
    ("disc", (2, 1), 50, FACTORIES),
    ("disc", (2, 2), 50, ("make_train_fn", "make_dense_train_fn")),
    ("gen", (2, 2), 50, FACTORIES[:2]),
    # vocab 51, which 2 does not divide: those leaves stay replicated
    ("gen", (2, 2), 47, FACTORIES[:2]),
], ids=["disc-2x1", "disc-2x2", "gen-2x2", "gen-2x2-ragged"])
def test_mesh_factories_match_jax_and_the_eager_mesh_steps(decoder, shape,
                                                           vocab_words, names):
    """Every train factory on the mesh: the JAX factory's losses and params
    at dropout 0; the eager mesh step's metrics, params, moments, CPU
    generator and collectives bit for bit at dropout 0 and 0.5 (where the
    second data row's masks come from its seeds plus its coordinate: a
    graph that seeded it as the first row would miss)."""
    _run_against_jax(_cases(decoder, vocab_words, shape[0], names), shape)


def test_remat_factories_on_a_vocab_shard():
    """cfg.remat on a (1, 2) mesh, MN-QIH-gen with its embedding and LM head
    split over the model axis (the recomputed embedding's reduction over
    the model group): make_train_fn equal to the eager remat mesh step bit
    for bit at dropout 0.5, and to JAX's remat factory at dropout 0."""
    _run_against_jax(_cases("gen", 50, 1, FACTORIES[:1], remat=True), (1, 2))


@pytest.mark.parametrize("group", [1, 2], ids=["make_train_fn",
                                               "make_multistep_train_fn"])
def test_remat_factories_on_one_device(group):
    """cfg.remat on one device: two calls of the factory equal the eager
    remat steps bit for bit at dropout 0.5 (the recomputation redraws the
    forward's masks from its own generator); at dropout 0 they equal the
    factory without remat bit for bit, and JAX's remat factory (losses
    rtol 1e-4, params atol 1e-4)."""
    cfg, batches = _dropout_case()
    cfg = cfg.replace(remat=True)
    groups = [batches[:1], batches[1:2]] if group == 1 else [batches[:2],
                                                              batches[2:4]]
    calls = [g[0] if group == 1 else
             {k: torch.stack([b[k] for b in g]) for k in g[0]}
             for g in groups]
    make, eager = ((make_train_fn, train_step) if group == 1
                   else (make_multistep_train_fn, multi_train_step))
    fn, ref = make(cfg), _fresh(cfg)
    state = _fresh(cfg)
    for b in calls:
        state, m = fn(state, b)
        ref, me = eager(ref, b, cfg)
        for k in ("loss", "grad_norm", "lr", "step"):
            assert torch.equal(torch.as_tensor(m[k]), torch.as_tensor(me[k])), k
    for k, v in flatten(ref.params).items():
        assert torch.equal(flatten(state.params)[k], v), k
    assert torch.equal(state.gen.get_state(), ref.gen.get_state())
    # dropout 0: remat changes nothing, and it is JAX's remat step
    cfg0 = cfg.replace(dropout=0.0)
    a, b_ = make(cfg0), make(cfg0.replace(remat=False))
    sa, sb = _fresh(cfg0), _fresh(cfg0)
    for b in calls:
        sa, ma = a(sa, b)
        sb, mb = b_(sb, b)
        assert torch.equal(torch.as_tensor(ma["loss"]),
                           torch.as_tensor(mb["loss"]))
    for k, v in flatten(sb.params).items():
        assert torch.equal(flatten(sa.params)[k], v), k
    mesh = jax_make_mesh(1, 1, devices=jax.devices()[:1])
    jstate = jax_init(cfg0)
    jstate = jstate._replace(params=jax.tree.map(lambda p: p * 8,
                                                 jstate.params))
    params = params_from_numpy(_tree_to_dict(jstate.params), cfg0, "cpu")
    state = _fresh(cfg0)._replace(params=params)
    jstate = jax_shard(jstate, cfg0, mesh)
    jfn = (jax_train_fn if group == 1 else jax_multi_fn)(cfg0, mesh)
    fn = make(cfg0)
    for g, b in zip(groups, calls):
        host = [{k: v.numpy() for k, v in x.items()} for x in g]
        jstate, jm = jfn(jstate, shard_batch(host[0], mesh) if group == 1
                         else shard_batch_stack(host, mesh))
        state, m = fn(state, b)
        np.testing.assert_allclose(np.asarray(m["loss"]),
                                   np.asarray(jm["loss"]), rtol=1e-4)
    want = _tree_to_dict(jstate.params)
    for k, v in flatten(state.params).items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_mesh_evals_through_the_factories_equal_one_device(shape):
    """evaluate_split on the mesh through the eval factories made for it
    (graphs, their bodies run eagerly here), disc and gen, streaming and
    resident: the metrics, ranks and candidate rankings of one device."""
    cases = []
    for decoder in ("disc", "gen"):
        cfg, pcfg, _, _, (split, vocab) = _case(decoder)
        params_np = _tree_to_dict(jax_init(cfg).params)
        params_np = {k: v * 4 for k, v in params_np.items()}
        cases.append((pcfg, params_np, split, vocab, 4))
    results = run_ranks(workers.evaluate_factories, shape[0] * shape[1],
                        shape, cases, timeout=TIMEOUT)
    want = []
    for pcfg, params_np, split, vocab, bs in cases:
        params = params_from_numpy(params_np, pcfg, "cpu")
        for resident in (False, True):
            want.append(evaluate_split(params, split, vocab, pcfg, "cpu",
                                       batch_size=bs, return_ranks=True,
                                       collect_rankings=True,
                                       resident=resident))
    for got in results:
        assert len(got) == len(want)
        for (gm, gr, gc), (m, r, c) in zip(got, want):
            np.testing.assert_array_equal(gr, r)
            np.testing.assert_array_equal(gc, c)
            for k, v in gm.items():
                assert v == pytest.approx(m[k], rel=1e-12), k


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process and its (1, 1)
    mesh, whose collectives are real calls that act as the identity (the
    smoke's NCCL world of one, on the CPU); torn down after the test."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_disc_mesh_step_without_round_valid(world_of_one):
    """A disc batch with no round_valid key: its count is made on the
    device; the factory on the world-of-one mesh equals the eager mesh step
    bit for bit at dropout 0.5, and at dropout 0 the loss is the one-device
    step's (rtol 1e-6)."""
    mesh = world_of_one
    cfg, batches = _dropout_case()
    batch = {k: v for k, v in batches[0].items() if k != "round_valid"}
    assert "round_valid" in batches[0]
    fn = make_train_fn(cfg, mesh)
    assert fn.steps.mesh is mesh
    got, m = fn(_fresh(cfg), batch)
    want, me = train_step(_fresh(cfg), batch, cfg, mesh=mesh)
    assert torch.equal(m["loss"], me["loss"])
    for k, v in flatten(want.params).items():
        assert torch.equal(flatten(got.params)[k], v), k
    cfg0 = cfg.replace(dropout=0.0)
    _, m0 = make_train_fn(cfg0, mesh)(_fresh(cfg0), batch)
    _, m1 = train_step(_fresh(cfg0), batch, cfg0)
    np.testing.assert_allclose(float(m0["loss"]), float(m1["loss"]),
                               rtol=1e-6)


def test_mesh_factory_captures_once_and_replays_its_collectives(
        fake_card, world_of_one):
    """On the stand-ins: a mesh factory's first call captures (its warm-up
    issues the step's collectives; the capture's are taken back out), a
    later call of the same signature replays and adds the same count
    again, a new signature captures anew."""
    mesh = world_of_one
    cfg, batches = _dropout_case()
    fn = make_multistep_train_fn(cfg, mesh)
    stack = {k: torch.stack([b[k] for b in batches[:2]]) for k in batches[0]}
    n0 = mesh_mod.collectives
    _, me = multi_train_step(_fresh(cfg), stack, cfg, mesh=mesh)
    per_call = mesh_mod.collectives - n0
    # a step: the count, the loss, one gradient bucket
    assert per_call == 2 * 3
    state, m = fn(_fresh(cfg), stack)
    assert mesh_mod.collectives - n0 == 2 * per_call
    assert torch.equal(m["loss"], me["loss"])
    for _ in range(2):
        state, _ = fn(state, stack)
    assert fn.captures == 1 and fake_card[0].replays == 2
    assert mesh_mod.collectives - n0 == 4 * per_call
    fn(state, {k: v[:1] for k, v in stack.items()})      # G = 1: a new graph
    assert fn.captures == 2 and len(fake_card) == 2
    assert mesh_mod.collectives - n0 == 4 * per_call + per_call // 2


def test_remat_graph_reseeds_its_recompute_generators(fake_card,
                                                      world_of_one):
    """Under cfg.remat the factory registers three generators a step with
    its graph, seeds the recomputation's with the encoder's seed (plus the
    data coordinate) before every call, and the recomputation draws from
    it as the forward drew from the encoder's: the two end in one state."""
    mesh = world_of_one
    cfg, batches = _dropout_case()
    cfg = cfg.replace(remat=True)
    fn = make_multistep_train_fn(cfg, mesh)
    stack = {k: torch.stack([b[k] for b in batches[:2]]) for k in batches[0]}
    state = _fresh(cfg)
    for call in ("capture", "replay"):
        seeds = step_seeds(_copy(state.gen), 2)
        state, _ = fn(state, stack)
        gens = fn.steps.generators(2, "cpu")
        for g, (enc, dec) in zip(gens, seeds):
            assert g.encoder.initial_seed() == g.recompute.initial_seed() \
                == enc + mesh.d
            assert g.decoder.initial_seed() == dec + mesh.d
            seeded = torch.Generator().manual_seed(enc + mesh.d).get_state()
            if call == "capture":
                # the warm-up and the stand-in capture drew the same masks
                # from each: the forward's and the recomputation's
                assert torch.equal(g.encoder.get_state(),
                                   g.recompute.get_state())
                assert not torch.equal(g.recompute.get_state(), seeded)
            else:
                # re-seeded for the replay, which draws nothing here
                assert torch.equal(g.recompute.get_state(), seeded)
    (made,) = fake_card
    assert isinstance(fn, GraphedTrainStep) and fn.captures == 1
    assert made.generators == [x for g in fn.steps.generators(2, "cpu")
                               for x in g]
    assert len(made.generators) == 6


def _copy(gen: torch.Generator) -> torch.Generator:
    g = torch.Generator()
    g.set_state(gen.get_state())
    return g


def test_make_mesh_makes_each_groups_communicator(monkeypatch):
    """make_mesh issues one collective on its data group and then its model
    group (a NCCL communicator is made at a group's first collective, which
    a capture cannot do), outside the collectives count."""
    calls = []
    real = dist.all_reduce

    def recorded(t, group=None, **kw):
        calls.append(group)
        return real(t, group=group, **kw)

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        monkeypatch.setattr(dist, "all_reduce", recorded)
        n0 = mesh_mod.collectives
        mesh = make_mesh(1, 1, device="cpu")
        assert calls == [mesh.data_group, mesh.model_group]
        assert None not in calls and mesh_mod.collectives == n0
    finally:
        dist.destroy_process_group()
