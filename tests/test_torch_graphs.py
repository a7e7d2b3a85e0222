"""The port's compiled dispatch (visdial_tpu_torch/parallel/graph.py, the
factories in parallel/train_step.py, the engine's serve functions in
infer.py) on CPU tensors, where each runs its captured function eagerly:

- make_train_fn, make_multistep_train_fn (G = 3) and make_dense_train_fn
  against the JAX factories from the same init at dropout 0 in f32 (losses
  atol 1e-5, params atol 2e-5: the limits of tests/test_torch_train.py);
- the factories against the eager train_step / multi_train_step at dropout
  0.5, bit for bit (the same arithmetic, the dropout generators seeded from
  the state's in the eager order), the CPU generator left in the same state;
- the device step state (lr, Adam's scales) equal to the eager floats bit
  for bit over steps 0-200, and the seed schedule equal to G eager draws;
- the engine's packed disc [top_i; top_s] and gen [log_prob, tokens] against
  the JAX engine's _serve_disc_jit / _serve_gen_jit (indices and tokens
  equal, scores rtol 1e-4 as tests/test_torch_infer.py);
- the helper's bookkeeping, driven through stand-ins for torch.cuda's graph
  API: one capture a signature, static leaves in the signature, copy-in,
  cloned outputs, launch counts taken out of the capture and added on each
  replay, generators registered; and the factories' copy-in of a foreign
  state, remat accepted, the graph on a mesh of more than one rank.
"""

import contextlib
from functools import partial

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.data.loader import TrainLoader as JaxTrainLoader
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.infer import InferenceEngine as JaxEngine
from visdial_tpu.parallel import optim as jax_optim
from visdial_tpu.parallel.mesh import make_mesh, shard_batch
from visdial_tpu.parallel.train_step import init_train_state as jax_init_state
from visdial_tpu.parallel.train_step import (make_dense_train_fn as jax_dense_fn,
                                             make_multistep_train_fn as jax_multi_fn,
                                             make_train_fn as jax_train_fn,
                                             shard_train_state)
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu_torch.data.loader import TrainLoader
from visdial_tpu_torch.infer import InferenceEngine
from visdial_tpu_torch.models.core import split_seeds
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.ops.lstm_cuda import lstm_layer
from visdial_tpu_torch.parallel import graph
from visdial_tpu_torch.parallel.mesh import Mesh
from visdial_tpu_torch.parallel.optim import (init_opt_state, lr_at_step,
                                              step_scalars, tree_map)
from visdial_tpu_torch.parallel.train_step import (GraphedTrainStep, TrainState,
                                                   init_train_state,
                                                   make_dense_train_fn,
                                                   make_multistep_train_fn,
                                                   make_train_fn,
                                                   multi_train_step, step_seeds,
                                                   train_step)
from visdial_tpu_torch.utils.params import flatten, params_from_numpy

from conftest import small_config
from test_torch_finetune import _dense_batch
from test_torch_infer import QUERIES, _checkpoint

torch.set_num_threads(1)


def _jax_case(encoder="mn-ques-im-hist", batch_size=4, steps=6):
    cfg = small_config(encoder=encoder, batch_size=batch_size)
    split, vocab = make_synthetic_split(cfg, num_dialogs=16, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    loader = JaxTrainLoader(split, vocab, cfg)
    batches = [b.as_dict() for e in range(2) for b in loader.epoch(e)]
    assert len(batches) >= steps
    return cfg, batches[:steps]


def _port_state(jstate, cfg):
    params = params_from_numpy(_tree_to_dict(jstate.params), cfg, "cpu")
    return TrainState(params, init_opt_state(params, cfg),
                      torch.Generator().manual_seed(0))


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _assert_params(state, jstate, atol):
    want = _tree_to_dict(jstate.params)
    got = flatten(state.params)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("group", [1, 3], ids=["make_train_fn",
                                               "make_multistep_train_fn"])
def test_factories_match_the_jax_factories(group):
    """Two calls of the factory from the JAX init (group steps each) against
    the JAX factory's two calls: losses, grad norms (atol 1e-5; rtol 1e-5),
    lr and step equal, params atol 2e-5."""
    cfg, batches = _jax_case(steps=2 * group)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jstate = jax_init_state(cfg)
    state = _port_state(jstate, cfg)
    jstate = shard_train_state(jstate, cfg, mesh)
    if group == 1:
        jfn, fn = jax_train_fn(cfg, mesh), make_train_fn(cfg)
        calls = [shard_batch(b, mesh) for b in batches]
        port_calls = [batch_to_device(b, "cpu") for b in batches]
    else:
        jfn, fn = jax_multi_fn(cfg, mesh), make_multistep_train_fn(cfg)
        calls = [_stack(batches[:group]), _stack(batches[group:])]
        port_calls = [batch_to_device(c, "cpu") for c in calls]
    assert isinstance(fn, GraphedTrainStep)
    for jb, b in zip(calls, port_calls):
        jstate, jm = jfn(jstate, jb)
        state, m = fn(state, b)
        np.testing.assert_allclose(np.asarray(m["loss"]), np.asarray(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(m["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(m["lr"]), np.asarray(jm["lr"]),
                                   rtol=1e-7)
        assert np.asarray(m["step"]).tolist() == np.asarray(jm["step"]).tolist()
    assert state.opt.step == 2 * group == int(jstate.opt.step)
    _assert_params(state, jstate, atol=2e-5)
    assert fn.captures == 0                    # CPU tensors: eager, no graph


def test_dense_factory_matches_the_jax_dense_factory():
    """make_dense_train_fn against the JAX one: one step from the same
    params (loss atol 1e-5, params atol 1e-5, the limits of
    tests/test_torch_finetune.py)."""
    cfg, jparams, batch = _dense_batch("mn-ques-im-hist")
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jstate = jax_init_state(cfg)._replace(params=jparams)
    state = _port_state(jstate, cfg)
    jnew, jm = jax_dense_fn(cfg, mesh)(shard_train_state(jstate, cfg, mesh),
                                       shard_batch(batch, mesh))
    new, m = make_dense_train_fn(cfg)(state, batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
    assert m["step"] == int(jm["step"]) == 1
    _assert_params(new, jnew, atol=1e-5)


def _dropout_case(batch_size=4):
    cfg = small_config(encoder="mn-ques-im-hist", batch_size=batch_size,
                       dropout=0.5)
    split, vocab = make_synthetic_split(cfg, num_dialogs=16, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    batches = [batch_to_device(b.as_dict(), "cpu")
               for e in range(2) for b in TrainLoader(split, vocab, cfg).epoch(e)]
    return cfg, batches


def _fresh(cfg):
    state = init_train_state(cfg)
    return state._replace(params=tree_map(lambda p: p * 8, state.params))


@pytest.mark.parametrize("group", [1, 3], ids=["make_train_fn",
                                               "make_multistep_train_fn"])
def test_factories_equal_the_eager_steps_with_dropout(group):
    """Dropout 0.5, two calls: the factory and the eager steps give equal
    losses, grad norms, lr, step and params, and the CPU generators end in
    the same state; a different generator seed changes the loss."""
    cfg, batches = _dropout_case()
    eager, graphed = _fresh(cfg), _fresh(cfg)
    if group == 1:
        fn = make_train_fn(cfg)
        calls = batches[:2]
        step = partial(train_step, cfg=cfg)
    else:
        fn = make_multistep_train_fn(cfg)
        calls = [{k: torch.stack([b[k] for b in batches[i:i + group]])
                  for k in batches[0]} for i in (0, group)]
        step = partial(multi_train_step, cfg=cfg)
    for b in calls:
        eager, me = step(eager, b)
        graphed, mg = fn(graphed, b)
        for k in ("loss", "grad_norm", "lr", "step"):
            assert torch.equal(torch.as_tensor(me[k]), torch.as_tensor(mg[k])), k
    assert eager.opt.step == graphed.opt.step == 2 * group
    for k, v in flatten(eager.params).items():
        assert torch.equal(flatten(graphed.params)[k], v), k
    for k, v in flatten(eager.opt.v).items():
        assert torch.equal(flatten(graphed.opt.v)[k], v), k
    assert torch.equal(eager.gen.get_state(), graphed.gen.get_state())
    _, m0 = train_step(_fresh(cfg), batches[0], cfg)
    other = _fresh(cfg)._replace(gen=torch.Generator().manual_seed(5))
    _, mo = make_train_fn(cfg)(other, batches[0])
    assert float(mo["loss"]) != float(m0["loss"])


def test_step_scalars_are_the_eager_floats_over_200_steps():
    """step_scalars(0, 201) row s == [lr_at_step(s), 1/(1 - b1^(s+1)),
    1/(1 - b2^(s+1))], each the float32 value the eager step computes
    (lr with decay to its floor), bit for bit; the lr also equals the JAX
    package's."""
    cfg = small_config(learning_rate=1e-3, lr_decay_rate=0.98, min_lr=2e-4,
                       vocab_size=40)
    got = step_scalars(0, 201, cfg)
    assert got.dtype == torch.float32 and got.shape == (201, 3)
    f32 = partial(torch.tensor, dtype=torch.float32)
    floored = 0
    for s in range(201):
        t = f32(float(s + 1))
        want = [lr_at_step(s, cfg),
                float(1.0 / (1.0 - f32(cfg.adam_beta1) ** t)),
                float(1.0 / (1.0 - f32(cfg.adam_beta2) ** t))]
        assert got[s].tolist() == want, s
        assert want[0] == float(jax_optim.lr_at_step(np.int32(s), cfg)), s
        floored += want[0] == np.float32(cfg.min_lr)
    assert 0 < floored < 201                    # the floor is reached
    assert step_scalars(37, 3, cfg).tolist() == got[37:40].tolist()


def test_step_seeds_are_the_eager_draws():
    """step_seeds(gen, G) == G eager steps' split_seeds draws, and leaves
    the generator in the same state."""
    a, b = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    got = step_seeds(a, 4)
    want = [tuple(split_seeds(b)) for _ in range(4)]
    assert got == want and len(set(got)) == 4
    assert torch.equal(a.get_state(), b.get_state())


def test_foreign_state_is_copied_in():
    """A call with a state that is not the factory's own (a resume) copies
    it into the factory's buffers: the result is the eager step's from
    that state, in the first state's tensors."""
    cfg, batches = _dropout_case()
    fn = make_train_fn(cfg)
    first, _ = fn(_fresh(cfg), batches[0])
    buffers = flatten(first.params)
    foreign = init_train_state(cfg, seed=3)
    want, wm = train_step(init_train_state(cfg, seed=3), batches[1], cfg)
    got, gm = fn(foreign, batches[1])
    assert float(gm["loss"]) == float(wm["loss"]) and got.opt.step == 1
    for k, v in flatten(got.params).items():
        assert v is buffers[k]
        assert torch.equal(v, flatten(want.params)[k]), k
    with pytest.raises(ValueError, match="does not fit"):
        fn(init_train_state(cfg.replace(embed_size=8)), batches[1])


def test_remat_is_refused_and_a_mesh_steps_eagerly():
    """Once refused, both now take the graph: every factory accepts
    cfg.remat (a third generator a step, the recomputation's), and on a
    mesh of two ranks with a process group each factory is a
    GraphedTrainStep over that mesh (its collectives in the graph); a mesh
    made without a process group is the one-device step."""
    cfg = small_config(vocab_size=40, remat=True)
    cpu = torch.device("cpu")
    for make in (make_train_fn, make_multistep_train_fn, make_dense_train_fn):
        fn = make(cfg)
        assert isinstance(fn, GraphedTrainStep) and fn.steps.mesh is None
        gens = fn.steps.generators(2, cpu)
        assert len(gens) == 2 and all(g.recompute is not None for g in gens)
    group = object()             # a process group's stand-in: never called
    two = Mesh(data=2, model=1, d=1, m=0, device=cpu, data_group=group)
    for make in (make_train_fn, make_multistep_train_fn, make_dense_train_fn):
        fn = make(cfg.replace(remat=False), two)
        assert isinstance(fn, GraphedTrainStep) and fn.steps.mesh is two
        assert all(g.recompute is None for g in fn.steps.generators(1, cpu))
    alone = make_train_fn(cfg, Mesh(1, 1, 0, 0, cpu))
    assert isinstance(alone, GraphedTrainStep) and alone.steps.mesh is None


def test_engine_packs_disc_answers_as_the_jax_engine(tmp_path):
    """serve_disc's (2, k) [top_i; top_s] against _serve_disc_jit's on one
    JAX-written checkpoint: the indices equal, the scores rtol 1e-4."""
    path = _checkpoint(tmp_path)
    want_eng = JaxEngine(path, synthetic=8)
    eng = InferenceEngine(path, synthetic=8, device="cpu")
    for question, caption, history in QUERIES:
        jbatch, jt = want_eng._batch(caption, history, question, None)
        want = np.asarray(want_eng._serve_disc_jit(want_eng.params, jbatch,
                                                   want_eng._table, jt, 5))
        batch, t = eng._batch(caption, history, question, None)
        assert t == jt
        got = eng.serve_disc(batch, eng._round(t), 5)
        assert got.shape == (2, 5) and got.dtype == torch.float32
        assert got[0].tolist() == want[0].tolist()
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-4)
        ranked = eng.rank_answers(question, caption, history, top_k=5)
        assert [a["score"] for a in ranked] == got[1].tolist()
    assert eng.serve_disc.captures == 0


@pytest.mark.parametrize("beam", [0, 5], ids=["greedy", "beam5"])
def test_engine_packs_gen_answers_as_the_jax_engine(tmp_path, beam):
    """serve_gen's (1 + La,) [log_prob, tokens] against _serve_gen_jit's:
    the tokens equal, the log-prob rtol 1e-4; generate_answer reads it."""
    path = _checkpoint(tmp_path, decoder="gen")
    want_eng = JaxEngine(path, synthetic=8)
    eng = InferenceEngine(path, synthetic=8, device="cpu")
    for question, caption, history in QUERIES:
        jbatch, jt = want_eng._batch(caption, history, question, None)
        want = np.asarray(want_eng._serve_gen_jit(want_eng.params, jbatch,
                                                  beam, jt))
        batch, t = eng._batch(caption, history, question, None)
        got = eng.serve_gen(batch, eng._round(t), beam)
        assert got.shape == (1 + eng.cfg.max_ans_len,)
        assert got[1:].tolist() == want[1:].tolist()
        np.testing.assert_allclose(float(got[0]), want[0], rtol=1e-4)
        out = eng.generate_answer(question, caption, history, beam_size=beam)
        assert out["log_prob"] == float(got[0])
        assert out["answer"] == " ".join(eng.vocab.decode(
            got[1:].long().numpy()))


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: records its generators and the
    pool it was captured in (another graph's, or its own) and counts its
    replays."""
    made = []

    def __init__(self):
        self.generators, self.replays, self.captured_in = [], 0, None
        _FakeGraph.made.append(self)

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        self.replays += 1

    def pool(self):
        return self.captured_in or ("pool", id(self))


def _fake_capture(g, capture_error_mode, pool=None, stream=None):
    g.captured_in, g.stream = pool, stream
    return contextlib.nullcontext()


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """The helper's graph path on CPU tensors: the device test says yes and
    torch.cuda's graph API is replaced by stand-ins (a capture runs the
    function, a replay runs nothing)."""
    _FakeGraph.made = []
    monkeypatch.setattr(graph, "_device", lambda leaves: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    streams = {}
    monkeypatch.setattr(graph, "side_stream",
                        lambda index: streams.setdefault(index, _FakeStream()))
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return _FakeGraph.made


def test_helper_captures_once_a_signature_and_counts_replays(fake_card,
                                                             monkeypatch):
    """One capture a signature (shapes, dtypes and static leaves), the
    warm-up's result returned by the first call, the inputs copied into the
    graph's buffers on a replay, outputs cloned, the capture's launches
    taken out and a replay's added, the generators registered."""
    monkeypatch.setattr(lstm_layer, "launches", 0)
    seen = []

    def fn(batch, k):
        lstm_layer.launches += 2            # as two kernel launches would
        seen.append(batch["x"])
        return {"y": batch["x"] * k}

    g = graph.Graphed(fn)
    gen = torch.Generator()
    x1, x2 = torch.arange(3.0), torch.arange(3.0) + 10
    out = g({"x": x1}, 2, generators=[gen])
    assert torch.equal(out["y"], x1 * 2) and g.captures == 1
    assert lstm_layer.launches == 2              # the warm-up ran; capture did not
    assert len(fake_card) == 1 and fake_card[0].generators == [gen]
    buf = seen[-1]
    assert buf is not x1 and torch.equal(buf, x1)   # the graph's own buffer
    out2 = g({"x": x2}, 2)
    assert g.captures == 1 and fake_card[0].replays == 1
    assert torch.equal(buf, x2)                       # copied in
    assert lstm_layer.launches == 4                   # a replay's launches
    captured = out2["y"]
    assert captured is not out["y"]
    g({"x": x2}, 3)                                   # a static leaf differs
    g({"x": torch.arange(4.0)}, 2)                    # a shape differs
    g({"x": x2.double()}, 2)                          # a dtype differs
    assert g.captures == 4 and len(fake_card) == 4
    g({"x": x1}, 2)
    assert g.captures == 4 and fake_card[0].replays == 2
    assert lstm_layer.launches == 4 + 3 * 2 + 2


def test_a_capture_holds_the_capture_lock(fake_card):
    """Graphed holds graph.CAPTURING over a capture and over nothing else:
    not the warm-up, not a replay (the streamed eval's staging thread takes
    it around its uploads, so none runs during a capture)."""
    held = []

    def fn(x):
        held.append(graph.CAPTURING.locked())
        return x + 1

    g = graph.Graphed(fn)
    g(torch.zeros(2))
    g(torch.ones(2))
    assert held == [False, True] and g.captures == 1
    assert fake_card[0].replays == 1 and not graph.CAPTURING.locked()


def test_warm_up_and_capture_share_the_device_side_stream(fake_card, monkeypatch):
    """Every graph of a device is warmed up and captured on one stream
    (graph.side_stream): a second Graphed's warm-up and capture take the
    stream the first took, so cuBLAS makes its workspace for that stream
    once, before any warm-up."""
    entered = []
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: entered.append(s) or contextlib.nullcontext())
    first, second = graph.Graphed(lambda x: x + 1), graph.Graphed(lambda x: x * 2)
    first(torch.zeros(2))
    second(torch.zeros(3))
    side = graph.side_stream(None)        # the stand-in device has no index
    assert [g.stream for g in fake_card] == [side, side]
    assert entered == [side, side]        # the two warm-ups


def test_helper_restores_the_counters_when_a_capture_fails(fake_card,
                                                           monkeypatch):
    """A capture that raises leaves the counters as the warm-up left them
    and caches nothing; the error reaches the caller."""
    monkeypatch.setattr(lstm_layer, "launches", 0)
    calls = []

    def fn(x):
        calls.append(1)
        lstm_layer.launches += 1
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is capturing")
        return x + 1

    g = graph.Graphed(fn)
    with pytest.raises(RuntimeError, match="capturing"):
        g(torch.zeros(2))
    assert lstm_layer.launches == 1 and g.captures == 0


def test_train_factory_captures_once_and_registers_its_generators(fake_card):
    """The graph path of make_multistep_train_fn on stand-ins: one capture
    for a run of equal batch stacks, 2G generators registered, and the
    first call's metrics are the eager steps' (the warm-up is the call;
    the stand-in capture runs the steps once more, so the params are not
    compared here)."""
    cfg, batches = _dropout_case()
    stacked = {k: torch.stack([b[k] for b in batches[:2]]) for k in batches[0]}
    fn = make_multistep_train_fn(cfg)
    _, me = multi_train_step(_fresh(cfg), stacked, cfg)
    state, m = fn(_fresh(cfg), stacked)
    for k in ("loss", "grad_norm", "lr", "step"):
        assert torch.equal(m[k], me[k]), k
    fn(state, stacked)
    assert fn.captures == 1 and len(fake_card) == 1
    assert fake_card[0].replays == 1 and len(fake_card[0].generators) == 4
