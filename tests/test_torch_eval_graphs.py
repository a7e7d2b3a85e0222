"""The port's eval dispatch (parallel/train_step.py's eval factories, the
harness's batch graphs in eval_harness.py, generate's decode) on CPU
tensors, where each graph's function runs eagerly:

- make_eval_fn, make_disc_table_eval_fns and make_gen_bucket_eval_fns
  against the JAX factories on the same numpy-seeded small-config params
  and batches (f32, dropout 0): scores and row scores rtol 1e-4, the
  table and the joint states 1e-4 of their largest value, ranks equal (the limits of tests/test_torch_infer.py and
  tests/test_torch_resident.py);
- evaluate_split with the factories passed, with None and with False (the
  direct path): equal metrics, ranks and candidate rankings, streaming and
  resident, disc and gen;
- sampling's draw equal to torch.multinomial's for the same generator;
- two gen splits of one answer width and different answer counts through
  one pair of factories (passed, and the cached ones);
- on stand-ins for torch.cuda's graph API (test_torch_graphs.py's
  fake_card): the resident eval's one capture a variant and nb replays, its
  stacks and disc's table read in place, in the table graph's pool; the
  params read from the factories' one shared copy, which holds the params
  last given; the streaming path's replays of the factories' graphs and of
  the harness's rank graph; each split's own row graphs; a factory's replay
  outside inference mode; generate's sampling generator registered; and
  every factory eager with impl="plain", graphed on a mesh as on none.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from visdial_tpu.data.loader import EvalLoader as JaxEvalLoader
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.parallel.mesh import make_mesh, shard_batch
from visdial_tpu.parallel.train_step import init_train_state
from visdial_tpu.parallel.train_step import (
    make_disc_table_eval_fns as jax_table_fns,
    make_eval_fn as jax_eval_fn,
    make_gen_bucket_eval_fns as jax_bucket_fns)
from visdial_tpu.utils.checkpoint import _tree_to_dict, save_checkpoint
from visdial_tpu.utils.metrics import ranks_from_scores as jax_ranks
from visdial_tpu_torch import eval_harness, generate
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.decoders import gen_decode
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.parallel.graph import Graphed, InferenceGraphed
from visdial_tpu_torch.parallel.mesh import Mesh
from visdial_tpu_torch.parallel.train_step import (make_disc_table_eval_fns,
                                                   make_eval_fn,
                                                   make_gen_bucket_eval_fns)
from visdial_tpu_torch.utils.metrics import ranks_from_scores
from visdial_tpu_torch.utils.params import flatten, params_from_numpy

from conftest import small_config
from test_torch_graphs import fake_card  # noqa: F401

torch.set_num_threads(1)

RTOL = 1e-4
METRIC_KEYS = ("mrr", "r@1", "r@5", "r@10", "mean_rank", "num_examples")


def _setup(decoder, encoder="mn-ques-im-hist", scale=4.0, num_dialogs=10):
    """10 dialogs in batches of 4 (the last one padded); the JAX init
    weights times `scale` so that the scores spread, bridged to the port."""
    cfg = small_config(encoder=encoder, decoder=decoder)
    split, vocab = make_synthetic_split(cfg, num_dialogs=num_dialogs, seed=5)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * scale, init_train_state(cfg).params)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    return cfg, split, vocab, jparams, params


def _mesh():
    return make_mesh(1, 1, devices=jax.devices()[:1])


def _batch(cfg, split, vocab, option_tokens=True):
    b = next(iter(JaxEvalLoader(split, vocab, cfg,
                                option_tokens=option_tokens)))
    return b.as_dict()


def _close(got, want, of_max=False):
    """rtol 1e-4; of_max: relative to the largest |want| (LSTM states near
    zero have no relative precision to hold)."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0 if of_max else RTOL,
        atol=RTOL * np.abs(want).max() if of_max else 0)


@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_make_eval_fn_matches_the_jax_factory(decoder):
    """make_eval_fn's (B, R, K) scores against the JAX make_eval_fn's on
    one batch (rtol 1e-4), their ranks equal; a graph on one device."""
    cfg, split, vocab, jparams, params = _setup(decoder)
    batch = _batch(cfg, split, vocab)
    want = np.asarray(jax_eval_fn(cfg, _mesh())(jparams,
                                                shard_batch(batch, _mesh())))
    fn = make_eval_fn(cfg)
    assert isinstance(fn, InferenceGraphed)
    got = fn(params, batch_to_device(batch, "cpu"))
    assert got.shape == want.shape == (cfg.batch_size, cfg.num_rounds,
                                       cfg.num_options)
    _close(got.numpy(), want)
    gt = batch["gt_ind"]
    assert ranks_from_scores(got, torch.from_numpy(gt)).tolist() == \
        np.asarray(jax_ranks(want, gt)).tolist()
    assert fn.captures == 0                 # CPU tensors: eager, no graph


def test_disc_table_fns_match_the_jax_factories():
    """make_disc_table_eval_fns: the (M, H) option table (1e-4 of its
    largest value) and the scores by gather (rtol 1e-4) against the JAX
    pair's, the ranks equal, and the scores those of make_eval_fn's direct
    path (rtol 1e-4)."""
    cfg, split, vocab, jparams, params = _setup("disc")
    batch = _batch(cfg, split, vocab, option_tokens=False)
    jtable_fn, jscore_fn = jax_table_fns(cfg, _mesh())
    jtable = jtable_fn(jparams, np.asarray(split.opt_list))
    want = np.asarray(jscore_fn(jparams, jtable, shard_batch(batch, _mesh())))
    table_fn, score_fn = make_disc_table_eval_fns(cfg)
    table = table_fn(params, torch.from_numpy(split.opt_list.astype(np.int64)))
    assert table.shape == (len(split.opt_list), cfg.rnn_hidden_size)
    _close(table.numpy(), np.asarray(jtable), of_max=True)
    got = score_fn(params, table, batch_to_device(batch, "cpu"))
    _close(got.numpy(), want)
    gt = batch["gt_ind"]
    assert ranks_from_scores(got, torch.from_numpy(gt)).tolist() == \
        np.asarray(jax_ranks(want, gt)).tolist()
    direct = make_eval_fn(cfg)(params, batch_to_device(
        _batch(cfg, split, vocab), "cpu"))
    _close(got.numpy(), direct.numpy())


def test_gen_bucket_fns_match_the_jax_factories():
    """make_gen_bucket_eval_fns: the encoder's (N, H) joint (1e-4 of its
    largest value) and the row scores (rtol 1e-4) of every candidate of
    one batch at two widths (the static leaves) against the JAX pair's."""
    cfg, split, vocab, jparams, params = _setup("gen")
    batch = _batch(cfg, split, vocab, option_tokens=False)
    jenc, jrow = jax_bucket_fns(cfg, _mesh())
    enc, row = make_gen_bucket_eval_fns(cfg)
    jjoint = jenc(jparams, shard_batch(batch, _mesh()))
    joint = enc(params, batch_to_device(batch, "cpu"))
    _close(joint.numpy(), np.asarray(jjoint), of_max=True)
    K = cfg.num_options
    rows = batch["opt_inds"].reshape(-1).astype(np.int32)
    ridx = (np.arange(rows.size) // K).astype(np.int32)
    opt_list = split.opt_list.astype(np.int32)
    opt_len = split.opt_list_len.astype(np.int32)
    T = opt_list.shape[1] + 1
    for width in (T, T - 1):
        keep = opt_len[rows] + 1 <= width
        want = np.asarray(jrow(jparams, jjoint, opt_list, opt_len, rows[keep],
                               ridx[keep], width, vocab.start, vocab.end))
        got = row(params, joint, *(torch.from_numpy(a.astype(np.int64)) for a
                                   in (opt_list, opt_len, rows[keep],
                                       ridx[keep])),
                  width, vocab.start, vocab.end)
        assert got.shape == (int(keep.sum()),)
        _close(got.numpy(), want)


def _run(params, split, vocab, cfg, resident, **fns):
    return evaluate_split(params, split, vocab, cfg, "cpu", return_ranks=True,
                          collect_rankings=True, resident=resident, **fns)


@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_evaluate_split_with_factories_none_and_false(decoder, resident):
    """The factories passed, None (the harness's cached factories) and
    False (the direct path, which streams): equal metrics, ranks and
    candidate rankings; the factories' paths stream or stay resident as
    asked."""
    cfg, split, vocab, _, params = _setup(decoder)
    key = "table_fns" if decoder == "disc" else "gen_fns"
    made = (make_disc_table_eval_fns if decoder == "disc"
            else make_gen_bucket_eval_fns)(cfg)
    runs = {"passed": _run(params, split, vocab, cfg, resident, **{key: made}),
            "none": _run(params, split, vocab, cfg, resident),
            "false": _run(params, split, vocab, cfg, resident, **{key: False})}
    want, want_ranks, want_cand = runs["none"]
    assert ("resident_cache_bytes" in want) == resident
    assert "resident_cache_bytes" not in runs["false"][0]
    for name, (m, ranks, cand) in runs.items():
        np.testing.assert_array_equal(ranks, want_ranks, err_msg=name)
        np.testing.assert_array_equal(cand, want_cand, err_msg=name)
        for k in METRIC_KEYS:
            assert m[k] == want[k], (name, k)
    assert want["num_examples"] == 10 * cfg.num_rounds


def test_sampled_draw_is_torch_multinomial():
    """gen_decode's sampled tokens equal a loop that draws each step with
    torch.multinomial from a generator of the same seed, and leave the
    generator in the same state (the draw is multinomial's one-sample
    path, written out so that a capture takes it)."""
    cfg, split, vocab, _, params = _setup("gen")
    joint = torch.randn(6, cfg.rnn_hidden_size,
                        generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    toks, _ = gen_decode(params["decoder"], params["embed"], joint, cfg,
                         start_token=vocab.start, end_token=vocab.end,
                         greedy=False, gen=g, temperature=0.7)
    ref = torch.Generator().manual_seed(3)
    # the reference loop: gen_decode's step with torch.multinomial's draw
    from visdial_tpu_torch.models.decoders import _joint_to_state, _step_logp
    h, c = _joint_to_state(joint, cfg.num_layers)
    tok = torch.full((6,), vocab.start, dtype=torch.long)
    done = torch.zeros(6, dtype=torch.bool)
    rows = []
    for _ in range(cfg.max_ans_len):
        _, logits, h, c = _step_logp(params["decoder"], params["embed"], tok,
                                     h, c)
        nxt = torch.multinomial(torch.softmax(logits / 0.7, dim=-1), 1,
                                generator=ref)[:, 0]
        stop = (nxt == vocab.end) | (nxt == 0)
        emit = torch.where(done | stop, 0, nxt)
        done = done | stop
        rows.append(emit)
        tok = torch.where(emit == 0, vocab.end, emit)
    assert torch.equal(toks, torch.stack(rows, dim=1))
    assert torch.equal(g.get_state(), ref.get_state())


def _graphs_of(fn):
    """A Graphed's captures: (graph, inputs, output, ...) of each
    signature."""
    return list(fn._graphs.values())


@pytest.fixture
def rank_graphs(monkeypatch):
    """Fresh harness rank graphs (module-level, as the JAX harness's jits),
    so that a test counts only its own captures: (_RANKED, _COMBINED)."""
    fresh = (InferenceGraphed(eval_harness._ranked),
             InferenceGraphed(eval_harness._combined))
    monkeypatch.setattr(eval_harness, "_RANKED", fresh[0])
    monkeypatch.setattr(eval_harness, "_COMBINED", fresh[1])
    return fresh


# a stand-in replay computes nothing: the ranks it leaves are the buffers'
# uninitialised values, whose MRR may divide by zero
STALE_RANKS = pytest.mark.filterwarnings("ignore:divide by zero")


@STALE_RANKS
@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_resident_eval_replays_one_batch_graph(fake_card, decoder):
    """The resident eval on stand-ins: one batch graph captured per
    variant (the first run's warm-up scores batch 0, the other nb - 1
    batches replay; a later run replays nb times), whose inputs are the
    0-dim batch index and, for disc, the table graph's output itself (read
    in place, in the table graph's pool); the stacks are not inputs (read
    in place) and the params are the factories' shared copy; the
    collect_rankings variant captures its own."""
    cfg, split, vocab, _, params = _setup(decoder)
    fns = (make_disc_table_eval_fns if decoder == "disc"
           else make_gen_bucket_eval_fns)(cfg)
    key = "table_fns" if decoder == "disc" else "gen_fns"
    evaluate_split(params, split, vocab, cfg, "cpu", resident=True,
                   **{key: fns})
    res = next(iter(split._torch_resident_eval.values()))
    nb = len(res.keep)
    assert nb == 3 and res.captures == 1
    (entry,) = res.graphs.values()
    assert entry.graph.held is fns[0].held is fns[1].held
    (capture,) = _graphs_of(entry.graph)
    index = capture.inputs[0]
    assert index.shape == () and capture.graph.replays == nb - 1
    if decoder == "disc":
        (table_capture,) = _graphs_of(fns[0])
        assert len(capture.inputs) == 2
        assert capture.inputs[1] is table_capture.output
        assert capture.graph.captured_in == table_capture.graph.pool()
    else:
        assert capture.inputs[1:] == [None]
        assert capture.graph.captured_in is None
    m = evaluate_split(params, split, vocab, cfg, "cpu", resident=True,
                       **{key: fns})
    assert "cold_compile" not in m
    assert res.captures == 1 and capture.graph.replays == 2 * nb - 1
    evaluate_split(params, split, vocab, cfg, "cpu", resident=True,
                   collect_rankings=True, **{key: fns})
    assert res.captures == 2 and len(res.graphs) == 2
    if decoder == "disc":
        assert fns[0].captures == 1 and table_capture.graph.replays == 2


@STALE_RANKS
def test_graphs_read_the_params_they_are_given(fake_card, rank_graphs):
    """On stand-ins (a replay computes nothing): the factories' graphs and
    the resident batch graph take no params among their inputs; they read
    the factories' one shared copy, which after an eval with params A and
    one with params B holds B, in the tensors the first eval made."""
    cfg, split, vocab, _, a = _setup("disc")
    b = params_from_numpy({k: v.numpy() * 0.5 for k, v in flatten(a).items()},
                          cfg, "cpu")
    fns = make_disc_table_eval_fns(cfg)
    for resident in (True, False):
        evaluate_split(a, split, vocab, cfg, "cpu", resident=resident,
                       table_fns=fns)
    held = flatten(fns[0].held.tree)
    assert all(torch.equal(t, flatten(a)[k]) for k, t in held.items())
    for resident in (True, False):
        evaluate_split(b, split, vocab, cfg, "cpu", resident=resident,
                       table_fns=fns)
    want = flatten(b)
    now = flatten(fns[0].held.tree)
    for k, t in held.items():
        assert now[k] is t and torch.equal(t, want[k]), k
    res = next(iter(split._torch_resident_eval.values()))
    shapes = {tuple(t.shape) for t in want.values()}
    for g in (fns[0], fns[1], *(e.graph for e in res.graphs.values())):
        for capture in _graphs_of(g):
            assert not any(isinstance(x, torch.Tensor) and x.dim() > 1
                           and tuple(x.shape) in shapes
                           and x.dtype == torch.float32
                           for x in capture.inputs)


def test_factory_replays_outside_inference_mode(fake_card):
    """A factory's graph buffers are made under its own inference mode, so
    they are inference tensors (a copy into one outside that mode raises);
    a later call from outside inference mode copies its batch in and
    replays all the same."""
    cfg, split, vocab, _, params = _setup("disc")
    loader = JaxEvalLoader(split, vocab, cfg)
    b1, b2 = (batch_to_device(b.as_dict(), "cpu") for b in
              list(loader)[:2])
    fn = make_eval_fn(cfg)
    fn(params, b1)
    (capture,) = _graphs_of(fn)
    ques = capture.inputs[[i for i, x in enumerate(capture.inputs)
                           if isinstance(x, torch.Tensor)
                           and x.shape == b1["ques"].shape
                           and torch.equal(x, b1["ques"])][0]]
    assert ques.is_inference() and not torch.is_inference_mode_enabled()
    with pytest.raises(RuntimeError, match="[Ii]nference"):
        ques.copy_(b2["ques"])
    fn(params, b2)
    assert fn.captures == 1 and capture.graph.replays == 1
    assert torch.equal(ques, b2["ques"])


@STALE_RANKS
def test_stream_graph_replays_per_batch(fake_card, rank_graphs):
    """The streaming eval on stand-ins replays the factories' graphs: the
    table graph once a call, over the split's device opt_list in place;
    score_fn's graph captured on the first batch and replayed for the
    other nb - 1, then nb times on a second call, over the table graph's
    output in place and in its pool; the harness's rank graph likewise,
    one capture for the ranks and the candidate rankings together."""
    cfg, split, vocab, _, params = _setup("disc")
    fns = make_disc_table_eval_fns(cfg)
    evaluate_split(params, split, vocab, cfg, "cpu", table_fns=fns,
                   collect_rankings=True)
    (table_capture,) = _graphs_of(fns[0])
    assert table_capture.inputs == [
        split._torch_device_tables[("disc", "cpu")]["opt_list"]]
    (capture,) = _graphs_of(fns[1])
    (ranked,) = _graphs_of(rank_graphs[0])
    assert fns[1].captures == 1 and capture.graph.replays == 2
    assert capture.inputs[0] is table_capture.output
    assert capture.graph.captured_in == table_capture.graph.pool()
    assert ranked.graph.replays == 2 and len(ranked.output) == 2
    evaluate_split(params, split, vocab, cfg, "cpu", table_fns=fns,
                   collect_rankings=True)
    assert fns[0].captures == fns[1].captures == rank_graphs[0].captures == 1
    assert table_capture.graph.replays == 1 and capture.graph.replays == 5
    with pytest.raises(ValueError, match="clones only"):
        fns[1](params, table_capture.output, batch_to_device(
            next(iter(JaxEvalLoader(split, vocab, cfg,
                                    option_tokens=False))).as_dict(), "cpu"),
            clone=False)


def _two_gen_splits():
    """Two gen splits of one answer width and different answer counts M."""
    cfg = small_config(encoder="mn-ques-im-hist", decoder="gen")
    s1, vocab = make_synthetic_split(cfg, num_dialogs=10, seed=5)
    s2, _ = make_synthetic_split(cfg, num_dialogs=6, seed=6)
    assert s1.opt_list.shape[1] == s2.opt_list.shape[1]
    assert len(s1.opt_list) != len(s2.opt_list)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * 4.0, init_train_state(cfg).params)
    return cfg, (s1, s2), vocab, params_from_numpy(_tree_to_dict(jparams),
                                                   cfg, "cpu")


@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
def test_two_gen_splits_of_different_answer_counts(resident):
    """Two gen splits of one answer width and different M, one after the
    other, with gen_fns=None (the cached factories) and with one passed
    pair: each split's ranks and candidate rankings equal those of a fresh
    pair of factories on it alone."""
    cfg, splits, vocab, params = _two_gen_splits()
    made = make_gen_bucket_eval_fns(cfg)
    for fns in (None, made):
        for split in splits:
            got = _run(params, split, vocab, cfg, resident, gen_fns=fns)
            want = _run(params, split, vocab, cfg, resident,
                        gen_fns=make_gen_bucket_eval_fns(cfg))
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(g, w)


@STALE_RANKS
@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
def test_two_gen_splits_capture_their_own_graphs(fake_card, rank_graphs,
                                                 resident):
    """On stand-ins: the second split (another M) captures its own row
    graphs, over its own device tables in place, and the first split's
    evals replay theirs again; nothing is copied into another split's
    buffers."""
    cfg, splits, vocab, params = _two_gen_splits()
    fns = make_gen_bucket_eval_fns(cfg)
    for split in (*splits, splits[0]):
        _run(params, split, vocab, cfg, resident, gen_fns=fns)
    tables = [s._torch_device_tables[("gen", "cpu")]["opt_list"]
              for s in splits]
    if resident:
        assert [next(iter(s._torch_resident_eval.values())).captures
                for s in splits] == [1, 1]
        return
    read = [[x for x in c.inputs if x is t] for t in tables
            for c in _graphs_of(fns[1])]
    assert all(len(r) <= 1 for r in read)
    by_split = [sum(any(x is t for x in c.inputs) for c in _graphs_of(fns[1]))
                for t in tables]
    assert by_split[0] >= 1 and by_split[1] >= 1
    assert sum(by_split) == fns[1].captures
    for t, s in zip(tables, splits):
        np.testing.assert_array_equal(t.numpy(), s.opt_list)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sample"])
def test_generate_registers_the_sampling_generator(fake_card, tmp_path,
                                                   sample):
    """generate's decode on stand-ins: one graph for the batches of one
    shape; with --sample the device generator it draws from is
    registered with it, greedy registers none."""
    cfg = small_config(encoder="lf-ques-im", decoder="gen")
    _, vocab = make_synthetic_split(cfg, num_dialogs=4, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    path = save_checkpoint(str(tmp_path / "g"), init_train_state(cfg), cfg)
    generate.main(["--load_path", path, "--synthetic", "8", "--device",
                   "cpu", "--batch_size", "2", "--num_dialogs", "6",
                   "--out_path", str(tmp_path / "g.json")]
                  + (["--sample", "--seed", "4"] if sample else []))
    (made,) = fake_card
    assert made.replays == 2                  # 3 batches: capture, 2 replays
    if sample:
        (g,) = made.generators
        assert isinstance(g, torch.Generator) and g.initial_seed() == 4
    else:
        assert made.generators == []


def test_eval_factories_are_eager_where_chosen():
    """With impl="plain" every factory returns the eager function (no
    Graphed); on a mesh of two ranks, of one, or none, the graphs (a vocab
    shard's reductions inside them); the harness's cached factories are
    reused per (cfg, mesh, impl)."""
    cfg = small_config(vocab_size=40)
    two = Mesh(data=2, model=1, d=0, m=0, device=torch.device("cpu"))
    one = Mesh(data=1, model=1, d=0, m=0, device=torch.device("cpu"))
    for make in (make_eval_fn, make_disc_table_eval_fns,
                 make_gen_bucket_eval_fns):
        for mesh, impl, graphed in ((two, None, True), (None, "plain", False),
                                    (one, None, True), (None, None, True),
                                    (None, "cuda", True)):
            out = make(cfg, mesh, impl)
            fns = out if isinstance(out, tuple) else (out,)
            assert all(isinstance(f, Graphed) == graphed for f in fns), (
                make.__name__, mesh, impl)
            assert all(callable(f) for f in fns)
    assert eval_harness._cached_disc_table_fns(cfg, None, None) is \
        eval_harness._cached_disc_table_fns(cfg, None, None)
    assert eval_harness._cached_eval_fn(cfg, two, None) is not \
        eval_harness._cached_eval_fn(cfg, None, None)
