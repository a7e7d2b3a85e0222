"""The port's resident evals and staged streaming eval
(visdial_tpu_torch/eval_harness.py) against each other and against the JAX
package's resident eval on the same params (bridged in f32): MN disc, LF
disc with the incremental history and MN gen bucketed, each over a batch
size that does not divide the split; collect_rankings; the cache reused;
the byte-cap fallback; the evaluate CLI resident against the JAX CLI
resident; and the staging thread's contract (a loader exception reaches
the consumer, an abandoned generator stops the thread, items and ranks
come in loader order)."""

import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.eval_harness import evaluate_split as jax_evaluate_split
from visdial_tpu.evaluate import main as jax_evaluate_main
from visdial_tpu.parallel.mesh import make_mesh
from visdial_tpu.parallel.train_step import init_train_state
from visdial_tpu.utils.checkpoint import _tree_to_dict, save_checkpoint
from visdial_tpu_torch import eval_harness
from visdial_tpu_torch.eval_harness import _staged, evaluate_split
from visdial_tpu_torch.evaluate import main as evaluate_main
from visdial_tpu_torch.utils.params import params_from_numpy

from conftest import small_config

torch.set_num_threads(1)

METRIC_KEYS = ("mrr", "r@1", "r@5", "r@10", "mean_rank", "num_examples")
RESIDENT_KEYS = {"resident_cache_seconds", "resident_cache_bytes",
                 "cold_compile"}
# the JAX tests' limits: the same math on both sides, in f32
TOL = {"disc": 1e-9, "gen": 1e-6}
CASES = [("mn-ques-im-hist", "disc"), ("lf-ques-im-hist", "disc"),
         ("mn-ques-im-hist", "gen")]


def _setup(encoder, decoder, num_dialogs=10, batch_size=4, scale=4.0):
    """10 dialogs in batches of 4 (the last one padded); the init weights
    times `scale` so that the scores spread."""
    cfg = small_config(encoder=encoder, decoder=decoder,
                       batch_size=batch_size)
    split, vocab = make_synthetic_split(cfg, num_dialogs=num_dialogs, seed=5)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * scale, init_train_state(cfg).params)
    params = params_from_numpy(_tree_to_dict(jparams), cfg, "cpu")
    return cfg, split, vocab, jparams, params


def _close(got, want, tol):
    for k in METRIC_KEYS:
        assert got[k] == pytest.approx(want[k], abs=tol), k


@pytest.mark.parametrize("encoder,decoder", CASES)
def test_resident_matches_streaming_and_jax(encoder, decoder):
    cfg, split, vocab, jparams, params = _setup(encoder, decoder)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    want = jax_evaluate_split(jparams, split, vocab, cfg, mesh, resident=True)
    assert "resident_cache_seconds" in want
    streamed, s_ranks = evaluate_split(params, split, vocab, cfg, "cpu",
                                       return_ranks=True)
    res, r_ranks = evaluate_split(params, split, vocab, cfg, "cpu",
                                  return_ranks=True, resident=True)
    assert not RESIDENT_KEYS & set(streamed)
    assert RESIDENT_KEYS <= set(res) and res["cold_compile"] is True
    assert res["num_examples"] == 10 * cfg.num_rounds
    # the same math on one device: equal ranks, in loader order
    np.testing.assert_array_equal(r_ranks, s_ranks)
    _close(res, streamed, 0.0)
    _close(res, want, TOL[decoder])
    # the second call reuses the cache: no rebuild, no cold_compile tag
    again = evaluate_split(params, split, vocab, cfg, "cpu", resident=True)
    assert again["resident_cache_seconds"] == res["resident_cache_seconds"]
    assert again["resident_cache_bytes"] == res["resident_cache_bytes"]
    assert "cold_compile" not in again
    _close(again, res, 0.0)


def test_resident_cache_bytes_count_the_uploaded_stacks():
    """resident_cache_bytes is what the port uploads: the stacks as
    batch_to_device ships them (integers as int64, image features float32)
    and opt_list, exactly."""
    cfg, split, vocab, _, params = _setup("mn-ques-im-hist", "disc")
    res = evaluate_split(params, split, vocab, cfg, "cpu", resident=True)
    cache = split.__dict__["_torch_resident_eval"]
    (ev,) = cache.values()
    nb, bs, R, K = 3, 4, cfg.num_rounds, cfg.num_options
    assert ev.stacks["ques"].shape == (nb, bs, R, cfg.max_ques_len)
    assert ev.stacks["img"].dtype == torch.float32
    assert ev.stacks["opt_inds"].shape == (nb, bs, R, K)
    want = (sum(t.numel() * t.element_size() for t in ev.stacks.values())
            + split.opt_list.size * 8)
    assert res["resident_cache_bytes"] == ev.nbytes == want


def test_resident_collect_rankings_matches_streaming_and_jax():
    cfg, split, vocab, jparams, params = _setup("lf-ques-im-hist", "disc")
    split.round_valid[0, -1] = 0      # dumped but not ranked
    split.round_scoreable[9, 1] = 0   # neither
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    _, want = jax_evaluate_split(jparams, split, vocab, cfg, mesh,
                                 collect_rankings=True, resident=True)
    m1, c1 = evaluate_split(params, split, vocab, cfg, "cpu",
                            collect_rankings=True)
    m2, c2 = evaluate_split(params, split, vocab, cfg, "cpu",
                            collect_rankings=True, resident=True)
    assert "resident_cache_seconds" in m2 and c2.dtype == np.int32
    assert c2.shape == (10, cfg.num_rounds, cfg.num_options)
    np.testing.assert_array_equal(c2, c1)
    np.testing.assert_array_equal(c2, want)
    assert c2[0, -1].any() and not c2[9, 1].any()
    _close(m2, m1, 0.0)


def test_resident_byte_cap_falls_back_to_streaming():
    cfg, split, vocab, _, params = _setup("lf-ques-hist", "disc")
    res = evaluate_split(params, split, vocab, cfg, "cpu", resident=True,
                         resident_max_bytes=16)
    assert not RESIDENT_KEYS & set(res)              # streamed
    assert res["num_examples"] == 10 * cfg.num_rounds
    # a later call with a workable cap does not inherit the failed build
    # (the cache key holds the cap)
    res2 = evaluate_split(params, split, vocab, cfg, "cpu", resident=True)
    assert "resident_cache_seconds" in res2
    _close(res2, res, 0.0)


def test_evaluate_cli_resident_matches_jax_cli(tmp_path, capsys):
    """Both CLIs resident (their default) on one JAX-written checkpoint:
    equal JSON lines but for the timing and resident keys."""
    cfg, _, _, jparams, _ = _setup("mn-ques-im-hist", "disc")
    state = init_train_state(cfg)._replace(params=jparams)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, cfg)
    args = ["--load_path", path, "--synthetic", "6", "--batch_size", "4"]
    lines = {}
    for who, fn, extra in (("jax", jax_evaluate_main, []),
                           ("port", evaluate_main, ["--device", "cpu"])):
        fn(args + extra)
        out = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
        assert len(out) == 1, out
        lines[who] = json.loads(out[0])
    got, want = lines["port"], lines["jax"]
    assert RESIDENT_KEYS <= set(got) and RESIDENT_KEYS <= set(want)
    skip = RESIDENT_KEYS | {"evals_per_sec", "eval_seconds"}
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}


def _staging_threads():
    return [t for t in threading.enumerate()
            if t.name == eval_harness.STAGING_THREAD]


def _join_staging(timeout=10.0):
    deadline = time.time() + timeout
    for t in _staging_threads():
        t.join(max(deadline - time.time(), 0.01))
    assert not _staging_threads()


def test_staged_raises_a_loader_exception_in_the_consumer():
    def loader():
        yield 1
        yield 2
        raise KeyError("broken batch")

    got = []
    with pytest.raises(KeyError, match="broken batch"):
        for item in _staged(loader(), lambda x: x * 10):
            got.append(item)
    assert got == [10, 20]
    _join_staging()


def test_staged_raises_a_stage_exception_in_the_consumer():
    def stage(x):
        if x == 3:
            raise ValueError("cannot stage 3")
        return x

    with pytest.raises(ValueError, match="cannot stage 3"):
        list(_staged(range(10), stage))
    _join_staging()


def test_abandoning_the_generator_stops_the_thread():
    """The consumer leaves after one item while the producer is blocked on
    the full queue: closing the generator releases it, and the items it
    staged are dropped."""
    staged = []

    def stage(x):
        staged.append(x)
        return x

    gen = _staged(iter(range(1000)), stage)
    assert next(gen) == 0
    time.sleep(0.3)                     # the queue fills, the producer waits
    gen.close()
    _join_staging()
    assert len(staged) < 10


def test_staged_items_come_in_loader_order():
    """A stage of uneven length keeps the loader's order."""
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.01, 40)

    def stage(i):
        time.sleep(delays[i])
        return i

    assert list(_staged(range(40), stage)) == list(range(40))
    _join_staging()


def test_streamed_ranks_come_in_loader_order():
    """The one-batch-late readback keeps each batch's ranks with its own
    batch: the streamed ranks equal the resident ones (scored with no
    pipeline) at batch sizes 1, 3 and 10 (one batch: only the final
    readback)."""
    cfg, split, vocab, _, params = _setup("mn-ques-im-hist", "disc")
    _, want = evaluate_split(params, split, vocab, cfg, "cpu",
                             return_ranks=True, resident=True)
    for bs in (1, 3, 10):
        _, got = evaluate_split(params, split, vocab, cfg, "cpu",
                                batch_size=bs, return_ranks=True)
        np.testing.assert_array_equal(got, want)
    _join_staging()
