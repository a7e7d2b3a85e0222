"""The port's own copies of the configuration and the data modules
(visdial_tpu_torch/config.py, data/) against the JAX package's: Config field
by field and through its JSON both ways, the synthetic splits array by
array, and TrainLoader / EvalLoader batches byte for byte under a float32
config, in both option layouts, with the port's native core and without."""

import dataclasses

import numpy as np
import pytest

from visdial_tpu import config as jax_config
from visdial_tpu.data import loader as jax_loader
from visdial_tpu.data import synthetic as jax_synthetic
from visdial_tpu_torch import config as torch_config
from visdial_tpu_torch.data import loader as torch_loader
from visdial_tpu_torch.data import native as torch_native
from visdial_tpu_torch.data import synthetic as torch_synthetic

from conftest import small_config


def _flagship(cfg_mod, **kw):
    """__graft_entry__.py::_flagship_config's fields under either Config."""
    base = dict(encoder="mn-ques-im-hist", decoder="disc", vocab_size=8848,
                batch_size=4, dropout=0.0, use_pallas=False)
    return cfg_mod.Config(**{**base, **kw})


def test_config_fields_and_defaults_equal():
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jax_config.Config)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(torch_config.Config)]
    assert tf == jf
    assert torch_config.Config().to_dict() == dataclasses.asdict(jax_config.Config())
    for name in ("ENCODERS", "DECODERS", "RESUME_OVERRIDABLE"):
        assert getattr(torch_config, name) == getattr(jax_config, name), name
    for enc in jax_config.ENCODERS:
        for fn in ("encoder_family", "encoder_uses_history", "encoder_uses_image"):
            assert getattr(torch_config, fn)(enc) == getattr(jax_config, fn)(enc)


@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_config_flagship_and_json_round_trip(decoder):
    want = _flagship(jax_config, decoder=decoder)
    got = _flagship(torch_config, decoder=decoder)
    assert got.to_dict() == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    assert got.max_fact_len == want.max_fact_len
    # the port reads the JAX package's meta.json and the JAX package the port's
    assert torch_config.Config.from_json(want.to_json()) == got
    assert jax_config.Config.from_json(got.to_json()) == want
    other = {"learning_rate": 0.5, "max_ans_len": 7}
    assert got.replace(**other).to_json() == want.replace(**other).to_json()
    a, b = want.replace(**other), got.replace(**other)
    assert torch_config.resume_config_mismatches(b, got) == \
        jax_config.resume_config_mismatches(a, want)
    with pytest.raises(ValueError):
        got.replace(encoder="bogus")


def test_synthetic_splits_equal():
    cfg = small_config()
    for make in ("make_synthetic_split",):
        (js, jv), (ts, tv) = (getattr(m, make)(cfg, num_dialogs=5, seed=3)
                              for m in (jax_synthetic, torch_synthetic))
        _assert_splits_equal(js, ts)
        assert tv.word2ind == jv.word2ind and tv.size == jv.size
    fl = _flagship(jax_config)
    (js, jv), (ts, tv) = (m.make_random_split(fl, num_dialogs=4,
                                              num_unique_answers=500, seed=1)
                          for m in (jax_synthetic, torch_synthetic))
    _assert_splits_equal(js, ts)
    assert (tv.size, tv.start, tv.end) == (jv.size, jv.start, jv.end) == (
        8804, 8802, 8803)
    assert torch_synthetic.synthetic_vocab(20).word2ind == \
        jax_synthetic.synthetic_vocab(20).word2ind


@pytest.mark.parametrize("a,seed", [(1.2, 1), (1.5, 7)])
def test_zipf_redraw_options_equal(a, seed):
    """The port's zipf redraw gives the JAX function's candidate pools for
    the same split and seed, keeping every round's ground-truth row in its
    slot (and, as the reference does, possibly in other slots too)."""
    fl = _flagship(jax_config)
    splits = [m.make_random_split(fl, num_dialogs=6, num_unique_answers=400,
                                  seed=2)[0]
              for m in (jax_synthetic, torch_synthetic)]
    gt_rows = np.take_along_axis(splits[0].opt_inds,
                                 splits[0].gt_ind[..., None], axis=2)
    jax_synthetic.zipf_redraw_options(splits[0], a, seed=seed)
    torch_synthetic.zipf_redraw_options(splits[1], a, seed=seed)
    _assert_splits_equal(*splits)
    assert np.array_equal(np.take_along_axis(
        splits[1].opt_inds, splits[1].gt_ind[..., None], axis=2), gt_rows)
    # the skew: the most drawn row takes far more than a uniform share
    counts = np.bincount(splits[1].opt_inds.ravel(), minlength=400)
    assert counts.max() > 10 * splits[1].opt_inds.size / 400


def _assert_splits_equal(a, b):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
        else:
            assert fa[k] == fb[k], k


def _assert_batches_equal(got, want):
    g, w = got.as_dict(), want.as_dict()
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


CASES = [("mn-ques-im-hist", "disc", True), ("mn-ques-im-hist", "disc", False),
         ("mn-ques-hist", "gen", False), ("lf-ques-im-hist", "disc", True),
         ("hre-ques-hist", "gen", False)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("encoder,decoder,dedup", CASES)
def test_loader_batches_byte_identical(monkeypatch, encoder, decoder, dedup,
                                       native):
    """Train batches (dedup'd and expanded option layouts) and eval batches
    (with and without option tokens) of the port's loader equal the JAX
    loader's byte for byte under a float32 config."""
    if native:
        assert torch_native.available()        # g++ builds the port's core
    else:
        monkeypatch.setattr(torch_loader, "_native", None)
    cfg = small_config(encoder=encoder, decoder=decoder,
                       disc_dedup_options=dedup)
    split, vocab = jax_synthetic.make_synthetic_split(cfg, num_dialogs=7, seed=0)
    cfg_t = torch_config.Config.from_json(cfg.replace(vocab_size=vocab.size).to_json())
    cfg = cfg.replace(vocab_size=vocab.size)
    jt = list(jax_loader.TrainLoader(split, vocab, cfg).epoch(seed=2))
    tt = list(torch_loader.TrainLoader(split, vocab, cfg_t).epoch(seed=2))
    assert len(tt) == len(jt) > 0
    for a, b in zip(tt, jt):
        _assert_batches_equal(a, b)
    for opts in (True, False):
        je = list(jax_loader.EvalLoader(split, vocab, cfg, batch_size=3,
                                        option_tokens=opts))
        te = list(torch_loader.EvalLoader(split, vocab, cfg_t, batch_size=3,
                                          option_tokens=opts))
        assert len(te) == len(je) == 3
        for a, b in zip(te, je):
            _assert_batches_equal(a, b)


def test_native_core_builds_outside_the_jax_package():
    """The port compiles native/loader_core.cpp into build/visdial_tpu_torch/
    native/, never into visdial_tpu/data/, and its fast paths equal the
    numpy ones."""
    import os

    path = torch_native._build()
    assert path is not None and os.sep.join(
        ["build", "visdial_tpu_torch", "native"]) in path
    rng = np.random.default_rng(0)
    seq = rng.integers(1, 9, (6, 5)).astype(np.int32)
    lens = rng.integers(0, 6, 6).astype(np.int32)
    seq = np.where(np.arange(5) < lens[:, None], seq, 0).astype(np.int32)
    np.testing.assert_array_equal(torch_native.right_align(seq, lens),
                                  torch_loader.right_align(seq, lens))
