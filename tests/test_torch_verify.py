"""The port's on-card gate (visdial_tpu_torch/verify.py) rehearsed on the
CPU, mirroring tests/test_verify.py: the gate must be able to fail -- a
tolerance breach, a NaN, a shape mismatch, a perturbed kernel route or a
crash each make ok False -- and its tiny run passes with the kernel routes'
card guard substituted, so that the wrappers take their plain versions on
CPU tensors.  Also random_batch byte for byte against the JAX package's."""

import numpy as np
import pytest
import torch

from visdial_tpu.config import Config as JaxConfig
from visdial_tpu.data.synthetic import random_batch as jax_random_batch
from visdial_tpu_torch import verify
from visdial_tpu_torch.config import Config
from visdial_tpu_torch.data.synthetic import random_batch
from visdial_tpu_torch.ops import attention_cuda, lstm_cuda

torch.set_num_threads(1)


@pytest.fixture
def on_cpu(monkeypatch):
    """The kernel routes on CPU tensors: the wrappers' plain versions."""
    monkeypatch.setattr(verify, "_require_card", lambda t: None)


def test_record_flags_out_of_tolerance():
    ok = verify._record("x", np.ones(4), np.ones(4), rel_tol=1e-3)
    assert ok["ok"] and ok["max_rel_err"] == 0.0
    bad = verify._record("x", torch.ones(4) * 1.01, torch.ones(4),
                         rel_tol=1e-3)
    assert not bad["ok"]
    assert bad["max_rel_err"] == pytest.approx(0.01, rel=1e-6)


def test_record_flags_nan_and_shape_mismatch():
    nan = verify._record("x", np.array([np.nan]), np.array([1.0]), 1e-3)
    assert not nan["ok"]
    # a NaN on the plain side must fail too: np.max over it is NaN, and
    # max(0.0, nan) would otherwise keep 0.0
    nan_want = verify._record("x", np.array([5.0, 5.0]),
                              np.array([1.0, np.nan]), 1e-3)
    assert not nan_want["ok"]
    inf = verify._record("x", torch.tensor([float("inf")]),
                         torch.tensor([1.0]), 1e-3)
    assert not inf["ok"]
    mis = verify._record("x", np.ones(3), np.ones(4), 1e-3)
    assert not mis["ok"]
    tree = verify._record("x", {"a": np.ones(2)},
                          {"a": np.ones(2), "b": np.ones(2)}, 1e-3)
    assert not tree["ok"]


def test_aggregate_requires_every_check():
    good, bad = {"ok": True}, {"ok": False}
    assert verify._aggregate([good, good])["ok"]
    assert not verify._aggregate([good, bad])["ok"]


def test_run_checks_tiny_passes_with_plain_routes(on_cpu):
    res = verify.run_checks("tiny", device="cpu")
    failed = [c for c in res["checks"] if not c["ok"]]
    assert res["ok"], failed
    assert len(res["checks"]) == 22
    assert {c["name"] for c in res["checks"]} >= {
        "lstm_fwd_f32", "lstm_fwd_bf16@big", "lstm_bwd_bf16@big",
        "lstm_bwd_bf16@small", "lstm_bwd_f32@big", "attention_bf16",
        "attention_fusion_f32", "lm_logprobs_bf16", "lm_dlogits_f32",
        "train_grads_disc_bf16", "train_grads_gen_f32",
        "train_grads_disc_dedup_bf16", "lm_vocab_shards_f32",
        "lm_vocab_shards_bf16"}
    assert res["scale"] == "tiny" and res["backend"] == "cpu"


def test_run_checks_refuse_cpu_tensors():
    """Without the substitution every check fails: on a CPU tensor the
    wrappers would compare the plain version with itself."""
    res = verify.run_checks("tiny", include={"lstm_fwd_f32", "lm_dlogits"},
                            device="cpu")
    assert not res["ok"] and len(res["checks"]) == 3
    assert all("CUDA tensor" in c["error"] for c in res["checks"])


def test_run_checks_catches_perturbed_kernel(on_cpu, monkeypatch):
    orig = lstm_cuda.lstm_layer

    def broken(*args, **kwargs):
        outs = orig(*args, **kwargs)
        return (outs[0] + 0.1,) + tuple(outs[1:])

    monkeypatch.setattr(lstm_cuda, "lstm_layer", broken)
    res = verify.run_checks("tiny", include={"lstm_fwd_f32"}, device="cpu")
    assert len(res["checks"]) == 1
    assert not res["ok"]


def test_run_checks_turns_crash_into_failure(on_cpu, monkeypatch):
    def crash(*args, **kwargs):
        raise RuntimeError("the kernel says no")

    monkeypatch.setattr(attention_cuda, "masked_slot_attention", crash)
    res = verify.run_checks("tiny", include={"attention_bf16"}, device="cpu")
    assert not res["ok"]
    assert "the kernel says no" in res["checks"][0]["error"]


@pytest.mark.parametrize("full_lengths", [True, False])
@pytest.mark.parametrize("decoder", ["disc", "gen"])
def test_random_batch_equals_jax(decoder, full_lengths):
    kw = dict(vocab_size=97, batch_size=3, num_rounds=4, num_options=7,
              decoder=decoder)
    want = jax_random_batch(JaxConfig(**kw), seed=11,
                            full_lengths=full_lengths)
    got = random_batch(Config(**kw), seed=11, full_lengths=full_lengths)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
