"""The port's bench (visdial_tpu_torch.bench) on the CPU: the line's keys at
a tiny scale, the refusals (warmup 0, a failed gate, a missing card), the
counted train step, the baseline cache, and the helpers held as
tests/test_bench_units.py holds the JAX bench's.  The rates themselves are
the card's (chip_smoke.py's bench phase)."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from visdial_tpu_torch import bench
from visdial_tpu_torch.data.synthetic import random_batch
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.parallel.train_step import init_train_state, train_step
from conftest import small_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX bench's line (BENCH_r05.json's record) and its realistic block
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline_torch_cpu", "backend",
    "n_chips", "kernel_check", "lengths", "model", "compute_dtype",
    "batch_size", "train_rounds_per_sec", "train_rounds_per_sec_per_chip",
    "loss_fingerprint", "train_achieved_tflops_per_sec_per_chip", "train_mfu",
    "eval_100cand_per_sec", "eval_100cand_per_sec_per_chip",
    "disc_table_eval_per_sec_per_chip", "disc_table_build_seconds",
    "disc_eval_e2e_per_sec_per_chip", "disc_eval_resident_per_sec_per_chip",
    "disc_eval_resident_cache_seconds", "gen_eval_e2e_per_sec_per_chip",
    "gen_eval_resident_per_sec_per_chip", "gen_eval_resident_cache_seconds",
    "serving_disc_p50_ms", "serving_disc_p95_ms", "serving_gen_p50_ms",
    "serving_gen_p95_ms", "gen_batch_size", "gen_train_rounds_per_sec_per_chip",
    "gen_loss_fingerprint", "gen_train_mfu", "gen_eval_100cand_per_sec",
    "gen_eval_100cand_per_sec_per_chip",
    "disc_train_plain_rounds_per_sec_per_chip",
    "disc_train_dedup_rounds_per_sec_per_chip",
    "disc_train_dedup_zipf_rounds_per_sec_per_chip", "realistic"}
REALISTIC_KEYS = {
    "train_rounds_per_sec_per_chip", "eval_100cand_per_sec",
    "eval_100cand_per_sec_per_chip", "gen_train_rounds_per_sec_per_chip",
    "gen_eval_100cand_per_sec", "gen_eval_100cand_per_sec_per_chip"}
PORT_KEYS = {"device_name", "power_limit_w", "allow_tf32",
             "train_flops_per_step", "gen_train_flops_per_step",
             "kernel_launches"}
# off the card: no gate (--no_kernel_check) and no peak, so no MFU
CPU_ABSENT = {"kernel_check", "train_mfu", "gen_train_mfu"}

# the counted plain step at small_config's widths (batch 4, 4 rounds, 12
# candidates), measured on this CPU: LF-QIH (small_config's encoder) and
# MN-QIH (the bench's)
SMALL_FLOPS = {"lf-ques-im-hist": 51_704_832, "mn-ques-im-hist": 52_184_064}


def _tiny_flagship(encoder="mn-ques-im-hist", decoder="disc", batch_size=32,
                   compute_dtype="bfloat16", img_spatial=False):
    return small_config(encoder=encoder, decoder=decoder,
                        compute_dtype=compute_dtype, vocab_size=40,
                        dropout=0.5, use_pallas=True)


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _boom(what):
    def fn(*a, **kw):
        raise AssertionError(f"{what} must not run")
    return fn


@pytest.fixture
def tiny_bench(monkeypatch, tmp_path):
    """flagship_config at small_config's widths, the split sizes shrunk
    through the module's constants, and the baseline caches in tmp_path
    with a record that matches this host (nothing measured)."""
    monkeypatch.setattr(bench, "flagship_config", _tiny_flagship)
    for name, value in dict(TABLE_ROWS=1024, DEDUP_ANSWERS=500,
                            HARNESS_DIALOGS=16, HARNESS_ANSWERS=300,
                            SERVING_DIALOGS=2, SERVING_ANSWERS=200,
                            GEN_BATCH=8).items():
        monkeypatch.setattr(bench, name, value)
    cache = tmp_path / "baseline.json"
    cache.write_text(json.dumps({"rounds_per_sec": 4.0, "steps_measured": 10,
                                 "host_cpus": os.cpu_count(),
                                 "estimated": False}))
    monkeypatch.setattr(bench, "BASELINE_CACHE", str(tmp_path / "absent.json"))
    monkeypatch.setattr(bench, "BASELINE_BUILD_CACHE", str(cache))
    monkeypatch.setattr(bench, "bench_torch_cpu", _boom("the baseline"))
    return cache


def test_main_prints_the_jax_keys_at_a_tiny_scale(tiny_bench, capsys):
    """(a) One line on stdout with every key of the JAX line (but the gate
    and the MFUs, which need the card) plus the port's; every rate finite
    and positive; the counted step small_config's; the pre-port files and
    the cache untouched."""
    frozen = [os.path.join(ROOT, f) for f in ("bench.py",
                                              "bench_baseline_torch.json")]
    before = [_digest(f) for f in frozen + [str(tiny_bench)]]
    bench.main(["--device", "cpu", "--no_kernel_check", "--steps", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert set(rec) == (JAX_KEYS - CPU_ABSENT) | PORT_KEYS
    assert set(rec["realistic"]) == REALISTIC_KEYS
    assert (rec["backend"], rec["device_name"], rec["n_chips"]) == ("cpu", "cpu", 1)
    assert rec["power_limit_w"] is None and rec["allow_tf32"] is False
    assert (rec["model"], rec["compute_dtype"]) == ("mn-ques-im-hist-disc",
                                                    "bfloat16")
    assert rec["gen_batch_size"] == 8
    assert rec["train_flops_per_step"] == SMALL_FLOPS["mn-ques-im-hist"]
    assert abs(rec["vs_baseline"] - rec["value"] / 4.0) <= 0.01
    for key in ("loss_fingerprint", "gen_loss_fingerprint"):
        assert len(rec[key]) == bench.TRAIN_DISPATCH_GROUP
        assert all(np.isfinite(rec[key]))
    rates = [(k, v) for d in (rec, rec["realistic"]) for k, v in d.items()
             if k.endswith(("_per_sec", "_per_chip", "_ms", "_seconds",
                            "_per_step"))]
    assert len(rates) >= 30
    assert all(np.isfinite(v) and v > 0 for _, v in rates), rates
    # the CPU takes the plain versions: no kernel launched
    assert rec["kernel_launches"] == dict.fromkeys(rec["kernel_launches"], 0)
    assert [_digest(f) for f in frozen + [str(tiny_bench)]] == before


def test_warmup_zero_is_refused_before_any_step(monkeypatch):
    """(b) The JAX bench crashes after its timed windows with warmup 0
    (bench.py:235-239); the port refuses it at entry."""
    monkeypatch.setattr(bench, "make_multistep_train_fn", _boom("a train step"))
    monkeypatch.setattr(bench, "random_batch", _boom("batch assembly"))
    cfg = small_config(vocab_size=40)
    with pytest.raises(ValueError, match="warmup"):
        bench.bench_train(cfg, "cpu", warmup=0)


def test_failed_gate_exits_1_with_the_gate_block_only(monkeypatch, capsys):
    """(c) A failing gate: value 0, the failed checks named, no row
    measured and no baseline, exit 1."""
    from visdial_tpu_torch import verify

    gate = {"ok": False, "backend": "cpu", "device_name": "cpu",
            "scale": "flagship",
            "checks": [{"name": "lstm_fwd_f32", "ok": False,
                        "max_abs_err": 9.9, "max_rel_err": 9.9,
                        "rel_tol": 0.003},
                       {"name": "attention_f32", "ok": True,
                        "max_abs_err": 0.0, "max_rel_err": 0.0,
                        "rel_tol": 0.003}]}
    monkeypatch.setattr(verify, "run_checks", lambda *a, **kw: gate)
    monkeypatch.setattr(bench, "flagship_config", _tiny_flagship)
    monkeypatch.setattr(bench, "bench_train", _boom("a measured row"))
    monkeypatch.setattr(bench, "torch_baseline", _boom("the baseline"))
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu"])
    assert e.value.code == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert rec["kernel_gate_failed"] == ["lstm_fwd_f32"]
    assert rec["kernel_check"]["ok"] is False
    assert "train_rounds_per_sec" not in rec
    assert "baseline_torch_cpu" not in rec


def test_cuda_without_a_card_raises_and_never_runs_on_the_cpu(monkeypatch):
    """(d) --device cuda (the default) with no card raises before the gate
    or any row; nothing falls back to the CPU."""
    from visdial_tpu_torch import verify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(verify, "run_checks", _boom("the gate"))
    monkeypatch.setattr(bench, "bench_train", _boom("a measured row"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(["--device", "cuda", "--no_kernel_check"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("encoder", sorted(SMALL_FLOPS))
def test_counted_step(encoder, dtype):
    """(e) The count is the CPU's measured figure in both dtypes, equal to a
    count of the plain step in the config's own dtype, and at least three
    times the option LSTM's forward, 2·N·T·((E+H)+(H+H))·4H (forward plus a
    backward of twice its work)."""
    cfg = small_config(encoder=encoder, vocab_size=40, compute_dtype=dtype,
                       dropout=0.5)
    batch = batch_to_device(random_batch(cfg, seed=0), "cpu")
    n = bench.step_flops(cfg.replace(use_pallas=True), batch)
    assert n == SMALL_FLOPS[encoder]
    with FlopCounterMode(display=False) as counter:
        train_step(init_train_state(cfg), batch, cfg)
    assert counter.get_total_flops() == n
    E, H = cfg.embed_size, cfg.rnn_hidden_size
    N = cfg.batch_size * cfg.num_rounds * cfg.num_options
    assert n >= 3 * 2 * N * cfg.max_ans_len * ((E + H) + (H + H)) * 4 * H


@pytest.mark.parametrize("decoder,per_dialog", [("disc", 193_195_163_648),
                                                ("gen", 17_182_711_808)])
def test_counted_step_at_flagship_widths_is_linear_in_the_batch(decoder,
                                                                per_dialog):
    """The flagship step's count a dialog, the figure chip_smoke.py holds
    the card's count to at batch 32 (disc) and 64 (gen): the count is
    linear in the batch, so a dialog's operations on this CPU give the
    card's step."""
    counts = []
    for b in (1, 2):
        cfg = bench.flagship_config(decoder=decoder, batch_size=b)
        batch = batch_to_device(random_batch(cfg, seed=0), "cpu")
        counts.append(bench.step_flops(cfg, batch))
    assert counts == [per_dialog, 2 * per_dialog]


def test_median_rate_rejects_single_stall():
    """(f) One stalled window out of three does not move the median."""
    draws = iter([100.0, 3.0, 98.0])
    assert bench.median_rate(lambda: next(draws)) == 98.0


def test_median_rate_runs_n_windows():
    calls = []
    bench.median_rate(lambda: calls.append(1) or float(len(calls)), n=5)
    assert len(calls) == 5


def test_flagship_config_defaults():
    cfg = bench.flagship_config()
    assert (cfg.encoder, cfg.decoder) == ("mn-ques-im-hist", "disc")
    assert (cfg.batch_size, cfg.vocab_size, cfg.dropout) == (32, 8848, 0.5)
    assert cfg.compute_dtype == "bfloat16"
    assert not cfg.img_spatial


def test_flagship_config_img_spatial():
    """--img_spatial gives the 49 x 512 pool5 geometry the validator
    accepts."""
    cfg = bench.flagship_config(img_spatial=True).validate()
    assert cfg.img_spatial
    assert cfg.img_feat_size == 49 * 512
    assert cfg.img_spatial_slots * cfg.img_spatial_channels == cfg.img_feat_size


def test_peak_and_power_limit_by_card(monkeypatch):
    """The peak is the H100's for its dtype and None for any other device,
    the CPU included; the power limit is nvidia-smi's, None on the CPU."""
    cuda = torch.device("cuda", 0)
    assert bench.peak_flops(torch.device("cpu"), "bfloat16") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert bench.peak_flops(cuda, "bfloat16") == 989e12
    assert bench.peak_flops(cuda, "float32") == 165e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Tesla T4")
    assert bench.peak_flops(cuda, "bfloat16") is None

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **kw: Done)
    assert bench.power_limit_w(cuda) == 700.0
    assert bench.power_limit_w(torch.device("cpu")) is None


def test_baseline_reads_a_matching_cache_and_measures_otherwise(monkeypatch,
                                                                tmp_path):
    """The JAX bench's cache is read when it matches this host and never
    written; otherwise the baseline is measured once and cached in the
    port's build directory, which the next call reads."""
    root = tmp_path / "root.json"
    build = tmp_path / "build" / "baseline.json"
    monkeypatch.setattr(bench, "BASELINE_CACHE", str(root))
    monkeypatch.setattr(bench, "BASELINE_BUILD_CACHE", str(build))
    record = {"rounds_per_sec": 3.2, "steps_measured": 10,
              "host_cpus": os.cpu_count(), "estimated": False}
    root.write_text(json.dumps(record))
    monkeypatch.setattr(bench, "bench_torch_cpu", _boom("a measurement"))
    assert bench.torch_baseline() == record

    root.write_text(json.dumps({**record, "host_cpus": -1}))
    frozen = root.read_text()
    measured = {**record, "rounds_per_sec": 7.5}
    calls = []
    monkeypatch.setattr(bench, "bench_torch_cpu",
                        lambda: calls.append(1) or measured)
    assert bench.torch_baseline() == measured
    assert bench.torch_baseline() == measured
    assert len(calls) == 1 and root.read_text() == frozen
    assert json.loads(build.read_text()) == measured
