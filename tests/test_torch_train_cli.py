"""The port's training CLI (visdial_tpu_torch/train.py) and its checkpoints:
a tiny run that checkpoints and resumes to the same numbers as an unbroken
run, checkpoints crossing between the packages in both directions, the
retrieval metrics against the JAX package's, and that no module of the
port imports JAX."""

import dataclasses
import json
import os
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

from visdial_tpu.config import Config
from visdial_tpu.data.synthetic import make_synthetic_split
from visdial_tpu.models.model import model_loss as jax_model_loss
from visdial_tpu.parallel.train_step import init_train_state as jax_init_state
from visdial_tpu.parallel.train_step import train_step as jax_train_step
from visdial_tpu.data.loader import TrainLoader
from visdial_tpu.utils.checkpoint import _tree_to_dict
from visdial_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from visdial_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from visdial_tpu.utils.metrics import ranks_from_scores as jax_ranks
from visdial_tpu.utils.metrics import retrieval_metrics as jax_metrics
from visdial_tpu_torch.train import main
from visdial_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                load_train_state)
from visdial_tpu_torch.utils.metrics import ranks_from_scores, retrieval_metrics
from visdial_tpu_torch.utils.params import flatten

from conftest import small_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    return small_config(encoder="mn-ques-im-hist", num_rounds=3, **kw)


def _argv(cfg: Config, tmp_path, run_name: str, *extra) -> list[str]:
    """CLI flags that rebuild `cfg` (every field off its default)."""
    argv = []
    for f in dataclasses.fields(Config):
        v = getattr(cfg, f.name)
        if f.name != "vocab_size" and v != f.default:
            argv += [f"--{f.name}", str(v)]
    return argv + ["--synthetic", "12", "--device", "cpu", "--log_every", "1",
                   "--save_path", str(tmp_path), "--run_name", run_name, *extra]


def _jax_train_event_keys() -> set[str]:
    """The keys of the JAX CLI's `train` event, read from the dict literal
    it logs in visdial_tpu/train.py."""
    import ast

    with open(os.path.join(ROOT, "visdial_tpu", "train.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            pairs = dict(zip(node.keys, node.values))
            if any(isinstance(k, ast.Constant) and k.value == "event"
                   and isinstance(v, ast.Constant) and v.value == "train"
                   for k, v in pairs.items()):
                return keys
    raise AssertionError("no train event in visdial_tpu/train.py")


def _events(tmp_path, run_name):
    with open(os.path.join(tmp_path, run_name, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_checkpoint_resume_reproduces_the_unbroken_run(tmp_path):
    """4 steps, checkpoint at 2 and 4, resume to 7 (crossing an epoch):
    the same losses and params as 7 unbroken steps, dropout 0.3 included
    (the generator state travels in the checkpoint; bit-equal)."""
    cfg = _cfg(dropout=0.3)
    main(_argv(cfg, tmp_path, "whole", "--max_steps", "7"))
    main(_argv(cfg, tmp_path, "split", "--max_steps", "4", "--save_every", "2",
               "--eval_every", "4"))
    ev = _events(tmp_path, "split")
    assert [e["step"] for e in ev if e["event"] == "checkpoint"] == [2, 4]
    assert [e for e in ev if e["event"] == "eval"][0]["num_examples"] > 0
    main(_argv(cfg, tmp_path, "split", "--max_steps", "7", "--resume"))
    ev = _events(tmp_path, "split")
    assert [e["from"] for e in ev if e["event"] == "resumed"] == [
        os.path.join(str(tmp_path), "split", "step_00000004")]
    train_events = [e for e in _events(tmp_path, "whole") if e["event"] == "train"]
    missing = _jax_train_event_keys() - set(train_events[0])
    assert not missing, f"the port's train event lacks {sorted(missing)}"
    whole = {e["step"]: e["loss"] for e in train_events}
    split = {e["step"]: e["loss"] for e in ev if e["event"] == "train"}
    assert sorted(split) == list(range(1, 8)) and split == whole
    a, _, _ = load_train_state(latest_checkpoint(str(tmp_path / "whole")), "cpu")
    b, _, _ = load_train_state(latest_checkpoint(str(tmp_path / "split")), "cpu")
    assert a.opt.step == b.opt.step == 7
    for k, v in flatten(a.params).items():
        assert torch.equal(v, flatten(b.params)[k]), k
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_port_checkpoint_loads_in_jax(tmp_path, optimizer):
    """The JAX package's load_checkpoint reads the port's whole train
    state: params, both moments (sgd: (0,) second moments) and the step."""
    cfg = _cfg(optimizer=optimizer)
    main(_argv(cfg, tmp_path, "run", "--max_steps", "3"))
    path = latest_checkpoint(str(tmp_path / "run"))
    state, cfg_j, _ = jax_load_checkpoint(path)
    port, cfg_p, _ = load_train_state(path, "cpu")
    assert cfg_j.to_json() == cfg_p.to_json()
    assert int(np.asarray(state.opt.step)) == port.opt.step == 3
    for jtree, ptree in ((state.params, port.params), (state.opt.m, port.opt.m),
                         (state.opt.v, port.opt.v)):
        want = {k: v.numpy() for k, v in flatten(ptree).items()}
        got = _tree_to_dict(jtree)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert any(np.abs(m).max() > 0 for m in _tree_to_dict(state.opt.m).values())


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """Two JAX train steps, checkpointed by the JAX package; the port's CLI
    resumes at step 2 with the same params and moments, and its next loss
    equals the JAX package's third step (dropout 0; atol 1e-5)."""
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    cfg = _cfg()
    split, vocab = make_synthetic_split(cfg, num_dialogs=12, seed=cfg.seed)
    cfg = cfg.replace(vocab_size=vocab.size)
    state = jax_init_state(cfg)
    batches = [b.as_dict() for b in TrainLoader(split, vocab, cfg).epoch(cfg.seed)]
    step_fn = jax.jit(partial(jax_train_step, cfg=cfg, impl="xla"))
    losses = []
    for b in batches[:3]:
        if len(losses) == 2:
            jax_save_checkpoint(str(tmp_path / "run"), state, cfg)
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    port, _, _ = load_train_state(latest_checkpoint(str(tmp_path / "run")), "cpu")
    assert port.opt.step == 2
    main(_argv(cfg, tmp_path, "run", "--max_steps", "3", "--resume"))
    ev = _events(tmp_path, "run")
    assert [e["event"] for e in ev if e["event"] == "resumed"] == ["resumed"]
    (loss3,) = [e["loss"] for e in ev if e["event"] == "train"]
    np.testing.assert_allclose(loss3, losses[2], atol=1e-5)


def test_resume_refuses_a_structural_mismatch(tmp_path):
    cfg = _cfg()
    main(_argv(cfg, tmp_path, "run", "--max_steps", "1"))
    with pytest.raises(SystemExit, match="rnn_hidden_size"):
        main(_argv(cfg.replace(rnn_hidden_size=16), tmp_path, "run",
                   "--max_steps", "2", "--resume"))


@pytest.mark.parametrize("ties", ["optimistic", "pessimistic", "mean"])
def test_ranks_and_metrics_match_jax(ties):
    """ranks_from_scores under the three tie rules (scores with exact ties
    to the ground truth) and retrieval_metrics, including its empty guard."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 5, (6, 4, 12)).astype(np.float32)
    gt = rng.integers(0, 12, (6, 4))
    want = np.asarray(jax_ranks(scores, gt, ties=ties))
    got = ranks_from_scores(torch.from_numpy(scores), torch.from_numpy(gt), ties)
    assert got.dtype == (torch.float32 if ties == "mean" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert retrieval_metrics(got.numpy()) == jax_metrics(want)
    assert retrieval_metrics(np.zeros(0)) == jax_metrics(np.zeros(0))
    with pytest.raises(ValueError, match="ties"):
        ranks_from_scores(torch.from_numpy(scores), torch.from_numpy(gt), "x")


def test_eval_mode_loss_matches_jax():
    """model_loss(train=False) on a train batch against the JAX package."""
    from visdial_tpu.models.model import model_init as jax_model_init
    from visdial_tpu_torch.models.model import batch_to_device, model_loss
    from visdial_tpu_torch.utils.params import params_from_numpy

    cfg = _cfg()
    split, vocab = make_synthetic_split(cfg, num_dialogs=8, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    jparams = jax.tree.map(lambda p: p * 4,
                           jax_model_init(jax.random.PRNGKey(0), cfg))
    batch = next(iter(TrainLoader(split, vocab, cfg).epoch(0))).as_dict()
    want = jax_model_loss(jparams, batch, cfg, train=False, impl="xla")
    got = model_loss(params_from_numpy(_tree_to_dict(jparams), cfg, "cpu"),
                     batch_to_device(batch, "cpu"), cfg, train=False)
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)


def test_port_imports_no_jax_anywhere():
    """Every module of visdial_tpu_torch imports with `jax` blocked, and
    pulls in no module of the JAX package visdial_tpu at all (the port keeps
    its own copies of the configuration and the data modules)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import visdial_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "visdial_tpu_torch.__path__, 'visdial_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'visdial_tpu' "
        "or m.startswith('visdial_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'visdial_tpu_torch.train' in mods and len(mods) > 15, mods\n"
        "new = {'visdial_tpu_torch.parallel.mesh', 'visdial_tpu_torch.verify',"
        " 'visdial_tpu_torch.parallel.launch', 'visdial_tpu_torch.models.vgg16',"
        " 'visdial_tpu_torch.data.prepro_img'}\n"
        "assert new <= set(mods), new - set(mods)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py cannot run here, so its imports are read from its AST:
    no jax and no module of the JAX package, anywhere in the file."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert any(n.startswith("visdial_tpu_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in ("jax", "visdial_tpu")]
    assert not bad, bad
