"""Checkpoints in the JAX package's on-disk format, read and written without
JAX (port of visdial_tpu/utils/checkpoint.py).

A checkpoint is a directory step_<N>/ holding params.npz, opt_m.npz and
opt_v.npz (arrays keyed by tree path) and meta.json ({"step", "rng",
"config", "extra"}).  The writer stores the whole train state: params, the
optimizer moments and step, and the dropout generator's state in
extra["torch_generator_state"]; "rng" is a 2-word threefry key derived from
the config's seed, so the JAX package's load_checkpoint reads what the port
writes.  Readers rebuild the Config from meta.json and check every key and
shape against the port's own model: `load_checkpoint` reads params only
(serving), `load_train_state` the whole state (resume).  A checkpoint the
JAX package wrote resumes here with its params, moments and step; its
generator is seeded from its rng key.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from ..config import Config

from ..parallel.optim import OptState
from ..parallel.train_step import TrainState
from .params import param_shapes, params_from_numpy, params_to_numpy, unflatten

GENERATOR_KEY = "torch_generator_state"


def save_checkpoint(directory: str, state, cfg: Config, step: int | None = None,
                    extra: dict | None = None) -> str:
    """Atomic write of <directory>/step_<N>/; returns its path.  `state` is
    a parallel.train_step.TrainState (N is its step) or a params tree alone
    (zero moments, N = step or 0)."""
    if not isinstance(state, TrainState):
        params, m, v, gen = state, None, None, None
        step = int(step or 0)
    else:
        params, m, v, gen = state.params, state.opt.m, state.opt.v, state.gen
        step = int(state.opt.step if step is None else step)
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        flat = params_to_numpy(params)
        if m is None:
            m = {k: np.zeros_like(a) for k, a in flat.items()}
            # sgd keeps no second moment: its leaves are (0,) in the JAX state
            v = ({k: np.zeros((0,), np.float32) for k in flat}
                 if cfg.optimizer == "sgd" else m)
        else:
            m, v = params_to_numpy(m), params_to_numpy(v)
        extra = dict(extra or {})
        if gen is not None:
            extra[GENERATOR_KEY] = gen.get_state().tolist()
        np.savez(os.path.join(tmp, "params.npz"), **flat)
        np.savez(os.path.join(tmp, "opt_m.npz"), **m)
        np.savez(os.path.join(tmp, "opt_v.npz"), **v)
        meta = {"step": step, "rng": [0, int(cfg.seed) & 0xFFFFFFFF],
                "config": json.loads(cfg.to_json()), "extra": extra}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    return os.path.join(directory, steps[-1]) if steps else None


def _read(path: str) -> tuple[dict, Config]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return meta, Config.from_dict(meta["config"])


def _npz(path: str, name: str) -> dict:
    with np.load(os.path.join(path, name)) as z:
        return dict(z)


def load_checkpoint(path: str, device) -> tuple[dict, Config, dict]:
    """(params on `device`, Config, extra) from a checkpoint directory."""
    meta, cfg = _read(path)
    params = params_from_numpy(_npz(path, "params.npz"), cfg, device)
    extra = {k: v for k, v in meta.get("extra", {}).items() if k != GENERATOR_KEY}
    return params, cfg, extra


def load_train_state(path: str, device):
    """(TrainState on `device`, Config, extra) from a checkpoint directory
    written by either package."""
    meta, cfg = _read(path)
    params = params_from_numpy(_npz(path, "params.npz"), cfg, device)
    m = params_from_numpy(_npz(path, "opt_m.npz"), cfg, device)
    if cfg.optimizer == "sgd":   # (0,) second-moment leaves
        v = unflatten({k: torch.zeros((0,), device=device)
                       for k in param_shapes(cfg)})
    else:
        v = params_from_numpy(_npz(path, "opt_v.npz"), cfg, device)
    extra = dict(meta.get("extra", {}))
    gen = torch.Generator()
    if GENERATOR_KEY in extra:
        gen.set_state(torch.tensor(extra.pop(GENERATOR_KEY), dtype=torch.uint8))
    else:   # a JAX checkpoint: seed from its key words
        words = [int(w) & 0xFFFFFFFF for w in meta["rng"]]
        gen.manual_seed(sum(w << (32 * i) for i, w in enumerate(words[:2])))
    state = TrainState(params, OptState(int(meta["step"]), m, v), gen)
    return state, cfg, extra
