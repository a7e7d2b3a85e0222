"""Checkpoints in the JAX package's on-disk format, read and written without
JAX (port of visdial_tpu/utils/checkpoint.py).

A checkpoint is a directory step_<N>/ holding params.npz, opt_m.npz and
opt_v.npz (arrays keyed by tree path) and meta.json ({"step", "rng",
"config", "extra"}).  The reader rebuilds the Config from meta.json and
checks every param key and shape against the port's own model; it loads
params only (serving needs no optimizer state).  The writer stores zero
optimizer moments and a 2-word threefry rng key, so the JAX package's
load_checkpoint reads what it writes.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np

from visdial_tpu.config import Config

from .params import params_from_numpy, params_to_numpy


def save_checkpoint(directory: str, params: dict, cfg: Config, step: int = 0,
                    extra: dict | None = None) -> str:
    """Atomic write of <directory>/step_<step>/; returns its path."""
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        flat = params_to_numpy(params)
        zeros = {k: np.zeros_like(v) for k, v in flat.items()}
        # sgd keeps no second moment: its leaves are (0,) in the JAX state
        second = ({k: np.zeros((0,), np.float32) for k in flat}
                  if cfg.optimizer == "sgd" else zeros)
        np.savez(os.path.join(tmp, "params.npz"), **flat)
        np.savez(os.path.join(tmp, "opt_m.npz"), **zeros)
        np.savez(os.path.join(tmp, "opt_v.npz"), **second)
        meta = {"step": int(step), "rng": [0, int(cfg.seed) & 0xFFFFFFFF],
                "config": json.loads(cfg.to_json()), "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def load_checkpoint(path: str, device) -> tuple[dict, Config, dict]:
    """(params on `device`, Config, extra) from a checkpoint directory."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = Config.from_dict(meta["config"])
    with np.load(os.path.join(path, "params.npz")) as z:
        params = params_from_numpy(dict(z), cfg, device)
    return params, cfg, meta.get("extra", {})
