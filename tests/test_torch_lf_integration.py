"""The port's twin of tests/test_train_integration.py's disc bar: LF-QIH-disc
(hidden 32 / embed 24, lr 5e-3, no decay) trained 300 steps on the CPU on
the separable synthetic task must rank the ground truth at MRR > 0.8
through the port's evaluate_split (chance over 12 options ~0.26; the JAX
package measures 0.95 at this budget)."""

import numpy as np
import torch

from visdial_tpu_torch.config import Config
from visdial_tpu_torch.data.loader import TrainLoader
from visdial_tpu_torch.data.synthetic import make_synthetic_split
from visdial_tpu_torch.eval_harness import evaluate_split
from visdial_tpu_torch.models.model import batch_to_device
from visdial_tpu_torch.parallel.train_step import init_train_state, train_step

from conftest import small_config

torch.set_num_threads(1)


def test_lf_disc_learns_synthetic_to_near_optimal_retrieval():
    cfg = Config.from_json(small_config(
        encoder="lf-ques-im-hist", decoder="disc", rnn_hidden_size=32,
        embed_size=24, learning_rate=5e-3, lr_decay_rate=1.0).to_json())
    split, vocab = make_synthetic_split(cfg, num_dialogs=32, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    assert cfg.lf_hist_incremental
    state = init_train_state(cfg)
    loader, losses = TrainLoader(split, vocab, cfg), []
    while len(losses) < 300:
        for b in loader.epoch(seed=len(losses)):
            state, m = train_step(state, batch_to_device(b.as_dict(), "cpu"), cfg)
            losses.append(float(m["loss"]))
            if len(losses) == 300:
                break
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.5, f"loss did not decrease: {first} -> {last}"
    metrics = evaluate_split(state.params, split, vocab, cfg, "cpu")
    assert metrics["mrr"] > 0.8, metrics
