"""Where a CUDA-graph replay of the train step and the eager step part at a
narrow shape, on the card: eager against itself, a replay from the graph's
own state, and a replay after a state was copied in, at H 64 and H 512 (a
narrow MN-QIH-disc, tests/test_torch_cuda.py::_small_graph_case).  Prints,
for each, how many param leaves differ and the largest differences.

    python scripts/graph_determinism.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402

import test_torch_cuda as cases  # noqa: E402
from visdial_tpu_torch.parallel.train_step import (init_train_state,  # noqa: E402
                                                   make_train_fn, train_step)
from visdial_tpu_torch.utils.params import flatten  # noqa: E402


def diff(a, b):
    fa, fb = flatten(a.params), flatten(b.params)
    bad = {k: float((fa[k] - fb[k]).abs().max()) for k in fa
           if not torch.equal(fa[k], fb[k])}
    return len(bad), sorted(bad.items(), key=lambda kv: -kv[1])[:3]


def main():
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    for H in (64, 512):
        cfg, batches = cases._small_graph_case(dev)
        cfg = cfg.replace(rnn_hidden_size=H)
        b0, b1 = batches[0], batches[1]
        eager = [train_step(init_train_state(cfg, device=dev, seed=7), b1,
                            cfg)[0] for _ in range(3)]
        print("H", H, "eager vs eager", diff(eager[0], eager[1]),
              diff(eager[0], eager[2]))
        ref = init_train_state(cfg, device=dev, seed=7)
        ref, _ = train_step(ref, b0, cfg)
        ref, _ = train_step(ref, b1, cfg)
        fn = make_train_fn(cfg)
        s, _ = fn(init_train_state(cfg, device=dev, seed=7), b0)
        s, _ = fn(s, b1)
        print("H", H, "replay, own state, vs eager", diff(s, ref))
        fn = make_train_fn(cfg)
        fn(init_train_state(cfg, device=dev, seed=0), b0)
        out, _ = fn(init_train_state(cfg, device=dev, seed=7), b1)
        print("H", H, "replay after copy-in vs eager", diff(out, eager[0]))


if __name__ == "__main__":
    main()
