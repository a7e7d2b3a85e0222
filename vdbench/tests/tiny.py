"""A tiny copy of the benchmark's spec for the CPU tests: the same cells'
kinds at widths a test can hold, written under a temporary directory with
a copy of the encoder family modules beside its configs."""

from __future__ import annotations

import json
import os
import shutil

from vdbench import encoders

CONFIG = {
    "encoder": "mn-ques-im-hist", "decoder": "disc", "vocab_size": 60,
    "embed_size": 16, "rnn_hidden_size": 24, "num_layers": 2,
    "img_feat_size": 32, "img_norm": True, "dropout": 0.5,
    "max_ques_len": 6, "max_ans_len": 4, "max_cap_len": 10,
    "num_rounds": 4, "num_options": 12, "batch_size": 4,
    "learning_rate": 0.001, "lr_decay_rate": 0.9997, "min_lr": 5e-05,
    "grad_clip": 5.0, "optimizer": "adam", "adam_beta1": 0.9,
    "adam_beta2": 0.999, "adam_eps": 1e-08, "compute_dtype": "float32",
    "disc_dedup_options": True,
}
TRAFFIC = {"dialogs": 64, "answers": 200, "zipf_a": 1.2,
           "mean_lengths": {"question": 3.0, "answer": 2.0, "caption": 5.0}}
LIMITS = {
    "train": {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-3},
              "update_gap": {"limit": 1e-3}},
    "eval": {"rank_moved": {"limit": 0.0},
             "out_of_band": {"limit": 0.5, "band": 0.01}},
}


def write(root: str, ranks: int = 2) -> str:
    """The tiny spec under root; returns its path.  Cells: tiny-disc.train,
    tiny-gen.train, tiny-disc.eval and tiny-gen.train-dp<ranks>."""
    os.makedirs(os.path.join(root, "vdbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "vdbench", "traffic"), exist_ok=True)
    os.makedirs(os.path.join(root, "vdbench", "limits"), exist_ok=True)
    shutil.copytree(encoders.HERE, os.path.join(root, "vdbench", "encoders"),
                    ignore=shutil.ignore_patterns("__pycache__"),
                    dirs_exist_ok=True)

    def put(path, obj):
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)

    put("vdbench/configs/tiny-disc.json", CONFIG)
    put("vdbench/configs/tiny-gen.json", dict(CONFIG, decoder="gen"))
    put("vdbench/traffic/train.json", dict(TRAFFIC, kind="train",
                                           steps_per_dispatch=3,
                                           trace_dispatches=2))
    put("vdbench/traffic/train-dp.json", dict(TRAFFIC, kind="train",
                                              steps_per_dispatch=3,
                                              trace_dispatches=2, ranks=ranks))
    put("vdbench/traffic/eval.json", dict(TRAFFIC, kind="eval", dialogs=20,
                                          passes_traced=1))
    cells = [("tiny-disc.train", "tiny-disc", "train", "train"),
             ("tiny-gen.train", "tiny-gen", "train", "train"),
             ("tiny-disc.eval", "tiny-disc", "eval", "eval"),
             (f"tiny-gen.train-dp{ranks}", "tiny-gen", "train-dp", "train")]
    for name, _, _, kind in cells:
        put(f"vdbench/limits/{name}.json", LIMITS[kind])
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "BENCHMARK.json")) as f:
        real = json.load(f)
    spec = {
        "configs": [{"name": n, "file": f"vdbench/configs/{n}.json"}
                    for n in ("tiny-disc", "tiny-gen")],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1}
                      for n, c, t, _ in cells],
        "end_to_end": [dict(m, workloads=[n for n, _, _, k in cells
                                          if _kind_of(m, real, n, k)])
                       for m in real["end_to_end"]],
        "per_layer": [dict(m, workloads=[n for n, _, _, k in cells
                                         if _kind_of(m, real, n, k)])
                      for m in real["per_layer"]],
    }
    path = os.path.join(root, "BENCHMARK.json")
    put("BENCHMARK.json", spec)
    return path


def _kind_of(metric: dict, real: dict, cell: str, kind: str) -> bool:
    """Whether the real spec gives `metric` to a cell of this kind."""
    if "workloads" not in metric:
        return True
    kinds = {w["name"]: w["traffic"] for w in real["workloads"]}
    return any(("val" in kinds[w]) == (kind == "eval")
               for w in metric["workloads"])
