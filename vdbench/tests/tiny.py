"""A tiny copy of the benchmark's spec for the CPU tests: the same cells'
kinds at widths a test can hold, written under a temporary directory with
a copy of the encoder family modules and of the metrics' readers beside
its configs."""

from __future__ import annotations

import json
import os
import shutil

from vdbench import spec

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


def write(root: str, ranks: int = 2, real: str = spec.SPEC) -> str:
    """The tiny spec under root, its metrics taken from the spec at `real`;
    returns its path.  Cells: tiny-disc.train, tiny-gen.train,
    tiny-disc.eval and tiny-gen.train-dp<ranks>."""
    files = os.path.join(os.path.dirname(os.path.abspath(real)), "vdbench")
    os.makedirs(os.path.join(root, "vdbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "vdbench", "traffic"), exist_ok=True)
    os.makedirs(os.path.join(root, "vdbench", "limits"), exist_ok=True)
    for d in ("encoders", "metrics"):
        shutil.copytree(os.path.join(files, d), os.path.join(root, "vdbench", d),
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
    # name, config, traffic and its (kind, decoder, over several ranks)
    cells = [("tiny-disc.train", "tiny-disc", "train", ("train", "disc", False)),
             ("tiny-gen.train", "tiny-gen", "train", ("train", "gen", False)),
             ("tiny-disc.eval", "tiny-disc", "eval", ("eval", "disc", False)),
             (f"tiny-gen.train-dp{ranks}", "tiny-gen", "train-dp",
              ("train", "gen", True))]
    for name, _, _, like in cells:
        put(f"vdbench/limits/{name}.json", LIMITS[like[0]])
    with open(real) as f:
        bench = json.load(f)
    profiles = _profiles(bench, os.path.dirname(os.path.abspath(real)))

    def given(m: dict) -> dict:
        """m, listing the tiny cells like the real cells it lists."""
        if "workloads" not in m:
            return dict(m, workloads=[n for n, *_ in cells])
        likes = {profiles[w] for w in m["workloads"]}
        return dict(m, workloads=[n for n, _, _, like in cells if like in likes])

    put("BENCHMARK.json", {
        "configs": [{"name": n, "file": f"vdbench/configs/{n}.json"}
                    for n in ("tiny-disc", "tiny-gen")],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1}
                      for n, c, t, _ in cells],
        "end_to_end": [given(m) for m in bench["end_to_end"]],
        "per_layer": [given(m) for m in bench["per_layer"]],
    })
    return os.path.join(root, "BENCHMARK.json")


def _profiles(bench: dict, root: str) -> dict:
    """{cell: (its traffic's kind, its decoder, whether over several
    ranks)} of each cell of the spec `bench` at root."""
    configs = {c["name"]: c["file"] for c in bench["configs"]}
    out = {}
    for w in bench["workloads"]:
        with open(os.path.join(root, configs[w["config"]])) as f:
            decoder = json.load(f)["decoder"]
        with open(os.path.join(root, "vdbench", "traffic",
                               w["traffic"] + ".json")) as f:
            mix = json.load(f)
        out[w["name"]] = (mix["kind"], decoder, int(mix.get("ranks", 1)) > 1)
    return out
