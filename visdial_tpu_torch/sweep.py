"""Model-matrix sweep on one GPU (port of visdial_tpu/sweep.py).

Trains every requested encoder x decoder pair through
visdial_tpu_torch.train with the same hyperparameters, evaluates it on the
val split and writes one JSON results table ({"<encoder>-<decoder>":
{metrics..., "train_seconds"}}), with each run's JSONL and checkpoints
under --save_path.  Prints a `sweep_done` event per pair and
`sweep_complete` at the end.

Usage:
    python -m visdial_tpu_torch.sweep --data_dir data --num_epochs 15
    python -m visdial_tpu_torch.sweep --synthetic 64 --max_steps 60 \
        --extra "--embed_size 32 --rnn_hidden_size 32 --img_feat_size 64 \
                 --max_ques_len 6 --max_ans_len 4 --max_cap_len 8 \
                 --num_rounds 4 --num_options 12 --batch_size 8" \
        [--device cuda | --device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from .config import DECODERS, ENCODERS
from .train import main as train_main


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--encoders", type=str, default=",".join(ENCODERS))
    p.add_argument("--decoders", type=str, default=",".join(DECODERS))
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--num_epochs", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--save_path", type=str, default="checkpoints/sweep")
    p.add_argument("--out", type=str, default="sweep_results.json")
    p.add_argument("--extra", type=str, default="",
                   help="extra train flags appended verbatim")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    results = {}
    for encoder in args.encoders.split(","):
        for decoder in args.decoders.split(","):
            name = f"{encoder}-{decoder}"
            run_args = ["--encoder", encoder, "--decoder", decoder,
                        "--save_path", args.save_path, "--run_name", name,
                        "--device", args.device]
            if args.data_dir:
                run_args += ["--data_dir", args.data_dir]
            if args.synthetic:
                run_args += ["--synthetic", str(args.synthetic)]
            if args.num_epochs:
                run_args += ["--num_epochs", str(args.num_epochs)]
            if args.max_steps:
                run_args += ["--max_steps", str(args.max_steps)]
            run_args += args.extra.split()
            t0 = time.time()
            metrics = train_main(run_args)
            results[name] = {**metrics, "train_seconds": time.time() - t0}
            print(json.dumps({"event": "sweep_done", "model": name,
                              **{k: metrics.get(k) for k in
                                 ("mrr", "r@1", "r@5", "r@10", "mean_rank")}}),
                  flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"event": "sweep_complete", "out": args.out,
                      "models": len(results)}), flush=True)
    return results


if __name__ == "__main__":
    main()
