"""Generation CLI on one GPU or a data axis of them (port of
visdial_tpu/generate.py).

Loads a gen-decoder checkpoint of either package, decodes an answer for
every round of the first --num_dialogs dialogs of a split through
models/model.py::model_generate (greedy; --sample --temperature, drawn from
a torch.Generator on the device seeded with --seed; or --beam_size), one
CUDA graph a batch shape on the card (parallel/graph.py),
detokenizes with the vocabulary and writes the JSON that `vis/index.html`
renders: {"model", "split", "dialogs": [{"image_id", "caption", "rounds":
[{"question", "gt_answer", "generated", "log_prob"}, ...]}, ...]}.

A round is written when it has a question.  The JAX CLI writes only the
rounds with round_valid set, which marks the rounds that can be ranked
against a ground truth: on a v1.0 test-style split no round has one, and it
writes no round at all.

Usage:
    python -m visdial_tpu_torch.generate --load_path checkpoints/run/step_N \
        [--data_dir data | --synthetic 64] [--num_dialogs 20] \
        [--sample --temperature 0.8 | --beam_size 5] \
        [--out_path generated.json] [--device cuda | --device cpu]

Under torchrun, --mesh_data / --mesh_model lay the processes out
(parallel/mesh.py): each data rank decodes its dialogs of every batch (all
of a batch the data axis does not divide), the answers are gathered in
split order, and rank 0 alone writes them.  The params stay whole on every
rank (the checkpoint holds whole arrays, the vocab leaves a few tens of MB),
so the ranks of a model group decode their data rank's dialogs alike, with
no communication between steps: the same tokens as one device, bit for bit.
A sampling rank's generator is seeded with --seed plus its data coordinate,
the same across its model group.
"""

from __future__ import annotations

import argparse
import json
from functools import partial

import torch

from .data.dataset import load_split
from .data.loader import EvalLoader
from .data.synthetic import make_synthetic_split
from .models.model import batch_to_device, model_generate
from .parallel.graph import InferenceGraphed
from .parallel.mesh import (add_mesh_args, broadcast_tree, make_mesh,
                            slice_dialogs)
from .utils.checkpoint import load_checkpoint


def _decode(params, cfg, batch, start_token, end_token, greedy, temperature,
            beam_size, gen):
    """model_generate with every argument positional: the static ones are
    leaves of the graph's signature."""
    return model_generate(params, batch, cfg, start_token=start_token,
                          end_token=end_token, greedy=greedy, gen=gen,
                          temperature=temperature, beam_size=beam_size)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--load_path", required=True)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--num_dialogs", type=int, default=20,
                   help="how many dialogs to decode (0 = whole split)")
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--sample", action="store_true",
                   help="temperature sampling instead of greedy")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--beam_size", type=int, default=0,
                   help=">1 enables beam search (overrides --sample)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_path", type=str, default="generated.json")
    p.add_argument("--device", type=str, default="cuda")
    add_mesh_args(p)
    args = p.parse_args(argv)

    mesh = make_mesh(args.mesh_data, args.mesh_model, args.device)
    device = mesh.device
    params, cfg, _ = load_checkpoint(args.load_path, device)
    params = broadcast_tree(params, mesh)
    if cfg.decoder != "gen":
        raise SystemExit(f"checkpoint is {cfg.decoder!r}; generation needs a "
                         "gen decoder")
    if args.data_dir:
        cfg = cfg.replace(data_dir=args.data_dir)
    if args.synthetic:
        data, vocab = make_synthetic_split(cfg, num_dialogs=args.synthetic,
                                           seed=cfg.seed + 1)
    else:
        data, vocab = load_split(cfg.data_dir, args.split)
    if vocab.size != cfg.vocab_size:
        raise SystemExit(f"checkpoint/vocab mismatch: the checkpoint has "
                         f"vocab_size {cfg.vocab_size}, the data {vocab.size}")

    bs = args.batch_size or cfg.batch_size
    n = args.num_dialogs or data.num_dialogs
    gen = (torch.Generator(device=device).manual_seed(args.seed + mesh.d)
           if args.sample else None)
    sl = mesh.dialog_slice(bs)
    # the decode, as JAX's jitted model_generate: one CUDA graph a batch
    # signature, over the params it closes over (whole on every rank, so
    # no collective runs inside); the sampling generator is registered
    # with it, so a replay draws from its state and advances it as an
    # eager call does.  The ranks' dialogs are gathered after it.
    decode = partial(InferenceGraphed(partial(_decode, params, cfg)),
                     generators=[gen] if gen is not None else [])
    loader = EvalLoader(data, vocab, cfg, batch_size=bs, option_tokens=False)
    records = []
    for batch_idx, batch in enumerate(loader):
        arrays = batch.as_dict()
        if sl is not None:
            arrays = slice_dialogs(arrays, *sl)
        toks, logp = decode(batch_to_device(arrays, device), vocab.start,
                            vocab.end, not args.sample, args.temperature,
                            args.beam_size, gen)
        if sl is not None:      # the ranks' dialogs back in batch order
            toks, logp = (mesh.gather_data(t).flatten(0, 1) for t in (toks, logp))
        toks, logp = toks.cpu().numpy(), logp.cpu().numpy()
        for b in range(toks.shape[0]):
            i = batch_idx * bs + b            # global dialog index
            if not batch.dialog_valid[b] or i >= n:
                break
            rounds = []
            for r in range(cfg.num_rounds):
                # padded rounds of short dialogs have no question: an
                # "answer" to them would render garbage in the viewer
                if not (data.ques_len[i, r] > 0 or batch.ques[b, r].any()):
                    continue
                rounds.append({
                    "question": " ".join(vocab.decode(batch.ques[b, r])),
                    "gt_answer": " ".join(vocab.decode(data.ans[i, r])),
                    "generated": " ".join(vocab.decode(toks[b, r])),
                    "log_prob": float(logp[b, r]),
                })
            records.append({
                "image_id": int(data.img_ids[i]),
                "caption": " ".join(vocab.decode(data.cap[i])),
                "rounds": rounds,
            })
        if len(records) >= n:
            break

    if mesh.is_main:
        with open(args.out_path, "w") as f:
            json.dump({"model": f"{cfg.encoder}-{cfg.decoder}",
                       "split": args.split, "dialogs": records}, f, indent=1)
        print(json.dumps({"event": "generated", "dialogs": len(records),
                          "out_path": args.out_path}), flush=True)
    return records


if __name__ == "__main__":
    main()
