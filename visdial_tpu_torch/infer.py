"""Interactive / serving inference on a GPU (port of visdial_tpu/infer.py).

Load a checkpoint once and answer ad-hoc (caption, history, question)
queries.  A disc checkpoint embeds the whole answer pool (the split's
deduplicated option list) into a table once; a query is one encoder forward,
one (1, H) x (H, M) product against the table, top-k.  A gen checkpoint
decodes a free-form answer, greedily or by beam search: as in the JAX
package every round of the one-dialog batch is decoded and the current
round's answer is returned.

Each request is one CUDA graph replay (parallel/graph.py), the counterpart
of the JAX engine's _serve_disc_jit and _serve_gen_jit: serve_disc runs the
encoder, takes the current round by a device index, scores the pool and
takes the top k, packed as [top_i; top_s] in float32; serve_gen decodes and
packs [log_prob, tokens...].  One graph per top_k or beam width; one
readback per request.  The host keeps the tokenizer and the batch assembly,
as the JAX engine does.  pool_scores stays eager: the reference.

CLI: one JSON query per stdin line, one JSON answer per stdout line
({"answers": [...]} for disc, {"answer", "log_prob"} for gen):

    echo '{"caption": "a man on a horse", "question": "is it sunny ?",
           "history": [["is the man old ?", "no"]]}' | \
    python -m visdial_tpu_torch.infer --load_path checkpoints/run/step_N \
        --data_dir data [--top_k 5] [--beam_size 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
from functools import partial

import numpy as np
import torch

from .data.dataset import VisDialSplit, load_split
from .data.loader import BatchAssembler
from .data.synthetic import make_synthetic_split

from .data.prepro import tokenize
from .models.encoders import encoder_apply
from .models.model import (_impl, batch_to_device, model_generate,
                           model_option_table)
from .ops.contract import mm_f32
from .parallel.graph import Graphed
from .utils.checkpoint import load_checkpoint


@torch.inference_mode()
def serve_disc(params, table, cfg, impl: str, batch: dict, t: torch.Tensor,
               k: int) -> torch.Tensor:
    """(2, k) float32 [top_i; top_s]: round t's (a (1,) index tensor) joint
    state against the pool table, its k best (infer.py::serve_disc; indices
    < 2^24 are exact in float32)."""
    joint = encoder_apply(params["encoder"], params["embed"], batch, cfg,
                          impl=impl)
    j = joint.index_select(0, t).to(table.dtype)                 # (1, H)
    top_s, top_i = torch.topk(mm_f32(j, table.T)[0], k)
    return torch.stack([top_i.float(), top_s])


@torch.inference_mode()
def serve_gen(params, cfg, start_token: int, end_token: int, impl: str,
              batch: dict, t: torch.Tensor, beam: int) -> torch.Tensor:
    """(1 + La,) float32 [log_prob, tokens...] of round t's decoded answer
    (infer.py::serve_gen; beam <= 1 decodes greedily)."""
    toks, logp = model_generate(params, batch, cfg, start_token=start_token,
                                end_token=end_token, beam_size=beam, impl=impl)
    return torch.cat([logp[0].index_select(0, t),
                      toks[0].index_select(0, t)[0].float()])


class InferenceEngine:
    """Params + vocabulary (+ the answer-pool table for disc) on one
    device."""

    def __init__(self, load_path: str = "", data_dir: str = "",
                 synthetic: int = 0, *, params=None, cfg=None, data=None,
                 vocab=None, device="cuda"):
        """Build from a checkpoint path (the CLI route) or from in-memory
        components (pass params, cfg, data, vocab and no load_path).  The
        device is explicit: there is no silent move to the CPU."""
        self.device = torch.device(device)
        if load_path:
            params, cfg, _ = load_checkpoint(load_path, self.device)
            if data_dir:
                cfg = cfg.replace(data_dir=data_dir)
            if synthetic:
                data, vocab = make_synthetic_split(
                    cfg, num_dialogs=synthetic, seed=cfg.seed + 1)
            else:
                data, vocab = load_split(cfg.data_dir, "val")
        if any(v is None for v in (params, cfg, data, vocab)):
            raise ValueError("need load_path or explicit (params, cfg, data, vocab)")
        self.cfg = cfg
        # batches are assembled in float32; the encoder casts on the device
        self._asm_cfg = cfg.replace(compute_dtype="float32")
        self.vocab = vocab
        self.params = params
        self.opt_list = data.opt_list
        self.opt_list_len = data.opt_list_len
        self._feat_dim = data.img_feat.shape[1]
        self.impl = _impl(cfg, self.device)
        self.table = None
        if cfg.decoder == "disc":
            with torch.inference_mode():
                self.table = model_option_table(
                    params, torch.from_numpy(data.opt_list.astype(np.int64)).to(
                        self.device), cfg, impl=self.impl)
        # the served functions hold the params, not the engine, so a dropped
        # engine frees its graphs at once
        self.serve_disc = Graphed(partial(serve_disc, params, self.table, cfg,
                                          self.impl))
        self.serve_gen = Graphed(partial(serve_gen, params, cfg, vocab.start,
                                         vocab.end, self.impl))

    # -- raw text -> one-dialog split (visdial_tpu/infer.py::_encode_dialog)
    def _encode_dialog(self, caption: str, history, question: str,
                       img_feat=None) -> tuple[VisDialSplit, int]:
        cfg, v = self.cfg, self.vocab
        R = cfg.num_rounds
        # keep the most recent turns when the dialog exceeds the round budget
        history = list(history or [])
        history = history[max(len(history) - (R - 1), 0):]
        t = len(history)                       # current round index
        ques = np.zeros((1, R, cfg.max_ques_len), np.int32)
        ques_len = np.zeros((1, R), np.int32)
        ans = np.zeros((1, R, cfg.max_ans_len), np.int32)
        ans_len = np.zeros((1, R), np.int32)
        for r, (q, a) in enumerate(history):
            ques[0, r], ques_len[0, r] = v.encode(tokenize(q), cfg.max_ques_len)
            ans[0, r], ans_len[0, r] = v.encode(tokenize(a), cfg.max_ans_len)
        ques[0, t], ques_len[0, t] = v.encode(tokenize(question),
                                              cfg.max_ques_len)
        cap = np.zeros((1, cfg.max_cap_len), np.int32)
        cap[0], cap_n = v.encode(tokenize(caption or ""), cfg.max_cap_len)
        F = self._feat_dim
        feat = (np.asarray(img_feat, np.float32).reshape(1, F)
                if img_feat is not None else np.zeros((1, F), np.float32))
        split = VisDialSplit(
            ques=ques, ques_len=ques_len, ans=ans, ans_len=ans_len,
            cap=cap, cap_len=np.array([cap_n], np.int32),
            opt_list=self.opt_list, opt_list_len=self.opt_list_len,
            opt_inds=np.zeros((1, R, cfg.num_options), np.int32),
            gt_ind=np.zeros((1, R), np.int32),
            img_feat=feat, img_ids=np.zeros(1, np.int64),
        )
        return split, t

    def _batch(self, caption, history, question, img_feat):
        split, t = self._encode_dialog(caption, history, question, img_feat)
        asm = BatchAssembler(split, self.vocab, self._asm_cfg)
        batch = asm.assemble(np.array([0]), with_options=False).as_dict()
        return batch_to_device(batch, self.device), t

    def _round(self, t: int) -> torch.Tensor:
        return torch.tensor([t], dtype=torch.long, device=self.device)

    # -- public API -------------------------------------------------------
    @torch.inference_mode()
    def pool_scores(self, question: str, caption: str = "", history=None,
                    img_feat=None) -> torch.Tensor:
        """(M,) float32 scores of every answer in the pool, on the device
        (disc decoder)."""
        if self.table is None:
            raise ValueError("pool scores need a disc checkpoint")
        batch, t = self._batch(caption, history, question, img_feat)
        joint = encoder_apply(self.params["encoder"], self.params["embed"],
                              batch, self.cfg, impl=self.impl)
        j = joint[t:t + 1].to(self.table.dtype)                  # (1, H)
        return mm_f32(j, self.table.T)[0]

    def rank_answers(self, question: str, caption: str = "", history=None,
                     img_feat=None, top_k: int = 5) -> list[dict]:
        """Top-k answers of the whole pool with their scores (one call of
        serve_disc, one readback)."""
        if self.table is None:
            raise ValueError("ranking needs a disc checkpoint")
        batch, t = self._batch(caption, history, question, img_feat)
        k = min(int(top_k), self.table.shape[0])
        top_i, top_s = self.serve_disc(batch, self._round(t), k).cpu()
        return [{"answer": " ".join(self.vocab.decode(self.opt_list[i])),
                 "score": s}
                for i, s in zip(top_i.long().tolist(), top_s.tolist())]

    def generate_answer(self, question: str, caption: str = "", history=None,
                        img_feat=None, beam_size: int = 0) -> dict:
        """Free-form decoded answer (gen decoder), greedy or by beam search
        at beam_size > 1: {"answer", "log_prob"} (the summed log-prob of
        the emitted tokens; one call of serve_gen, one readback)."""
        if self.cfg.decoder != "gen":
            raise ValueError("generation needs a gen checkpoint")
        batch, t = self._batch(caption, history, question, img_feat)
        packed = self.serve_gen(batch, self._round(t), int(beam_size)).cpu()
        return {"answer": " ".join(self.vocab.decode(packed[1:].long().numpy())),
                "log_prob": float(packed[0])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--load_path", required=True)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--beam_size", type=int, default=0,
                   help="gen checkpoints: beam width (<= 1 decodes greedily)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    engine = InferenceEngine(args.load_path, data_dir=args.data_dir,
                             synthetic=args.synthetic, device=args.device)
    print(json.dumps({"event": "ready",
                      "model": f"{engine.cfg.encoder}-{engine.cfg.decoder}"}),
          flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:  # one bad request -> one error line, never a dead server
            q = json.loads(line)
            if engine.cfg.decoder == "disc":
                out = {"answers": engine.rank_answers(
                    q["question"], q.get("caption", ""), q.get("history"),
                    q.get("img_feat"), top_k=args.top_k)}
            else:
                out = engine.generate_answer(
                    q["question"], q.get("caption", ""), q.get("history"),
                    q.get("img_feat"), beam_size=args.beam_size)
        except Exception as e:
            out = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
