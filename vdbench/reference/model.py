"""The MN-QIH encoder and both decoders in plain PyTorch, float32.

Every product goes through `Ops.mm` / `Ops.bmm`: exact float32 products
(the caller turns TF32 off), or with precision "fp8" the lower-precision
control: each operand rounded to float8 e4m3 under a per-tensor scale (its
largest magnitude to 448), in the forward and in the backward.

The model (Das et al. 2017, MN-QIH; train.lua's options):
  * tokens embed through one table whose pad row reads zero;
  * a stacked LSTM over each right-aligned question and each per-round
    fact (caption; question + answer of each earlier round), its state
    carried through pad steps, the top layer's last state kept;
  * the fc7 image, L2-normalised, projected to H and fused with the
    question state: query = tanh(W [q; img] + b);
  * attention over the fact slots 0..t of round t: softmax of the
    unscaled dot products, then joint = tanh(W [query; memory] + b);
  * disc: each candidate through an option LSTM (its last state), score =
    dot(candidate, joint), 100-way NLL of the ground truth;
  * gen: an LSTM language model started at h = joint in every layer,
    teacher-forced over <START> + answer, NLL of answer + <END>.
Dropout (rate from the configuration) falls on the first LSTM layer's
outputs (before the second layer) and on [query; memory]; the caller hands
the keep masks in (dropout.py draws them).
"""

from __future__ import annotations

import torch

NEG = -1e30
E4M3_MAX = 448.0


def _round8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _MM8(torch.autograd.Function):
    """a @ b with both operands, and the gradient's, rounded to e4m3."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _round8(a), _round8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _round8(g)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


class Ops:
    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, a, b):
        return _MM8.apply(a, b) if self.fp8 else a @ b

    bmm = mm


def embed(p: dict, tok: torch.Tensor) -> torch.Tensor:
    return p["embed"]["table"][tok] * (tok != 0)[..., None].float()


def linear(ops: Ops, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return ops.mm(x, lp["w"]) + lp["b"]


def lstm(ops: Ops, layers: list, x: torch.Tensor, mask: torch.Tensor,
         keep: list | None = None, rate: float = 0.0,
         h0: torch.Tensor | None = None, lo: int = 0, hi: int | None = None):
    """The stacked masked LSTM over steps [lo, hi) of x (N, T, E) with
    mask (N, T): the top layer's outputs (N, hi - lo, H) and last state
    (N, H).  Steps outside [lo, hi) must be pad for every row: before lo
    the state stays at its start (right-aligned rows, zero start), after
    hi it is carried.  keep: the first layers' keep masks (N, T, H) of
    dropout at `rate`; h0: every layer's start state (else zeros)."""
    N, T = mask.shape
    hi = T if hi is None else hi
    H = layers[0]["w"].shape[1] // 4
    inp, m_all = x[:, lo:hi], mask[:, lo:hi, None]
    for li, lp in enumerate(layers):
        h = h0 if h0 is not None else x.new_zeros(N, H)
        c = x.new_zeros(N, H)
        outs = []
        for t in range(hi - lo):
            z = linear(ops, lp, torch.cat([inp[:, t], h], dim=-1))
            i, f, g, o = z.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = m_all[:, t]
            h = m * h_new + (1 - m) * h
            c = m * c_new + (1 - m) * c
            outs.append(h)
        inp = torch.stack(outs, dim=1)
        if keep is not None and li < len(layers) - 1:
            inp = torch.where(keep[li][:, lo:hi], inp / (1.0 - rate), 0.0)
    return inp, h


def _one(keep):
    """A two-layer LSTM's keep masks: the one between its layers."""
    return None if keep is None else [keep]


def right_span(tok: torch.Tensor) -> int:
    """First step that holds a real token in any right-aligned row."""
    real = (tok != 0).any(dim=0).nonzero()
    return int(real[0]) if real.numel() else tok.shape[1] - 1


def left_span(tok: torch.Tensor) -> int:
    """One past the last step that holds a real token in any row."""
    real = (tok != 0).any(dim=0).nonzero()
    return int(real[-1]) + 1 if real.numel() else 1


def last_state(ops, layers, p, tok, keep=None, rate=0.0, right=True):
    """The top layer's state after each row's last token (N, H)."""
    x, mask = embed(p, tok), (tok != 0).float()
    if right:
        _, h = lstm(ops, layers, x, mask, keep, rate, lo=right_span(tok))
    else:
        _, h = lstm(ops, layers, x, mask, keep, rate, hi=left_span(tok))
    return h


def encode(ops: Ops, p: dict, b: dict, rate: float = 0.0,
           masks: dict | None = None) -> torch.Tensor:
    """joint (B * R, H) of the MN-QIH encoder; b holds ques (B, R, Lq) and
    facts (B, R, Lf) right-aligned, img (B, F) normalised; masks the keep
    masks "ques", "fact" (N, L, H) and "cat" (N, 2H) at `rate`."""
    enc = p["encoder"]
    B, R, Lq = b["ques"].shape
    N = B * R
    masks = masks or {}
    kq, kf = masks.get("ques"), masks.get("fact")
    q = last_state(ops, enc["ques_lstm"]["layers"], p,
                   b["ques"].reshape(N, Lq), _one(kq), rate)
    facts = last_state(ops, enc["fact_lstm"]["layers"], p,
                       b["facts"].reshape(N, -1), _one(kf), rate)
    facts = facts.reshape(B, R, -1)
    img = linear(ops, enc["img_proj"], b["img"]).repeat_interleave(R, dim=0)
    query = torch.tanh(linear(ops, enc["query_fusion"],
                              torch.cat([q, img], dim=-1)))
    qr = query.reshape(B, R, -1)
    scores = ops.bmm(qr, facts.transpose(1, 2))                 # (B, R, R)
    slot = torch.arange(R, device=qr.device)
    scores = torch.where(slot[None, :] <= slot[:, None], scores, NEG)
    mem = ops.bmm(torch.softmax(scores, dim=-1), facts).reshape(N, -1)
    cat = torch.cat([query, mem], dim=-1)
    if masks.get("cat") is not None:
        cat = torch.where(masks["cat"], cat / (1.0 - rate), 0.0)
    return torch.tanh(linear(ops, enc["fusion"], cat))


def option_states(ops: Ops, p: dict, tok: torch.Tensor, keep=None,
                  rate: float = 0.0) -> torch.Tensor:
    """Candidates' last states (M, H); tok (M, La) left-aligned."""
    return last_state(ops, p["decoder"]["opt_lstm"]["layers"], p, tok,
                      _one(keep), rate, right=False)


def disc_nll(ops: Ops, joint: torch.Tensor, emb: torch.Tensor,
             rows: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-round NLL (N,) of the ground truth among the candidates;
    emb (U, H) candidate states, rows (N, K) into emb, gt (N,)."""
    cand = emb[rows]                                             # (N, K, H)
    scores = ops.bmm(cand, joint[:, :, None])[..., 0]            # (N, K)
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(1, gt[:, None])[:, 0]


def gen_nll(ops: Ops, p: dict, joint: torch.Tensor, ans_in: torch.Tensor,
            ans_out: torch.Tensor, keep=None, rate: float = 0.0):
    """(summed NLL, target count) of the teacher-forced answers; ans_in /
    ans_out (N, La + 1) left-aligned."""
    dec = p["decoder"]
    layers = dec["lm_lstm"]["layers"]
    hi = left_span(ans_in)
    outs, _ = lstm(ops, layers, embed(p, ans_in), (ans_in != 0).float(),
                   _one(keep), rate, h0=joint, hi=hi)
    tgt = ans_out[:, :hi] * (ans_in[:, 1:2] != 0)
    logits = linear(ops, dec["out_proj"], outs.reshape(-1, outs.shape[-1]))
    logp = torch.log_softmax(logits, dim=-1)
    tok = logp.gather(1, tgt.reshape(-1, 1))[:, 0]
    real = (tgt.reshape(-1) != 0).float()
    return -(tok * real).sum(), real.sum()
