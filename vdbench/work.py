"""Operations and bytes of the work a cell feeds, counted from the shapes and
real lengths of the batches the benchmark made, never from the program.

Only products are counted (2 operations a multiply-add), as a FLOP counter
counts them; an LSTM step counts only where its row holds a real token
(the kernels skip all-pad tiles).  A kernel's bytes count each input read
once and each output written once.  A roofline share is the larger of the
operation bound and the byte bound over the measured kernel time.

The model step (MN-QIH, either decoder), per layer of a stacked LSTM with
input width `in` and hidden H, over `real` real row-steps:
  forward 2 real (in + H) 4H; its backward twice that (the input's and the
  weights' gradients);
  img_proj 2 B F H forward and 2 B F H backward (the weights' only: the
  image is data); query_fusion and fusion 2 N 2H H each; attention
  2 N R H for its scores and 2 N R H for the weighted sum; disc scores
  2 N K H; gen LM head 2 T H V over the T real targets; each backward
  twice its forward.
Kernels: K1 (lstm_fwd_step_kernel) the LSTM forward above; K2
(lstm_bwd_gates_kernel, lstm_bwd_dh_kernel) real (2 (in + H) 4H + 2 4H H)
a layer: the gates recomputed and dh through W_h; K5 (lm_score_partial_
kernel, lm_score_combine_kernel) and K6 (lm_dlogits_kernel) 2 T H V each.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# NVIDIA H100 SXM, dense (the data sheet): bf16 operations/s, HBM bytes/s
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2            # bytes an element in the compute dtype

K1 = ("lstm_fwd_step_kernel",)
K2 = ("lstm_bwd_gates_kernel", "lstm_bwd_dh_kernel")
K5K6 = ("lm_score_partial_kernel", "lm_score_combine_kernel",
        "lm_dlogits_kernel")


@dataclass
class Work:
    """Operations and bytes by kernel group, and the model's operations."""
    k1: list = field(default_factory=lambda: [0.0, 0.0])     # [ops, bytes]
    k2: list = field(default_factory=lambda: [0.0, 0.0])
    k5k6: list = field(default_factory=lambda: [0.0, 0.0])
    model: float = 0.0
    steps: int = 0

    def add(self, other: "Work") -> "Work":
        for k in ("k1", "k2", "k5k6"):
            getattr(self, k)[0] += getattr(other, k)[0]
            getattr(self, k)[1] += getattr(other, k)[1]
        self.model += other.model
        self.steps += other.steps
        return self


def lstm_layers(config: dict, in_dim: int) -> list[int]:
    H = config["rnn_hidden_size"]
    return [in_dim] + [H] * (config["num_layers"] - 1)


def lstm_fwd(config: dict, real: float, in_dim: int) -> tuple[float, float]:
    """(operations, bytes) of K1 over `real` row-steps of a stacked LSTM."""
    H = config["rnn_hidden_size"]
    ops = nbytes = 0.0
    for i in lstm_layers(config, in_dim):
        ops += 2.0 * real * (i + H) * 4 * H
        nbytes += BF16 * ((i + H) * 4 * H + real * (i + H))
    return ops, nbytes


def lstm_bwd(config: dict, real: float, in_dim: int) -> tuple[float, float]:
    """(operations, bytes) of K2: reads x, h_prev, c_prev and the output
    gradient a step, writes the gate gradients (4H)."""
    H = config["rnn_hidden_size"]
    ops = nbytes = 0.0
    for i in lstm_layers(config, in_dim):
        ops += real * (2.0 * (i + H) * 4 * H + 2.0 * 4 * H * H)
        nbytes += BF16 * ((i + H) * 4 * H + real * (i + 3 * H + 4 * H))
    return ops, nbytes


def lm_head(config: dict, targets: float) -> tuple[float, float]:
    """(operations, bytes) of K5 and K6 together over `targets` real
    target tokens: each reads W and the rows; K6 writes the logits'
    gradient."""
    H, V = config["rnn_hidden_size"], config["vocab_size"]
    ops = 2 * (2.0 * targets * H * V)
    nbytes = 2 * BF16 * (H * V + targets * H) + BF16 * targets * V + 8 * targets
    return ops, nbytes


def fact_lengths(split: dict, idx: np.ndarray, config: dict) -> np.ndarray:
    width = max(config["max_cap_len"],
                config["max_ques_len"] + config["max_ans_len"])
    R = config["num_rounds"]
    out = np.empty((len(idx), R), np.int64)
    out[:, 0] = np.minimum(split["cap_len"][idx], width)
    out[:, 1:] = np.minimum(split["ques_len"][idx][:, :R - 1]
                            + split["ans_len"][idx][:, :R - 1], width)
    return out


def _encoder(config: dict, split: dict, idx: np.ndarray, train: bool) -> Work:
    E, H, F, R = (config["embed_size"], config["rnn_hidden_size"],
                  config["img_feat_size"], config["num_rounds"])
    B, N = len(idx), len(idx) * R
    w = Work()
    grad = 3.0 if train else 1.0
    for real in (float(split["ques_len"][idx].sum()),
                 float(fact_lengths(split, idx, config).sum())):
        f_ops, f_bytes = lstm_fwd(config, real, E)
        w.k1[0] += f_ops
        w.k1[1] += f_bytes
        if train:
            b_ops, b_bytes = lstm_bwd(config, real, E)
            w.k2[0] += b_ops
            w.k2[1] += b_bytes
        w.model += grad * f_ops
    dense = 2.0 * N * 2 * H * H * 2 + 4.0 * N * R * H      # fusions, attention
    w.model += grad * dense + (2.0 if train else 1.0) * 2.0 * B * F * H
    return w


def train_step(config: dict, split: dict, idx: np.ndarray) -> Work:
    """One optimizer step over dialogs idx (a rank's shard on a data axis).
    The disc candidate rows are those the configuration runs through the
    option LSTM: the shard's unique rows, or with disc_dedup_options false
    every candidate of every round."""
    E, H, K, R = (config["embed_size"], config["rnn_hidden_size"],
                  config["num_options"], config["num_rounds"])
    N = len(idx) * R
    w = _encoder(config, split, idx, train=True)
    if config["decoder"] == "disc":
        rows = split["opt_inds"][idx].reshape(-1)
        if config.get("disc_dedup_options", True):
            rows = np.unique(rows)
        real = float(split["opt_list_len"][rows].sum())
        w.model += 3.0 * 2.0 * N * K * H
    else:
        real = float((split["ans_len"][idx] + 1).sum())     # <START> + answer
        o, b = lm_head(config, real)                        # answer + <END>
        w.k5k6[0] += o
        w.k5k6[1] += b
        w.model += 3.0 * 2.0 * real * H * config["vocab_size"]
    f_ops, f_bytes = lstm_fwd(config, real, E)
    b_ops, b_bytes = lstm_bwd(config, real, E)
    w.k1[0] += f_ops
    w.k1[1] += f_bytes
    w.k2[0] += b_ops
    w.k2[1] += b_bytes
    w.model += 3.0 * f_ops
    w.steps = 1
    return w


def eval_pass(config: dict, split: dict) -> Work:
    """One pass of the disc retrieval eval over the split: the option table
    over the pool, then every dialog's encoder and its rounds' scores."""
    E, H, K, R = (config["embed_size"], config["rnn_hidden_size"],
                  config["num_options"], config["num_rounds"])
    n = len(split["gt_ind"])
    w = _encoder(config, split, np.arange(n), train=False)
    f_ops, f_bytes = lstm_fwd(config, float(split["opt_list_len"].sum()), E)
    w.k1[0] += f_ops
    w.k1[1] += f_bytes
    w.model += f_ops + 2.0 * n * R * K * H
    return w


def roofline_pct(ops_bytes, seconds: float | None) -> float | None:
    """The bound's time over the kernels' measured time, in %; None where
    the kernels did not run or no work was counted."""
    ops, nbytes = ops_bytes
    if not seconds or ops <= 0:
        return None
    return 100.0 * max(ops / PEAK_BF16, nbytes / PEAK_BYTES) / seconds
