#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (visdial_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and holds each against its plain
PyTorch version on the card at the shapes the serving, training and
evaluation paths give it: K1 (LSTM forward, with and without cell states;
also over LF's 256-step history and HRE's dialog LSTM), K2 (LSTM backward,
through LSTMLayerFn; also with LF's gradient only at the history bounds),
K3 (slot attention, through AttentionFn; also over 49 pool5 locations), K4
(attention + fusion), K5 (LM-head log-probs and row logsumexp) and K6
(LM-head d-logits, and TokenLogprobFn's gradients); K1 and K2 are timed
beside cuDNN's LSTM (torch.nn.LSTM, the library yardstick only).  Then it
drives the
main paths at full width (random weights from a seed): flagship MN-QIH-disc
served over a 50,000-answer pool through InferenceEngine and the JSON-lines
CLI, trained through train_step (kernel path against the plain path at
dropout 0 and 0.5, then 20 steps), MN-QIH-gen trained the same way,
evaluated through evaluate_split over 100 candidates a round and served
(greedy and beam 5); LF-QIH-disc trained, evaluated and served the same
way; each other encoder family (LF's ablations and its per-round history,
HRE, HREA, MN with the pool5 map) through one train step and one eval
batch; MN-QIH-disc and -gen evaluated resident, staged and plain over 256
dialogs; the train CLI for both decoders with a resume; the evaluate CLI on
the train CLI's checkpoint with the v1.0 rankings dump; dense fine-tuning of
that checkpoint (kernel step against plain, 20 steps, the finetune CLI);
the generate CLI on the gen checkpoint (greedy, beam 5, a test-style
split); the sweep CLI over MN-QIH x {disc, gen}; the mesh step
(parallel/mesh.py) in a world-1 NCCL group, MN-QIH-disc and -gen bit for
bit equal to train_step, then the train CLI under that group (and, with
two cards, two NCCL ranks against one device); K5 and K6 on 2 and 4 vocab
shards combined as the model axis combines them; the verify gate at
flagship shapes; VGG-16 (card against CPU, images/s in f32 and bf16, the
prepro_img CLI); and the real-data recipe on generated VisDial JSON
(prepro, prepro_img on the card, prepro again, then the parity runbook
training and re-evaluating LF-QIH-disc and MN-QIH-gen).  Beside them bf16, the
JAX package's production precision: the contraction helper
(ops/contract.py, bf16 operands, f32 results on the tensor cores) against
float64 at the training step's head shapes beside the upcast route it
replaced; MN-QIH-disc (batch 32) and MN-QIH-gen (batch 64) trained at bf16
(kernel step against the plain step at dropout 0 and 0.5, 20 timed steps,
the loss trajectory against the f32 step's); the resident eval of both at
bf16 (scores, MRR and rank flips against the plain path); MN-QIH-disc
served at bf16 (at the evals' scaled params, every top-1 the plain
path's); and the port's two learning bars (LF-QIH-disc MRR > 0.8,
MN-QH-gen > 0.6) trained on the card in f32 and in bf16.  On a machine with
two cards also the generate CLI on two NCCL ranks at --mesh_model 2
against one card, and every kernel launched on the second card in this
process.  Then the compiled dispatch (parallel/graph.py): the train steps
as CUDA graphs (make_multistep_train_fn) against the eager multi_train_step
at the bench's points, bit for bit, serving through the engine's graphs
against their eager bodies, the eval factories, evaluate_split streaming
and resident, generate's decode and VGG-16's forward graphed against
their eager functions, with both paths' rates, latencies and memory; and
the same dispatch over a mesh in a world-1 NCCL group (the collectives
captured in the graphs): the train factories at those points in bf16 and
f32 with remat off and on, the dense factory, a disc batch without
round_valid, remat's memory at LF's 256-step history, the evals, the
generate CLI and the train CLI with --remat true, each against the eager
mesh path bit for bit (with two cards (2, 1) and (1, 2) NCCL ranks, with
four (2, 2)).  Last the bench (visdial_tpu_torch.bench.bench_port at its default
flagship configuration, the Torch-CPU baseline left out): its
line's keys the JAX bench's plus the port's, every rate finite and
positive, both MFUs in (0, 1] and every kernel launched by its rows.  Each
path must have gone through its kernels and agree with a run of the plain
versions on the same card.

Each phase prints one JSON line.  Then come the raw nvidia-smi line (card
name, power limit), the kernel summary line (each kernel's launches on its
main path, error, time, plain time, bound and library time), and, last, the
result line {"ok": true, "device": {...}}.  Any failed check raises, and the
exit code is non-zero.  Without a CUDA device the script exits non-zero at
once.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# f32: both sides sum K <= 1,024 products of f32 operands in another order
# at every step; bf16: outputs are rounded to bf16 (one ulp is 2^-8 at |h| <
# 1), and an order-dependent flip of h's rounding feeds the next step.  The
# same limits hold over LF's 256 history steps as over 40: a difference
# that enters the carries at step t is multiplied at each later step by the
# step's Jacobian, f * (cell) plus o * tanh' * (the gates' W_h terms),
# whose norm is below 1 at these weights (uniform +-0.08 over H = 512,
# sigmoid' <= 1/4), so it decays geometrically instead of adding up over T;
# the rows of LSTM_SHAPES at T = 256 check it.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Gradients, relative to the largest reference value: f32 as above; bf16
# also rounds dgp (and both sides' residuals) to bf16 at every step, and
# that rounding feeds dh through T steps and dW through N*T-row sums.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SCORE_TOL = 1e-3   # served scores: 512-term dot products of f32 LSTM states
GEN_SHAPES = [(640, 16, 300, 512), (640, 40, 300, 512), (640, 9, 300, 512),
              (640, 9, 512, 512)]
LSTM_SHAPES = [(8192, 8, 300, 512), (8192, 8, 512, 512),
               (10, 40, 300, 512), (10, 16, 300, 512),
               (320, 40, 300, 512), (320, 16, 300, 512),
               (32000, 8, 300, 512), (32000, 8, 512, 512),
               # LF's history (a training batch, a served request, and the
               # per-round hist_concat path), HRE/HREA's dialog LSTM
               (32, 256, 300, 512), (1, 256, 300, 512), (320, 256, 300, 512),
               (32, 10, 512, 512), (1, 10, 512, 512),
               # gen's question, fact and LM LSTMs at batch 64, and the disc
               # eval table's last 1,696-row chunk: other tiles and K-splits
               # (ops/lstm_cuda.py::lstm_tile, dh_splits)
               *GEN_SHAPES, (1696, 8, 300, 512)]             # N, T, E, H
# how a shape's rows are aligned (lstm_case): LF's incremental history is
# left-aligned with ragged ends, hist_concat right-aligned, the dialog LSTM
# unmasked; the rest mix right- and left-aligned rows
ALIGN = {(32, 256, 300, 512): "left", (1, 256, 300, 512): "left",
         (320, 256, 300, 512): "right", (32, 10, 512, 512): "ones",
         (1, 10, 512, 512): "ones"}
# LF's history layer, where K1 and K2 are reported beside the head shape
HIST_HEAD = (32, 256, 300, 512)
# HRE/HREA's dialog LSTM, every step real: cuDNN takes it with no packing
DIALOG_HEAD = (32, 10, 512, 512)
# the head shape of K1 and K2, where the single-pass TF32 control runs
LSTM_HEAD = (32000, 8, 300, 512)
# the training path: the option LSTM's 32,000 candidate rows (both layers),
# the question and fact LSTMs' 320 rows (first layers), LF's history (left-
# aligned, and per round right-aligned), the dialog LSTM, gen's LSTMs and
# the 1,696-row tile
BWD_SHAPES = [(32000, 8, 300, 512), (32000, 8, 512, 512),
              (320, 40, 300, 512), (320, 16, 300, 512),
              (32, 256, 300, 512), (320, 256, 300, 512), (32, 10, 512, 512),
              *GEN_SHAPES, (1696, 8, 300, 512)]
# K2 as LF's top history layer sees it: g_hs nonzero only at the 10 rounds'
# prefix bounds of each row, g_hT = g_cT = 0
SPARSE_BWD = (32, 256, 300, 512)
# K4 (B, R, S, H): a served request, an eval batch, ragged rows with
# all-masked rows (the two sides of its route threshold are added)
ATTN_SHAPES = [(1, 10, 10, 512), (32, 10, 10, 512), (7, 10, 10, 512)]
# K3: the training batch, one dialog, a batch with all-masked rows, and
# img_spatial's 49 slots and the limit of 64
ATTN3_SHAPES = [(32, 10, 10, 512), (1, 10, 10, 512), (4, 10, 10, 512),
                (32, 10, 49, 512), (1, 10, 49, 512), (32, 10, 64, 512)]
# the masks of those shapes: the encoder's causal mask as it hands it over,
# an expanded view (batch stride 0), but at these dialog counts a copy with
# all-masked rows; at img_spatial's 49 pool5 locations the image pathway's
# all-ones mask, also an expanded view
ATTN_MASKED = {"attention": 4, "attention_fusion": 7}
SPATIAL_SLOTS = 49
# train: loss is a mean of 320 f32 NLLs; grad_norm and the gradients are
# sums in another order (K2 and the f32 contractions vs autograd + cuBLAS)
LOSS_TOL, GNORM_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-4
TRAIN_STEPS = 20
# bf16, the JAX package's production precision (bench.py:72-89: batch 32
# disc, :578: batch 64 gen): the kernel path against the plain path, both
# in bf16.  Every activation is rounded to bf16 (2^-8 relative) where the
# two paths round sums taken in another order, so a rounding that lands
# apart flips by one ulp and feeds the steps after it; the loss is a mean
# of 320-640 NLLs, the norm a sum over every gradient, each leaf held to
# GRAD_TOL's bf16 share of its largest value (measured on the H100: loss
# within 2e-6, norm 1e-4 to 2e-4 relative, leaves 5e-3 to 6e-3)
TRAIN_TOL = {"float32": (LOSS_TOL, GNORM_RTOL, TRAIN_GRAD_TOL),
             "bfloat16": (1e-4, 2e-3, GRAD_TOL["bfloat16"])}
BF16_GEN_BATCH = 64
# the bf16 kernel step's 20-step loss trajectory at dropout 0 against the f32
# kernel step's from the same init and batches, every step within this share
# of the first step's f32 loss (ln 100 at init): bf16 rounds the scores and
# every gradient, and the two runs drift apart by rounding only, a drift
# that grows as the 64 dialogs are memorised (measured: 0.021 at step 20,
# 0.46% of the first loss, as the loss falls to 0.42); a wrong gradient
# moves a loss by far more
TRAJ_RTOL = 1e-2
# bf16 evals and serving (kernel path against the plain path, both bf16),
# absolute: disc scores are 512-term dot products of bf16 LSTM states (at
# EVAL_SCALE) that may differ by one bf16 ulp each, gen scores sums of <= 8
# f32 token log-probs over bf16 hidden states (measured on the H100: disc
# 0.0101, gen 0.00079); MRR may move only through rank flips at near ties
# (measured 1e-5 to 3e-5)
SCORE_TOL_BF16 = {"disc": 2.5e-2, "gen": 2e-3}
# bf16 serving of MN-QIH-disc over the 50k-answer pool, at EVAL_SCALE as
# the disc evals (at the init scale the pool's scores lie within ~1e-4 and
# any rank would be a near tie): its own limit, ~2x its reading as the
# eval's is (measured on the H100: 0.0130; the top-1 gap 0.004 or more)
SERVE_TOL_BF16 = 3e-2
MRR_TOL_BF16 = 1e-3
# the contraction helper (ops/contract.py) at the head shapes against a
# float64 product of the same bf16 operands, relative to the largest |value|:
# f32 sums of exact bf16 products (the tensor cores' f32 accumulation
# truncates, measured ~7e-5 over 256,000 rows); a GEMM whose output were
# rounded to bf16 (the planted control) is ~2^-9 off and must fail it
CONTRACT_ROWS, CONTRACT_TOL = 256_000, 5e-4
# the learning bars of tests/test_torch_lf_integration.py and tests/
# test_torch_gen.py::test_gen_decoder_learns_to_rank_above_chance on the
# card, through the kernels: (label, Config fields over tests/conftest.py::
# small_config's, steps, MRR bar)
SMALL_CONFIG = dict(vocab_size=0, embed_size=16, rnn_hidden_size=24,
                    num_layers=2, img_feat_size=32, img_embed_size=16,
                    max_ques_len=6, max_ans_len=4, max_cap_len=8,
                    num_rounds=4, num_options=12, batch_size=4, dropout=0.0)
INTEGRATION = [
    ("lf_disc", dict(encoder="lf-ques-im-hist", decoder="disc",
                     rnn_hidden_size=32, embed_size=24, learning_rate=5e-3,
                     lr_decay_rate=1.0), 300, 0.8),
    ("mn_gen", dict(encoder="mn-ques-hist", decoder="gen", learning_rate=5e-3,
                    lr_decay_rate=1.0), 400, 0.6)]
# the evals' rate: runs of each path over 8 full 32-dialog batches
EVAL_DIALOGS, EVAL_REPS = 256, 3
# dense fine-tuning: the train CLI's MN-QIH-disc checkpoint on 64 annotated
# dialogs, steps at the JAX finetune test's learning rate
FT_DIALOGS, FT_STEPS, FT_LR = 64, 20, 0.02
# generate: the dialogs of --synthetic the CLI decodes (two batches)
GEN_DIALOGS = 64
# ddp: mesh steps a decoder, held bit for bit to train_step's
DDP_STEPS = 5
# vocab_shards: d-logits and dx of the combined shards against the whole
# vocab's, relative to the largest |value| (the shards' logsumexp differs
# from the whole vocab's by f32 rounding only)
SHARD_RTOL = 1e-5
# vgg16: the prepro_img CLI's images (a full batch of 64 and a padded one),
# and fc7 / pool5 on the card (cuDNN, TF32 off) against the CPU, relative
# to the largest |value| (f32 sums in another order over 15 layers)
VGG_IMAGES, VGG_RTOL = 96, 1e-4
# pipeline: the generated VisDial JSON's dialogs a split and its word pool
# (every word appears well over prepro's min count of 5 in train, so the
# vocab is the pool, "?" and four specials: 604, which a model axis of 2
# divides), and the runbook's steps a model at batch 32 (one epoch)
PIPE_DIALOGS = {"train": 256, "val": 64, "test": 32}
PIPE_WORDS, PIPE_STEPS = 599, 8
PIPE_CONFIG = {"batch_size": 32}
# where the CLI phases write their checkpoints and outputs (git-ignored)
SMOKE_DIR = os.path.join(ROOT, "build", "visdial_tpu_torch")
# the other encoder families (label, encoder, flagship_setup options), each
# through one train step and one eval batch
FAMILIES = [("lf-ques", "lf-ques", {}), ("lf-ques-hist", "lf-ques-hist", {}),
            ("lf-ques-im", "lf-ques-im", {}),
            ("hre-ques-hist", "hre-ques-hist", {}),
            ("hre-ques-im-hist", "hre-ques-im-hist", {}),
            ("hrea-ques-im-hist", "hrea-ques-im-hist", {}),
            ("lf-ques-im-hist-concat", "lf-ques-im-hist",
             {"lf_hist_incremental": False}),
            ("mn-ques-im-hist-spatial", "mn-ques-im-hist", {"img_spatial": True})]
FAMILY_EVAL_DIALOGS = 32
# disc evals run on the init weights with every parameter outside the LSTMs
# (embeddings, projections, fusions) times this: at the init (uniform +-0.08)
# a round's 100 disc scores lie within ~1e-4 of each other, so any rank
# comparison would be one of near ties; x4 spreads them (std ~0.5 for
# LF-QIH-disc).  The LSTMs keep their init scale: with W x4 LF's 256-step
# history is chaotic (in f32, a relative change of 1e-6 in its input moves h
# by ~2 after 200 steps), so two summation orders would disagree by units
# however right the kernel is
EVAL_SCALE = 4.0
# K5 / K6 (NT, H, V): gen training's 320 x 9 tokens, one 8,192-row scoring
# chunk of gen eval (x 9 steps), ragged rows with the flagship vocab's
# ragged tail, and one row over a vocab narrower than a tile
LM_SHAPES = [(2880, 512, 8804), (73728, 512, 8804), (513, 512, 8848),
             (1, 512, 10)]
# the head shape of K5 and K6, where the single-pass TF32 control runs
LM_HEAD = LM_SHAPES[0]
# K5, relative to the largest |logp|, in either dtype: bf16 products are exact
# in f32 on both sides, f32 products f32-accurate (3xTF32 in the kernel), all
# accumulated in f32, so only the order of the 512-term sums and of the
# vocab's logsumexp differs
LM_TOL = 1e-5
# K6, per element: f32 within 1e-5 of |ref|; bf16 within one bf16 ulp of ref
# (both sides round the same f32 value, up to a sum-order difference, to
# bf16); plus DLOG_FLOOR x |g_i| / V for entries whose p underflows
DLOG_RTOL, DLOG_FLOOR = 1e-5, {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# the planted control: logits whose running sum over H is rounded to bf16
# after every 16 products (one bf16 wgmma k-step), as a kernel that kept
# its accumulator in bf16 would give; the limits above must refuse it
CONTROL_DEPTH = 16
# the least time of a call: operations at the card's peak for the operand
# type or bytes at its memory rate, whichever is larger (H100 SXM data
# sheet, at 700 W).  bfloat16: the tensor cores' 989 TFLOP/s.  float32: an
# f32-accurate product on the tensor cores takes three TF32 products a term
# (3xTF32, as K1 and K2 compute it), so 495 / 3 = 165 TFLOP/s, above the
# CUDA cores' 67; a kernel that beat this bound would not be f32-accurate.
PEAK_OPS = {"float32": 165e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
SIZE = {"float32": 4, "bfloat16": 2}
# the bench phase: the keys of the JAX bench's line (BENCH_r05.json's
# record), its realistic block's, and the keys the port's line adds
BENCH_STEPS = 8
BENCH_JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline_torch_cpu", "backend",
    "n_chips", "kernel_check", "lengths", "model", "compute_dtype",
    "batch_size", "train_rounds_per_sec", "train_rounds_per_sec_per_chip",
    "loss_fingerprint", "train_achieved_tflops_per_sec_per_chip", "train_mfu",
    "eval_100cand_per_sec", "eval_100cand_per_sec_per_chip",
    "disc_table_eval_per_sec_per_chip", "disc_table_build_seconds",
    "disc_eval_e2e_per_sec_per_chip", "disc_eval_resident_per_sec_per_chip",
    "disc_eval_resident_cache_seconds", "gen_eval_e2e_per_sec_per_chip",
    "gen_eval_resident_per_sec_per_chip", "gen_eval_resident_cache_seconds",
    "serving_disc_p50_ms", "serving_disc_p95_ms", "serving_gen_p50_ms",
    "serving_gen_p95_ms", "gen_batch_size", "gen_train_rounds_per_sec_per_chip",
    "gen_loss_fingerprint", "gen_train_mfu", "gen_eval_100cand_per_sec",
    "gen_eval_100cand_per_sec_per_chip",
    "disc_train_plain_rounds_per_sec_per_chip",
    "disc_train_dedup_rounds_per_sec_per_chip",
    "disc_train_dedup_zipf_rounds_per_sec_per_chip", "realistic"}
BENCH_REALISTIC_KEYS = {
    "train_rounds_per_sec_per_chip", "eval_100cand_per_sec",
    "eval_100cand_per_sec_per_chip", "gen_train_rounds_per_sec_per_chip",
    "gen_eval_100cand_per_sec", "gen_eval_100cand_per_sec_per_chip"}
BENCH_PORT_KEYS = {"device_name", "power_limit_w", "allow_tf32",
                   "train_flops_per_step", "gen_train_flops_per_step",
                   "kernel_launches"}
# what bench.main adds around bench_port's rows (the baseline left out here)
BENCH_MAIN_KEYS = {"metric", "value", "unit", "vs_baseline",
                   "baseline_torch_cpu"}
# the counted plain f32 step at the flagship widths: linear in the batch,
# counted on a CPU at batch 1, 2 and 3 (a dialog's operations; shapes only)
BENCH_FLOPS = {"train_flops_per_step": 32 * 193_195_163_648,
               "gen_train_flops_per_step": 64 * 17_182_711_808}
# graphs: timed dispatches a window (two windows a path, in turns) and
# rounds of REQUESTS a serving path
GRAPH_DISPATCHES = 2
GRAPH_SERVE_ROUNDS = 4
# the eval, generate and VGG-16 points of `graphs`: calls a turn, score
# batches a table eval, the sampling seed, and the bound on a graphed
# path's peak device memory (what its graphs keep included) over eager's
GRAPH_EVAL_REPS, GRAPH_TABLE_BATCHES, GRAPH_VGG_REPS = 4, 8, 2
GRAPH_SAMPLE_SEED = 5
GRAPH_PEAK_RATIO = 1.3
# mesh_graphs: steps a dispatch and timed dispatches a turn of its train
# points, make_train_fn's calls a check, and the multi-card evals' dialogs
# and answers
MESH_GROUP, MESH_DISPATCHES, MESH_CALLS = 4, 1, 3
MESH_EVAL_DIALOGS, MESH_EVAL_ANSWERS = 128, 20_000
REQUESTS = [
    ("is it sunny ?", "a park photo", []),
    ("what color is it ?", "w101 w202 w303", [("is there a dog ?", "yes")]),
    ("w017 w018 ?", "w005 w006 w007", [("w001 ?", "w002"), ("w003", "w004")]),
    ("how many people are there ?", "a street",
     [("is it day ?", "yes"), ("is it busy ?", "no"), ("any cars ?", "2")]),
    ("w400 w401 w402 ?", "", [("w403", "w404 w405")] * 4),
    ("can you see the sky ?", "a man on a horse",
     [("is the man old ?", "no"), ("is he wearing a hat ?", "yes , a red one")]),
    ("w600 ?", "w601 w602", [("w603 ?", "w604")] * 9),
    ("what is he holding ?", "w010 w020 w030 w040", [("w050 ?", "w060")] * 12),
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def launch_ms(fn, n: int = 200) -> float:
    """n calls of fn back to back between one pair of CUDA events, over n:
    the rate the card can be fed at (for a kernel of a few microseconds,
    the host's time a call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lstm_case(gen, N, T, E, H, align: str = "mixed"):
    """w, b, x, mask, h0, c0 on the CPU.  align "mixed": right- and
    left-aligned rows, an eighth of them all-pad; "left" / "right": every
    row so, of ragged lengths from 1 to T; "ones": every step real."""
    w = torch.empty(E + H, 4 * H).uniform_(-0.08, 0.08, generator=gen)
    b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=gen)
    x = torch.randn(N, T, E, generator=gen) * 0.5
    lens = torch.randint(0, T + 1, (N,), generator=gen)
    if align == "mixed":
        lens[: max(N // 8, 1)] = 0                 # all-pad rows
    else:
        lens = lens.clamp(min=1) if align != "ones" else torch.full((N,), T)
    steps = torch.arange(T)
    right = steps[None] >= (T - lens)[:, None]     # right-aligned rows
    left = steps[None] < lens[:, None]             # left-aligned rows
    mask = {"mixed": torch.where((torch.arange(N) % 2 == 0)[:, None], right,
                                 left),
            "left": left, "right": right, "ones": left}[align]
    h0 = torch.randn(N, H, generator=gen) * 0.5
    c0 = torch.randn(N, H, generator=gen) * 0.5
    return w, b, x, mask.float(), h0, c0


def abs_err(got, want) -> float:
    """max |got - want| over a sequence of tensor pairs."""
    return max(float((g.float() - r.float()).abs().max())
               for g, r in zip(got, want))


def rel_err(got, want) -> float:
    """max |got - want| / max |want| over a sequence of tensor pairs."""
    return max(float((g.float() - r.float()).abs().max())
               / max(float(r.float().abs().max()), 1e-30)
               for g, r in zip(got, want))


def bound(ops: float, nbytes: float, dtype: str) -> dict:
    """bound_ms and what bounds it, for `ops` operations on `dtype`
    operands that must move `nbytes` bytes (each input read once, each
    output written once)."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lstm_bound(mask, N, T, E, H, dtype, save_cell=False, backward=False):
    """K1 (K2 with backward): the gate products of the real steps only (the
    kernels skip a row tile's all-pad steps; a pad step carries its state),
    plus K2's dh product; the bytes of x, mask, W, b, the states and the
    outputs."""
    real = float(mask.sum())
    G, sz = 4 * H, SIZE[dtype]
    if backward:
        ops = real * (2 * (E + H) * G + 2 * G * H)
        nbytes = sz * (N * T * (E + 3 * H) + N * T * G) + 4 * (
            (E + H) * G + G + N * T + 4 * N * H)
    else:
        ops = real * 2 * (E + H) * G
        nbytes = sz * N * T * (E + H * (2 if save_cell else 1)) + 4 * (
            (E + H) * G + G + N * T + 4 * N * H)
    return bound(ops, nbytes, dtype)


def attention_bound(B, R, S, H, dtype, fusion=False):
    """K3 (K4 with fusion): scores and the weighted sum over S slots, plus
    K4's (2H, H) fusion product; the bytes of q, slots, valid, out (and
    K4's Wf and bias)."""
    sz = SIZE[dtype]
    ops = 4 * B * R * S * H + (4 * B * R * H * H if fusion else 0)
    nbytes = sz * (2 * B * R * H + B * S * H) + 4 * B * R * S + (
        4 * (2 * H * H + H) if fusion else 0)
    return bound(ops, nbytes, dtype)


def lm_bound(NT, H, V, dtype, dlogits=False):
    """K5 (K6 with dlogits): the (NT, H) x (H, V) logits product; the bytes
    of x, W, b, tgt and the outputs (K5's logp and lse, K6's lse and g in
    and its (NT, V) d-logits out)."""
    sz = SIZE[dtype]
    nbytes = sz * NT * H + 4 * (H * V + V + NT) + (
        8 * NT + sz * NT * V if dlogits else 8 * NT)
    return bound(2 * NT * H * V, nbytes, dtype)


def tf32_control(fn, args, want, err_fn, limit: float, kernel: str,
                 shape) -> float:
    """The planted control: fn (a plain version) run once with single-pass
    TF32 matmuls, as a kernel that rounded its f32 products to TF32 would
    compute; its error against the full-f32 reference must exceed the f32
    limit.  allow_tf32 is restored to False afterwards."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err = err_fn(got, want)
    emit({"phase": "tf32_control", "kernel": kernel, "shape": list(shape),
          "err": err, "limit": limit, "over_limit": err > limit})
    check(err > limit, f"{kernel} {shape}: the single-pass TF32 control passes "
          f"the f32 limit ({err} <= {limit})")
    return err


def _demangle(names: list[str]) -> dict:
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def kernel_report() -> list[dict]:
    """For each tensor-core kernel (K1, K2, K5's first pass, K6 and K4's
    tensor-core route) and for K3 and K4's few-rows route: registers,
    shared memory and spills, as ptxas -v wrote them into the build's
    nvcc.log (the dynamic shared memory from the tile configuration in its
    template arguments, as common.cuh::TileSmem sizes it; K3's and K4's
    few-rows route size theirs by shape), and the count of tensor-core
    instructions (HGMMA, HMMA) in its SASS, by cuobjdump -sass.  Each
    tensor-core kernel's SASS must hold HGMMA where cuobjdump can tell."""
    from visdial_tpu_torch.ops import _build

    lib = _build.library_path()
    with open(os.path.join(os.path.dirname(lib), "nvcc.log")) as f:
        log = f.read()
    res, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )"
                      r"(\w+)", ln)
        if m:
            cur = m.group(1)
            res.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if cur and m:
            res[cur].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            s = re.search(r"(\d+) bytes smem", ln)
            res[cur].update(registers=int(m[1]), static_smem=int(s[1]) if s else 0)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass, why = {}, None
    if os.path.exists(tool):
        proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, timeout=300)
        cur = None
        for ln in proc.stdout.splitlines():
            m = re.match(r"\s*Function : (\S+)", ln)
            if m:
                cur = m.group(1)
                sass[cur] = {"hgmma": 0, "hmma": 0}
            elif cur and "HGMMA" in ln:
                sass[cur]["hgmma"] += 1
            elif cur and "HMMA" in ln:
                sass[cur]["hmma"] += 1
        if proc.returncode != 0 or not sass:
            why = f"cuobjdump -sass exited {proc.returncode}: {proc.stderr[-300:]}"
    else:
        why = "no cuobjdump in the CUDA toolkit"
    families = ("lstm_", "lm_", "attention_kernel", "fusion_stream",
                "fusion_tiles")
    names = sorted(n for n in res if any(f in n for f in families)
                   and "combine" not in n)
    plain = _demangle(names)
    rows = []
    for n in names:
        row = {"phase": "kernel_resources", "kernel": plain[n], **res[n]}
        m = re.search(r"<(float|__nv_bfloat16), (\d+), (\d+), (\d+)>", plain[n])
        if m:
            f32, bm, bn, stages = m[1] == "float", int(m[2]), int(m[3]), int(m[4])
            ring = (stages + (2 if f32 else 0)) * (bm + bn) * 128
            row["dynamic_smem"] = max(ring, bm * (bn + 8) * 4) + 1024
        else:
            row["dynamic_smem"] = "by shape"
        tensor_cores = "attention_kernel" not in n and "fusion_stream" not in n
        if why:
            row["tensor_core_sass"] = f"not known: {why}"
        else:
            check(n in sass, f"{plain[n]} not in cuobjdump's SASS")
            row.update(sass[n])
            check(sass[n]["hgmma"] > 0 or not tensor_cores,
                  f"{plain[n]}: no HGMMA in its SASS")
        emit(row)
        rows.append(row)
    counts = {f: sum(f in n for n in names) for f in families}
    check(counts["lstm_"] >= 6 and counts["lm_"] >= 4
          and all(counts[f] >= 2 for f in families[2:]),
          f"ptxas reported kernels {counts}")
    return rows


def cudnn_lstm(w, b, x, mask, h0, c0, train: bool = False):
    """K1's function as one cuDNN call, the yardstick `library_ms` (the port
    never calls it): a one-layer torch.nn.LSTM carrying W[:E].T as
    weight_ih, W[E:].T as weight_hh, b as bias_ih and a zero bias_hh
    (tests/test_torch_parity.py::_to_torch_lstm; gate order i, f, g, o in
    both).  A row's real steps, right- or left-aligned in x, go to cuDNN
    left-aligned in a PackedSequence of the same lengths; rows with no real
    step are left out (their state passes through unchanged).  With every
    step real, x goes as it is.  Returns (module, pack, hx, rows): pack()
    builds the input from x (the gather and pack_padded_sequence, the
    packing time), hx the rows' (h0, c0).  The module computes in x's
    dtype."""
    from torch.nn.utils.rnn import pack_padded_sequence

    N, T, E = x.shape
    H = w.shape[1] // 4
    m = torch.nn.LSTM(E, H, batch_first=True).to(x.device, x.dtype)
    h0, c0 = h0.to(x.dtype), c0.to(x.dtype)
    with torch.no_grad():
        m.weight_ih_l0.copy_(w[:E].T)
        m.weight_hh_l0.copy_(w[E:].T)
        m.bias_ih_l0.copy_(b)
        m.bias_hh_l0.zero_()
    m.train(train)
    lens = mask.sum(1).long()
    if bool((lens == T).all()):
        return m, lambda t=x: t, (h0[None], c0[None]), None
    rows = torch.nonzero(lens > 0)[:, 0]
    real = mask[rows] != 0
    # the real steps first, in time order (a stable sort of pad-ness)
    order = torch.argsort((~real).to(torch.int8), dim=1, stable=True)
    lens_host = lens[rows].cpu()

    def pack(t=x):
        left = t[rows].gather(1, order[..., None].expand(-1, -1, t.shape[-1]))
        return pack_padded_sequence(left, lens_host, batch_first=True,
                                    enforce_sorted=False)

    return m, pack, (h0[rows][None], c0[rows][None]), rows


def cudnn_forward(w, b, x, mask, h0, c0, hT) -> dict:
    """library_ms (cuDNN's inference forward on the packed input),
    library_pack_ms, and cuDNN's hT against K1's on the same rows."""
    m, pack, hx, rows = cudnn_lstm(w, b, x, mask, h0, c0)
    with torch.no_grad():
        packed = pack()
        _, (h_n, _) = m(packed, hx)
        want = hT if rows is None else hT[rows]
        out = {"library_ms": time_ms(lambda: m(packed, hx)),
               "library_pack_ms": None if rows is None else time_ms(pack),
               "library_max_abs_err": float((h_n[0].float() - want).abs().max()),
               "library": "torch.nn.LSTM (cuDNN)"}
    name = str(x.dtype).split(".")[1]
    check(out["library_max_abs_err"] <= TOL[name],
          f"cuDNN's LSTM disagrees with K1: {out['library_max_abs_err']}")
    return out


def cudnn_backward(w, b, x, mask, h0, c0, cot, dw) -> dict:
    """library_ms of cuDNN's backward (dx, dh0, dc0 and the weight
    gradients: what LSTMLayerFn's whole backward computes) for the
    cotangents `cot` (g_hs, g_hT, g_cT), packed as the input is; its weight
    gradient is held to LSTMLayerFn's `dw`.  A pad step after a row's last
    real step outputs the carried final state, so its g_hs is added to
    g_hT (the pads before the first real step carry h0: no weight
    gradient)."""
    from torch.nn.utils.rnn import PackedSequence

    m, pack, (h0r, c0r), rows = cudnn_lstm(w, b, x, mask, h0, c0, train=True)
    dt, name = x.dtype, str(x.dtype).split(".")[1]
    g_hs, g_ht, g_ct = cot
    steps = torch.arange(mask.shape[1], device=mask.device)
    last = torch.where(mask != 0, steps, -1).max(dim=1).values
    after = (steps[None] > last[:, None]).float()
    g_ht = g_ht.float() + (g_hs.float() * after[..., None]).sum(dim=1)
    with torch.no_grad():
        packed = pack()
        g = pack(g_hs.to(dt))
    if rows is None:
        xin = packed.detach().clone().requires_grad_()
        g_out = g_hs.to(dt)
    else:
        data = packed.data.detach().clone().requires_grad_()
        xin = PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                             packed.unsorted_indices)
        g_out = g.data
        g_ht, g_ct = g_ht[rows], g_ct[rows]
    hx = (h0r.clone().requires_grad_(), c0r.clone().requires_grad_())
    out, (h_n, c_n) = m(xin, hx)
    outs = (out if rows is None else out.data, h_n, c_n)
    ins = [data if rows is not None else xin, *hx, *m.parameters()]
    cots = (g_out, g_ht.to(dt)[None], g_ct.to(dt)[None])
    grads = torch.autograd.grad(outs, ins, cots, retain_graph=True)
    err = rel_err([torch.cat([grads[3], grads[4]], dim=1).T], [dw])
    check(err <= GRAD_TOL[name],
          f"cuDNN's LSTM weight gradient disagrees with LSTMLayerFn's: {err}")
    ms = time_ms(lambda: torch.autograd.grad(outs, ins, cots,
                                             retain_graph=True),
                 reps=5, warmup=1)
    return {"library_ms": ms, "library_grad_rel_err": err,
            "library": "torch.nn.LSTM backward (cuDNN)"}


def counted_choice(fn, call):
    """call()'s result and the tile and split counters of fn (K1's or K2's
    wrapper) that it moved, {attribute: change}."""
    from visdial_tpu_torch.ops.lstm_cuda import choice_counters

    attrs = [a for _, o, a in choice_counters() if o is fn]
    before = {a: getattr(fn, a) for a in attrs}
    out = call()
    return out, {a: getattr(fn, a) - before[a] for a in attrs
                 if getattr(fn, a) != before[a]}


def lstm_checks(dev, gen) -> list[dict]:
    from visdial_tpu_torch.ops.lstm import lstm_layer_plain
    from visdial_tpu_torch.ops.lstm_cuda import (k_tile, layer_plan, lstm_layer,
                                                 resident_clusters, sm_count)

    rows = []
    for N, T, E, H in LSTM_SHAPES:
        align = ALIGN.get((N, T, E, H), "mixed")
        w, b, x, mask, h0, c0 = lstm_case(gen, N, T, E, H, align)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            args = [t.to(dev) for t in (w, b, x.to(dt), mask, h0, c0)]
            got, moved = counted_choice(lstm_layer, lambda: lstm_layer(*args))
            torch.cuda.synchronize()
            index = dev.index or 0
            clusters = (resident_clusters(index, -(-E // k_tile(dt)) * k_tile(dt), H, T)
                        if dt == torch.bfloat16 else 0)
            route, last = layer_plan(N, H, dt, clusters, sm_count(index))
            want_moved = {f"route_{route}": 1}
            if route == "step":
                want_moved[f"tile_{last}"] = 1
            check(moved == want_moved,
                  f"lstm_layer {(N, T, E, H)} {name}: {route} route ({last}), "
                  f"counters moved {moved}")
            want = lstm_layer_plain(*args)
            torch.cuda.synchronize()
            err = abs_err(got, want)
            check(all(torch.isfinite(g.float()).all() for g in got),
                  f"lstm_layer non-finite at {(N, T, E, H)} {name}")
            check(err <= TOL[name], f"lstm_layer {(N, T, E, H)} {name}: "
                  f"max abs err {err} > {TOL[name]}")
            # the training forward: cs (and the rest) against the plain one
            got_cs = lstm_layer(*args, save_cell=True)
            want_cs = lstm_layer_plain(*args, save_cell=True)
            torch.cuda.synchronize()
            cs_err = abs_err(got_cs, want_cs)
            check(cs_err <= TOL[name], f"lstm_layer save_cell {(N, T, E, H)} "
                  f"{name}: max abs err {cs_err} > {TOL[name]}")
            del got_cs, want_cs
            row = {"phase": "lstm_layer", "shape": [N, T, E, H], "dtype": name,
                   "align": align, "route": route, "launch": last, "max_abs_err": err,
                   "cs_max_abs_err": cs_err,
                   "tol": TOL[name],
                   "ms": time_ms(lambda: lstm_layer(*args)),
                   "plain_ms": time_ms(lambda: lstm_layer_plain(*args)),
                   "cs_ms": time_ms(lambda: lstm_layer(*args, save_cell=True)),
                   "cs_plain_ms": time_ms(
                       lambda: lstm_layer_plain(*args, save_cell=True)),
                   **lstm_bound(mask, N, T, E, H, name)}
            if (N, T, E, H) == LSTM_HEAD and dt == torch.float32:
                row["tf32_control_err"] = tf32_control(
                    lstm_layer_plain, args, want, abs_err, TOL[name],
                    "lstm_layer", (N, T, E, H))
            if ((N, T, E, H) in (LSTM_HEAD, DIALOG_HEAD, HIST_HEAD)
                    and dt == torch.float32 or (N, T, E, H) == LSTM_HEAD):
                row.update(cudnn_forward(*args, got[1]))
            emit(row)
            rows.append(row)
    return rows


def causal_mask(dev, B, R, S, masked: bool):
    """The encoder's causal mask (slot s visible to round r where s <= r)
    on the card as it hands it over, an expanded view with batch stride 0;
    with `masked`, a copy in which rows (1, 3) and (B - 1, 0) see nothing."""
    valid = (torch.arange(S)[None, :] <= torch.arange(R)[:, None]).float()
    valid = valid.to(dev)[None].expand(B, R, S)
    if masked:
        valid = valid.contiguous()
        valid[1, 3] = 0.0
        valid[B - 1, 0] = 0.0
    return valid


def attention_checks(dev, gen) -> list[dict]:
    """K4 against attention_fusion_ref at ATTN_SHAPES and the two sides of
    its route threshold, f32 and bf16, with the single-pass TF32 control at
    the f32 eval batch."""
    from visdial_tpu_torch.ops.attention import attention_fusion_ref
    from visdial_tpu_torch.ops.attention_cuda import (FUSION_STREAM_ROWS,
                                                      attention_fusion,
                                                      fusion_route,
                                                      pack_fusion_weight)

    sides = sorted({b for t in FUSION_STREAM_ROWS.values() for b in
                    (t // 10, t // 10 + 1)} - {s[0] for s in ATTN_SHAPES})
    shapes = ATTN_SHAPES + [(b, 10, 10, 512) for b in sides]
    rows = []
    for B, R, S, H in shapes:
        q = torch.randn(B, R, H, generator=gen) * 0.5
        s = torch.randn(B, S, H, generator=gen) * 0.5
        valid = causal_mask(dev, B, R, S, B == ATTN_MASKED["attention_fusion"])
        fw = torch.empty(2 * H, H).uniform_(-0.08, 0.08, generator=gen)
        fb = torch.empty(H).uniform_(-0.08, 0.08, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            args = [q.to(dev, dt), s.to(dev, dt), valid, fw.to(dev), fb.to(dev)]
            got = attention_fusion(*args)
            torch.cuda.synchronize()
            want = attention_fusion_ref(*args)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()),
                  f"attention_fusion non-finite at {(B, R, S, H)} {name}")
            check(err <= TOL[name], f"attention_fusion {(B, R, S, H)} {name}: "
                  f"max abs err {err} > {TOL[name]}")
            route = fusion_route(B, R, S, H, dt)
            row = {"phase": "attention_fusion", "shape": [B, R, S, H],
                   "dtype": name, "route": route, "max_abs_err": err,
                   "tol": TOL[name],
                   "ms": time_ms(lambda: attention_fusion(*args), 50),
                   "launch_ms": launch_ms(lambda: attention_fusion(*args)),
                   "plain_ms": time_ms(
                                       lambda: attention_fusion_ref(*args), 50),
                   **attention_bound(B, R, S, H, name, fusion=True)}
            if route == "tiles":   # the wrapper's packing of Wf, inside "ms"
                row["pack_ms"] = time_ms(lambda: pack_fusion_weight(args[3], dt),
                                         50)
            if (B, R, S, H) == ATTN_SHAPES[1] and dt == torch.float32:
                row["tf32_control_err"] = tf32_control(
                    attention_fusion_ref, args, want,
                    lambda a, b: float((a.float() - b.float()).abs().max()),
                    TOL[name], "attention_fusion", (B, R, S, H))
            emit(row)
            rows.append(row)
    return rows


def lstm_bwd_checks(dev, gen) -> list[dict]:
    """K2 through LSTMLayerFn against autograd through the plain forward,
    and K2 alone against its plain version on the same residuals."""
    from visdial_tpu_torch.ops.lstm import lstm_layer_bwd_plain, lstm_layer_plain
    from visdial_tpu_torch.ops.lstm_cuda import (LSTMLayerFn, dh_splits,
                                                 lstm_layer, lstm_layer_bwd,
                                                 lstm_tile, sm_count)

    rows = []
    for (N, T, E, H), sparse in ([(shape, False) for shape in BWD_SHAPES]
                                 + [(SPARSE_BWD, True)]):
        align = ALIGN.get((N, T, E, H), "mixed")
        case = lstm_case(gen, N, T, E, H, align)
        g_hs = torch.randn(N, T, H, generator=gen)
        g_ht, g_ct = torch.randn(2, N, H, generator=gen)
        if sparse:   # 10 prefix bounds a row, inside its real steps
            lens = case[3].sum(1).long().clamp(min=1)
            at = torch.zeros(N, T, dtype=torch.bool)
            at[torch.arange(N)[:, None],
               torch.randint(0, T, (N, 10), generator=gen) % lens[:, None]] = True
            g_hs = torch.where(at[..., None], g_hs, 0.0)
            g_ht, g_ct = torch.zeros(2, N, H)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            w, b, x, mask, h0, c0 = (t.to(dev) for t in case)
            x = x.to(dt)
            cot = [g_hs.to(dev, dt), g_ht.to(dev), g_ct.to(dev)]
            grads, ms = [], []
            for fn in (LSTMLayerFn.apply, lstm_layer_plain):
                ins = [t.clone().requires_grad_() for t in (w, b, x, h0, c0)]
                outs = fn(*ins[:3], mask, *ins[3:])
                grads.append(torch.autograd.grad(outs, ins, cot,
                                                 retain_graph=True))
                torch.cuda.synchronize()
                ms.append(time_ms(lambda: torch.autograd.grad(
                    outs, ins, cot, retain_graph=True), reps=5, warmup=1))
                del outs, ins
            err = rel_err(*grads)
            check(all(bool(torch.isfinite(g.float()).all()) for g in grads[0]),
                  f"LSTMLayerFn grads non-finite at {(N, T, E, H)} {name}")
            check(err <= GRAD_TOL[name], f"lstm_layer_bwd {(N, T, E, H)} {name}: "
                  f"grad rel err {err} > {GRAD_TOL[name]}")
            dw = grads[0][0]
            del grads
            # K2 alone on the forward's residuals
            hs, cs, _, _ = lstm_layer(w, b, x, mask, h0, c0, save_cell=True)
            h_prev = torch.cat([h0.to(dt)[:, None], hs[:, :-1]], dim=1)
            c_prev = torch.cat([c0.to(dt)[:, None], cs[:, :-1]], dim=1)
            args = (w, b, x, mask, h_prev, c_prev, *cot)
            k2, moved = counted_choice(lstm_layer_bwd,
                                       lambda: lstm_layer_bwd(*args))
            k2_plain = lstm_layer_bwd_plain(*args)
            torch.cuda.synchronize()
            sms = sm_count(dev.index or 0)
            tile = lstm_tile(N, H, dt, sms)
            S = dh_splits(N, H, dt, tile, sms)
            check(moved == {f"tile_{tile[0]}": 1, f"dh_split_{S}": 1},
                  f"lstm_layer_bwd {(N, T, E, H)} {name}: tile {tile}, S {S}, "
                  f"counters moved {moved}")
            k2_err, k2_abs = rel_err(k2, k2_plain), abs_err(k2, k2_plain)
            check(k2_err <= GRAD_TOL[name], f"K2 {(N, T, E, H)} {name}: "
                  f"rel err {k2_err} > {GRAD_TOL[name]}")
            extra = {}
            if (N, T, E, H) == LSTM_HEAD and dt == torch.float32:
                extra["tf32_control_err"] = tf32_control(
                    lstm_layer_bwd_plain, args, k2_plain, rel_err,
                    GRAD_TOL[name], "lstm_layer_bwd", (N, T, E, H))
            # the K2 rows of the kernel table: the option LSTM, the dialog
            # LSTM and LF's history with its gradient at the bounds only
            if ((sparse or (N, T, E, H) in (LSTM_HEAD, DIALOG_HEAD))
                    and dt == torch.float32
                    or (N, T, E, H) == LSTM_HEAD and not sparse):
                extra.update(cudnn_backward(w, b, x, mask, h0, c0, cot, dw))
            del k2, k2_plain, dw
            row = {**extra, "phase": "lstm_layer_bwd", "shape": [N, T, E, H],
                   "dtype": name, "align": align, "sparse_g_hs": sparse,
                   "tile": tile, "dh_splits": S,
                   "grad_max_rel_err": err,
                   "k2_max_rel_err": k2_err, "max_abs_err": k2_abs,
                   "tol": GRAD_TOL[name],
                   "bwd_ms": ms[0], "bwd_plain_ms": ms[1],
                   "ms": time_ms(lambda: lstm_layer_bwd(*args), reps=5),
                   "plain_ms": time_ms(lambda: lstm_layer_bwd_plain(*args),
                                       reps=5),
                   **lstm_bound(mask, N, T, E, H, name, backward=True)}
            del args, hs, cs, h_prev, c_prev
            emit(row)
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


def sdpa_attention(q, s, valid):
    """K3's function as one PyTorch call, the yardstick `library_ms` (the
    port never calls it): unscaled softmax over the slots with an additive
    -1e30 mask, one head."""
    mask = torch.where(valid > 0, 0.0, -1e30).to(q.dtype)[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, None], s[:, None], s[:, None], attn_mask=mask, scale=1.0)[:, 0]


def attention_only_checks(dev, gen) -> list[dict]:
    """K3 forward against attention_plain and AttentionFn's grads against
    autograd through attention_plain (relative to the largest reference)."""
    from visdial_tpu_torch.ops.attention import attention_plain
    from visdial_tpu_torch.ops.attention_cuda import (AttentionFn,
                                                      masked_slot_attention)

    rows = []
    for B, R, S, H in ATTN3_SHAPES:
        q = torch.randn(B, R, H, generator=gen) * 0.5
        s = torch.randn(B, S, H, generator=gen) * 0.5
        if S == SPATIAL_SLOTS:
            valid = torch.ones((1, R, S), device=dev).expand(B, R, S)
        else:
            valid = causal_mask(dev, B, R, S, B == ATTN_MASKED["attention"])
        g = torch.randn(B, R, H, generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            outs, grads = [], []
            for fn in (AttentionFn.apply, attention_plain):
                qq = q.to(dev, dt).requires_grad_()
                ss = s.to(dev, dt).requires_grad_()
                out = fn(qq, ss, valid)
                grads.append(torch.autograd.grad(out, (qq, ss), g.to(dev, dt)))
                outs.append(out.detach())
            torch.cuda.synchronize()
            err = rel_err(outs[:1], outs[1:])
            grad_err = rel_err(*grads)
            check(bool(torch.isfinite(outs[0].float()).all()),
                  f"attention non-finite at {(B, R, S, H)} {name}")
            check(err <= TOL[name] and grad_err <= GRAD_TOL[name],
                  f"attention {(B, R, S, H)} {name}: rel err {err} (tol "
                  f"{TOL[name]}), grad rel err {grad_err} (tol {GRAD_TOL[name]})")
            args = (q.to(dev, dt), s.to(dev, dt), valid)
            row = {"phase": "attention", "shape": [B, R, S, H], "dtype": name,
                   "mask": "all-ones" if S == SPATIAL_SLOTS else "causal",
                   "max_rel_err": err, "max_abs_err": abs_err(outs[:1], outs[1:]),
                   "grad_max_rel_err": grad_err,
                   "tol": TOL[name], "grad_tol": GRAD_TOL[name],
                   "ms": time_ms(lambda: masked_slot_attention(*args), 50),
                   "launch_ms": launch_ms(lambda: masked_slot_attention(*args)),
                   "plain_ms": time_ms(lambda: attention_plain(*args), 50),
                   "library_ms": time_ms(lambda: sdpa_attention(*args), 50),
                   **attention_bound(B, R, S, H, name)}
            emit(row)
            rows.append(row)
    return rows


def bf16_accum_logits(x, w, b):
    """The planted control's (NT, V) logits: products exact in f32, but the
    running sum over H rounded to bf16 after every CONTROL_DEPTH of them."""
    xf, wf = x.float(), w.to(x.dtype).float()
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.bfloat16,
                      device=x.device)
    for k in range(0, x.shape[1], CONTROL_DEPTH):
        acc = (acc.float() + xf[:, k:k + CONTROL_DEPTH]
               @ wf[k:k + CONTROL_DEPTH]).bfloat16()
    return acc.float() + b.float()


def dlogits_ref(x, w, b, tgt, lse, g):
    """What K6 is held to: its plain version (ops/lm_score.py::
    lm_dlogits_plain) in bf16, and in f32 the same formula evaluated in
    float64 and rounded to f32.  The plain version's own f32 product
    (cuBLAS, TF32 off) is off from float64 by up to 1.1e-5 in a logit over
    the 650M entries at 73,728 rows (scripts/lm_f64_error.py), more than the
    DLOG_RTOL it would be held to, and more than K6's own 2.9e-6."""
    from visdial_tpu_torch.ops.lm_score import lm_dlogits_plain

    if x.dtype != torch.float32:
        return lm_dlogits_plain(x, w, b, tgt, lse, g)
    d = (x.double() @ w.double()).add_(b.double())
    d.sub_(lse.double()[:, None]).exp_().neg_()
    d.scatter_add_(1, tgt.long()[:, None], torch.ones_like(d[:, :1]))
    return d.mul_(g.double()[:, None]).float()


def dlogits_over_limit(got, ref, g, dtype) -> float:
    """The largest ratio of K6's per-element error to its limit (<= 1
    passes): DLOG_RTOL x |ref| in f32, one bf16 ulp of ref in bf16, plus
    DLOG_FLOOR x |g_i| / V; g = 0 rows must give exact zeros."""
    r = ref.float().abs()
    if dtype == torch.bfloat16:
        ulp = torch.exp2((torch.frexp(r).exponent - 8).float())
        lim = torch.where(r > 0, ulp, 0.0)
    else:
        lim = DLOG_RTOL * r
    lim += DLOG_FLOOR[str(dtype).split(".")[1]] * g.abs()[:, None] / r.shape[1]
    err = (got.float() - ref.float()).abs()
    return float(torch.where(err > 0, err / lim, 0.0).max())


def lm_checks(dev, gen) -> tuple[list[dict], list[dict]]:
    """K5 and K6 against their plain versions at LM_SHAPES, f32 and bf16,
    each beside the planted bf16-accumulation control, which its limit must
    refuse (at more than one row), and TokenLogprobFn's dx / dW / db against
    autograd through the plain masked NLL at the training shape."""
    from visdial_tpu_torch.ops.lm_loss import masked_nll_fused, masked_nll_ref
    from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,
                                                lm_token_logprobs_lse_plain)
    from visdial_tpu_torch.ops.lm_score_cuda import (lm_dlogits,
                                                     lm_token_logprobs_lse,
                                                     pack_lm_weight, pad_lm_bias)

    k5, k6 = [], []
    for NT, H, V in LM_SHAPES:
        x = torch.tanh(torch.randn(NT, H, generator=gen))   # LSTM states
        w = torch.randn(H, V, generator=gen) * 0.1
        b = torch.randn(V, generator=gen) * 0.1
        tgt = torch.randint(0, V, (NT,), generator=gen)
        tgt[::4] = 0                                        # pad targets
        g = torch.randn(NT, generator=gen)
        g[tgt == 0] = 0.0                                   # as the loss gives
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            args = [x.to(dev, dt), w.to(dev), b.to(dev), tgt.to(dev)]
            got = lm_token_logprobs_lse(*args)
            want = lm_token_logprobs_lse_plain(*args)
            logits_c = bf16_accum_logits(*args[:3])
            lse_c = torch.logsumexp(logits_c, dim=-1)
            control = (logits_c.gather(1, args[3][:, None])[:, 0] - lse_c, lse_c)
            torch.cuda.synchronize()
            tol = LM_TOL * max(1.0, float(want[0].abs().max()))
            err, control_err = abs_err(got, want), abs_err(control, want)
            del control
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"lm_score non-finite at {(NT, H, V)} {name}")
            check(err <= tol, f"lm_score {(NT, H, V)} {name}: max abs err "
                  f"{err} > {tol}")
            check(NT == 1 or control_err > tol, f"lm_score {(NT, H, V)} "
                  f"{name}: the bf16-accumulation control passes ({control_err}"
                  f" <= {tol})")
            head = (NT, H, V) == LM_HEAD and dt == torch.float32
            row = {"phase": "lm_score", "shape": [NT, H, V], "dtype": name,
                   "max_abs_err": err, "tol": tol, "control_err": control_err,
                   "ms": time_ms(lambda: lm_token_logprobs_lse(*args)),
                   "plain_ms": time_ms(lambda: lm_token_logprobs_lse_plain(*args)),
                   # the wrappers' operand preparation, inside "ms"
                   "pack_ms": time_ms(lambda: (pack_lm_weight(args[1], dt),
                                               pad_lm_bias(args[2]))),
                   **lm_bound(NT, H, V, name)}
            if head:
                row["tf32_control_err"] = tf32_control(
                    lm_token_logprobs_lse_plain, args, want, abs_err, tol,
                    "lm_score", (NT, H, V))
            emit(row)
            k5.append(row)
            lse, gd = want[1], g.to(dev)
            got = lm_dlogits(*args, lse, gd)
            ref = dlogits_ref(*args, lse, gd)
            # f32: the plain version beside the float64 reference
            plain_over = dlogits_over_limit(
                got, lm_dlogits_plain(*args, lse, gd), gd, dt)
            d_c = -torch.exp(logits_c - lse[:, None])
            d_c.scatter_add_(1, args[3][:, None], torch.ones_like(d_c[:, :1]))
            d_c = (gd[:, None] * d_c).to(dt)
            del logits_c
            torch.cuda.synchronize()
            err = abs_err([got], [ref])
            over = dlogits_over_limit(got, ref, gd, dt)
            control_over = dlogits_over_limit(d_c, ref, gd, dt)
            check(bool(torch.isfinite(got.float()).all()) and got.dtype == dt,
                  f"lm_dlogits non-finite or not {name} at {(NT, H, V)}")
            check(over <= 1.0, f"lm_dlogits {(NT, H, V)} {name}: an error "
                  f"{over} x its per-element limit (max abs err {err})")
            check(NT == 1 or control_over > 1.0, f"lm_dlogits {(NT, H, V)} "
                  f"{name}: the bf16-accumulation control passes ({control_over}"
                  " x the limit)")
            del got, d_c
            extra = {}
            if head:
                extra["tf32_control_over_limit"] = tf32_control(
                    lm_dlogits_plain, (*args, lse, gd), ref,
                    lambda got, want: dlogits_over_limit(got, want, gd, dt), 1.0,
                    "lm_dlogits", (NT, H, V))
            del ref
            row = {**extra, "phase": "lm_dlogits", "shape": [NT, H, V], "dtype": name,
                   "max_abs_err": err, "err_over_limit": over,
                   "err_over_limit_vs_plain": plain_over,
                   "control_over_limit": control_over,
                   "ms": time_ms(lambda: lm_dlogits(*args, lse, gd), reps=5),
                   "plain_ms": time_ms(lambda: lm_dlogits_plain(*args, lse, gd),
                                       reps=5),
                   **lm_bound(NT, H, V, name, dlogits=True)}
            torch.cuda.empty_cache()
            emit(row)
            k6.append(row)
    # the training loss head: 320 rows x 9 steps, ragged targets
    N, T, (_, H, V) = 320, 9, LM_SHAPES[0]
    outs = torch.tanh(torch.randn(N, T, H, generator=gen))
    w = torch.randn(H, V, generator=gen) * 0.1
    b = torch.randn(V, generator=gen) * 0.1
    tgt = torch.randint(1, V, (N, T), generator=gen)
    tgt *= torch.arange(T)[None] < torch.randint(1, T + 1, (N, 1), generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        vals, grads = [], []
        for fn in (masked_nll_fused, masked_nll_ref):
            ins = [t.to(dev).requires_grad_() for t in (outs.to(dt), w, b)]
            v = fn(*ins, tgt.to(dev))
            grads.append(torch.autograd.grad(v, ins))
            vals.append(float(v.detach()))
        err, loss_err = rel_err(*grads), abs(vals[0] - vals[1])
        check(loss_err <= LOSS_TOL * max(1.0, abs(vals[1]))
              and err <= GRAD_TOL[name], f"TokenLogprobFn {name}: loss "
              f"{vals[0]} vs {vals[1]}, grad rel err {err} > {GRAD_TOL[name]}")
        emit({"phase": "lm_head_grads", "shape": [N, T, H, V], "dtype": name,
              "loss": vals[0], "loss_err": loss_err, "grad_max_rel_err": err,
              "tol": GRAD_TOL[name]})
    return k5, k6


def _wrappers() -> dict:
    from visdial_tpu_torch.bench import kernel_wrappers

    return kernel_wrappers()


def kernel_launches() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def first_step_errs(pk, gk, pp, gp, lr, cfg) -> tuple[float, float, float]:
    """Two first optimizer steps from the same state, as {path: tensor} of
    their new params (pk, pp) and clipped gradients (gk, gp): (the largest
    gradient rel err of a leaf, the largest param abs err, how far the
    param err exceeds its bound).  Adam's first update lr*g/(|g| + eps)
    moves by at most lr/eps times a change of g, so the params are held to
    that bound, element-wise."""
    grad_err = max(rel_err([gk[k]], [gp[k]]) for k in gp)
    param_err, param_excess = 0.0, 0.0
    for k in pp:
        d = (pk[k] - pp[k]).abs()
        bound = lr / cfg.adam_eps * (gk[k] - gp[k]).abs() + 1e-6
        param_err = max(param_err, float(d.max()))
        param_excess = max(param_excess, float((d - bound).max()))
    return grad_err, param_err, param_excess


def compare_steps(cfg, state0, batch, seed: int, loss_fn=None) -> dict:
    """One train_step and the gradients of loss_fn (default model_loss) on
    the kernel path and the plain path from the same params, batch and
    generator seed."""
    from visdial_tpu_torch.parallel.optim import clip_by_global_norm
    from visdial_tpu_torch.parallel.train_step import (TrainState,
                                                       loss_and_grads,
                                                       train_step)
    from visdial_tpu_torch.models.model import model_loss
    from visdial_tpu_torch.utils.params import flatten

    loss_fn = loss_fn or model_loss
    out = {}
    for impl in ("cuda", "plain"):
        st = TrainState(state0.params, state0.opt,
                        torch.Generator().manual_seed(seed))
        new, m = train_step(st, batch, cfg, impl=impl, loss_fn=loss_fn)
        _, grads = loss_and_grads(state0.params, batch, cfg,
                                  torch.Generator().manual_seed(seed), impl,
                                  loss_fn)
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
        out[impl] = (flatten(new.params), m, flatten(grads))
    (pk, mk, gk), (pp, mp, gp) = out["cuda"], out["plain"]
    loss_tol, gnorm_rtol, grad_tol = TRAIN_TOL[cfg.compute_dtype]
    loss_err = abs(float(mk["loss"]) - float(mp["loss"]))
    gnorm_err = abs(float(mk["grad_norm"]) / float(mp["grad_norm"]) - 1)
    grad_err, param_err, param_excess = first_step_errs(pk, gk, pp, gp,
                                                        mk["lr"], cfg)
    check(bool(torch.isfinite(mk["loss"])), "train_step loss non-finite")
    check(loss_err <= loss_tol and gnorm_err <= gnorm_rtol
          and grad_err <= grad_tol and param_excess <= 0.0,
          f"train_step kernel vs plain ({cfg.compute_dtype}, dropout "
          f"{cfg.dropout}): loss err {loss_err} (tol {loss_tol}), grad_norm "
          f"rel err {gnorm_err} (tol {gnorm_rtol}), grad rel err {grad_err} "
          f"(tol {grad_tol}), param err {param_err} exceeding its bound by "
          f"{param_excess}")
    return {"loss": float(mk["loss"]), "loss_err": loss_err,
            "grad_norm": float(mk["grad_norm"]), "grad_norm_rel_err": gnorm_err,
            "grad_max_rel_err": grad_err, "param_max_abs_err": param_err,
            "tols": [loss_tol, gnorm_rtol, grad_tol]}


def path_kernels(cfg, train: bool) -> tuple[set, set]:
    """(the kernels a path of cfg's model must launch, those it must not):
    K1 always, K2 in training; K3 where it attends over slots in training
    (MN, HREA) or over pool5 locations (img_spatial, train and eval); K4
    for MN's and HREA's eval tail; K5 for the gen decoder, K6 in its
    training."""
    from visdial_tpu_torch.config import encoder_family, encoder_uses_image

    fam = encoder_family(cfg.encoder)
    spatial = cfg.img_spatial and encoder_uses_image(cfg.encoder)
    need = {"lstm_layer"}
    if train:
        need |= {"lstm_layer_bwd"} | (
            {"attention"} if fam in ("mn", "hrea") or spatial else set())
    else:
        need |= ({"attention_fusion"} if fam in ("mn", "hrea") else set()) | (
            {"attention"} if spatial else set())
    if cfg.decoder == "gen":
        need |= {"lm_score", "lm_dlogits"} if train else {"lm_score"}
    return need, set(_wrappers()) - need


def check_launches(launches: dict, cfg, train: bool, what: str) -> None:
    need, never = path_kernels(cfg, train)
    check(all(launches[k] > 0 for k in need) and all(launches[k] == 0
                                                     for k in never),
          f"{what}: launches {launches}, expected > 0 for {sorted(need)} "
          f"and 0 for {sorted(never)}")


def tensor_core_calls() -> int:
    """The contraction helper's calls on its bf16 tensor-core route."""
    from visdial_tpu_torch.ops.contract import mm_f32, scores_f32

    return mm_f32.tensor_core + scores_f32.tensor_core


def check_contractions(calls: int, cfg, what: str) -> None:
    """A bf16 path on the card contracts on the tensor cores (the upcast
    route never runs there); an f32 path never does."""
    check((calls > 0) == (cfg.compute_dtype == "bfloat16"),
          f"{what} ({cfg.compute_dtype}): {calls} tensor-core contractions")


def loss_trajectory(cfg, state0, batches) -> dict:
    """TRAIN_STEPS kernel-path steps at dropout 0 in bf16 and in f32 from
    the same init and batches: every step's bf16 loss within TRAJ_RTOL x
    the first f32 loss of the f32 one."""
    from visdial_tpu_torch.parallel.train_step import train_step

    losses = {}
    for dt in ("bfloat16", "float32"):
        c, st = cfg.replace(dropout=0.0, compute_dtype=dt), state0
        losses[dt] = []
        for b in batches:
            st, m = train_step(st, b, c, impl="cuda")
            losses[dt].append(float(m["loss"]))
        del st
    first = abs(losses["float32"][0])
    rel = max(abs(a - r) for a, r in zip(*losses.values())) / first
    check(all(map(math.isfinite, losses["bfloat16"])) and rel <= TRAJ_RTOL,
          f"bf16 loss trajectory {losses['bfloat16']} against f32 "
          f"{losses['float32']}: err {rel} of the first loss > {TRAJ_RTOL}")
    return {"steps": len(batches), "max_rel_err": rel, "tol": TRAJ_RTOL,
            "bf16": losses["bfloat16"], "f32": losses["float32"]}


def train(dev, decoder: str = "disc", encoder: str = "mn-ques-im-hist",
          phase: str = "", dtype: str = "float32",
          batch_size: int = 32) -> dict:
    """A training path: flagship <encoder>-<decoder> at full width in
    `dtype` (bf16 adds the loss trajectory against f32)."""
    from visdial_tpu_torch.parallel.train_step import train_step
    from visdial_tpu_torch.profile_train import flagship_setup

    cfg, batches, state0 = flagship_setup(dev, TRAIN_STEPS, decoder=decoder,
                                          encoder=encoder, compute_dtype=dtype,
                                          batch_size=batch_size)
    row = {"phase": phase or ("train" if decoder == "disc" else "gen_train"),
           "model": f"{encoder}-{decoder}", "vocab": cfg.vocab_size,
           "dtype": dtype, "batch_dialogs": cfg.batch_size}
    if decoder == "disc":
        check(cfg.vocab_size == 8804 and "opt_uniq" in batches[0],
              "train batches: vocab 8,804 and the dedup layout")
        row.update({"candidate_rows": int(batches[0]["opt_uniq"].shape[0]),
                    "unique_rows": int((batches[0]["opt_uniq"] != 0).any(1).sum())})
    else:
        check(cfg.vocab_size == 8804 and "ans_out" in batches[0]
              and "opt" not in batches[0], "gen train batches: vocab 8,804 and "
              "teacher-forced answers without candidates")
        row["lm_tokens"] = int(batches[0]["ans_out"].numel())
    if "hist_flat" in batches[0]:
        row["hist_shape"] = list(batches[0]["hist_flat"].shape)
        row["hist_tokens"] = int((batches[0]["hist_flat"] != 0).sum())
    row["dropout0"] = compare_steps(cfg, state0, batches[0], seed=1)
    cfg = cfg.replace(dropout=0.5)
    row["dropout05"] = compare_steps(cfg, state0, batches[0], seed=2)

    def run(state, impl, n):
        times, losses = [], []
        for b in batches[:n]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(state, b, cfg, impl=impl)
            losses.append(float(m["loss"]))       # reads back: synchronises
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, statistics.median(times)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    calls = tensor_core_calls()
    losses, step_ms = run(state0, "cuda", TRAIN_STEPS)
    launches = kernel_launches()
    calls = tensor_core_calls() - calls
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check_launches(launches, cfg, True, row["phase"])
    check_contractions(calls, cfg, row["phase"])
    torch.cuda.reset_peak_memory_stats(dev)
    _, plain_ms = run(state0, "plain", 5)
    rounds = cfg.batch_size * cfg.num_rounds
    row.update({"steps": TRAIN_STEPS, "dropout": cfg.dropout,
                "launches": launches, "loss_first": losses[0],
                "loss_last": losses[-1], "step_ms": step_ms,
                "rounds_per_s": rounds / step_ms * 1e3,
                "plain_step_ms": plain_ms,
                "plain_rounds_per_s": rounds / plain_ms * 1e3,
                "peak_mem_gb": peak / 2 ** 30,
                "plain_peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                "tensor_core_contractions": calls})
    if dtype == "bfloat16":
        row["trajectory"] = loss_trajectory(cfg, state0, batches)
    emit(row)
    return row


def disc_scores(params, split, vocab, cfg, dev, impl: str) -> torch.Tensor:
    """(dialogs, R, K) disc scores of `split`, batch by batch through the
    option table, as evaluate_split computes them."""
    from visdial_tpu_torch.data.loader import EvalLoader
    from visdial_tpu_torch.models.model import (batch_to_device,
                                                model_option_table,
                                                model_scores_with_table)

    out = []
    with torch.inference_mode():
        table = model_option_table(
            params, torch.from_numpy(split.opt_list).long().to(dev), cfg,
            impl=impl)
        for b in EvalLoader(split, vocab, cfg, option_tokens=False):
            d = batch_to_device(b.as_dict(), dev)
            s = model_scores_with_table(params, d, table, cfg, impl=impl)
            out.append(s[torch.from_numpy(b.dialog_valid.astype(bool)).to(dev)])
    return torch.cat(out)


def scaled(params: dict, k: float) -> dict:
    """params with every leaf outside the LSTMs times k (EVAL_SCALE)."""
    from visdial_tpu_torch.utils.params import flatten, unflatten

    return unflatten({n: v if "lstm" in n else v * k
                      for n, v in flatten(params).items()})


def eval_pair(params, split, vocab, cfg, dev, what: str) -> dict:
    """evaluate_split of `split` on the kernel path (its launches read
    right after it) and on the plain path.  Ranks must be equal; for the
    disc decoder a rank may differ only where the plain scores of the
    ground truth and another candidate lie within twice the largest score
    difference between the paths (a near tie), and that difference must be
    within SCORE_TOL."""
    import numpy as np

    from visdial_tpu_torch.eval_harness import evaluate_split

    reset_launches()
    mk, rk = evaluate_split(params, split, vocab, cfg, dev, impl="cuda",
                            return_ranks=True)
    launches = kernel_launches()
    check_launches(launches, cfg, False, what)
    mp, rp = evaluate_split(params, split, vocab, cfg, dev, impl="plain",
                            return_ranks=True)
    rounds = split.num_dialogs * cfg.num_rounds
    check(len(rk) == len(rp) == rounds and math.isfinite(mk["mrr"]),
          f"{what}: ranked {len(rk)} rounds, mrr {mk['mrr']}")
    row = {"launches": launches, "dialogs": split.num_dialogs,
           "rounds": int(len(rk)), "mrr": mk["mrr"], "plain_mrr": mp["mrr"],
           "mean_rank": mk["mean_rank"],
           "rank_mismatches": int((rk != rp).sum())}
    if cfg.decoder == "disc":
        s_k = disc_scores(params, split, vocab, cfg, dev, "cuda")
        s_p = disc_scores(params, split, vocab, cfg, dev, "plain")
        err = float((s_k - s_p).abs().max())
        check(bool(torch.isfinite(s_k).all()) and err <= SCORE_TOL,
              f"{what}: score err {err} > {SCORE_TOL}")
        gt = torch.from_numpy(split.gt_ind).long().to(dev)
        s_gt = s_p.gather(-1, gt[..., None])
        near = ((s_p - s_gt).abs() <= 2 * err).sum(-1).flatten().cpu().numpy() - 1
        row.update({"score_max_abs_err": err, "score_tol": SCORE_TOL})
        check(bool((np.abs(rk - rp) <= near).all()),
              f"{what}: {row['rank_mismatches']} ranks differ from the plain "
              "path's beyond the near ties")
    else:
        check(row["rank_mismatches"] == 0, f"{what}: {row['rank_mismatches']} "
              "ranks differ from the plain path's")
    return row


def evaluate(dev, encoder: str = "mn-ques-im-hist", decoder: str = "gen",
             phase: str = "gen_eval") -> dict:
    """An evaluation path: evaluate_split (gen width-bucketed) of the
    flagship <encoder>-<decoder> over 48 dialogs x 10 rounds x 100
    candidates, the kernel path against the plain path (eval_pair; this
    run also warms both paths up).  Then the rate: EVAL_REPS runs of each
    path, in turn, over EVAL_DIALOGS dialogs (full 32-dialog batches)."""
    import numpy as np

    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.models.model import model_init

    base = Config(encoder=encoder, decoder=decoder, dropout=0.0)
    split, vocab = make_random_split(base, num_dialogs=48, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    check(cfg.gen_eval_bucketed, "gen eval takes the bucketed path")
    params = model_init(cfg, seed=0, device=dev)
    if decoder == "disc":
        params = scaled(params, EVAL_SCALE)
    row = {"phase": phase, "model": f"{encoder}-{decoder}",
           "vocab": cfg.vocab_size, "candidates": cfg.num_options,
           **eval_pair(params, split, vocab, cfg, dev, phase)}
    split, _ = make_random_split(base, num_dialogs=EVAL_DIALOGS, seed=1)
    runs = {"cuda": [], "plain": []}
    for _ in range(EVAL_REPS):
        for impl in runs:
            runs[impl].append(evaluate_split(params, split, vocab, cfg, dev,
                                             impl=impl, return_ranks=True))
    rounds = len(runs["cuda"][0][1])
    check(rounds == EVAL_DIALOGS * cfg.num_rounds, f"{phase} timed {rounds} "
          "rounds")
    for impl, rs in runs.items():
        check(all(np.array_equal(r, rs[0][1]) for _, r in rs),
              f"{phase} ({impl}): ranks differ between repeated runs")
    # an unchecked near tie may move a rank by one; the 48-dialog run above
    # holds the ranks equal
    diff = np.abs(runs["cuda"][0][1] - runs["plain"][0][1])
    check(diff.max() <= 1 and (diff > 0).sum() <= rounds // 1000,
          f"{phase}: ranks of {int((diff > 0).sum())} of {rounds} timed "
          f"rounds differ from the plain path's, by up to {diff.max()}")
    rates = {impl: [m["evals_per_sec"] for m, _ in rs] for impl, rs in runs.items()}
    row.update({"timed_dialogs": EVAL_DIALOGS, "timed_rounds": rounds,
                "timed_reps": EVAL_REPS, "timed_rank_mismatches": int((diff > 0).sum()),
                "timed_mrr": runs["cuda"][0][0]["mrr"],
                "evals_per_sec": statistics.median(rates["cuda"]),
                "plain_evals_per_sec": statistics.median(rates["plain"]),
                "evals_per_sec_runs": rates["cuda"],
                "plain_evals_per_sec_runs": rates["plain"]})
    emit(row)
    return row


def families(dev) -> list[dict]:
    """Every other encoder family at full width: one train step of the
    kernel path against the plain path at dropout 0 (compare_steps), then
    one eval batch of FAMILY_EVAL_DIALOGS dialogs (eval_pair); each path's
    launches must be the family's kernels (path_kernels)."""
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.profile_train import flagship_setup

    rows = []
    for label, encoder, opts in FAMILIES:
        t0 = time.perf_counter()
        cfg, batches, state0 = flagship_setup(dev, 1, encoder=encoder, **opts)
        reset_launches()
        step = compare_steps(cfg, state0, batches[0], seed=1)
        train_launches = kernel_launches()
        check_launches(train_launches, cfg, True, f"{label} train")
        split, vocab = make_random_split(cfg, num_dialogs=FAMILY_EVAL_DIALOGS,
                                         seed=2)
        ev = eval_pair(scaled(state0.params, EVAL_SCALE), split, vocab, cfg,
                       dev, f"{label} eval")
        row = {"phase": "families", "family": label, "model": f"{encoder}-disc",
               "img_spatial": cfg.img_spatial,
               "lf_hist_incremental": cfg.lf_hist_incremental,
               "train_launches": train_launches, "dropout0": step,
               "eval_launches": ev.pop("launches"), "eval": ev,
               "wall_s": time.perf_counter() - t0}
        emit(row)
        rows.append(row)
        del state0, batches
        torch.cuda.empty_cache()
    return rows


def gen_serve(dev) -> dict:
    """The gen serving path: InferenceEngine on flagship MN-QIH-gen weights
    answers REQUESTS greedily and by beam search (5); tokens equal the
    plain path's on the card."""
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.infer import InferenceEngine
    from visdial_tpu_torch.models.model import model_init

    base = Config(encoder="mn-ques-im-hist", decoder="gen", dropout=0.0)
    split, vocab = make_random_split(base, num_dialogs=8,
                                     num_unique_answers=50_000, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=0, device=dev)
    reset_launches()
    eng = InferenceEngine(params=params, cfg=cfg, data=split, vocab=vocab,
                          device=dev)
    eng.generate_answer("is it sunny ?")                         # warm-up
    answers, lat_ms = {0: [], 5: []}, {0: [], 5: []}
    for beam in (0, 5):
        for question, caption, history in REQUESTS:
            t0 = time.perf_counter()
            answers[beam].append(eng.generate_answer(question, caption, history,
                                                     beam_size=beam))
            lat_ms[beam].append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    check(launches["lstm_layer"] > 0 and launches["attention_fusion"] > 0,
          f"a kernel of the gen serving path never launched: {launches}")
    plain = InferenceEngine(params=params, cfg=cfg.replace(use_pallas=False),
                            data=split, vocab=vocab, device=dev)
    check(plain.impl == "plain" and eng.impl == "cuda", "impl routing")
    lp_err = 0.0
    for beam in (0, 5):
        for (question, caption, history), got in zip(REQUESTS, answers[beam]):
            want = plain.generate_answer(question, caption, history,
                                         beam_size=beam)
            # decoded words carry no spaces: equal answers, equal tokens
            check(got["answer"] == want["answer"], f"gen answer (beam {beam}) "
                  f"differs from the plain path's: {got} vs {want}")
            check(math.isfinite(got["log_prob"]),
                  f"non-finite log-prob {got['log_prob']}")
            lp_err = max(lp_err, abs(got["log_prob"] - want["log_prob"]))
    check(lp_err <= SCORE_TOL, f"gen log-prob err {lp_err} > {SCORE_TOL}")
    row = {"phase": "gen_serve", "model": "mn-ques-im-hist-gen",
           "vocab": cfg.vocab_size, "requests": len(REQUESTS),
           "launches": launches, "log_prob_max_abs_err": lp_err}
    for beam, name in ((0, "greedy"), (5, "beam5")):
        lat = sorted(lat_ms[beam])
        row[name] = {"p50_ms": lat[len(lat) // 2], "max_ms": lat[-1],
                     "answer0": answers[beam][0]["answer"],
                     "log_prob0": answers[beam][0]["log_prob"]}
    emit(row)
    return row


def read_jsonl(text: str) -> list[dict]:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def train_cli() -> dict:
    """Train 4 steps through the CLI (eval and checkpoints on the way), then
    resume to step 6."""
    save = os.path.join(SMOKE_DIR, "smoke_train")
    shutil.rmtree(save, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "visdial_tpu_torch.train", "--synthetic", "64",
            "--encoder", "mn-ques-im-hist", "--decoder", "disc",
            "--eval_every", "4", "--save_every", "2", "--log_every", "1",
            "--save_path", save, "--run_name", "smoke"]
    runs = []
    for extra in (["--max_steps", "4"], ["--max_steps", "6", "--resume"]):
        proc = subprocess.run(base + extra, capture_output=True, text=True,
                              timeout=600, cwd=ROOT, env=env)
        check(proc.returncode == 0, f"train CLI {extra} exited "
              f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        runs.append(read_jsonl(proc.stdout))
    first, second = runs
    kinds = {e["event"] for e in first}
    check({"config", "train", "eval", "checkpoint", "done"} <= kinds,
          f"train CLI events: {sorted(kinds)}")
    evals = [e for e in first if e["event"] == "eval"]
    check(len(evals) == 1 and math.isfinite(evals[0]["mrr"])
          and evals[0]["step"] == 4, f"train CLI eval: {evals}")
    check([e["step"] for e in first if e["event"] == "checkpoint"] == [2, 4],
          "train CLI checkpoints at steps 2 and 4")
    check(first[-1]["event"] == "done" and first[-1]["step"] == 4,
          f"train CLI done: {first[-1]}")
    resumed = [e for e in second if e["event"] == "resumed"]
    steps = [e["step"] for e in second if e["event"] == "train"]
    check(len(resumed) == 1 and resumed[0]["from"].endswith("step_00000004")
          and steps == [5, 6] and second[-1]["event"] == "done"
          and second[-1]["step"] == 6,
          f"train CLI resume: {resumed} train steps {steps}")
    # gen: 2 steps with an eval at the end
    gen = [a if a != "disc" else "gen" for a in base]
    gen[gen.index("smoke")] = "smoke_gen"
    proc = subprocess.run(gen + ["--max_steps", "2", "--eval_every", "2"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env=env)
    check(proc.returncode == 0, f"gen train CLI exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    gen_events = read_jsonl(proc.stdout)
    gen_evals = [e for e in gen_events if e["event"] == "eval"]
    check(len(gen_evals) == 1 and gen_evals[0]["step"] == 2
          and math.isfinite(gen_evals[0]["mrr"])
          and gen_events[-1]["event"] == "done",
          f"gen train CLI: {gen_evals} {gen_events[-1:]}")
    row = {"phase": "train_cli", "losses": [e["loss"] for e in first + second
                                            if e["event"] == "train"],
           "mrr": evals[0]["mrr"], "resumed_from": 4,
           "final_step": second[-1]["step"], "final_mrr": second[-1]["final_mrr"],
           "gen_losses": [e["loss"] for e in gen_events if e["event"] == "train"],
           "gen_mrr": gen_evals[0]["mrr"]}
    emit(row)
    return row


def evaluate_cli() -> dict:
    """The evaluate CLI on the checkpoint train_cli wrote (MN-QIH-disc,
    step 6) over a --synthetic split, with the v1.0 rankings dump: the JAX
    CLI's JSON keys, and every dumped ranking a permutation of 1..100."""
    run = os.path.join(SMOKE_DIR, "smoke_train", "smoke")
    ranks_path = os.path.join(run, "ranks.json")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "visdial_tpu_torch.evaluate", "--load_path",
         os.path.join(run, "step_00000006"), "--synthetic", "64",
         "--save_ranks", ranks_path],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    check(proc.returncode == 0, f"evaluate CLI exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    lines = read_jsonl(proc.stdout)
    keys = {"model", "split", "mrr", "r@1", "r@5", "r@10", "mean_rank",
            "num_examples", "evals_per_sec", "eval_seconds",
            # the resident eval, the CLI's default
            "resident_cache_seconds", "resident_cache_bytes", "cold_compile"}
    check(len(lines) == 1 and set(lines[0]) == keys
          and lines[0]["model"] == "mn-ques-im-hist-disc"
          and lines[0]["num_examples"] == 640 and math.isfinite(lines[0]["mrr"]),
          f"evaluate CLI output: {proc.stdout[-2000:]}")
    with open(ranks_path) as f:
        sub = json.load(f)
    perm = list(range(1, 101))
    check(len(sub) == 640 and all(sorted(e["ranks"]) == perm for e in sub)
          and {e["round_id"] for e in sub} == set(range(1, 11)),
          f"evaluate CLI --save_ranks: {len(sub)} entries")
    row = {"phase": "evaluate_cli", **lines[0], "dumped_rounds": len(sub)}
    emit(row)
    return row


def run_cli(main, argv: list) -> tuple:
    """A CLI's main(argv) in this process, so that its kernel launches
    count, with its standard output captured: (return value, JSON lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, read_jsonl(buf.getvalue())


def eval_resident(dev) -> list[dict]:
    """The resident and staged evals: flagship MN-QIH-disc and MN-QIH-gen
    over gen_eval's 256-dialog split.  A cold resident run (the cache
    built; its launches are the path's), then EVAL_REPS runs of each path
    in turn: resident (warm), staged stream and the plain versions
    (streaming).  Ranks: resident and staged equal, and equal to plain but
    for near ties (as in `evaluate`); candidate rankings (collect_rankings)
    equal between resident and staged; a 16-byte cap streams (no
    resident_* keys)."""
    import numpy as np

    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.models.model import model_init, model_option_table

    rows = []
    for decoder in ("disc", "gen"):
        base = Config(encoder="mn-ques-im-hist", decoder=decoder, dropout=0.0)
        split, vocab = make_random_split(base, num_dialogs=EVAL_DIALOGS, seed=1)
        cfg = base.replace(vocab_size=vocab.size)
        params = model_init(cfg, seed=0, device=dev)
        if decoder == "disc":
            params = scaled(params, EVAL_SCALE)
        what = f"eval_resident {decoder}"

        def run(impl, resident, collect=False, **kw):
            return evaluate_split(params, split, vocab, cfg, dev, impl=impl,
                                  return_ranks=True, collect_rankings=collect,
                                  resident=resident, **kw)

        reset_launches()
        cold, cold_ranks = run("cuda", True)
        launches = kernel_launches()
        check_launches(launches, cfg, False, what)
        check(cold.get("cold_compile") is True
              and {"resident_cache_seconds", "resident_cache_bytes"} <= set(cold),
              f"{what}: first resident run {cold}")
        reset_launches()
        run("cuda", False)                          # warms the staged path
        staged_launches = kernel_launches()
        check_launches(staged_launches, cfg, False, what + " staged")
        run("plain", False)
        paths = {"resident": ("cuda", True), "staged": ("cuda", False),
                 "plain": ("plain", False)}
        runs = {p: [] for p in paths}
        for _ in range(EVAL_REPS):
            for p, (impl, res) in paths.items():
                runs[p].append(run(impl, res))
        check(all("cold_compile" not in m and "resident_cache_bytes" in m
                  for m, _ in runs["resident"]), f"{what}: warm resident keys")
        rounds = EVAL_DIALOGS * cfg.num_rounds
        ref = runs["resident"][0][1]
        check(len(ref) == rounds and np.array_equal(ref, cold_ranks),
              f"{what}: resident ranked {len(ref)} rounds")
        for p, rs in runs.items():
            check(all(np.array_equal(r, rs[0][1]) for _, r in rs),
                  f"{what} ({p}): ranks differ between repeated runs")
        check(np.array_equal(runs["staged"][0][1], ref),
              f"{what}: staged ranks differ from the resident ones")
        diff = np.abs(runs["plain"][0][1] - ref)
        check(diff.max() <= 1 and (diff > 0).sum() <= rounds // 1000,
              f"{what}: ranks of {int((diff > 0).sum())} of {rounds} rounds "
              f"differ from the plain path's, by up to {diff.max()}")
        _, _, cand = run("cuda", True, collect=True)
        _, _, cand_staged = run("cuda", False, collect=True)
        _, _, cand_plain = run("plain", False, collect=True)
        check(cand.shape == (EVAL_DIALOGS, cfg.num_rounds, cfg.num_options)
              and np.array_equal(cand, cand_staged)
              and (np.sort(cand, -1) == np.arange(1, cfg.num_options + 1)).all(),
              f"{what}: resident candidate rankings differ from the staged ones")
        capped = run("cuda", True, resident_max_bytes=16)[0]
        check(not any(k.startswith("resident_") or k == "cold_compile"
                      for k in capped) and capped["mrr"] == runs["staged"][0][0]["mrr"],
              f"{what}: the byte cap did not stream: {capped}")
        rates = {p: [m["evals_per_sec"] for m, _ in rs] for p, rs in runs.items()}
        extra = {}
        if decoder == "disc":
            # the resident rate includes the option table's build (the JAX
            # harness's timing), the staged and plain ones exclude it
            opt_list = torch.from_numpy(split.opt_list).long().to(dev)
            with torch.inference_mode():
                extra = {"option_rows": int(opt_list.shape[0]),
                         "table_build_ms": time_ms(lambda: model_option_table(
                             params, opt_list, cfg, impl="cuda"), reps=3)}
        row = {"phase": "eval_resident", "model": f"mn-ques-im-hist-{decoder}",
               "dialogs": EVAL_DIALOGS, "rounds": rounds, "reps": EVAL_REPS,
               "launches": launches, "staged_launches": staged_launches,
               "mrr": cold["mrr"],
               "cold_compile": cold["cold_compile"],
               "cold_evals_per_sec": cold["evals_per_sec"],
               "resident_cache_seconds": cold["resident_cache_seconds"],
               "resident_cache_bytes": cold["resident_cache_bytes"],
               "evals_per_sec": statistics.median(rates["resident"]),
               "staged_evals_per_sec": statistics.median(rates["staged"]),
               "plain_evals_per_sec": statistics.median(rates["plain"]),
               "evals_per_sec_runs": rates["resident"],
               "staged_evals_per_sec_runs": rates["staged"],
               "plain_evals_per_sec_runs": rates["plain"],
               "rank_mismatches_vs_plain": int((diff > 0).sum()),
               "cand_rounds_differing_from_plain":
                   int((cand != cand_plain).any(-1).sum()),
               "capped_keys": sorted(capped), **extra}
        emit(row)
        rows.append(row)
        del params
        torch.cuda.empty_cache()
    return rows


def eval_scores(params, split, vocab, cfg, dev, impl: str) -> torch.Tensor:
    """(dialogs, R, K) candidate scores of `split`: disc through the option
    table (disc_scores), gen through model_scores on the candidate
    tokens."""
    from visdial_tpu_torch.data.loader import EvalLoader
    from visdial_tpu_torch.models.model import batch_to_device, model_scores

    if cfg.decoder == "disc":
        return disc_scores(params, split, vocab, cfg, dev, impl)
    out = []
    with torch.inference_mode():
        for b in EvalLoader(split, vocab, cfg):
            s = model_scores(params, batch_to_device(b.as_dict(), dev), cfg,
                             impl=impl)
            out.append(s[torch.from_numpy(b.dialog_valid.astype(bool)).to(dev)])
    return torch.cat(out)


def eval_bf16(dev) -> list[dict]:
    """The resident eval of flagship MN-QIH disc and gen at bf16 over
    EVAL_DIALOGS dialogs (as eval_resident runs it at f32): a cold run (its
    launches are the path's), then EVAL_REPS timed runs; against the plain
    path at bf16: scores within the decoder's SCORE_TOL_BF16, MRR within
    MRR_TOL_BF16, and a ground truth's rank may move from the plain path's
    by at most the number of candidates whose plain score lies within twice
    the measured score error of its own (a bf16 near tie; the rounds with
    such candidates and the moved ranks are counted)."""
    import numpy as np

    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.models.model import model_init

    rows = []
    for decoder in ("disc", "gen"):
        base = Config(encoder="mn-ques-im-hist", decoder=decoder, dropout=0.0,
                      compute_dtype="bfloat16")
        split, vocab = make_random_split(base, num_dialogs=EVAL_DIALOGS, seed=1)
        cfg = base.replace(vocab_size=vocab.size)
        params = model_init(cfg, seed=0, device=dev)
        if decoder == "disc":
            params = scaled(params, EVAL_SCALE)
        what, tol = f"eval_bf16 {decoder}", SCORE_TOL_BF16[decoder]

        def run(impl, resident):
            return evaluate_split(params, split, vocab, cfg, dev, impl=impl,
                                  return_ranks=True, resident=resident)

        reset_launches()
        calls = tensor_core_calls()
        cold, rk = run("cuda", True)
        launches = kernel_launches()
        check_launches(launches, cfg, False, what)
        check_contractions(tensor_core_calls() - calls, cfg, what)
        rates = [run("cuda", True)[0]["evals_per_sec"] for _ in range(EVAL_REPS)]
        mp, rp = run("plain", False)
        s_k = eval_scores(params, split, vocab, cfg, dev, "cuda")
        s_p = eval_scores(params, split, vocab, cfg, dev, "plain")
        err = float((s_k - s_p).abs().max())
        check(bool(torch.isfinite(s_k).all()) and err <= tol,
              f"{what}: score err {err} > {tol}")
        # two scores each off by at most err can change order only where
        # they lie within 2 err, so a ground truth's rank may move by at
        # most the number of candidates whose plain score is that close
        gt = torch.from_numpy(split.gt_ind).long().to(dev)[..., None]
        close = ((s_p - s_p.gather(-1, gt)).abs() <= 2 * err).sum(-1) - 1
        close = close.flatten().cpu().numpy()
        moved = np.abs(rk.astype(np.int64) - rp.astype(np.int64))
        check(len(rk) == len(rp) == close.size and (moved <= close).all(),
              f"{what}: {int((moved > close).sum())} ranks moved further "
              f"from the plain path's than the candidates within 2 x the "
              f"score error ({2 * err}) allow")
        mrr_err = abs(cold["mrr"] - mp["mrr"])
        check(mrr_err <= MRR_TOL_BF16, f"{what}: mrr {cold['mrr']} against "
              f"plain {mp['mrr']} (tol {MRR_TOL_BF16})")
        row = {"phase": "eval_bf16", "model": f"mn-ques-im-hist-{decoder}",
               "dtype": "bfloat16", "dialogs": EVAL_DIALOGS,
               "rounds": int(len(rk)), "launches": launches,
               "mrr": cold["mrr"], "plain_mrr": mp["mrr"], "mrr_err": mrr_err,
               "mrr_tol": MRR_TOL_BF16, "score_max_abs_err": err,
               "score_tol": tol,
               "near_tie_rounds": int((close > 0).sum()),
               "rank_flips": int((moved > 0).sum()),
               "rank_moved_max": int(moved.max()),
               "evals_per_sec": statistics.median(rates),
               "evals_per_sec_runs": rates,
               "plain_evals_per_sec": mp["evals_per_sec"]}
        emit(row)
        rows.append(row)
        del params, s_k, s_p
        torch.cuda.empty_cache()
    return rows


def contraction_checks(dev, k2_rows) -> list[dict]:
    """The contraction helper (ops/contract.py) on bf16 operands at the
    training step's head shapes, against a float64 product of the same
    operands (relative to its largest |value|, within CONTRACT_TOL), each
    beside a planted control (the same GEMM with a bf16 output, which the
    limit must refuse) and the upcast route the port ran before (f32 copies,
    then an f32 GEMM, TF32 off), timed in the same call: the option LSTM's
    dW (x^T . dgp over CONTRACT_ROWS rows at E 300 and 512) and dx (dgp .
    Wx^T), and TokenLogprobFn's dx (dlog . W^T) and dW (x^T . dlog) at
    LM_HEAD.  Then LSTMLayerFn's whole bf16 backward at the head beside
    cuDNN's bf16 backward (lstm_bwd_checks)."""
    from visdial_tpu_torch.ops.contract import mm_f32

    g = torch.Generator(device=dev).manual_seed(11)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()

    M, G = CONTRACT_ROWS, 4 * 512
    NT, H, V = LM_HEAD
    dgp = rand(M, G, scale=0.01)
    dlog, xl = rand(NT, V, scale=1e-3), torch.tanh(rand(NT, H))
    cases = [("lstm_dw", rand(M, E, scale=0.5).T, dgp) for E in (300, 512)]
    cases += [("lstm_dx", dgp, rand(300, G, scale=0.08).T),
              ("lm_dx", dlog, rand(H, V, scale=0.1).T),
              ("lm_dw", xl.T, dlog)]
    rows = []
    for site, a, b in cases:
        shape = [a.shape[0], a.shape[1], b.shape[1]]
        got = mm_f32(a, b)
        ref = a.double() @ b.double()
        scale = float(ref.abs().max())
        err = float((got.double() - ref).abs().max()) / scale
        control = float((torch.mm(a, b).double() - ref).abs().max()) / scale
        del ref
        check(got.dtype == torch.float32 and err <= CONTRACT_TOL < control,
              f"contraction {site} {shape}: rel err {err} (tol {CONTRACT_TOL}), "
              f"bf16-output control {control} must exceed it")
        ops = 2.0 * shape[0] * shape[1] * shape[2]
        nbytes = 2 * (a.numel() + b.numel()) + 4 * got.numel()
        row = {"phase": "contraction", "site": site, "shape": shape,
               "dtype": "bfloat16", "max_rel_err": err, "tol": CONTRACT_TOL,
               "control_err": control,
               "ms": time_ms(lambda: mm_f32(a, b)),
               "upcast_ms": time_ms(lambda: a.float() @ b.float()),
               **bound(ops, nbytes, "bfloat16")}
        emit(row)
        rows.append(row)
        del got
    head = next(r for r in k2_rows if r["shape"] == list(LSTM_HEAD)
                and r["dtype"] == "bfloat16" and not r["sparse_g_hs"])
    row = {"phase": "contraction", "site": "lstm_layer_fn_backward",
           "shape": list(LSTM_HEAD), "dtype": "bfloat16",
           "bwd_ms": head["bwd_ms"], "k2_ms": head["ms"],
           "library_ms": head["library_ms"], "library": head["library"]}
    emit(row)
    rows.append(row)
    del dgp, dlog, cases
    torch.cuda.empty_cache()
    return rows


def integration(dev) -> list[dict]:
    """The port's two learning bars on the card through the kernels, in f32
    and in bf16, at the CPU tests' configs and step counts
    (tests/test_torch_lf_integration.py: LF-QIH-disc, MRR > 0.8 at 300
    steps; tests/test_torch_gen.py::test_gen_decoder_learns_to_rank_above_
    chance: MN-QH-gen, MRR > 0.6 at 400): the CPU tests' small_config with
    use_pallas on, the same synthetic split and init, the loss falling as
    those tests require, then evaluate_split on the card."""
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.loader import TrainLoader
    from visdial_tpu_torch.data.synthetic import make_synthetic_split
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.models.model import batch_to_device
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       train_step)

    rows = []
    for label, fields, steps, bar in INTEGRATION:
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            base = Config(**{**SMALL_CONFIG, **fields, "compute_dtype": dtype})
            split, vocab = make_synthetic_split(base, num_dialogs=32, seed=0)
            cfg = base.replace(vocab_size=vocab.size)
            state = init_train_state(cfg, device=dev)
            loader, losses = TrainLoader(split, vocab, cfg), []
            reset_launches()
            calls = tensor_core_calls()
            while len(losses) < steps:
                for b in loader.epoch(seed=len(losses)):
                    state, m = train_step(
                        state, batch_to_device(b.as_dict(), dev), cfg)
                    losses.append(m["loss"])
                    if len(losses) == steps:
                        break
            losses = torch.stack(losses).tolist()
            what = f"integration {label} {dtype}"
            launches = kernel_launches()
            check_launches(launches, cfg, True, what)
            check_contractions(tensor_core_calls() - calls, cfg, what)
            first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
            mrr = evaluate_split(state.params, split, vocab, cfg, dev)["mrr"]
            check(all(map(math.isfinite, losses))
                  and last < first * (0.5 if cfg.decoder == "disc" else 1.0)
                  and mrr > bar, f"{what}: loss {first} -> {last}, mrr {mrr} "
                  f"(bar {bar})")
            row = {"phase": "integration_bf16", "model": f"{cfg.encoder}-{cfg.decoder}",
                   "label": label, "dtype": dtype, "steps": steps,
                   "launches": launches, "loss_first5": first,
                   "loss_last5": last, "mrr": mrr, "mrr_bar": bar,
                   "wall_s": time.perf_counter() - t0}
            emit(row)
            rows.append(row)
    return rows


def dense_entries(split, cfg) -> list[dict]:
    """Dense targets built from the split as tests/test_finetune.py builds
    them: relevance 1.0 on a fixed non-ground-truth slot of round 2."""
    out = []
    for i in range(split.num_dialogs):
        rel = [0.0] * cfg.num_options
        rel[(int(split.gt_ind[i, 1]) + 2) % cfg.num_options] = 1.0
        out.append({"image_id": int(split.img_ids[i]), "round_id": 2,
                    "gt_relevance": rel})
    return out


def finetune(dev) -> dict:
    """Dense fine-tuning of the MN-QIH-disc checkpoint train_cli wrote
    (flagship width, its --synthetic data): the first dense step on the
    kernel path against the plain path at dropout 0 and 0.5
    (compare_steps), FT_STEPS timed steps (the loss falls, NDCG on the
    annotated rounds rises; their launches), then the finetune CLI in this
    process for the same steps: its events, its NDCG and loss, and a
    checkpoint that reloads."""
    from visdial_tpu_torch.data.loader import DenseLoader
    from visdial_tpu_torch.data.synthetic import make_synthetic_split
    from visdial_tpu_torch.finetune import main as finetune_main
    from visdial_tpu_torch.finetune import ndcg_on_entries
    from visdial_tpu_torch.models.model import batch_to_device, model_dense_loss
    from visdial_tpu_torch.parallel.optim import init_opt_state
    from visdial_tpu_torch.parallel.train_step import TrainState, train_step
    from visdial_tpu_torch.utils.checkpoint import load_checkpoint, load_train_state

    load = os.path.join(SMOKE_DIR, "smoke_train", "smoke", "step_00000006")
    params, cfg, _ = load_checkpoint(load, dev)
    check(cfg.encoder == "mn-ques-im-hist" and cfg.decoder == "disc"
          and cfg.rnn_hidden_size == 512 and cfg.num_options == 100,
          f"finetune: the checkpoint is {cfg.encoder}-{cfg.decoder}")
    split, vocab = make_synthetic_split(cfg, num_dialogs=FT_DIALOGS,
                                        seed=cfg.seed + 1)
    dense = dense_entries(split, cfg)
    dense_path = os.path.join(SMOKE_DIR, "smoke_dense.json")
    with open(dense_path, "w") as f:
        json.dump(dense, f)
    cfg = cfg.replace(learning_rate=FT_LR, lr_decay_rate=1.0)
    loader = DenseLoader(split, vocab, cfg, dense)
    check(len(loader) == FT_DIALOGS and loader.skipped == 0,
          f"finetune: {len(loader)} usable entries, {loader.skipped} skipped")
    batches, epoch = [], 0
    while len(batches) < FT_STEPS:          # the CLI's order (--seed 0)
        batches += [batch_to_device(b, dev) for b in loader.epoch(seed=epoch)]
        epoch += 1
    state0 = TrainState(params, init_opt_state(params, cfg),
                        torch.Generator().manual_seed(0))
    row = {"phase": "finetune", "model": "mn-ques-im-hist-disc",
           "batch_dialogs": cfg.batch_size, "dense_rows": int(
               batches[0]["dense_opt"].shape[0] * batches[0]["dense_opt"].shape[1]),
           "lr": FT_LR, "dropout": cfg.dropout,
           "dropout0": compare_steps(cfg.replace(dropout=0.0), state0,
                                     batches[0], seed=1,
                                     loss_fn=model_dense_loss),
           "dropout05": compare_steps(cfg.replace(dropout=0.5), state0,
                                      batches[0], seed=2,
                                      loss_fn=model_dense_loss)}
    before = ndcg_on_entries(params, split, vocab, cfg, dev, dense)
    reset_launches()
    state, losses, times = state0, [], []
    for b in batches[:FT_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg, loss_fn=model_dense_loss)
        losses.append(float(m["loss"]))          # reads back: synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    check_launches(launches, cfg, True, "finetune")
    after = ndcg_on_entries(state.params, split, vocab, cfg, dev, dense)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and after["ndcg"] > before["ndcg"],
          f"finetune: loss {losses[0]} -> {losses[-1]}, NDCG {before} -> {after}")
    reset_launches()
    out, events = run_cli(finetune_main, [
        "--load_path", load, "--dense_json", dense_path,
        "--synthetic", str(FT_DIALOGS), "--steps", str(FT_STEPS),
        "--learning_rate", str(FT_LR), "--eval_every", str(FT_STEPS // 2),
        "--log_every", "5", "--save_path", SMOKE_DIR, "--run_name",
        "smoke_ft"])
    cli_launches = kernel_launches()
    check(all(cli_launches[k] > 0 for k in ("lstm_layer", "lstm_layer_bwd",
                                             "attention", "attention_fusion")),
          f"finetune CLI launches {cli_launches}")
    ndcg = [e for e in events if e["event"] == "ndcg"]
    steps = [e["step"] for e in events if e["event"] == "finetune"]
    check([e["step"] for e in ndcg] == [0, FT_STEPS // 2, FT_STEPS, FT_STEPS]
          and steps == list(range(1, FT_STEPS + 1))
          and events[-1]["event"] == "checkpoint"
          and out["last_loss"] < out["first_loss"]
          and out["ndcg_after"] > out["ndcg_before"],
          f"finetune CLI: {out}, events {[e['event'] for e in events]}")
    reloaded, rcfg, _ = load_train_state(out["checkpoint"], dev)
    check(reloaded.opt.step == FT_STEPS and rcfg.learning_rate == FT_LR,
          f"finetune CLI checkpoint: step {reloaded.opt.step}")
    row.update({"steps": FT_STEPS, "launches": launches,
                "cli_launches": cli_launches, "loss_first": losses[0],
                "loss_last": losses[-1], "ndcg_before": before["ndcg"],
                "ndcg_after": after["ndcg"], "ndcg_rounds": after["ndcg_rounds"],
                "step_ms": statistics.median(times),
                "cli": {k: out[k] for k in ("ndcg_before", "ndcg_after",
                                            "first_loss", "last_loss")}})
    emit(row)
    return row


def generate(dev) -> dict:
    """The generate CLI in this process on the gen checkpoint train_cli
    wrote (MN-QIH-gen, flagship width), against the plain versions on the
    card (the same params in a checkpoint whose config has use_pallas
    off): greedy strings equal and log-probs within SCORE_TOL; beam 5
    equal where the best beams' scores do not tie (within SCORE_TOL); the
    vis/ JSON contract; and on a test-style split (no round with a ground
    truth) every round that has a question kept."""
    import numpy as np

    from visdial_tpu_torch.data.synthetic import make_synthetic_split
    from visdial_tpu_torch.generate import main as generate_main
    from visdial_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    ckpt = os.path.join(SMOKE_DIR, "smoke_train", "smoke_gen", "step_00000002")
    params, cfg, _ = load_checkpoint(ckpt, dev)
    check(cfg.decoder == "gen" and cfg.rnn_hidden_size == 512,
          f"generate: the checkpoint is {cfg.encoder}-{cfg.decoder}")
    plain_ckpt = save_checkpoint(os.path.join(SMOKE_DIR, "smoke_gen_plain"),
                                 params, cfg.replace(use_pallas=False))

    def cli(path, name, *extra):
        out = os.path.join(SMOKE_DIR, f"generated_{name}.json")
        run_cli(generate_main, ["--load_path", path, "--out_path", out,
                                "--num_dialogs", "0", *extra])
        with open(out) as f:
            return json.load(f)

    syn = ["--synthetic", str(GEN_DIALOGS)]
    reset_launches()
    got = cli(ckpt, "greedy", *syn)
    launches = kernel_launches()
    need = {"lstm_layer", "attention_fusion"}
    check(all(launches[k] > 0 for k in need)
          and all(n == 0 for k, n in launches.items() if k not in need),
          f"generate launches {launches}: the encoder's K1 and K4 only")
    want = cli(plain_ckpt, "greedy_plain", *syn)
    beam = cli(ckpt, "beam5", *syn, "--beam_size", "5")
    beam_plain = cli(plain_ckpt, "beam5_plain", *syn, "--beam_size", "5")
    lp_err, beam_ties, n_rounds = 0.0, 0, 0
    for data in (got, want, beam):
        check(data["model"] == "mn-ques-im-hist-gen" and data["split"] == "val"
              and len(data["dialogs"]) == GEN_DIALOGS
              and all(set(d) == {"image_id", "caption", "rounds"}
                      and len(d["rounds"]) == cfg.num_rounds
                      and all(set(r) == {"question", "gt_answer", "generated",
                                         "log_prob"}
                              and isinstance(r["generated"], str)
                              and math.isfinite(r["log_prob"])
                              for r in d["rounds"])
                      for d in data["dialogs"]), "generate: vis/ JSON contract")
    for g, w in zip(got["dialogs"], want["dialogs"]):
        for gr, wr in zip(g["rounds"], w["rounds"]):
            n_rounds += 1
            check(gr["generated"] == wr["generated"],
                  f"generate: greedy {gr} differs from the plain run's {wr}")
            lp_err = max(lp_err, abs(gr["log_prob"] - wr["log_prob"]))
    for g, w in zip(beam["dialogs"], beam_plain["dialogs"]):
        for gr, wr in zip(g["rounds"], w["rounds"]):
            d = abs(gr["log_prob"] - wr["log_prob"])
            lp_err = max(lp_err, d)
            if gr["generated"] != wr["generated"]:
                beam_ties += 1
                check(d <= SCORE_TOL, f"generate: beam 5 {gr} differs from "
                      f"the plain run's {wr} beyond a score tie")
    check(lp_err <= SCORE_TOL, f"generate: log-prob err {lp_err}")
    # a v1.0 test-style split: dialog i asks 1 + i % R questions, no round
    # has a ground truth, the last asked round has its candidates
    split, vocab = make_synthetic_split(cfg, num_dialogs=GEN_DIALOGS,
                                        seed=cfg.seed + 1)
    asked = 1 + np.arange(GEN_DIALOGS) % cfg.num_rounds
    split.round_valid[:] = 0
    split.round_scoreable[:] = 0
    for i, k in enumerate(asked):
        split.ques[i, k:] = 0
        split.ques_len[i, k:] = 0
        split.round_scoreable[i, k - 1] = 1
    data_dir = os.path.join(SMOKE_DIR, "smoke_test_split")
    os.makedirs(data_dir, exist_ok=True)
    split.save(os.path.join(data_dir, "visdial_data_test.npz"))
    vocab.save(os.path.join(data_dir, "visdial_params.json"))
    test = cli(ckpt, "test", "--data_dir", data_dir, "--split", "test")
    kept = [len(d["rounds"]) for d in test["dialogs"]]
    check(test["split"] == "test" and kept == asked.tolist()
          and all(r["question"] for d in test["dialogs"] for r in d["rounds"]),
          f"generate: the test-style split kept {kept} rounds, asked {asked}")
    row = {"phase": "generate", "model": "mn-ques-im-hist-gen",
           "dialogs": GEN_DIALOGS, "rounds": n_rounds, "launches": launches,
           "log_prob_max_abs_err": lp_err, "beam5_score_ties": beam_ties,
           "greedy0": got["dialogs"][0]["rounds"][0],
           "test_split_rounds_kept": int(sum(kept))}
    emit(row)
    return row


def sweep(dev) -> dict:
    """The sweep CLI in this process over MN-QIH x {disc, gen} at flagship
    width, --max_steps 2 on a 64-dialog --synthetic split (the train CLI's
    eval on its 16 val dialogs at step 2, resident): both pairs in the
    results table with metrics in range; the runs launch all six kernels."""
    from visdial_tpu_torch.sweep import main as sweep_main

    out = os.path.join(SMOKE_DIR, "sweep_results.json")
    reset_launches()
    results, events = run_cli(sweep_main, [
        "--encoders", "mn-ques-im-hist", "--decoders", "disc,gen",
        "--synthetic", "64", "--max_steps", "2",
        "--save_path", os.path.join(SMOKE_DIR, "smoke_sweep"), "--out", out])
    launches = kernel_launches()
    check(all(n > 0 for n in launches.values()),
          f"sweep launches {launches}: every kernel")
    with open(out) as f:
        table = json.load(f)
    names = ["mn-ques-im-hist-disc", "mn-ques-im-hist-gen"]
    check(sorted(table) == names == sorted(results)
          and all(0.0 <= v["mrr"] <= 1.0 and 1.0 <= v["mean_rank"] <= 100.0
                  and all(0.0 <= v[k] <= 1.0 for k in ("r@1", "r@5", "r@10"))
                  and v["num_examples"] == 16 * 10
                  and "resident_cache_bytes" in v for v in table.values()),
          f"sweep results table: {table}")
    done = [e for e in events if e.get("event") == "sweep_done"]
    check([e["model"] for e in done] == names
          and events[-1] == {"event": "sweep_complete", "out": out, "models": 2},
          f"sweep events: {events[-3:]}")
    row = {"phase": "sweep", "models": names, "launches": launches,
           **{n: {k: table[n][k] for k in ("mrr", "mean_rank", "train_seconds")}
              for n in names}}
    emit(row)
    return row


def serve(dev, encoder: str = "mn-ques-im-hist", phase: str = "serve",
          beside: dict | None = None, dtype: str = "float32") -> dict:
    """A serving path: flagship <encoder>-disc served over a 50k-answer
    pool in `dtype` (the main path with MN-QIH; `beside`, another serve
    row, puts its latencies next to this one's).  In bf16 the params are
    scaled as the disc evals' (EVAL_SCALE) so that the ranks it checks
    are not near ties of the init scale, and every request's top-1 answer
    must be the plain path's."""
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.infer import InferenceEngine
    from visdial_tpu_torch.models.model import model_init

    base = Config(encoder=encoder, decoder="disc", dropout=0.0,
                  compute_dtype=dtype)
    split, vocab = make_random_split(base, num_dialogs=8,
                                     num_unique_answers=50_000, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=0, device=dev)
    score_tol = SCORE_TOL
    if dtype != "float32":
        params, score_tol = scaled(params, EVAL_SCALE), SERVE_TOL_BF16

    reset_launches()
    calls = tensor_core_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = InferenceEngine(params=params, cfg=cfg, data=split, vocab=vocab,
                          device=dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    answers, lat_ms = [], []
    eng.rank_answers("is it sunny ?")                            # warm-up
    for question, caption, history in REQUESTS:
        t0 = time.perf_counter()
        answers.append(eng.rank_answers(question, caption, history, top_k=5))
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    launches = kernel_launches()
    check_launches(launches, cfg, False, phase)
    check_contractions(tensor_core_calls() - calls, cfg, phase)

    # the same requests through the plain versions on the same card
    plain = InferenceEngine(params=params, cfg=cfg.replace(use_pallas=False),
                            data=split, vocab=vocab, device=dev)
    check(plain.impl == "plain" and eng.impl == "cuda", "impl routing")
    check(tuple(eng.table.shape) == (50_000, cfg.rnn_hidden_size)
          and bool(torch.isfinite(eng.table).all()), "answer table shape/finite")
    table_err = float((eng.table.float() - plain.table.float()).abs().max())
    check(table_err <= TOL[dtype], f"answer table err {table_err}")
    scores = [(eng.pool_scores(*req), plain.pool_scores(*req))
              for req in REQUESTS]
    score_err = max(float((s_k - s_p).abs().max()) for s_k, s_p in scores)
    check(score_err <= score_tol, f"served score err {score_err} > {score_tol}")
    # the k-th of two score lists each within score_err of the other differ
    # by at most score_err, so a place may hold another answer only where
    # the plain scores of the two lie within 2 score_err (bf16; f32 keeps
    # the limit it had)
    allow = score_tol if dtype == "float32" else 2 * score_err
    near_ties, top1_equal, top1_gaps = 0, 0, []
    for (s_k, s_p), got in zip(scores, answers):
        check(bool(torch.isfinite(s_k).all()), "non-finite served scores")
        top_k = torch.topk(s_k, 5).indices.tolist()
        best_p, top_p = torch.topk(s_p, 5)
        top_p = top_p.tolist()
        check([a["answer"] for a in got]
              == [" ".join(vocab.decode(split.opt_list[i])) for i in top_k],
              "rank_answers disagrees with its own pool scores")
        top1_equal += top_k[0] == top_p[0]
        top1_gaps.append(float(best_p[0] - best_p[1]))
        for i, j in zip(top_k, top_p):
            if i != j:
                near_ties += 1
                check(abs(float(s_p[i] - s_p[j])) <= allow,
                      f"top-k differs from the plain run: {top_k} vs {top_p}")
    if dtype != "float32":
        check(top1_equal == len(REQUESTS), f"{phase}: top-1 answer differs "
              f"from the plain run's in {len(REQUESTS) - top1_equal} requests")
    lat_ms.sort()
    row = {"phase": phase, "model": f"{encoder}-disc", "dtype": dtype,
           "vocab": cfg.vocab_size, "pool": int(split.opt_list.shape[0]),
           "requests": len(REQUESTS), "launches": launches,
           "table_build_s": table_s, "p50_ms": lat_ms[len(lat_ms) // 2],
           "max_ms": lat_ms[-1], "table_max_abs_err": table_err,
           "score_max_abs_err": score_err, "score_tol": score_tol,
           "topk_near_ties": near_ties, "top1_equal_plain": top1_equal,
           "top1_plain_gap_min": min(top1_gaps),
           "top1": answers[0][0]["answer"]}
    if beside:
        row.update({f"{beside['model']}_p50_ms": beside["p50_ms"],
                    f"{beside['model']}_max_ms": beside["max_ms"]})
    emit(row)
    return {"row": row, "params": params, "cfg": cfg}


def serve_cli(params, cfg) -> dict:
    """Write a checkpoint with the port's writer and drive the CLI on it."""
    from visdial_tpu_torch.utils.checkpoint import save_checkpoint

    path = save_checkpoint(os.path.join(ROOT, "build", "visdial_tpu_torch",
                                        "smoke_ckpt"), params, cfg)
    queries = [{"question": "is it sunny ?", "caption": "a park",
                "history": [["is there a dog ?", "yes"]]},
               {"question": "what color is the car ?"}]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "visdial_tpu_torch.infer", "--load_path", path,
         "--synthetic", "8", "--top_k", "5"],
        input="".join(json.dumps(q) + "\n" for q in queries),
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    check(proc.returncode == 0, f"infer CLI exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    check(len(lines) == 3 and lines[0].get("event") == "ready",
          f"infer CLI output: {proc.stdout[-2000:]}")
    check(all(len(ln.get("answers", [])) == 5 for ln in lines[1:]),
          f"infer CLI answers: {lines[1:]}")
    row = {"phase": "serve_cli", "answer_lines": len(lines) - 1,
           "top1": [ln["answers"][0]["answer"] for ln in lines[1:]]}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# the mesh, the vocab shards, the verify gate and VGG-16
# ---------------------------------------------------------------------------

def _first_step(state, batch, cfg, mesh=None):
    """(flat clipped gradients, flat params after one train_step) of one
    step from `state` (copied, not advanced), at generator seed 1."""
    from visdial_tpu_torch.parallel.optim import clip_by_global_norm
    from visdial_tpu_torch.parallel.train_step import (TrainState,
                                                       loss_and_grads,
                                                       train_step)
    from visdial_tpu_torch.utils.params import flatten

    _, grads = loss_and_grads(state.params, batch, cfg,
                              torch.Generator().manual_seed(1), mesh=mesh)
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    st = TrainState(state.params, state.opt, torch.Generator().manual_seed(1))
    new, m = train_step(st, batch, cfg, mesh=mesh)
    return flatten(grads), flatten(new.params), m["lr"]


def _ddp_rank(rank: int, steps: int) -> dict:
    """One rank of a 2-card NCCL world (run_ranks): `steps` mesh steps of
    MN-QIH-disc on its shard of the flagship batches, and rank 0 holding
    them against one device on the global batches: per step the loss and
    grad norm; the first step's gradients and params to compare_steps'
    limits (first_step_errs); the final params' largest difference."""
    from visdial_tpu_torch.parallel.mesh import make_mesh
    from visdial_tpu_torch.parallel.train_step import (shard_train_state,
                                                       train_step)
    from visdial_tpu_torch.profile_train import flagship_setup
    from visdial_tpu_torch.utils.params import flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(2, 1, "cuda")
    cfg, batches, state = flagship_setup(mesh.device, steps,
                                         shard=mesh.data_shard)
    state = shard_train_state(state, cfg, mesh)
    g2, p2, lr = _first_step(state, batches[0], cfg, mesh)
    out = []
    for b in batches:
        state, m = train_step(state, b, cfg, mesh=mesh)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    if not mesh.is_main:
        return {}
    cfg, batches, one = flagship_setup(mesh.device, steps)
    g1, p1, _ = _first_step(one, batches[0], cfg)
    grad_err, param_err, param_excess = first_step_errs(p2, g2, p1, g1, lr,
                                                        cfg)
    want = []
    for b in batches:
        one, m = train_step(one, b, cfg)
        want.append((float(m["loss"]), float(m["grad_norm"])))
    pm, p1 = flatten(state.params), flatten(one.params)
    return {"steps": out, "want": want, "grad_max_rel_err": grad_err,
            "first_param_max_abs_err": param_err,
            "first_param_excess": param_excess,
            "param_max_abs_err": max(float((pm[k] - p1[k]).abs().max())
                                     for k in p1)}


def ddp(dev) -> dict:
    """The mesh step (parallel/train_step.py) in a world-1 NCCL group made
    in this process: DDP_STEPS MN-QIH-disc and -gen steps bit for bit
    equal to the one-device train_step on the same batches at dropout 0
    (every collective of a world of one is the identity), then the train
    CLI with --mesh_data 1 under that group; with two cards, 2 NCCL ranks
    against one device on the same global batches, to compare_steps' f32
    limits."""
    import torch.distributed as dist

    from visdial_tpu_torch import train as train_cli_mod
    from visdial_tpu_torch.parallel.launch import free_port, run_ranks
    from visdial_tpu_torch.parallel.mesh import make_mesh
    from visdial_tpu_torch.parallel.train_step import (TrainState,
                                                       shard_train_state,
                                                       train_step)
    from visdial_tpu_torch.profile_train import flagship_setup
    from visdial_tpu_torch.utils.params import flatten

    os.environ.update({"MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", rank=0, world_size=1)
    row = {"phase": "ddp", "steps": DDP_STEPS}
    try:
        mesh = make_mesh(1, 1, "cuda")
        setups = {d: flagship_setup(dev, DDP_STEPS, decoder=d)
                  for d in ("disc", "gen")}

        def run(decoder, mesh_or_none):
            cfg, batches, state0 = setups[decoder]
            state = TrainState(state0.params, state0.opt,
                               torch.Generator().manual_seed(1))
            if mesh_or_none is not None:
                state = shard_train_state(state, cfg, mesh_or_none)
            metrics, times = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = train_step(state, b, cfg, mesh=mesh_or_none)
                metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return state, metrics, statistics.median(times)

        single = {d: run(d, None) for d in setups}
        reset_launches()
        meshed = {d: run(d, mesh) for d in setups}
        launches = kernel_launches()
        for d in setups:
            (s1, m1, ms1), (sm, mm, msm) = single[d], meshed[d]
            p1, pm = flatten(s1.params), flatten(sm.params)
            same = (all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                        for a, b in zip(m1, mm))
                    and all(torch.equal(p1[k], pm[k]) for k in p1))
            check(same, f"ddp {d}: the world-1 mesh step differs from "
                  f"train_step: losses {[float(a[0]) for a in m1]} vs "
                  f"{[float(a[0]) for a in mm]}")
            row[d] = {"bitwise_equal": same,
                      "losses": [float(a[0]) for a in mm],
                      "step_ms": msm, "train_step_ms": ms1,
                      "overhead": msm / ms1 - 1}
        cfg = setups["disc"][0]
        check_launches(launches, cfg.replace(decoder="gen"), True, "ddp")
        row["launches"] = launches
        # the train CLI on the mesh, in this process and group
        save = os.path.join(SMOKE_DIR, "smoke_ddp")
        shutil.rmtree(save, ignore_errors=True)
        _, events = run_cli(train_cli_mod.main, [
            "--synthetic", "64", "--encoder", "mn-ques-im-hist",
            "--mesh_data", "1", "--max_steps", "2", "--eval_every", "2",
            "--save_every", "2", "--log_every", "1", "--save_path", save,
            "--run_name", "ddp"])
        kinds = [e["event"] for e in events]
        config = next(e for e in events if e["event"] == "config")
        trains = [e for e in events if e["event"] == "train"]
        check(config["devices"] == 1 and config["mesh_data"] == 1
              and {"train", "eval", "checkpoint", "done"} <= set(kinds)
              and all(e["rounds_per_sec_per_chip"] == e["rounds_per_sec"]
                      for e in trains),
              f"ddp train CLI events: {kinds}")
        row["cli_losses"] = [e["loss"] for e in trains]
        row["cli_mrr"] = next(e for e in events if e["event"] == "eval")["mrr"]
    finally:
        dist.destroy_process_group()
    ranks = 1
    if torch.cuda.device_count() >= 2:
        ranks = 2
        got = run_ranks(_ddp_rank, 2, DDP_STEPS, timeout=600)[0]
        for (l2, n2), (l1, n1) in zip(got["steps"], got["want"]):
            check(abs(l2 - l1) <= LOSS_TOL and abs(n2 / n1 - 1) <= GNORM_RTOL,
                  f"ddp 2 ranks: loss {l2} vs {l1}, grad_norm {n2} vs {n1}")
        check(got["grad_max_rel_err"] <= TRAIN_GRAD_TOL
              and got["first_param_excess"] <= 0.0,
              f"ddp 2 ranks, first step against one device: grad rel err "
              f"{got['grad_max_rel_err']} (tol {TRAIN_GRAD_TOL}), param err "
              f"{got['first_param_max_abs_err']} exceeding its bound by "
              f"{got['first_param_excess']}")
        row.update({"two_rank_losses": [l for l, _ in got["steps"]],
                    "two_rank_grad_max_rel_err": got["grad_max_rel_err"],
                    "two_rank_first_param_max_abs_err":
                        got["first_param_max_abs_err"],
                    "two_rank_param_max_abs_err": got["param_max_abs_err"]})
    row["ddp_ranks"] = ranks
    emit(row)
    return row


def vocab_shards(dev, gen) -> dict:
    """K5 and K6 on M column shards of the flagship LM head (2,880 rows, H
    512): M = 2 and 4 of V 8,804 and M = 2 of V 8,806 (shards of an odd
    4,403 columns), targets re-based to each shard and -1 outside it,
    combined in this process as the model axis combines them
    (ops/lm_loss.py), against the whole-vocab kernels and the plain
    versions: logp, lse, d-logits and dx = sum of the shards'."""
    from visdial_tpu_torch.ops.lm_loss import combine_shards, target_logit
    from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,
                                                lm_token_logprobs_lse_plain)
    from visdial_tpu_torch.ops.lm_score_cuda import (lm_dlogits,
                                                     lm_token_logprobs_lse)
    from visdial_tpu_torch.parallel.mesh import VocabShard

    NT, H, _ = LM_HEAD
    rows, errs = [], {}
    whole = {}
    for V in (8804, 8806):
        x = torch.tanh(torch.randn(NT, H, generator=gen)).to(dev)
        w = (torch.randn(H, V, generator=gen) * 0.1).to(dev)
        b = (torch.randn(V, generator=gen) * 0.1).to(dev)
        tgt = torch.randint(0, V, (NT,), generator=gen)
        tgt[::4] = 0
        g = torch.randn(NT, generator=gen)
        g[tgt == 0] = 0.0
        tgt, g = tgt.to(dev), g.to(dev)
        # the references, outside the counted run
        wl, wse = lm_token_logprobs_lse(x, w, b, tgt)
        wd = lm_dlogits(x, w, b, tgt, wse, g).float()
        pl, pse = lm_token_logprobs_lse_plain(x, w, b, tgt)
        pd = lm_dlogits_plain(x, w, b, tgt, pse, g).float()
        whole[V] = (x, w, b, tgt, g, (wl, wse, wd, wd @ w.T),
                    (pl, pse, pd, pd @ w.T))
    reset_launches()
    outs = {}
    for V, M in ((8804, 2), (8804, 4), (8806, 2)):
        x, w, b, tgt, g, _, _ = whole[V]
        parts = []
        for m in range(M):
            shard = VocabShard(m, M, V // M, None)
            cols = slice(shard.lo, shard.lo + shard.size)
            local = shard.local_ids(tgt)
            ws, bs = w[:, cols].contiguous(), b[cols].contiguous()
            logp, lse = lm_token_logprobs_lse(x, ws, bs, local)
            parts.append((ws, bs, local, lse, target_logit(logp, lse, local)))
        logp, lse = combine_shards(torch.stack([p[3] for p in parts]),
                                   torch.stack([p[4] for p in parts]))
        dlog = [lm_dlogits(x, ws, bs, local, lse, g).float()
                for ws, bs, local, _, _ in parts]
        dx = sum(d @ p[0].T for d, p in zip(dlog, parts))
        outs[(V, M)] = (logp, lse, torch.cat(dlog, dim=1), dx)
    torch.cuda.synchronize()
    launches = kernel_launches()
    check(launches["lm_score"] == 8 and launches["lm_dlogits"] == 8,
          f"vocab_shards launches {launches}")
    for (V, M), got in outs.items():
        *_, kern, plain = whole[V]
        tol = LM_TOL * max(1.0, float(kern[0].abs().max()))
        row = {"V": V, "shards": M, "shard_cols": V // M}
        for ref_name, ref in (("kernel", kern), ("plain", plain)):
            e_lp = abs_err(got[:2], ref[:2])
            e_d = rel_err([got[2]], [ref[2]])
            e_dx = rel_err([got[3]], [ref[3]])
            row[f"vs_{ref_name}"] = {"logp_lse_max_abs_err": e_lp,
                                     "dlogits_max_rel_err": e_d,
                                     "dx_max_rel_err": e_dx}
            check(e_lp <= tol and e_d <= SHARD_RTOL and e_dx <= SHARD_RTOL,
                  f"vocab_shards V {V} M {M} vs {ref_name}: logp/lse err "
                  f"{e_lp} (tol {tol}), d-logits {e_d}, dx {e_dx} (tol "
                  f"{SHARD_RTOL})")
        rows.append(row)
    # the shard route's time: K5 and K6 on one of two shards at the head
    x, w, b, tgt, g, _, _ = whole[8804]
    shard = VocabShard(0, 2, 4402, None)
    ws, bs = w[:, :4402].contiguous(), b[:4402].contiguous()
    local = shard.local_ids(tgt)
    lse = lm_token_logprobs_lse(x, ws, bs, local)[1]
    timing = {"shape": [NT, H, 4402],
              "lm_score_ms": time_ms(lambda: lm_token_logprobs_lse(x, ws, bs, local)),
              "lm_dlogits_ms": time_ms(lambda: lm_dlogits(x, ws, bs, local, lse, g)),
              "lm_score_plain_ms": time_ms(
                  lambda: lm_token_logprobs_lse_plain(x, ws, bs, local)),
              "lm_dlogits_plain_ms": time_ms(
                  lambda: lm_dlogits_plain(x, ws, bs, local, lse, g)),
              "lm_score_bound": lm_bound(NT, H, 4402, "float32"),
              "lm_dlogits_bound": lm_bound(NT, H, 4402, "float32", dlogits=True)}
    row = {"phase": "vocab_shards", "cases": rows, "launches": launches,
           "half_shard": timing, "tol_rel": SHARD_RTOL}
    emit(row)
    return row


def verify_phase() -> dict:
    """visdial_tpu_torch.verify.main(["--scale", "flagship"]) in this
    process: every check ok; each check's max_rel_err beside its rel_tol."""
    from visdial_tpu_torch import verify

    reset_launches()
    t0 = time.perf_counter()
    rc, lines = run_cli(verify.main, ["--scale", "flagship"])
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    res = lines[-1]
    check(rc == 0 and res["ok"] and len(res["checks"]) == 22,
          "verify: failing checks "
          + str([c for c in res["checks"] if not c["ok"]]))
    check(all(n > 0 for n in launches.values()),
          f"verify launches {launches}")
    row = {"phase": "verify", "ok": res["ok"], "scale": res["scale"],
           "device_name": res["device_name"], "seconds": seconds,
           "launches": launches,
           "checks": {c["name"]: [c["max_rel_err"], c["rel_tol"]]
                      for c in res["checks"]}}
    emit(row)
    return row


def bench_phase() -> dict:
    """visdial_tpu_torch.bench.bench_port in this process at the default
    flagship configuration (the gate first, every row, BENCH_STEPS steps),
    without the Torch-CPU baseline: the line's keys are the JAX line's plus
    the port's, every rate finite and positive, both MFUs in (0, 1], the
    counted steps the CPU's count, and every kernel launched by the rows
    measured after the gate."""
    from visdial_tpu_torch import bench

    args = bench.parse_args(["--steps", str(BENCH_STEPS)])
    reset_launches()
    t0 = time.perf_counter()
    stats = bench.bench_port(args)
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    check(stats["kernel_check"]["ok"], "bench: the kernel gate failed")
    keys = set(stats) | BENCH_MAIN_KEYS
    want = BENCH_JAX_KEYS | BENCH_PORT_KEYS
    check(keys == want, f"bench keys: missing {sorted(want - keys)}, "
          f"extra {sorted(keys - want)}")
    check(set(stats["realistic"]) == BENCH_REALISTIC_KEYS,
          f"bench realistic keys {sorted(stats['realistic'])}")

    def numbers(d):
        for k, v in d.items():
            if isinstance(v, bool) or k in ("kernel_check", "kernel_launches"):
                continue
            if isinstance(v, dict):
                yield from numbers(v)
            elif isinstance(v, list):
                yield from ((k, x) for x in v)
            elif isinstance(v, (int, float)):
                yield k, v

    bad = [(k, v) for k, v in numbers(stats)
           if not (math.isfinite(v) and v > 0)]
    check(not bad, f"bench: numbers not finite and positive {bad}")
    for k in ("train_mfu", "gen_train_mfu"):
        check(0 < stats[k] <= 1, f"bench: {k} {stats[k]}")
    for k, n in BENCH_FLOPS.items():
        check(stats[k] == n, f"bench: {k} {stats[k]} against the CPU's {n}")
    check(all(n > 0 for n in stats["kernel_launches"].values()),
          f"bench: kernels not launched by the rows {stats['kernel_launches']}")
    row = {"phase": "bench", "seconds": seconds, "launches": launches,
           "line": stats}
    emit(row)
    return row


def _timed_dispatches(fn, state, stack, n: int):
    """n calls of fn(state, stack) between synchronisations: (state, each
    call's metrics, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = []
    for _ in range(n):
        state, m = fn(state, stack)
        ms.append(m)
    torch.cuda.synchronize()
    return state, ms, time.perf_counter() - t0


def graph_train_point(dev, decoder: str, batch_size: int, dtype: str,
                      mesh=None, remat: bool = False,
                      group: int | None = None,
                      dispatches: int = GRAPH_DISPATCHES) -> dict:
    """One bench point (bench.flagship_config: dropout 0.5, full-length
    random batches, `group` steps a dispatch, by default the bench's
    TRAIN_DISPATCH_GROUP) trained eagerly
    (multi_train_step, over `mesh` when one is given) and through
    make_multistep_train_fn's graph (over the same mesh) from one init, in
    turns (eager, graph, graph, eager; `dispatches` dispatches a turn after
    a first dispatch each): every dispatch's losses, grad norms, lr and
    step, the params, moments and CPU generator at the end bit for bit;
    one capture; a dispatch's kernel launches and collectives equal on both
    paths (over a mesh, at least one collective); rounds/s a path (the
    mean of its two turns) and peak memory a path (both states resident).
    Over a mesh, `batch_size` dialogs a rank, each data rank on batches
    of its own."""
    from visdial_tpu_torch.bench import TRAIN_DISPATCH_GROUP, flagship_config
    from visdial_tpu_torch.data.synthetic import random_batch
    from visdial_tpu_torch.models.model import batch_to_device
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       make_multistep_train_fn,
                                                       multi_train_step,
                                                       shard_train_state)

    group = group or TRAIN_DISPATCH_GROUP
    cfg = flagship_config(decoder=decoder, batch_size=batch_size,
                          compute_dtype=dtype).replace(remat=remat)
    d = mesh.d if mesh is not None else 0
    host = [random_batch(cfg, seed=100 * d + s) for s in range(group)]
    stack = batch_to_device({k: np.stack([b[k] for b in host])
                             for k in host[0]}, dev)
    graph_fn = make_multistep_train_fn(cfg, mesh)
    fns = {"eager": partial(multi_train_step, cfg=cfg, mesh=mesh),
           "graph": graph_fn}
    states = {}
    for path in fns:
        states[path] = init_train_state(cfg, device=dev, seed=0)
        if mesh is not None:
            states[path] = shard_train_state(states[path], cfg, mesh)
    metrics = {"eager": [], "graph": []}
    seconds = {"eager": 0.0, "graph": 0.0}
    peak, counts = {}, {}
    for path in fns:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        states[path], ms, first_s = _timed_dispatches(fns[path], states[path],
                                                      stack, 1)
        metrics[path] += ms
        counts[path] = mesh_counts()
        peak[path] = torch.cuda.max_memory_allocated(dev)
        seconds[f"{path}_first"] = first_s
    what = (f"{decoder} batch {batch_size} {dtype}" + (" remat" if remat
                                                        else ""))
    if mesh is not None:
        what = f"mesh {mesh.data}x{mesh.model} {what}"
    for path in ("eager", "graph", "graph", "eager"):
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        states[path], ms, sec = _timed_dispatches(fns[path], states[path],
                                                  stack, dispatches)
        seconds[path] += sec
        metrics[path] += ms
        peak[path] = max(peak[path], torch.cuda.max_memory_allocated(dev))
        per = {k: n // dispatches for k, n in mesh_counts().items()}
        check(per == counts[path], f"{what}: {path} counts a dispatch {per} "
              f"against the first's {counts[path]}")
    check(graph_fn.captures == 1, f"{what}: {graph_fn.captures} captures")
    check(counts["graph"] == counts["eager"], f"{what}: graph counts "
          f"{counts['graph']} against eager {counts['eager']}")
    check(mesh is None or counts["graph"]["collectives"] > 0,
          f"{what}: no collective issued")
    check_launches(counts["graph"], cfg, True, what)
    for me, mg in zip(metrics["eager"], metrics["graph"]):
        for k in ("loss", "grad_norm", "lr", "step"):
            check(torch.equal(me[k], mg[k]), f"{what}: {k} {mg[k].tolist()} "
                  f"against eager {me[k].tolist()}")
    _states_equal(states["eager"], states["graph"], what)
    check(all(math.isfinite(x) for m in metrics["graph"]
              for x in m["loss"].tolist()), f"{what}: non-finite losses")
    rounds = 2 * dispatches * group * batch_size * cfg.num_rounds
    row = {"point": what, "decoder": decoder, "batch_dialogs": batch_size,
           "dtype": dtype, "remat": remat, "dropout": cfg.dropout,
           "steps_a_dispatch": group, "dispatches_timed": 2 * dispatches,
           "captures": graph_fn.captures, "counts_a_dispatch": counts["graph"],
           "loss_last": metrics["graph"][-1]["loss"].tolist()[-1],
           "bit_equal": True}
    if mesh is not None:
        row["mesh"] = [mesh.data, mesh.model]
    for path in ("eager", "graph"):
        row[f"{path}_rounds_per_s"] = rounds / seconds[path]
        row[f"{path}_step_ms"] = seconds[path] / (
            2 * dispatches * group) * 1e3
        row[f"{path}_first_dispatch_s"] = seconds[f"{path}_first"]
        row[f"{path}_peak_mem_gb"] = peak[path] / 2 ** 30
    del states, fns, graph_fn, stack
    _release()                   # the graph (a cycle through its body) and pool
    return row


def graph_serve_point(dev, decoder: str, beam: int = 0) -> dict:
    """Serving at the bench's point (bench.bench_serving: flagship weights
    in bf16, a 50,000-answer pool): each of REQUESTS through the engine's
    graphed serve function and through its eager body (the same host work:
    tokenizer, batch assembly, one readback), in turns over GRAPH_SERVE_ROUNDS
    rounds; the packed outputs equal, one capture, p50 / p95 a path."""
    from visdial_tpu_torch.bench import SERVING_ANSWERS, SERVING_DIALOGS
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.infer import InferenceEngine
    from visdial_tpu_torch.models.model import model_init

    base = Config(encoder="mn-ques-im-hist", decoder=decoder, dropout=0.0,
                  compute_dtype="bfloat16")
    split, vocab = make_random_split(base, num_dialogs=SERVING_DIALOGS,
                                     num_unique_answers=SERVING_ANSWERS, seed=0)
    cfg = base.replace(vocab_size=vocab.size)
    eng = InferenceEngine(params=model_init(cfg, seed=0, device=dev), cfg=cfg,
                          data=split, vocab=vocab, device=dev)
    served = eng.serve_disc if decoder == "disc" else eng.serve_gen
    static = 5 if decoder == "disc" else beam
    paths = {"graph": served, "eager": served.fn}

    def call(path, req):
        question, caption, history = req
        batch, t = eng._batch(caption, history, question, None)
        return paths[path](batch, eng._round(t), static).cpu()

    outs = {"eager": [], "graph": []}
    lat = {"eager": [], "graph": []}
    reset_launches()
    call("graph", REQUESTS[0])                               # capture
    call("eager", REQUESTS[0])
    for r in range(GRAPH_SERVE_ROUNDS):
        for path in (("eager", "graph") if r % 2 else ("graph", "eager")):
            for req in REQUESTS:
                t0 = time.perf_counter()
                out = call(path, req)
                lat[path].append((time.perf_counter() - t0) * 1e3)
                if r == 0:
                    outs[path].append(out)
    what = f"graphs serve {decoder}" + (f" beam {beam}" if beam else "")
    check(served.captures == 1, f"{what}: {served.captures} captures")
    for a, b in zip(outs["eager"], outs["graph"]):
        check(torch.equal(a, b), f"{what}: graphed {b.tolist()} against eager "
              f"{a.tolist()}")
    launches = kernel_launches()
    check(launches["lstm_layer"] > 0 and launches["attention_fusion"] > 0,
          f"{what}: launches {launches}")
    row = {"decoder": decoder, "beam": beam, "dtype": cfg.compute_dtype,
           "pool": int(split.opt_list.shape[0]),
           "requests": len(lat["graph"]), "captures": served.captures,
           "equal": True, "launches": launches}
    for path in ("eager", "graph"):
        xs = sorted(lat[path])
        row[f"{path}_p50_ms"] = xs[len(xs) // 2]
        row[f"{path}_p95_ms"] = xs[int(len(xs) * 0.95)]
    return row


def _leaves(out) -> list:
    from torch.utils import _pytree as pytree

    return [x for x in pytree.tree_leaves(out)
            if isinstance(x, (torch.Tensor, np.ndarray))]


def _equal(a, b) -> bool:
    """Two outputs bit for bit: every tensor or array leaf equal."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor)
        else np.array_equal(x, y) for x, y in zip(la, lb))


def graph_turns(dev, what: str, calls: dict, reps: int, units: float) -> dict:
    """calls["eager"] and calls["graph"] (() -> outputs), each called once
    (the graph's capture) from an emptied allocator cache, then in turns
    (eager, graph, graph, eager) `reps` calls a turn between
    synchronisations: every call's outputs bit for bit the first eager
    call's, a call's launches equal on both paths (replays counted),
    `units` a call per second a path over its two turns.  Memory, the
    device memory each path reserves over what was reserved before its
    first call: eager's peak over that call, its allocations made in a
    fresh pool (torch.cuda.MemPool) so that they take new segments as a
    graph's private pool does; the graph's kept after its capture (its
    pool, buffers and params copy; the warm-up's blocks released) and its
    peak over the replayed call that follows (what it keeps and what a
    call allocates).  Checked: the graph's peak at most GRAPH_PEAK_RATIO
    times eager's."""
    first, launches, seconds, mem = {}, {}, {}, {}
    for path in ("eager", "graph"):
        reset_launches()
        _release()
        reserved = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if path == "eager":
            pool = torch.cuda.MemPool()
            with torch.cuda.use_mem_pool(pool):
                first[path] = calls[path]()
        else:
            first[path] = calls[path]()
        torch.cuda.synchronize(dev)
        seconds[f"{path}_first"] = time.perf_counter() - t0
        launches[path] = kernel_launches()
        if path == "eager":
            mem["eager_peak_gb"] = (torch.cuda.max_memory_reserved(dev)
                                    - reserved) / 2 ** 30
            continue
        _release()            # the warm-up's blocks go; the graph's stay
        mem["graph_kept_gb"] = (torch.cuda.memory_reserved(dev)
                                - reserved) / 2 ** 30
        torch.cuda.reset_peak_memory_stats(dev)
        calls[path]()
        torch.cuda.synchronize(dev)
        mem["graph_peak_gb"] = (torch.cuda.max_memory_reserved(dev)
                                - reserved) / 2 ** 30
    check(_equal(first["graph"], first["eager"]),
          f"{what}: the graph's first call differs from eager")
    calls["eager"]()                  # refill the allocator's emptied cache
    for path in ("eager", "graph", "graph", "eager"):
        reset_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = calls[path]()
            check(_equal(out, first["eager"]),
                  f"{what}: {path} outputs differ from the first eager call's")
        torch.cuda.synchronize(dev)
        seconds[path] = seconds.get(path, 0.0) + time.perf_counter() - t0
        per = {k: n // reps for k, n in kernel_launches().items()}
        check(per == launches[path], f"{what}: {path} launches a call {per} "
              f"against its first call's {launches[path]}")
    check(launches["graph"] == launches["eager"],
          f"{what}: graph launches {launches['graph']} against eager "
          f"{launches['eager']}")
    mem["graph_over_eager_peak"] = mem["graph_peak_gb"] / mem["eager_peak_gb"]
    check(mem["graph_peak_gb"] <= GRAPH_PEAK_RATIO * mem["eager_peak_gb"],
          f"{what}: graphed peak {mem['graph_peak_gb']:.4f} GB (kept "
          f"{mem['graph_kept_gb']:.4f}) over {GRAPH_PEAK_RATIO}x eager's "
          f"{mem['eager_peak_gb']:.4f}")
    row = {"point": what, "bit_equal": True, "launches": launches["graph"],
           **mem}
    for path in ("eager", "graph"):
        row[f"{path}_per_s"] = 2 * reps * units / seconds[path]
        row[f"{path}_ms_a_call"] = seconds[path] / (2 * reps) * 1e3
        row[f"{path}_first_s"] = seconds[f"{path}_first"]
    del first, pool
    return row


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def graph_eval_points(dev) -> list[dict]:
    """The eval factories and evaluate_split graphed against their eager
    functions at the bench's points in bf16 (bench_eval: disc at batch 32,
    gen at 64, random_batch, random weights; the disc table over
    TABLE_ROWS answers; bench_harness_e2e: HARNESS_DIALOGS dialogs over
    HARNESS_ANSWERS answers, streaming and resident, disc and gen)."""
    from visdial_tpu_torch.bench import (GEN_BATCH, HARNESS_ANSWERS,
                                         HARNESS_DIALOGS, TABLE_ROWS,
                                         flagship_config)
    from visdial_tpu_torch.data.synthetic import make_random_split, random_batch
    from visdial_tpu_torch.eval_harness import _GenBucketPlan, evaluate_split
    from visdial_tpu_torch.models.model import batch_to_device, model_init
    from visdial_tpu_torch.parallel.train_step import (make_disc_table_eval_fns,
                                                       make_eval_fn,
                                                       make_gen_bucket_eval_fns)

    rows = []
    for decoder, bs in (("disc", 32), ("gen", GEN_BATCH)):
        cfg = flagship_config(decoder=decoder, batch_size=bs)
        params = model_init(cfg, seed=cfg.seed, device=dev)
        batch = batch_to_device(random_batch(cfg, seed=0), dev)
        fn = make_eval_fn(cfg)

        def eager(f=fn):
            with torch.inference_mode():
                return f.fn(params, batch)

        row = graph_turns(dev, f"eval {decoder} batch {bs}",
                          {"eager": eager, "graph": partial(fn, params, batch)},
                          reps=GRAPH_EVAL_REPS, units=bs * cfg.num_rounds)
        rows.append({**row, "captures": fn.captures, "replays": fn.replays,
                     "unit": "rounds"})
        if decoder == "disc":
            opt_list = torch.from_numpy(np.random.default_rng(0).integers(
                1, cfg.vocab_size - 3, (TABLE_ROWS, cfg.max_ans_len))).to(dev)
            table_fn, score_fn = make_disc_table_eval_fns(cfg)

            def eager_table():
                with torch.inference_mode():
                    table = table_fn.fn(params, opt_list)
                    return table, [score_fn.fn(params, table, batch)
                                   for _ in range(GRAPH_TABLE_BATCHES)]

            def graph_table():
                # as the bench calls them: the factories' params copy, the
                # table read where its graph wrote it (score_fn in its pool)
                p = table_fn.held.load(params)
                table = table_fn(p, opt_list, clone=False)
                return table, [score_fn(p, table, batch)
                               for _ in range(GRAPH_TABLE_BATCHES)]

            row = graph_turns(
                dev, f"table eval {decoder} {TABLE_ROWS} answers",
                {"eager": eager_table, "graph": graph_table},
                reps=1, units=GRAPH_TABLE_BATCHES * bs * cfg.num_rounds)
            rows.append({**row, "captures": table_fn.captures
                         + score_fn.captures, "unit": "rounds, the table "
                         f"build and {GRAPH_TABLE_BATCHES} batches a call"})
        del params, batch, fn
        _release()
    for decoder in ("disc", "gen"):
        cfg = flagship_config(decoder=decoder)
        split, vocab = make_random_split(cfg, num_dialogs=HARNESS_DIALOGS,
                                         num_unique_answers=HARNESS_ANSWERS,
                                         seed=0)
        cfg = cfg.replace(vocab_size=vocab.size)
        params = model_init(cfg, seed=cfg.seed, device=dev)
        fns = (make_disc_table_eval_fns if decoder == "disc"
               else make_gen_bucket_eval_fns)(cfg)
        key = "table_fns" if decoder == "disc" else "gen_fns"
        for resident in (False, True):
            def run(f, resident=resident):
                _, ranks, cand = evaluate_split(
                    params, split, vocab, cfg, dev, return_ranks=True,
                    collect_rankings=True, resident=resident, **{key: f})
                return ranks, cand

            path = "resident" if resident else "stream"
            # the split's device tables and resident stacks are built
            # before the memory measure, which is of the eval alone
            run(tuple(f.fn for f in fns))
            row = graph_turns(
                dev, f"evaluate_split {decoder} {path}",
                {"eager": partial(run, tuple(f.fn for f in fns)),
                 "graph": partial(run, fns)},
                reps=1, units=HARNESS_DIALOGS * cfg.num_rounds)
            if resident:
                res = next(iter(split._torch_resident_eval.values()))
                (entry,) = res.graphs.values()
                row.update(captures=res.captures, batches=len(res.keep),
                           replays=entry.graph.replays)
                # four graphed runs: the capture's (batch 0 its warm-up),
                # the peak measure's and two turns
                check(res.captures == 1 and entry.graph.replays
                      == 4 * len(res.keep) - 1,
                      f"evaluate_split {decoder} resident: {res.captures} "
                      f"captures, {entry.graph.replays} replays over 4 runs "
                      f"of {len(res.keep)} batches")
            else:
                # the factories' graphs replayed a batch: one capture each
                # (gen: one row graph a width bucket)
                widths = (len(_GenBucketPlan.cached(split, cfg.batch_size)
                              .active) if decoder == "gen" else 1)
                row.update(captures=[f.captures for f in fns],
                           replays=[f.replays for f in fns])
                check([f.captures for f in fns] == [1, widths],
                      f"evaluate_split {decoder} stream: "
                      f"{[f.captures for f in fns]} captures")
            rows.append({**row, "unit": "rounds"})
        del params, fns, split
        _release()
    return rows


def graph_generate_points(dev) -> list[dict]:
    """generate's decode (one graph over the params it closes over, as the
    CLI builds it) against its eager body over GEN_DIALOGS dialogs of a
    random split at the bench's gen point in bf16 (batch 32): greedy, beam
    5 and sampled (temperature 0.8, each pass from a generator seeded
    GRAPH_SAMPLE_SEED, the graph's registered)."""
    from visdial_tpu_torch.bench import flagship_config
    from visdial_tpu_torch.data.loader import EvalLoader
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.generate import _decode
    from visdial_tpu_torch.models.model import batch_to_device, model_init
    from visdial_tpu_torch.parallel.graph import InferenceGraphed

    cfg = flagship_config(decoder="gen").replace(dropout=0.0)
    split, vocab = make_random_split(cfg, num_dialogs=GEN_DIALOGS, seed=2)
    cfg = cfg.replace(vocab_size=vocab.size)
    params = model_init(cfg, seed=cfg.seed, device=dev)
    batches = [batch_to_device(b.as_dict(), dev) for b in EvalLoader(
        split, vocab, cfg, option_tokens=False)]
    body = partial(_decode, params, cfg)
    rows = []
    for mode, greedy, beam in (("greedy", True, 0), ("beam5", True, 5),
                               ("sample", False, 0)):
        graph = InferenceGraphed(body)
        gen = (torch.Generator(device=dev) if not greedy else None)

        def decode(graphed):
            if gen is not None:
                gen.manual_seed(GRAPH_SAMPLE_SEED)
            args = (vocab.start, vocab.end, greedy, 0.8, beam, gen)
            if graphed:
                return [graph(b, *args, generators=[gen] if gen else [])
                        for b in batches]
            with torch.inference_mode():
                return [body(b, *args) for b in batches]

        row = graph_turns(dev, f"generate {mode}",
                          {"eager": partial(decode, False),
                           "graph": partial(decode, True)},
                          reps=GRAPH_EVAL_REPS, units=GEN_DIALOGS)
        rows.append({**row, "captures": graph.captures,
                     "replays": graph.replays, "batches": len(batches),
                     "unit": "dialogs"})
        check(graph.captures == 1, f"generate {mode}: {graph.captures} "
              "captures")
        del graph
    del params, batches, body
    _release()
    return rows


def graph_vgg_points(dev) -> list[dict]:
    """prepro_img's VGG-16 forward (one graph over the params it closes
    over) against vgg16.apply at batch 64, f32 (TF32 off) and bf16, on
    seeded images and He-scaled random weights: fc7 and pool5 bit for
    bit."""
    from visdial_tpu_torch.models import vgg16
    from visdial_tpu_torch.parallel.graph import Graphed

    x = torch.from_numpy(vgg16.preprocess(np.random.default_rng(3).integers(
        0, 256, (64, 224, 224, 3), dtype=np.uint8), origin="torchvision"))
    x = x.to(dev)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        params = vgg16.init_params(torch.Generator().manual_seed(0), he=True,
                                   dtype=dtype, device=dev)
        forward = Graphed(partial(vgg16.apply, params))
        row = graph_turns(dev, f"vgg16 {dtype}",
                          {"eager": partial(vgg16.apply, params, x),
                           "graph": partial(forward, x)},
                          reps=GRAPH_VGG_REPS, units=64)
        rows.append({**row, "captures": forward.captures,
                     "replays": forward.replays, "unit": "images"})
        check(forward.captures == 1, f"vgg16 {dtype}: {forward.captures} "
              "captures")
        del params, forward
        _release()
    return rows


def graphs(dev) -> dict:
    """The compiled dispatch (parallel/graph.py): the train graphs against
    the eager steps at the bench's points (disc batch 32, gen batch 64; bf16
    and f32), serving (disc top 5, gen greedy and beam 5), the eval
    factories and evaluate_split (streaming and resident), generate's
    decode and VGG-16's forward, each graphed against eager."""
    t0 = time.perf_counter()
    train = [graph_train_point(dev, decoder, batch, dtype)
             for decoder, batch in (("disc", 32), ("gen", 64))
             for dtype in ("bfloat16", "float32")]
    serve = [graph_serve_point(dev, "disc"), graph_serve_point(dev, "gen"),
             graph_serve_point(dev, "gen", beam=5)]
    t1 = time.perf_counter()
    evals = graph_eval_points(dev)
    t2 = time.perf_counter()
    generated = graph_generate_points(dev)
    t3 = time.perf_counter()
    vgg = graph_vgg_points(dev)
    row = {"phase": "graphs", "train": train, "serve": serve, "eval": evals,
           "generate": generated, "vgg16": vgg,
           "seconds": {"train_serve": t1 - t0, "eval": t2 - t1,
                       "generate": t3 - t2, "vgg16": time.perf_counter() - t3},
           "total_seconds": time.perf_counter() - t0}
    emit(row)
    return row


def reset_counts() -> None:
    """Every kernel's launches and the mesh's collectives to 0."""
    from visdial_tpu_torch.parallel import mesh as mesh_mod

    reset_launches()
    mesh_mod.collectives = 0


def mesh_counts() -> dict:
    """The kernels' launches and the mesh's collectives since reset_counts."""
    from visdial_tpu_torch.parallel import mesh as mesh_mod

    return {**kernel_launches(), "collectives": mesh_mod.collectives}


def _states_equal(a, b, what: str) -> None:
    from visdial_tpu_torch.utils.params import flatten

    for name, x, y in (("params", a.params, b.params), ("m", a.opt.m, b.opt.m),
                       ("v", a.opt.v, b.opt.v)):
        fx, fy = flatten(x), flatten(y)
        bad = [k for k in fx if not torch.equal(fx[k], fy[k])]
        check(not bad, f"{what}: {name} differ at {bad[:5]}")
    check(a.opt.step == b.opt.step
          and torch.equal(a.gen.get_state(), b.gen.get_state()),
          f"{what}: the steps or the CPU generators differ")


def _copy_state(state):
    """A TrainState of fresh tensors and a generator in the same state (a
    factory writes the state it is given in place)."""
    from visdial_tpu_torch.parallel.train_step import TrainState
    from visdial_tpu_torch.utils.params import flatten, unflatten

    def tree(t):
        return unflatten({k: v.clone() for k, v in flatten(t).items()})

    gen = torch.Generator()
    gen.set_state(state.gen.get_state())
    return TrainState(tree(state.params), state.opt._replace(
        m=tree(state.opt.m), v=tree(state.opt.v)), gen)


def _calls_equal(what: str, cfg, fn, eager, state0, batches) -> dict:
    """fn (a factory's GraphedTrainStep) and eager over the same calls from
    copies of state0: metrics, params, moments and CPU generators bit for
    bit, counts equal call by call, one capture; (the graph's counts a
    call)."""
    sg, se = _copy_state(state0), _copy_state(state0)
    per = {}
    for i, b in enumerate(batches):
        for path in ("graph", "eager"):
            reset_counts()
            if path == "graph":
                sg, mg = fn(sg, b)
            else:
                se, me = eager(se, b, cfg)
            torch.cuda.synchronize()
            per[path] = mesh_counts()
        check(per["graph"] == per["eager"], f"{what}: call {i} counts "
              f"{per['graph']} against eager {per['eager']}")
        for k in ("loss", "grad_norm"):
            check(torch.equal(torch.as_tensor(mg[k]), torch.as_tensor(me[k])),
                  f"{what}: call {i} {k} {float(mg[k])} against eager "
                  f"{float(me[k])}")
    _states_equal(sg, se, what)
    check(fn.captures == 1, f"{what}: {fn.captures} captures")
    return {"counts_a_call": per["graph"], "loss": float(mg["loss"]),
            "bit_equal": True}


def mesh_step_checks(dev, mesh) -> dict:
    """make_train_fn (MN-QIH-disc, bf16, dropout 0.5, with remat),
    make_dense_train_fn (dense batches of the flagship model) and
    make_train_fn over disc batches without round_valid (the loss's count
    made on the device: a host copy there fails the capture), each over
    the mesh against the eager mesh step, MESH_CALLS calls."""
    from visdial_tpu_torch.bench import flagship_config
    from visdial_tpu_torch.data.loader import DenseLoader
    from visdial_tpu_torch.data.synthetic import make_random_split, random_batch
    from visdial_tpu_torch.models.model import batch_to_device, model_dense_loss
    from visdial_tpu_torch.parallel.train_step import (init_train_state,
                                                       make_dense_train_fn,
                                                       make_train_fn,
                                                       shard_train_state,
                                                       train_step)

    out = {}
    cfg = flagship_config().replace(remat=True)
    batches = [batch_to_device(random_batch(cfg, seed=s), dev)
               for s in range(MESH_CALLS)]
    state0 = shard_train_state(init_train_state(cfg, device=dev, seed=0), cfg,
                               mesh)
    check(batches[0]["round_valid"].shape[0] == cfg.batch_size,
          "mesh steps: the batches carry round_valid")
    out["make_train_fn_remat"] = _calls_equal(
        "mesh make_train_fn remat", cfg, make_train_fn(cfg, mesh),
        partial(train_step, mesh=mesh), state0, batches)
    no_rv = [{k: v for k, v in b.items() if k != "round_valid"}
             for b in batches]
    cfg = cfg.replace(remat=False)
    out["make_train_fn_no_round_valid"] = _calls_equal(
        "mesh make_train_fn without round_valid", cfg,
        make_train_fn(cfg, mesh), partial(train_step, mesh=mesh), state0,
        no_rv)
    cfg = flagship_config(compute_dtype="float32")
    split, vocab = make_random_split(cfg, num_dialogs=2 * cfg.batch_size,
                                     num_unique_answers=20_000, seed=0)
    cfg = cfg.replace(vocab_size=vocab.size)
    dense = [batch_to_device(b, dev) for b in DenseLoader(
        split, vocab, cfg, dense_entries(split, cfg)).epoch(seed=0)]
    state0 = shard_train_state(init_train_state(cfg, device=dev, seed=0), cfg,
                               mesh)
    out["make_dense_train_fn"] = _calls_equal(
        "mesh make_dense_train_fn", cfg, make_dense_train_fn(cfg, mesh),
        partial(train_step, mesh=mesh, loss_fn=model_dense_loss), state0,
        dense)
    del state0, batches, no_rv, dense
    _release()
    return out


def _digest(tree) -> str:
    """A sha256 of a pytree's tensors' bytes, leaf by leaf in path order."""
    from visdial_tpu_torch.utils.params import flatten

    h = hashlib.sha256()
    for k, v in sorted(flatten(tree).items()):
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _remat_memory_rank(rank: int, remat: bool) -> dict:
    """One world-1 NCCL process of remat_memory: LF-QIH-disc at batch 32
    (dropout 0.5, f32) with cfg.remat = `remat`, make_train_fn's graph over
    the mesh as the process's first capture, then the eager mesh step from
    the same init.  Device memory reserved over what was reserved before,
    from an emptied cache: the graph's peak over its first call (warm-up
    and capture), what it keeps after it (the warm-up's blocks released)
    and its peak over a replayed call; eager's peak over two steps (its
    backward allocates on the autograd engine's thread, which a MemPool of
    this thread would not see).  The graph's state equal to eager's bit
    for bit; (the row, the loss and a digest of the graph's params)."""
    from visdial_tpu_torch.parallel.mesh import make_mesh
    from visdial_tpu_torch.parallel.train_step import (make_train_fn,
                                                       shard_train_state,
                                                       train_step)
    from visdial_tpu_torch.profile_train import flagship_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, 1, "cuda")
    dev = mesh.device
    cfg, batches, state0 = flagship_setup(dev, 2, dropout=0.5,
                                          encoder="lf-ques-im-hist")
    cfg = cfg.replace(remat=remat)
    row = {"history": list(batches[0]["hist_flat"].shape)}
    out = {}
    for path in ("graph", "eager"):
        state = shard_train_state(_copy_state(state0), cfg, mesh)
        _release()
        reserved = torch.cuda.memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if path == "graph":
            fn = make_train_fn(cfg, mesh)
            state, m = fn(state, batches[0])            # the capture
            torch.cuda.synchronize(dev)
            row["graph_first_call_peak_gb"] = (
                torch.cuda.max_memory_reserved(dev) - reserved) / 2 ** 30
            _release()
            row["graph_kept_gb"] = (torch.cuda.memory_reserved(dev)
                                    - reserved) / 2 ** 30
            torch.cuda.reset_peak_memory_stats(dev)
            state, m = fn(state, batches[1])            # a replay
        else:
            for b in batches:
                state, m = train_step(state, b, cfg, mesh=mesh)
        torch.cuda.synchronize(dev)
        row[f"{path}_peak_gb"] = (torch.cuda.max_memory_reserved(dev)
                                  - reserved) / 2 ** 30
        row[f"{path}_two_steps_s"] = time.perf_counter() - t0
        out[path] = (float(m["loss"]), state)
        if path == "graph":
            check(fn.captures == 1, f"remat memory: {fn.captures} captures")
            del fn
        del state, m
        _release()
    check(out["graph"][0] == out["eager"][0],
          f"remat memory remat={remat}: the graph's loss {out['graph'][0]} "
          f"against eager {out['eager'][0]}")
    _states_equal(out["graph"][1], out["eager"][1],
                  f"remat memory remat={remat}: the graph against eager")
    return {"row": row, "loss": out["graph"][0],
            "params": _digest(out["graph"][1].params)}


def remat_memory() -> dict:
    """LF-QIH-disc at batch 32 with its 32 x 256 history (dropout 0.5, f32):
    make_train_fn's graph with remat against the graph without, each in a
    world-1 NCCL process of its own (_remat_memory_rank), so that each
    graph is its process's first capture, as in a user's train process:
    the remat graph's reserved peak over a replayed call not above the
    other's; both graphs equal their eager steps, and each other, bit for
    bit (remat recomputes the same encoder, the same masks)."""
    from visdial_tpu_torch.parallel.launch import run_ranks

    got = {remat: run_ranks(_remat_memory_rank, 1, remat, timeout=600)[0]
           for remat in (False, True)}
    check(got[True]["loss"] == got[False]["loss"]
          and got[True]["params"] == got[False]["params"],
          f"remat memory: the remat graph's loss {got[True]['loss']} or "
          f"params differ from the graph's without remat "
          f"({got[False]['loss']})")
    row = {"point": "remat memory lf-ques-im-hist disc batch 32",
           "history": got[True]["row"]["history"], "loss": got[True]["loss"]}
    for remat, key in ((False, "no_remat"), (True, "remat")):
        row.update({f"{key}_{k}": v for k, v in got[remat]["row"].items()
                    if k != "history"})
    row["remat_over_no_remat_peak"] = (row["remat_graph_peak_gb"]
                                       / row["no_remat_graph_peak_gb"])
    check(row["remat_graph_peak_gb"] <= row["no_remat_graph_peak_gb"],
          f"remat memory: the remat graph's reserved peak "
          f"{row['remat_graph_peak_gb']:.4f} GB (kept "
          f"{row['remat_graph_kept_gb']:.4f}), over the "
          f"{row['no_remat_graph_peak_gb']:.4f} GB (kept "
          f"{row['no_remat_graph_kept_gb']:.4f}) of the graph without")
    return row


def mesh_eval_points(dev, mesh) -> list[dict]:
    """evaluate_split over the mesh through the eval factories made for it
    (their graphs) against their eager functions, streaming and resident,
    disc and gen, bf16, at the bench's harness point (HARNESS_DIALOGS
    dialogs over HARNESS_ANSWERS answers): ranks and rankings bit for bit,
    launches equal, rates and memory (graph_turns)."""
    from visdial_tpu_torch.bench import (HARNESS_ANSWERS, HARNESS_DIALOGS,
                                         flagship_config)
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import _GenBucketPlan, evaluate_split
    from visdial_tpu_torch.models.model import model_init
    from visdial_tpu_torch.parallel.train_step import (make_disc_table_eval_fns,
                                                       make_gen_bucket_eval_fns)

    rows = []
    for decoder in ("disc", "gen"):
        cfg = flagship_config(decoder=decoder)
        split, vocab = make_random_split(cfg, num_dialogs=HARNESS_DIALOGS,
                                         num_unique_answers=HARNESS_ANSWERS,
                                         seed=0)
        cfg = cfg.replace(vocab_size=vocab.size)
        params = model_init(cfg, seed=cfg.seed, device=dev)
        fns = (make_disc_table_eval_fns if decoder == "disc"
               else make_gen_bucket_eval_fns)(cfg, mesh)
        key = "table_fns" if decoder == "disc" else "gen_fns"
        for resident in (False, True):
            def run(f, resident=resident):
                _, ranks, cand = evaluate_split(
                    params, split, vocab, cfg, dev, return_ranks=True,
                    collect_rankings=True, resident=resident, mesh=mesh,
                    **{key: f})
                return ranks, cand

            run(tuple(f.fn for f in fns))     # the split's tables and stacks
            path = "resident" if resident else "stream"
            row = graph_turns(
                dev, f"mesh evaluate_split {decoder} {path}",
                {"eager": partial(run, tuple(f.fn for f in fns)),
                 "graph": partial(run, fns)},
                reps=1, units=HARNESS_DIALOGS * cfg.num_rounds)
            # as on one device: one resident batch graph; a streamed
            # batch's factories' graphs, gen's one row graph a width bucket
            widths = (len(_GenBucketPlan.cached(split, cfg.batch_size).active)
                      if decoder == "gen" else 1)
            caps = _eval_captures(split, fns, resident)
            check(caps == ([1] if resident else [1, widths]),
                  f"mesh evaluate_split {decoder} {path}: {caps} captures "
                  "over four graphed runs")
            rows.append({**row, "captures": caps, "unit": "rounds"})
        del params, fns, split
        _release()
    return rows


def _eval_captures(split, fns, resident: bool) -> list:
    """The captures of the graphs evaluate_split ran for `split` through
    the factories' functions `fns`: the resident batch graphs' (kept on
    the split), or each factory function's (a streamed batch)."""
    if resident:
        return [sum(r.captures for r in split.__dict__.get(
            "_torch_resident_eval", {}).values())]
    return [f.captures for f in fns]


class _EagerDecode:
    """generate's graph replaced by its body, run under inference mode:
    the eager path the CLI's graph is held to."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, generators=(), clone=True):
        with torch.inference_mode():
            return self.fn(*args)


def mesh_generate(dev) -> dict:
    """The generate CLI in this process under the world-1 group (its own
    mesh, the decode one graph a batch): greedy, beam 5 and sampled (--seed
    3) on a seeded flagship MN-QIH-gen checkpoint over GEN_DIALOGS
    synthetic dialogs, each JSON equal to the same CLI's with the graph
    replaced by its eager body, launches equal."""
    from visdial_tpu_torch import generate as generate_mod
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data.synthetic import make_synthetic_split
    from visdial_tpu_torch.parallel.train_step import init_train_state
    from visdial_tpu_torch.utils.checkpoint import save_checkpoint

    base = Config(encoder="mn-ques-im-hist", decoder="gen", dropout=0.0)
    _, vocab = make_synthetic_split(base, num_dialogs=GEN_DIALOGS,
                                    seed=base.seed + 1)
    cfg = base.replace(vocab_size=vocab.size)
    ckpt = save_checkpoint(os.path.join(SMOKE_DIR, "smoke_mesh_gen"),
                           init_train_state(cfg, device=dev), cfg)
    row = {"dialogs": GEN_DIALOGS}
    graphed = generate_mod.InferenceGraphed
    for mode, extra in (("greedy", []), ("beam5", ["--beam_size", "5"]),
                        ("sample", ["--sample", "--seed", "3",
                                    "--temperature", "0.8"])):
        outs, counts, secs = {}, {}, {}
        for path in ("graph", "eager"):
            out = os.path.join(SMOKE_DIR, f"mesh_generated_{mode}_{path}.json")
            generate_mod.InferenceGraphed = (graphed if path == "graph"
                                             else _EagerDecode)
            try:
                reset_counts()
                t0 = time.perf_counter()
                run_cli(generate_mod.main, [
                    "--load_path", ckpt, "--synthetic", str(GEN_DIALOGS),
                    "--num_dialogs", "0", "--out_path", out, "--mesh_data",
                    "1", *extra])
                secs[path] = time.perf_counter() - t0
                counts[path] = mesh_counts()
            finally:
                generate_mod.InferenceGraphed = graphed
            with open(out) as f:
                outs[path] = json.load(f)
        check(outs["graph"] == outs["eager"],
              f"mesh generate {mode}: the graphed CLI's JSON differs from "
              "the eager decode's")
        check(counts["graph"] == counts["eager"]
              and counts["graph"]["lstm_layer"] > 0,
              f"mesh generate {mode}: counts {counts}")
        rounds = sum(len(d["rounds"]) for d in outs["graph"]["dialogs"])
        row[mode] = {"equal": True, "rounds": rounds,
                     "launches": counts["graph"],
                     "graph_cli_s": secs["graph"], "eager_cli_s": secs["eager"]}
    return row


def mesh_train_cli() -> dict:
    """The train CLI with --mesh_data 1 --remat true under the world-1
    group: its steps through the factories' graphs (the encoder's
    recomputation inside), an eval and a checkpoint."""
    from visdial_tpu_torch import train as train_cli_mod

    save = os.path.join(SMOKE_DIR, "smoke_mesh_remat")
    shutil.rmtree(save, ignore_errors=True)
    reset_counts()
    _, events = run_cli(train_cli_mod.main, [
        "--synthetic", "64", "--encoder", "mn-ques-im-hist", "--mesh_data",
        "1", "--remat", "true", "--max_steps", "2", "--eval_every", "2",
        "--save_every", "2", "--log_every", "1", "--save_path", save,
        "--run_name", "remat"])
    counts = mesh_counts()
    kinds = [e["event"] for e in events]
    config = next(e for e in events if e["event"] == "config")
    trains = [e for e in events if e["event"] == "train"]
    check(config["remat"] is True and config["mesh_data"] == 1
          and {"train", "eval", "checkpoint", "done"} <= set(kinds)
          and all(math.isfinite(e["loss"]) for e in trains)
          and counts["collectives"] > 0 and counts["lstm_layer_bwd"] > 0,
          f"mesh train CLI --remat true: events {kinds}, counts {counts}")
    return {"losses": [e["loss"] for e in trains],
            "mrr": next(e for e in events if e["event"] == "eval")["mrr"],
            "counts": counts}


def _mesh_graph_rank(rank: int, shape: tuple, points: list,
                     evals: list) -> dict:
    """One rank of a NCCL world (run_ranks) laid out as `shape`: each train
    point (graph_train_point over the mesh, each rank on its own batches,
    batch the point's global batch over the data axis) and each eval point
    (decoder, resident: evaluate_split eagerly through the factories'
    functions, then twice through their graphs: ranks and rankings bit for
    bit, counts equal, the graphs captured on the first graphed run, at
    least one each, and only replayed on the second)."""
    from visdial_tpu_torch.bench import flagship_config
    from visdial_tpu_torch.data.synthetic import make_random_split
    from visdial_tpu_torch.eval_harness import evaluate_split
    from visdial_tpu_torch.models.model import model_init
    from visdial_tpu_torch.parallel.mesh import make_mesh
    from visdial_tpu_torch.parallel.train_step import (make_disc_table_eval_fns,
                                                       make_gen_bucket_eval_fns,
                                                       shard_train_state,
                                                       TrainState)
    from visdial_tpu_torch.parallel.optim import init_opt_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(*shape, "cuda")
    dev = mesh.device
    rows = [graph_train_point(dev, d, bs // mesh.data, dt, mesh=mesh,
                              remat=remat, group=MESH_GROUP,
                              dispatches=MESH_DISPATCHES)
            for d, bs, dt, remat in points]
    for decoder, resident in evals:
        cfg = flagship_config(decoder=decoder)
        split, vocab = make_random_split(cfg, num_dialogs=MESH_EVAL_DIALOGS,
                                         num_unique_answers=MESH_EVAL_ANSWERS,
                                         seed=0)
        cfg = cfg.replace(vocab_size=vocab.size)
        params = model_init(cfg, seed=cfg.seed, device=dev)
        params = shard_train_state(TrainState(
            params, init_opt_state(params, cfg), torch.Generator()), cfg,
            mesh).params
        fns = (make_disc_table_eval_fns if decoder == "disc"
               else make_gen_bucket_eval_fns)(cfg, mesh)
        key = "table_fns" if decoder == "disc" else "gen_fns"
        got, counts, caps = {}, {}, {}
        for path, f in (("eager", tuple(x.fn for x in fns)), ("graph", fns),
                        ("graph again", fns)):
            reset_counts()
            got[path] = evaluate_split(
                params, split, vocab, cfg, dev, return_ranks=True,
                collect_rankings=True, resident=resident, mesh=mesh,
                **{key: f})
            counts[path] = mesh_counts()
            caps[path] = _eval_captures(split, fns, resident)
        what = (f"mesh {shape[0]}x{shape[1]} evaluate_split {decoder} "
                + ("resident" if resident else "stream"))
        check(not any(caps["eager"]) and all(caps["graph"])
              and caps["graph again"] == caps["graph"],
              f"{what}: captures {caps} (eager, graphed, graphed again)")
        for path in ("graph", "graph again"):
            check(_equal(got[path][1:], got["eager"][1:]),
                  f"{what}: {path} ranks differ from eager's")
            check(counts[path] == counts["eager"],
                  f"{what}: {path} counts {counts[path]} against eager "
                  f"{counts['eager']}")
        rows.append({"point": what, "mrr": got["graph"][0]["mrr"],
                     "counts": counts["graph"], "bit_equal": True,
                     "captures": caps["graph"]})
        del params, fns, got
        _release()
    mesh.barrier()
    return {"rank": rank, "rows": rows}


def mesh_graphs(dev) -> dict:
    """The compiled dispatch over a mesh (parallel/train_step.py's factories
    with their NCCL collectives captured) in a world-1 NCCL group made in
    this process, every point against the eager mesh path it replaces:
    the train points (MN-QIH-disc batch 32, -gen batch 64; bf16 and f32;
    remat off and on), make_train_fn under remat, make_dense_train_fn, a
    disc batch without round_valid, evaluate_split streaming and resident
    through the eval factories, the generate CLI and the train CLI with
    --remat true.  Then, each in a world-1 NCCL process of its own, the
    remat memory point; with two cards, (2, 1) NCCL ranks (disc and gen,
    the disc evals) and (1, 2) with a vocab shard and remat (the gen
    evals); with four, (2, 2)."""
    import torch.distributed as dist

    from visdial_tpu_torch.parallel.launch import free_port
    from visdial_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    os.environ.update({"MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", rank=0, world_size=1)
    row = {"phase": "mesh_graphs"}
    try:
        mesh = make_mesh(1, 1, "cuda")
        row["train"] = [
            graph_train_point(dev, decoder, batch, dtype, mesh=mesh,
                              remat=remat, group=MESH_GROUP,
                              dispatches=MESH_DISPATCHES)
            for decoder, batch in (("disc", 32), ("gen", 64))
            for dtype in ("bfloat16", "float32") for remat in (False, True)]
        t1 = time.perf_counter()
        row["steps"] = mesh_step_checks(dev, mesh)
        t2 = time.perf_counter()
        row["eval"] = mesh_eval_points(dev, mesh)
        t3 = time.perf_counter()
        row["generate"] = mesh_generate(dev)
        row["train_cli"] = mesh_train_cli()
        t4 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    row["remat_memory"] = remat_memory()
    t5 = time.perf_counter()
    row["seconds"] = {"train": t1 - t0, "steps": t2 - t1, "eval": t3 - t2,
                      "generate_cli": t4 - t3, "remat_memory": t5 - t4}
    row["multi_card"], reason = mesh_multi_card()
    if reason:
        row["multi_card_reason"] = reason
    row["total_seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def mesh_multi_card() -> tuple[list, str]:
    """The mesh's NCCL worlds across cards (_mesh_graph_rank), as many as
    the machine has cards for: (2, 1) disc and gen and the disc evals,
    (1, 2) gen with remat on a vocab shard and its evals, with four cards
    (2, 2); (rank 0's rows a world, the reason none ran or '')."""
    from visdial_tpu_torch.parallel.launch import run_ranks

    cards = torch.cuda.device_count()
    worlds = []
    if cards >= 2:
        worlds += [((2, 1), [("disc", 32, "bfloat16", False),
                             ("gen", 64, "bfloat16", False)],
                    [("disc", False), ("disc", True)]),
                   ((1, 2), [("gen", 64, "bfloat16", True)],
                    [("gen", False), ("gen", True)])]
    if cards >= 4:
        worlds.append(((2, 2), [("disc", 32, "bfloat16", False),
                                ("gen", 64, "bfloat16", False)],
                       [("gen", True)]))
    out = []
    for shape, points, evals in worlds:
        t = time.perf_counter()
        got = run_ranks(_mesh_graph_rank, shape[0] * shape[1], shape, points,
                        evals, timeout=900)
        out.append({"mesh": list(shape), "rows": got[0]["rows"],
                    "seconds": time.perf_counter() - t})
    reason = "" if worlds else (f"{cards} CUDA device: the (2, 1) and (1, 2) "
                                "meshes need two cards, (2, 2) four")
    return out, reason


def vgg16_phase(dev) -> dict:
    """VGG-16 (models/vgg16.py) with He-scaled random weights from a seed,
    written in the JAX layout: apply on the card (f32, TF32 off) against
    the same function on the CPU for 4 images; images/s at batch 64 in f32
    and bf16 beside the FLOP bound; the prepro_img CLI over 96 seeded
    images (batch 64: the tail batch pads), its rows equal to apply's."""
    import numpy as np

    from visdial_tpu_torch.data import prepro_img
    from visdial_tpu_torch.models import vgg16

    root = os.path.join(SMOKE_DIR, "smoke_vgg16")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    weights = os.path.join(root, "vgg16.npz")
    vgg16.save_params(vgg16.init_params(torch.Generator().manual_seed(0),
                                        he=True), weights)
    images = np.random.default_rng(0).integers(0, 256, (VGG_IMAGES, 224, 224, 3),
                                               dtype=np.uint8)
    x = torch.from_numpy(vgg16.preprocess(images, origin="torchvision"))
    p_dev = vgg16.load_params(weights, torch.float32, dev)
    got = vgg16.apply(p_dev, x[:4].to(dev))
    want = vgg16.apply(vgg16.load_params(weights), x[:4])
    errs = {k: rel_err([got[k].cpu()], [want[k]]) for k in ("fc7", "pool5")}
    live = float((want["fc7"] > 0).float().mean())
    check(max(errs.values()) <= VGG_RTOL and live > 0.2,
          f"vgg16 card vs CPU: rel errs {errs} (tol {VGG_RTOL}), fc7 "
          f"non-zero share {live}")
    flop, n_params = vgg_counts()
    rates = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        params = p_dev if dt == torch.float32 else vgg16.load_params(
            weights, dt, dev)
        xb = x[:64].to(dev)
        ms = time_ms(lambda: vgg16.apply(params, xb), reps=5)
        # bytes: the images in, the weights, fc7 and pool5 out
        nbytes = 64 * 224 * 224 * 3 * 4 + n_params * SIZE[name] + 64 * (
            4096 * 4 + 7 * 7 * 512 * SIZE[name])
        rates[name] = {"batch": 64, "ms": ms, "images_per_s": 64 / ms * 1e3,
                       **bound(64 * flop, nbytes, name)}
        del params
    split = os.path.join(root, "visdial_data_val.npz")
    np.savez(split, img_ids=np.arange(VGG_IMAGES))
    npz = os.path.join(root, "images.npz")
    np.savez(npz, images=images)
    out = os.path.join(root, "feats.npz")
    t0 = time.perf_counter()
    run_cli(prepro_img.main, ["--split_npz", split, "--weights", weights,
                              "--images_npz", npz, "--out", out,
                              "--save_pool5", "--batch_size", "64"])
    cli_s = time.perf_counter() - t0
    with np.load(out) as z:
        keys, fc7, pool5 = sorted(z.files), z["images_val"], z["pool5_val"]
    same = True
    for s in range(0, VGG_IMAGES, 64):
        xb = x[s:s + 64]
        n = len(xb)
        xb = torch.nn.functional.pad(xb, (0, 0, 0, 0, 0, 0, 0, 64 - n))
        ref = vgg16.apply(p_dev, xb.to(dev))
        same &= bool(np.array_equal(fc7[s:s + n], ref["fc7"][:n].cpu().numpy())
                     and np.array_equal(pool5[s:s + n],
                                        ref["pool5"][:n].cpu().numpy()))
    check(keys == ["images_val", "pool5_val"]
          and fc7.shape == (VGG_IMAGES, 4096)
          and pool5.shape == (VGG_IMAGES, 7, 7, 512) and same,
          f"prepro_img CLI: keys {keys}, fc7 {fc7.shape}, pool5 "
          f"{pool5.shape}, rows equal to apply's: {same}")
    row = {"phase": "vgg16", "card_vs_cpu_rel_err": errs,
           "fc7_nonzero_share": live, "tol": VGG_RTOL, "flop_per_image": flop,
           "rates": rates, "cli_images": VGG_IMAGES, "cli_seconds": cli_s,
           "cli_rows_equal_apply": same}
    emit(row)
    return row


def vgg_counts() -> tuple[float, int]:
    """(operations of one 224 x 224 image through VGG-16, 2 per
    multiply-add of the 13 convolutions and two fc layers; its weights)."""
    from visdial_tpu_torch.models.vgg16 import _CFG

    ops, side, ch, n = 0.0, 224, 3, 0
    for item in _CFG:
        if item == "M":
            side //= 2
        else:
            ops += 2.0 * side * side * 9 * ch * item[1]
            n += 9 * ch * item[1] + item[1]
            ch = item[1]
    fc = 7 * 7 * 512 * 4096 + 4096 * 4096
    return ops + 2.0 * fc, n + fc + 2 * 4096

# ---------------------------------------------------------------------------
# the real-data recipe on generated inputs, decoding on a model axis, and
# every kernel on a second card


def visdial_json(path: str, n: int, seed: int, test: bool = False) -> None:
    """VisDial-format JSON of n dialogs over a PIPE_WORDS-word pool: v0.9
    style (10 answered rounds, 100 candidates with gt_index), or with test
    a v1.0 test-style split (dialog i asks 1 + i % 10 questions, no answer
    and no gt_index, the last asked round with its 100 candidates)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(PIPE_WORDS)])

    def sents(count, lo, hi, end=""):
        return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi))))
                + end for _ in range(count)]

    nq, na, R, K = max(8 * n, 200), max(12 * n, 300), 10, 100
    questions, answers = sents(nq, 3, 9, " ?"), sents(na, 1, 7)
    dialogs = []
    for i in range(n):
        rounds = []
        for r in range(1 + i % R if test else R):
            ai = int(rng.integers(na))
            others = rng.choice(na - 1, K - 1, replace=False)
            opts = [int(o + (o >= ai)) for o in others]
            slot = int(rng.integers(K))
            opts.insert(slot, ai)
            turn = {"question": int(rng.integers(nq))}
            if not test:
                turn.update(answer=ai, answer_options=opts, gt_index=slot)
            elif r == i % R:
                turn["answer_options"] = opts
            rounds.append(turn)
        dialogs.append({"image_id": 100_000 * seed + i,
                        "caption": sents(1, 8, 16)[0], "dialog": rounds})
    with open(path, "w") as f:
        json.dump({"version": "1.0" if test else "0.9",
                   "data": {"questions": questions, "answers": answers,
                            "dialogs": dialogs}}, f)


def vgg_weights() -> str:
    """He-scaled VGG-16 weights from seed 0 in the JAX npz layout: the
    vgg16 phase's file, written here when that phase has not run."""
    from visdial_tpu_torch.models import vgg16

    path = os.path.join(SMOKE_DIR, "smoke_vgg16", "vgg16.npz")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        vgg16.save_params(vgg16.init_params(torch.Generator().manual_seed(0),
                                            he=True), path)
    return path


def h5_route(split, vocab, root: str) -> dict:
    """load_split's reference-artifact route: where h5py is missing, the
    clear error (it names h5py and the npz route); where it is installed,
    `split` written in the reference's schema (Lua 1-based option rows and
    ground-truth positions, <START>/<END> left out of the params) read back
    equal."""
    from visdial_tpu_torch.data.dataset import load_split

    d = os.path.join(root, "reference_h5")
    os.makedirs(d, exist_ok=True)
    try:
        import h5py
    except ImportError:
        for name in ("visdial_data.h5", "data_img.h5", "visdial_params.json"):
            open(os.path.join(d, name), "w").close()
        try:
            load_split(d, "val")
        except ImportError as e:
            check("needs h5py" in str(e) and "npz" in str(e),
                  f"pipeline: the h5 route's error: {e}")
            return {"h5py": False, "error": str(e)}
        raise AssertionError("pipeline: the h5 route ran without h5py")
    with h5py.File(os.path.join(d, "visdial_data.h5"), "w") as h:
        for k, v in (("ques", split.ques), ("ques_length", split.ques_len),
                     ("ans", split.ans), ("ans_length", split.ans_len),
                     ("cap", split.cap), ("cap_length", split.cap_len),
                     ("opt_list", split.opt_list),
                     ("opt_length", split.opt_list_len),
                     ("opt", split.opt_inds + 1),
                     ("ans_index", split.gt_ind + 1)):
            h[f"{k}_val"] = v
    with h5py.File(os.path.join(d, "data_img.h5"), "w") as h:
        h["images_val"] = split.img_feat
    with open(os.path.join(d, "visdial_params.json"), "w") as f:
        json.dump({"word2ind": {w: i for w, i in vocab.word2ind.items()
                                if w not in ("<START>", "<END>")}}, f)
    got, got_vocab = load_split(d, "val")
    import numpy as np

    same = got_vocab.word2ind == vocab.word2ind and all(
        np.array_equal(getattr(got, k), getattr(split, k))
        for k in ("ques", "ans", "cap", "opt_list", "opt_inds", "gt_ind",
                  "img_feat"))
    check(same, "pipeline: the reference h5 artifacts read back differently")
    return {"h5py": True, "round_trip_equal": same}


def pipeline(dev) -> dict:
    """The README's real-data recipe end to end on generated inputs at the
    flagship widths (f32): VisDial JSON (train, val and a v1.0 test-style
    split) -> the prepro CLI without features -> prepro_img on the card
    over train and val (seeded images, He-scaled seeded weights) -> the
    prepro CLI with those fc7 features -> the parity runbook (--no-check, PIPE_STEPS steps at
    batch 32) for LF-QIH-disc and MN-QIH-gen: both feature checks ok, both
    models trained, checkpointed and re-evaluated through the evaluate CLI
    with a finite MRR equal to the train CLI's in-training eval at the
    same step, and each stage's kernels launched (check_launches); then
    the h5 route (h5_route).  Prints each stage's wall time."""
    import numpy as np

    import visdial_tpu_torch.evaluate as evaluate_mod
    import visdial_tpu_torch.train as train_mod
    from visdial_tpu_torch import parity_run
    from visdial_tpu_torch.config import Config
    from visdial_tpu_torch.data import prepro_img
    from visdial_tpu_torch.data.dataset import load_split

    root = os.path.join(SMOKE_DIR, "smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    stages = {}

    def stage(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        stages[name] = time.perf_counter() - t
        return out

    splits = ("train", "val", "test")
    js = {s: os.path.join(root, f"{s}.json") for s in splits}

    def write_json():
        for i, s in enumerate(splits):
            visdial_json(js[s], PIPE_DIALOGS[s], seed=i + 1, test=s == "test")

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def prepro_cli(out_dir, feats=None):
        argv = [sys.executable, "-m", "visdial_tpu_torch.data.prepro",
                "--train_json", js["train"], "--val_json", js["val"],
                "--test_json", js["test"], "--out_dir", out_dir]
        for s in splits:
            argv += [f"--img_feats_{s}", feats[s] if feats else ""]
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=300, cwd=ROOT, env=env)
        check(proc.returncode == 0, f"prepro CLI exited {proc.returncode}:\n"
              f"{proc.stderr[-4000:]}")

    text_dir, data_dir = os.path.join(root, "text"), os.path.join(root, "data")
    stage("json", write_json)
    stage("prepro_text", prepro_cli, text_dir)
    weights = stage("vgg16_weights", vgg_weights)
    # prepro_img names its array images_val for a val split and images_train
    # for any other (as the JAX CLI does), so the test split keeps prepro's
    # zero features
    feats = {s: os.path.join(root, f"feats_{s}.npz") for s in splits[:2]}
    feats["test"] = ""

    def features():
        for i, s in enumerate(splits[:2]):
            data, _ = load_split(text_dir, s)
            images = os.path.join(root, f"images_{s}.npz")
            np.savez(images, images=np.random.default_rng(10 + i).integers(
                0, 256, (data.num_dialogs, 224, 224, 3), dtype=np.uint8))
            run_cli(prepro_img.main, [
                "--split_npz", os.path.join(text_dir, f"visdial_data_{s}.npz"),
                "--weights", weights, "--images_npz", images, "--out",
                feats[s], "--batch_size", "64", "--device", dev.type])

    stage("prepro_img", features)
    stage("prepro_feats", prepro_cli, data_dir, feats)
    val, vocab = load_split(data_dir, "val")
    test, _ = load_split(data_dir, "test")
    check(val.img_feat.shape == (PIPE_DIALOGS["val"], 4096)
          and vocab.size % 2 == 0 and not test.round_valid.any()
          and int(test.round_scoreable.sum()) == PIPE_DIALOGS["test"],
          f"pipeline: the prepro'd splits (fc7 {val.img_feat.shape}, vocab "
          f"{vocab.size}, test rankable {int(test.round_valid.sum())})")

    dims = os.path.join(root, "dims.json")
    with open(dims, "w") as f:
        json.dump({**PIPE_CONFIG, "eval_every": PIPE_STEPS,
                   "save_every": PIPE_STEPS, "log_every": PIPE_STEPS}, f)
    models = {}
    orig = {"train": train_mod.main, "evaluate": evaluate_mod.main}
    for key in ("lf-disc", "mn-gen"):
        launches = {}

        def counted(name):
            def run(argv):
                reset_launches()
                t = time.perf_counter()
                out = orig[name](argv)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                stages[f"{key}:{name}"] = time.perf_counter() - t
                launches[name] = kernel_launches()
                return out
            return run

        train_mod.main, evaluate_mod.main = counted("train"), counted("evaluate")
        try:
            summary, lines = run_cli(parity_run.main, [
                "--data_dir", data_dir, "--work_dir", os.path.join(root, "runs"),
                "--models", key, "--max_steps", str(PIPE_STEPS),
                "--config_json", dims, "--no-check", "--device", dev.type])
        finally:
            train_mod.main, evaluate_mod.main = orig["train"], orig["evaluate"]
        checks = [e for e in lines if e.get("event") == "img_feature_check"]
        result = next(e for e in lines if e.get("event") == "parity_result")
        evals = [e for e in lines if e.get("event") == "eval"]
        saved = [e["step"] for e in lines if e.get("event") == "checkpoint"]
        encoder, decoder = parity_run.MODELS[key]
        cfg = Config(encoder=encoder, decoder=decoder)
        train_need = path_kernels(cfg, True)[0] | path_kernels(cfg, False)[0]
        check([c["split"] for c in checks] == ["train", "val"]
              and all(c["ok"] for c in checks),
              f"pipeline {key}: feature checks {checks}")
        check(lines[-1].get("event") == "parity_summary"
              and math.isfinite(result["mrr"]) and saved == [PIPE_STEPS]
              and result["checkpoint"].endswith(f"step_{PIPE_STEPS:08d}")
              and len(evals) == 1 and evals[0]["step"] == PIPE_STEPS,
              f"pipeline {key}: result {result}, checkpoints {saved}, evals "
              f"{[(e['step'], e['mrr']) for e in evals]}")
        check(result["mrr"] == evals[0]["mrr"],
              f"pipeline {key}: the evaluate CLI's MRR {result['mrr']} on the "
              f"step-{PIPE_STEPS} checkpoint against the train CLI's "
              f"{evals[0]['mrr']} at that step")
        check(all(launches["train"][k] > 0 for k in train_need)
              and all(n == 0 for k, n in launches["train"].items()
                      if k not in train_need),
              f"pipeline {key} train CLI: launches {launches['train']}, "
              f"expected > 0 for {sorted(train_need)} only")
        check_launches(launches["evaluate"], cfg, False,
                       f"pipeline {key} evaluate CLI")
        models[key] = {"mrr": result["mrr"], "train_eval_mrr": evals[0]["mrr"],
                       "checkpoint": result["checkpoint"],
                       "train_losses": [e["loss"] for e in lines
                                        if e.get("event") == "train"],
                       "launches": launches,
                       "feature_zero_frac": [c["zero_frac"] for c in checks]}
    h5 = stage("h5_route", h5_route, val, vocab, root)
    row = {"phase": "pipeline", "dialogs": PIPE_DIALOGS, "steps": PIPE_STEPS,
           **PIPE_CONFIG, "vocab": vocab.size, "models": models, "h5": h5,
           "stage_seconds": stages, "data_dir": data_dir}
    emit(row)
    return row


def timed_generate(argv: list) -> tuple[float, list]:
    """The generate CLI in this process: (its seconds, each batch's decode
    ms, model_generate between synchronisations)."""
    from visdial_tpu_torch import generate

    decode = generate.model_generate
    batch_ms = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(*a, **kw)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t) * 1e3)
        return out

    generate.model_generate = timed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_cli(generate.main, argv)
        torch.cuda.synchronize()
        return time.perf_counter() - t, batch_ms
    finally:
        generate.model_generate = decode


def _gen_axis_rank(rank: int, argvs: list) -> list:
    """One rank of a 2-card NCCL world at --mesh_model 2: the generate CLI
    once for each argv (rank 0 writes the JSON); timed_generate's numbers
    for each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return [timed_generate(argv) for argv in argvs]


def generate_model_axis(dev, pipe: dict) -> dict:
    """The generate CLI on two NCCL ranks at --mesh_model 2 (each card
    decodes on the whole params, as the CLI holds them) on the pipeline's
    MN-QIH-gen checkpoint, against the same CLI on one card: greedy, beam 5
    and sampled (same seed) strings equal, log-probs within SCORE_TOL; each
    call's seconds and each batch's model_generate time (encoder and
    decode) beside one card's.  Runs only where the machine has two
    cards."""
    from visdial_tpu_torch.parallel.launch import run_ranks

    cards = torch.cuda.device_count()
    if cards < 2:
        row = {"phase": "generate_model_axis", "ran": False,
               "reason": f"{cards} CUDA device: two NCCL ranks at "
                         "--mesh_model 2 need two cards"}
        emit(row)
        return row
    root = os.path.join(SMOKE_DIR, "smoke_pipeline")
    base = ["--load_path", pipe["models"]["mn-gen"]["checkpoint"],
            "--data_dir", pipe["data_dir"], "--num_dialogs", "0"]
    modes = {"greedy": [], "beam5": ["--beam_size", "5"],
             "sample": ["--sample", "--temperature", "1.0", "--seed", "3"]}
    one, one_t = {}, {}
    for mode, extra in modes.items():
        out = os.path.join(root, f"gen1_{mode}.json")
        one_t[mode] = timed_generate(base + ["--out_path", out, *extra])
        with open(out) as f:
            one[mode] = json.load(f)
    outs = {mode: os.path.join(root, f"gen2_{mode}.json") for mode in modes}
    two_t = run_ranks(_gen_axis_rank, 2, [
        base + ["--mesh_data", "1", "--mesh_model", "2", "--out_path",
                outs[mode], *extra] for mode, extra in modes.items()],
        timeout=600)[0]
    row = {"phase": "generate_model_axis", "ran": True, "ranks": 2,
           "vocab": pipe["vocab"], "dialogs": PIPE_DIALOGS["val"]}
    for (mode, extra), (s2, ms2) in zip(modes.items(), two_t):
        with open(outs[mode]) as f:
            got = json.load(f)
        want = one[mode]
        rounds, lp_err = 0, 0.0
        check(len(got["dialogs"]) == len(want["dialogs"])
              == PIPE_DIALOGS["val"], f"generate_model_axis {mode}: dialogs")
        for g, w in zip(got["dialogs"], want["dialogs"]):
            check(len(g["rounds"]) == len(w["rounds"]),
                  f"generate_model_axis {mode}: rounds")
            for gr, wr in zip(g["rounds"], w["rounds"]):
                rounds += 1
                check(gr["generated"] == wr["generated"],
                      f"generate_model_axis {mode}: {gr} on two cards, {wr} "
                      "on one")
                lp_err = max(lp_err, abs(gr["log_prob"] - wr["log_prob"]))
        check(lp_err <= SCORE_TOL, f"generate_model_axis {mode}: log-prob "
              f"err {lp_err} (tol {SCORE_TOL})")
        s1, ms1 = one_t[mode]
        row[mode] = {"rounds": rounds, "log_prob_max_abs_err": lp_err,
                     "cli_seconds_two_cards": s2, "cli_seconds_one_card": s1,
                     "batch_ms_two_cards": ms2, "batch_ms_one_card": ms1}
    emit(row)
    return row


def kernels_on(dev, dtype) -> dict:
    """Every kernel's wrapper once on `dev` in `dtype` against its plain
    version there: K1 at 320 rows (64 x 64 tiles) and 600 rows (the wide
    tiles), K2 at both, K3, K4 on both routes, K5 and K6 at the gen
    training tile.  {kernel: max abs err (K2 relative to the largest
    reference value, K5 to the largest |logp|; K6 its error over its
    limit)}, each within the smoke's limit; each launches once a call."""
    from visdial_tpu_torch.ops import attention_cuda
    from visdial_tpu_torch.ops.attention import (attention_fusion_ref,
                                                 attention_plain)
    from visdial_tpu_torch.ops.lm_score import (lm_dlogits_plain,
                                                lm_token_logprobs_lse_plain)
    from visdial_tpu_torch.ops.lstm import (INIT_SCALE, lstm_layer_bwd_plain,
                                            lstm_layer_plain)

    w = _wrappers()
    g = torch.Generator().manual_seed(dev.index or 0)
    errs = {}

    def err(a, r, rel=False):
        scale = float(r.float().abs().max()) if rel else 1.0
        return float((a.float() - r.float()).abs().max()) / max(scale, 1e-30)

    before = kernel_launches()
    for N, T, E, H in ((320, 16, 300, 512), (600, 5, 300, 512)):
        wt = torch.empty(E + H, 4 * H).uniform_(-INIT_SCALE, INIT_SCALE,
                                                generator=g)
        b = torch.empty(4 * H).uniform_(-0.5, 0.5, generator=g)
        x = torch.randn(N, T, E, generator=g).to(dtype)
        mask = (torch.rand(N, T, generator=g) < 0.6).float()
        h0, c0 = torch.randn(2, N, H, generator=g)
        args = [t.to(dev) for t in (wt, b, x, mask, h0, c0)]
        errs[f"lstm_layer_{N}"] = max(
            err(a, r) for a, r in zip(w["lstm_layer"](*args),
                                      lstm_layer_plain(*args)))
        hp, cp, ghs = (torch.randn(N, T, H, generator=g).to(dtype).to(dev)
                       for _ in range(3))
        bargs = args[:4] + [hp, cp, ghs] + args[4:]
        errs[f"lstm_layer_bwd_{N}"] = max(
            err(a, r, True) for a, r in zip(w["lstm_layer_bwd"](*bargs),
                                            lstm_layer_bwd_plain(*bargs)))
    for B in (1, 32):
        R = S = 10
        H = 512
        q = (torch.randn(B, R, H, generator=g) * 0.5).to(dev, dtype)
        s = (torch.randn(B, S, H, generator=g) * 0.5).to(dev, dtype)
        valid = (torch.arange(S)[None, :] <= torch.arange(R)[:, None]).float()
        valid = valid.to(dev)[None].expand(B, R, S)
        fw = torch.empty(2 * H, H).uniform_(-0.08, 0.08, generator=g).to(dev)
        fb = torch.empty(H).uniform_(-0.08, 0.08, generator=g).to(dev)
        route = attention_cuda.fusion_route(B, R, S, H, dtype)
        errs[f"attention_fusion_{route}"] = err(
            w["attention_fusion"](q, s, valid, fw, fb),
            attention_fusion_ref(q, s, valid, fw, fb))
        if B == 32:
            errs["attention"] = err(w["attention"](q, s, valid),
                                    attention_plain(q, s, valid))
    NT, H, V = 2880, 512, 8804
    x = torch.tanh(torch.randn(NT, H, generator=g)).to(dtype).to(dev)
    wl = (torch.randn(H, V, generator=g) * 0.1).to(dev)
    b = (torch.randn(V, generator=g) * 0.1).to(dev)
    tgt = torch.randint(0, V, (NT,), generator=g).to(dev)
    cot = torch.randn(NT, generator=g).to(dev)
    lp, lse = w["lm_score"](x, wl, b, tgt)
    want_lp, want_lse = lm_token_logprobs_lse_plain(x, wl, b, tgt)
    errs["lm_score"] = max(err(lp, want_lp), err(lse, want_lse)) / max(
        1.0, float(want_lp.abs().max()))
    # K6: its per-element error over its limit (dlogits_over_limit, <= 1)
    errs["lm_dlogits"] = dlogits_over_limit(
        w["lm_dlogits"](x, wl, b, tgt, want_lse, cot),
        dlogits_ref(x, wl, b, tgt, want_lse, cot), cot, dtype)
    torch.cuda.synchronize(dev)
    after = kernel_launches()
    launched = {k: after[k] - before[k] for k in after}
    check(launched == {"lstm_layer": 2, "lstm_layer_bwd": 2, "attention": 1,
                       "attention_fusion": 2, "lm_score": 1, "lm_dlogits": 1},
          f"two_cards {dev} {dtype}: launches {launched}")
    name = str(dtype).split(".")[1]
    limits = {k: (LM_TOL if k == "lm_score" else 1.0 if k == "lm_dlogits"
                  else GRAD_TOL[name] if k.startswith("lstm_layer_bwd")
                  else TOL[name]) for k in errs}
    bad = {k: (e, limits[k]) for k, e in errs.items() if not e <= limits[k]}
    check(not bad, f"two_cards {dev} {dtype}: kernel vs plain {bad}")
    return errs


def two_cards(dev) -> dict:
    """Every kernel (K1-K6, f32 and bf16) launched in this process on
    cuda:0 and then on cuda:1, each against its plain version on that card:
    a kernel's shared-memory limit is a device's attribute, which the
    launchers must set on each card (a card without it refuses the launch
    with "invalid argument").  Runs only where the machine has two
    cards."""
    cards = torch.cuda.device_count()
    if cards < 2:
        row = {"phase": "two_cards", "ran": False,
               "reason": f"{cards} CUDA device: the second card's launches "
                         "need a second card"}
        emit(row)
        return row
    row = {"phase": "two_cards", "ran": True, "errs": {}}
    for i in (0, 1):
        for dtype in (torch.float32, torch.bfloat16):
            row["errs"][f"cuda:{i}:{str(dtype).split('.')[1]}"] = kernels_on(
                torch.device("cuda", i), dtype)
    emit(row)
    return row


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this "
                 "check runs on a GPU only")
    sys.path.insert(0, ROOT)
    from visdial_tpu_torch.ops import _build

    # f32 references must be full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "allow_tf32": False})

    walls = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = time.perf_counter() - t
        return out

    timed("kernel_report", kernel_report)
    gen = torch.Generator().manual_seed(0)
    k5, k6 = timed("lm_checks", lm_checks, dev, gen)
    k1 = timed("lstm_layer", lstm_checks, dev, gen)
    k2 = timed("lstm_layer_bwd", lstm_bwd_checks, dev, gen)
    k3 = timed("attention", attention_only_checks, dev, gen)
    k4 = timed("attention_fusion", attention_checks, dev, gen)
    served = timed("serve", serve, dev)
    timed("serve_cli", serve_cli, served["params"], served["cfg"])
    del served["params"]
    trained = timed("train", train, dev)
    gen_trained = timed("gen_train", train, dev, "gen")
    gen_evaluated = timed("gen_eval", evaluate, dev)
    gen_served = timed("gen_serve", gen_serve, dev)
    lf_trained = timed("train_lf", train, dev, "disc", "lf-ques-im-hist",
                       "train_lf")
    lf_evaluated = timed("eval_lf", evaluate, dev, "lf-ques-im-hist", "disc",
                         "eval_lf")
    lf_served = timed("serve_lf", serve, dev, "lf-ques-im-hist", "serve_lf",
                      served["row"])
    fams = timed("families", families, dev)
    resident = timed("eval_resident", eval_resident, dev)
    # bf16, the JAX package's production precision, on the main paths
    contracted = timed("contraction", contraction_checks, dev, k2)
    trained_bf16 = timed("train_bf16", train, dev, phase="train_bf16",
                         dtype="bfloat16")
    gen_trained_bf16 = timed("gen_train_bf16", train, dev, "gen",
                             phase="gen_train_bf16", dtype="bfloat16",
                             batch_size=BF16_GEN_BATCH)
    evaluated_bf16 = timed("eval_bf16", eval_bf16, dev)
    served_bf16 = timed("serve_bf16", serve, dev, phase="serve_bf16",
                        beside=served["row"], dtype="bfloat16")
    del served_bf16["params"]
    integrated = timed("integration_bf16", integration, dev)
    timed("train_cli", train_cli)
    timed("evaluate_cli", evaluate_cli)
    tuned = timed("finetune", finetune, dev)
    generated = timed("generate", generate, dev)
    swept = timed("sweep", sweep, dev)
    meshed = timed("ddp", ddp, dev)
    sharded = timed("vocab_shards", vocab_shards, dev, gen)
    verified = timed("verify", verify_phase)
    timed("vgg16", vgg16_phase, dev)
    pipe = timed("pipeline", pipeline, dev)
    timed("generate_model_axis", generate_model_axis, dev, pipe)
    timed("two_cards", two_cards, dev)
    graphed = timed("graphs", graphs, dev)
    mesh_graphed = timed("mesh_graphs", mesh_graphs, dev)
    benched = timed("bench", bench_phase)
    emit({"phase": "wall_seconds", **walls, "total": sum(walls.values())})

    # launches: each kernel's count from the run of the main path it is
    # listed under (training for K1-K3, serving for K4, gen training for K5
    # and K6), and from every path's run in launches_by_path
    by_path = {"serve": served["row"]["launches"], "train": trained["launches"],
               "gen_train": gen_trained["launches"],
               "gen_eval": gen_evaluated["launches"],
               "gen_serve": gen_served["launches"],
               "train_lf": lf_trained["launches"],
               "eval_lf": lf_evaluated["launches"],
               "serve_lf": lf_served["row"]["launches"]}
    for f in fams:
        by_path[f"{f['family']}:train"] = f["train_launches"]
        by_path[f"{f['family']}:eval"] = f["eval_launches"]
    for r in resident:
        decoder = r["model"].rsplit("-", 1)[1]
        by_path[f"eval_resident:{decoder}"] = r["launches"]
        by_path[f"eval_staged:{decoder}"] = r["staged_launches"]
    by_path.update({"train_bf16": trained_bf16["launches"],
                    "gen_train_bf16": gen_trained_bf16["launches"],
                    "serve_bf16": served_bf16["row"]["launches"]})
    for r in evaluated_bf16:
        by_path[f"eval_bf16:{r['model'].rsplit('-', 1)[1]}"] = r["launches"]
    for r in integrated:
        by_path[f"integration_bf16:{r['label']}:{r['dtype']}"] = r["launches"]
    by_path.update({"finetune": tuned["launches"],
                    "finetune_cli": tuned["cli_launches"],
                    "generate": generated["launches"],
                    "sweep": swept["launches"],
                    "ddp": meshed["launches"],
                    "vocab_shards": sharded["launches"],
                    "verify": verified["launches"],
                    "bench": benched["launches"]})
    for r in graphed["train"]:
        by_path[f"graphs:{r['decoder']}:{r['dtype']}"] = r["counts_a_dispatch"]
    for r in graphed["serve"]:
        by_path[f"graphs:serve_{r['decoder']}{r['beam'] or ''}"] = r["launches"]
    for r in graphed["eval"] + graphed["generate"]:
        by_path[f"graphs:{r['point']}"] = r["launches"]
    for key, m in pipe["models"].items():
        for stage, n in m["launches"].items():
            by_path[f"pipeline:{key}:{stage}"] = n
    mesh_rows = mesh_graphed["train"] + [
        r for w in mesh_graphed["multi_card"] for r in w["rows"]
        if "counts_a_dispatch" in r]
    for r in mesh_rows:
        by_path[f"mesh_graphs:{r['point']}"] = r["counts_a_dispatch"]
    for name, r in mesh_graphed["steps"].items():
        by_path[f"mesh_graphs:{name}"] = r["counts_a_call"]
    for r in mesh_graphed["eval"]:
        by_path[f"mesh_graphs:{r['point']}"] = r["launches"]
    for mode in ("greedy", "beam5", "sample"):
        by_path[f"mesh_graphs:generate {mode}"] = \
            mesh_graphed["generate"][mode]["launches"]
    by_path["mesh_graphs:train_cli remat"] = mesh_graphed["train_cli"]["counts"]

    def head_row(rows, shape, dtype="float32", **match):
        return next(r for r in rows if r["shape"] == shape
                    and r["dtype"] == dtype
                    and all(r.get(k) == v for k, v in match.items()))

    def side_head(rows, shape, keys, dtype="float32", **match):
        head = head_row(rows, shape, dtype, **match)
        return {k: head.get(k) for k in ("shape", "dtype") + keys + (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}

    def summary(rows, head_shape, path, **fixed):
        head = head_row(rows, head_shape)
        extra = {"launch_ms": head["launch_ms"]} if "launch_ms" in head else {}
        return {**fixed, **extra, "route": "cuda",
                "launches": by_path[path][fixed["name"]],
                "launches_by_path": {p: n[fixed["name"]] for p, n in by_path.items()},
                "max_abs_err": max(r["max_abs_err"] for r in rows
                                   if r["dtype"] == "float32"),
                "max_abs_err_bf16": max(r["max_abs_err"] for r in rows
                                        if r["dtype"] == "bfloat16"),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head.get("library_ms"),
                "shape": head_shape, "dtype": "float32"}

    print(smi, flush=True)
    emit({"kernels": [
        summary(k1, [32000, 8, 300, 512], "train", name="lstm_layer",
                source="visdial_tpu_torch/csrc/lstm_fwd.cu",
                replaces="visdial_tpu/ops/lstm_pallas.py:99",
                # LF's history layer (train_lf), left-aligned
                history_head=side_head(k1, list(HIST_HEAD),
                                       ("align", "cs_ms", "library_ms",
                                        "library_pack_ms")),
                library_pack_ms=head_row(k1, [32000, 8, 300, 512])["library_pack_ms"],
                # HRE/HREA's dialog LSTM, every step real: cuDNN unpacked
                dialog_head=side_head(k1, list(DIALOG_HEAD),
                                      ("align", "library_ms")),
                # the head in bf16 beside cuDNN's LSTM in bf16
                bf16_head=side_head(k1, list(LSTM_HEAD),
                                    ("library_ms", "library_pack_ms"),
                                    "bfloat16")),
        summary(k2, [32000, 8, 300, 512], "train", name="lstm_layer_bwd",
                source="visdial_tpu_torch/csrc/lstm_bwd.cu",
                replaces="visdial_tpu/ops/lstm_pallas.py:305",
                # LF's top history layer: g_hs only at the bounds
                history_head=side_head(k2, list(HIST_HEAD),
                                       ("align", "sparse_g_hs", "bwd_ms",
                                        "library_ms"), sparse_g_hs=True),
                # cuDNN's backward computes dx and dW too: beside it stands
                # LSTMLayerFn's whole backward, K2 and the GEMMs
                bwd_ms=head_row(k2, [32000, 8, 300, 512])["bwd_ms"],
                dialog_head=side_head(k2, list(DIALOG_HEAD),
                                      ("align", "bwd_ms", "library_ms")),
                # the head in bf16: LSTMLayerFn's whole backward (K2 and
                # the bf16 contractions) beside cuDNN's bf16 backward
                bf16_head=side_head(k2, list(LSTM_HEAD), ("bwd_ms",
                                                          "library_ms"),
                                    "bfloat16", sparse_g_hs=False)),
        summary(k3, [32, 10, 10, 512], "train", name="attention",
                source="visdial_tpu_torch/csrc/attention_fusion.cu",
                replaces="visdial_tpu/ops/attention_pallas.py:24",
                # img_spatial's 49 pool5 locations, all visible
                spatial_head=side_head(k3, [32, 10, 49, 512],
                                       ("launch_ms", "library_ms"))),
        summary(k4, [1, 10, 10, 512], "serve", name="attention_fusion",
                source="visdial_tpu_torch/csrc/attention_fusion.cu",
                replaces="visdial_tpu/ops/attention_pallas.py:115",
                # the eval batch's head (gen eval, the disc streaming eval),
                # on the tensor-core route
                eval_head=side_head(k4, [32, 10, 10, 512],
                                    ("route", "launch_ms", "pack_ms"))),
        summary(k5, [2880, 512, 8804], "gen_train", name="lm_score",
                source="visdial_tpu_torch/csrc/lm_score.cu",
                replaces="visdial_tpu/ops/lm_score_pallas.py:37"),
        summary(k6, [2880, 512, 8804], "gen_train", name="lm_dlogits",
                source="visdial_tpu_torch/csrc/lm_score.cu",
                replaces="visdial_tpu/ops/lm_score_pallas.py:161"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
