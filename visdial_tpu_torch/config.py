"""Frozen configuration (the port's own copy of visdial_tpu/config.py).

One frozen dataclass, constructed from argparse or a dict, serialized into
every checkpoint and metrics file, with the JAX package's fields, defaults
and validation, so a checkpoint's meta.json means the same thing to both
packages (tests/test_torch_data.py holds the two field by field).  Some
fields only steer the JAX package (prng_impl, mesh_model, the TPU notes
below); the port reads and ignores them.

Encoder/decoder names mirror the reference's 9x2 matrix
(reference: encoders/*.lua, decoders/{gen,disc}.lua).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any

# The reference's nine encoder variants (reference: encoders/ directory).
ENCODERS = (
    "lf-ques",
    "lf-ques-hist",
    "lf-ques-im",
    "lf-ques-im-hist",
    "hre-ques-hist",
    "hre-ques-im-hist",
    "hrea-ques-im-hist",
    "mn-ques-hist",
    "mn-ques-im-hist",
)

# The reference's two decoders (reference: decoders/gen.lua, decoders/disc.lua).
DECODERS = ("gen", "disc")

# Config fields a resumed run may override without invalidating the saved
# training state: run-control, IO, and execution-strategy knobs.  Everything
# else (architecture, data shapes, optimizer hyperparameters, RNG scheme) is
# structural — the saved state was produced under it, so a mismatch on
# resume must fail loudly instead of silently training current-flag math
# against old weights.
RESUME_OVERRIDABLE = frozenset({
    "num_epochs", "use_pallas", "compute_dtype", "remat",
    "mesh_data", "mesh_model", "gen_eval_bucketed", "disc_dedup_options",
    "data_dir", "save_path", "eval_every", "save_every", "log_every",
})


def resume_config_mismatches(saved: "Config", current: "Config") -> dict:
    """Structural fields that differ between a checkpoint's config and the
    current flags: {field: (saved_value, current_value)}."""
    diffs = {}
    for f in dataclasses.fields(Config):
        if f.name in RESUME_OVERRIDABLE:
            continue
        a, b = getattr(saved, f.name), getattr(current, f.name)
        if a != b:
            diffs[f.name] = (a, b)
    return diffs


def encoder_uses_image(encoder: str) -> bool:
    return "-im" in encoder


def encoder_uses_history(encoder: str) -> bool:
    return "-hist" in encoder


def encoder_family(encoder: str) -> str:
    """'lf' | 'hre' | 'hrea' | 'mn'."""
    return encoder.split("-", 1)[0]


@dataclass(frozen=True)
class Config:
    """All hyperparameters.  Defaults follow the reference option defaults
    (reference: train.lua cmd:option block; values marked [P] in SURVEY.md
    were chosen and documented here as the behavior of record).
    """

    # --- model ---
    encoder: str = "lf-ques-im-hist"
    decoder: str = "disc"
    vocab_size: int = 0          # filled from the data artifact
    embed_size: int = 300        # word embedding dim (reference -embedSize)
    rnn_hidden_size: int = 512   # LSTM hidden (reference -rnnHiddenSize)
    num_layers: int = 2          # LSTM layers (reference -numLayers)
    img_feat_size: int = 4096    # VGG-16 fc7 (reference data_img.h5 schema)
    img_embed_size: int = 300    # image projection (reference -imgEmbedSize)
    img_norm: bool = True        # L2-normalize image feature (reference -imgNorm)
    img_spatial: bool = False    # beyond-reference: image feature is a
                                 # flattened pool5 spatial map (slots x
                                 # channels); -im encoders attend over the
                                 # locations with the question state as the
                                 # query instead of projecting one fc7
                                 # vector (SURVEY.md §2 #12 conv5 note)
    img_spatial_slots: int = 49      # 7x7 pool5 grid
    img_spatial_channels: int = 512  # conv5 channels
    dropout: float = 0.5         # (reference -dropout; applied to LSTM outputs)

    # --- data shape contract (reference: data/prepro.py padding caps).
    # SURVEY.md marks the exact caps [P]; chosen behavior of record:
    # questions 16, answers 8, captions 40 tokens.
    max_ques_len: int = 16
    max_ans_len: int = 8
    max_cap_len: int = 40
    num_rounds: int = 10         # VisDial protocol: 10 rounds/dialog
    num_options: int = 100       # VisDial protocol: 100 candidates/round

    # --- training (reference: train.lua defaults; lrDecay chosen) ---
    batch_size: int = 32         # dialogs per step (rounds = 10x this)
    learning_rate: float = 1e-3
    lr_decay_rate: float = 0.9997  # multiplicative per-step decay
    min_lr: float = 5e-5
    grad_clip: float = 5.0       # L2 norm clip (reference model.lua, [P])
    num_epochs: int = 15
    seed: int = 1234
    optimizer: str = "adam"      # adam | sgd | rmsprop (reference optim_updates.lua)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8

    # --- TPU execution ---
    use_pallas: bool = True      # fused kernels on TPU; pure-JAX twin otherwise
    compute_dtype: str = "float32"  # float32 | bfloat16 for matmul inputs
    prng_impl: str = "rbg"       # rbg (TPU-native, faster dropout masks) |
                                 # threefry2x32 (JAX default, fully stable
                                 # across backends); applied by the CLIs
    gen_score_length_norm: bool = False
                                 # divide gen candidate scores by token
                                 # count (reference behavior is sum,
                                 # SURVEY.md [P]; flag aids parity tuning)
    gen_eval_bucketed: bool = True
                                 # gen retrieval eval: sort candidate rows
                                 # by length into static buckets and score
                                 # short rows at a narrower scan width —
                                 # identical scores (masked steps are exact
                                 # zeros), ~40% fewer FLOPs at real answer
                                 # lengths; False = single full-width pass
    disc_dedup_options: bool = True
                                 # disc TRAIN batches carry the batch's
                                 # UNIQUE candidate rows + a gather map
                                 # instead of the expanded (B,R,K,La)
                                 # tokens: candidates are draws from the
                                 # split's dedup'd opt_list, so rows repeat
                                 # within a batch (measured: 14% uniform,
                                 # 84-95% under zipf answer-popularity skew
                                 # — scripts/measure_dedup.py) and every
                                 # repeat is redundant option-LSTM work.
                                 # Scores/grads are exactly the plain
                                 # path's (same tokens per candidate); at
                                 # train time duplicate candidates SHARE
                                 # inter-layer dropout masks (noise-shape
                                 # only, same deviation class as
                                 # lf_hist_incremental).  False =
                                 # reference-exact per-candidate noise
    lf_hist_incremental: bool = True
                                 # LF history as ONE left-aligned LSTM pass
                                 # with per-round boundary readouts: the
                                 # deterministic computation is exactly
                                 # equivalent to per-round re-encoding with
                                 # ~10x fewer token-steps.  NOTE: at train
                                 # time the inter-layer dropout mask is
                                 # shared across a dialog's rounds (the
                                 # legacy path draws one per round); set
                                 # False for reference-exact noise sampling
    remat: bool = False          # jax.checkpoint the encoder in the loss:
                                 # trades ~1 extra encoder forward for not
                                 # storing its activations — enables much
                                 # larger batches / longer histories
    mesh_data: int = -1          # data-parallel axis size; -1 = all devices
    mesh_model: int = 1          # model axis (reserved, size 1 for this workload)

    # --- paths ---
    data_dir: str = "data"
    save_path: str = "checkpoints"
    eval_every: int = 0          # steps; 0 = every epoch
    save_every: int = 0          # steps; 0 = every epoch
    log_every: int = 50          # steps between JSONL metric records

    # Derived lengths -----------------------------------------------------
    @property
    def max_hist_concat_len(self) -> int:
        """LF concatenated history: caption + 9 full QA rounds.

        Reference dataloader.lua builds one concatenated token sequence per
        round (caption + Q1A1 + ... + Q(t-1)A(t-1)); we keep the full static
        worst case so no truncation is ever needed (documented decision —
        SURVEY.md §2 #5 marks reference truncation details [P]).
        """
        return self.max_cap_len + (self.num_rounds - 1) * (
            self.max_ques_len + self.max_ans_len
        )

    @property
    def max_fact_len(self) -> int:
        """Per-round 'fact' for HRE/MN: caption or one QA pair."""
        return max(self.max_cap_len, self.max_ques_len + self.max_ans_len)

    def validate(self) -> "Config":
        if self.encoder not in ENCODERS:
            raise ValueError(f"unknown encoder {self.encoder!r}; choose from {ENCODERS}")
        if self.decoder not in DECODERS:
            raise ValueError(f"unknown decoder {self.decoder!r}; choose from {DECODERS}")
        if self.optimizer not in ("adam", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.img_spatial and (self.img_feat_size
                                 != self.img_spatial_slots
                                 * self.img_spatial_channels):
            raise ValueError(
                f"img_spatial needs img_feat_size == slots*channels "
                f"({self.img_spatial_slots}*{self.img_spatial_channels}"
                f" != {self.img_feat_size})")
        return self

    # Serialization (checkpoints embed the config, like the reference
    # embeds `opt` inside every .t7 file) --------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields}).validate()

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw).validate()
