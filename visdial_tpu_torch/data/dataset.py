"""On-disk dataset artifact: the data contract (the port's own copy of
visdial_tpu/data/dataset.py).

The reference stores three artifacts (reference: data/prepro.py writers,
data/prepro_img.lua writer):

  * ``visdial_data.h5``    — token arrays, lengths, deduplicated option list,
                             per-round option indices, ground-truth index.
  * ``visdial_params.json``— word2ind / ind2word, image order.
  * ``data_img.h5``        — N x 4096 VGG-16 fc7 features.

We keep the same *logical* schema in a single ``.npz`` + sidecar ``.json``
per split (TPU-first packing: contiguous numpy arrays the loader can slice
without parsing).  Token index 0 is padding (the reference relies on
LookupTableMaskZero semantics); the special tokens <UNK>, <START>, <END>
are ordinary vocab entries appended after the min-count-filtered words
(reference: data/prepro.py vocabulary block).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np

PAD = 0
UNK_TOKEN = "<UNK>"
START_TOKEN = "<START>"
END_TOKEN = "<END>"


@dataclass
class VisDialSplit:
    """One split (train or val) of the dataset.

    Shapes (N dialogs, R rounds, Lq/La/Lc caps, M dedup'd options, F feat):
      ques      (N, R, Lq) int32, left-aligned, 0-padded
      ques_len  (N, R)     int32
      ans       (N, R, La) int32
      ans_len   (N, R)     int32
      cap       (N, Lc)    int32
      cap_len   (N,)       int32
      opt_list  (M, La)    int32   deduplicated candidate answers
      opt_list_len (M,)    int32
      opt_inds  (N, R, 100) int32  rows of opt_list  (reference memory trick)
      gt_ind    (N, R)     int32   ground-truth position in [0, 100)
      img_feat  (N, F)     float32 VGG-16 fc7 (or conv5-pooled) features
      img_ids   (N,)       int64   COCO image ids (bookkeeping)
      round_valid (N, R)   int32   1 = RANKABLE round (full candidate list
                                   + ground truth).  v0.9-style splits are
                                   all-ones (and omitting the field means
                                   all-ones — old artifacts load
                                   unchanged); v1.0 val/test dialogs with
                                   fewer than R rounds or rounds missing
                                   answer/options are padded and masked
                                   out of loss and metrics.
      round_scoreable (N, R) int32 1 = SCOREABLE round (full candidate
                                   list; ground truth optional) — the v1.0
                                   test split's submission rounds carry
                                   options but no gt_index, so they are
                                   scoreable (included in a --save_ranks
                                   dump) without being rankable.  Omitted
                                   field defaults to round_valid.
    """

    ques: np.ndarray
    ques_len: np.ndarray
    ans: np.ndarray
    ans_len: np.ndarray
    cap: np.ndarray
    cap_len: np.ndarray
    opt_list: np.ndarray
    opt_list_len: np.ndarray
    opt_inds: np.ndarray
    gt_ind: np.ndarray
    img_feat: np.ndarray
    img_ids: np.ndarray
    round_valid: np.ndarray | None = None
    round_scoreable: np.ndarray | None = None

    def __post_init__(self) -> None:
        if self.round_valid is None:
            self.round_valid = np.ones_like(self.gt_ind, dtype=np.int32)
        if self.round_scoreable is None:
            self.round_scoreable = self.round_valid.copy()

    @property
    def num_dialogs(self) -> int:
        return int(self.ques.shape[0])

    @property
    def num_rounds(self) -> int:
        return int(self.ques.shape[1])

    def validate(self) -> "VisDialSplit":
        n, r, _ = self.ques.shape
        assert self.ans.shape[:2] == (n, r)
        assert self.opt_inds.shape[:2] == (n, r)
        assert self.gt_ind.shape == (n, r)
        assert self.round_valid.shape == (n, r)
        assert self.round_scoreable.shape == (n, r)
        assert (self.round_scoreable >= self.round_valid).all(), \
            "every rankable round must be scoreable"
        assert self.img_feat.shape[0] == n
        assert self.opt_inds.max() < self.opt_list.shape[0]
        assert (self.gt_ind >= 0).all() and (self.gt_ind < self.opt_inds.shape[2]).all()
        return self

    def save(self, path: str) -> None:
        np.savez_compressed(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path: str) -> "VisDialSplit":
        with np.load(path) as z:
            return cls(**{k: z[k] for k in z.files}).validate()


@dataclass
class Vocabulary:
    """word <-> index map.  Index 0 is reserved for padding."""

    word2ind: dict[str, int]

    def __post_init__(self) -> None:
        self.ind2word = {i: w for w, i in self.word2ind.items()}

    @property
    def size(self) -> int:
        """Number of embedding rows needed: pad row + max index."""
        return max(self.word2ind.values()) + 1

    @property
    def unk(self) -> int:
        return self.word2ind[UNK_TOKEN]

    @property
    def start(self) -> int:
        return self.word2ind[START_TOKEN]

    @property
    def end(self) -> int:
        return self.word2ind[END_TOKEN]

    def encode(self, tokens: list[str], max_len: int) -> tuple[np.ndarray, int]:
        """Token list -> fixed-size left-aligned array (truncating)."""
        ids = [self.word2ind.get(t, self.unk) for t in tokens[:max_len]]
        out = np.zeros(max_len, dtype=np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    def decode(self, ids) -> list[str]:
        return [self.ind2word[int(i)] for i in ids if int(i) != PAD]

    def content_hash(self) -> str:
        """sha256 over the sorted (word, index) pairs — the identity of the
        vocabulary artifact.  Stored in visdial_params.json and printed by
        prepro so any tokenizer/vocab drift (nltk change, min-count tie
        behavior) is detectable by hash comparison instead of a silent MRR
        shift (SURVEY.md hard part #1)."""
        import hashlib

        payload = json.dumps(sorted(self.word2ind.items()),
                             separators=(",", ":")).encode()
        return hashlib.sha256(payload).hexdigest()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"word2ind": self.word2ind,
                       "vocab_sha256": self.content_hash()}, f)

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            payload = json.load(f)
        vocab = cls(word2ind=payload["word2ind"])
        stored = payload.get("vocab_sha256")
        if stored is not None and stored != vocab.content_hash():
            raise ValueError(
                f"{path}: vocab_sha256 mismatch — the artifact was edited "
                "or corrupted after prepro wrote it")
        return vocab

    @classmethod
    def build(cls, token_lists, min_count: int = 5) -> "Vocabulary":
        """Vocabulary from training tokens, min occurrence count 5
        (reference: data/prepro.py word-count threshold).  Ties/order:
        words sorted by first-occurrence order is NOT reproducible across
        runs of different corpora, so we sort kept words lexicographically —
        a deterministic, documented choice (SURVEY.md hard part #1).
        """
        counts: dict[str, int] = {}
        for toks in token_lists:
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
        kept = sorted(w for w, c in counts.items() if c >= min_count)
        word2ind = {w: i + 1 for i, w in enumerate(kept)}  # 0 = pad
        for special in (UNK_TOKEN, START_TOKEN, END_TOKEN):
            word2ind[special] = len(word2ind) + 1
        return cls(word2ind=word2ind)


def load_split(data_dir: str, split: str) -> tuple[VisDialSplit, Vocabulary]:
    """Load a split from data_dir (dataset.py::load_split).

    Accepts either artifact family found there:
      * native npz/json (written by the prepro / ingest_h5 CLIs), or
      * the reference's visdial_data.h5 + visdial_params.json + data_img.h5
        (reference: data/prepro.py + data/prepro_img.lua writers), read
        through data/ingest_h5.py where no npz exists -- so
        reference-produced data works with no conversion step where h5py
        is installed.
    """
    npz = os.path.join(data_dir, f"visdial_data_{split}.npz")
    if not os.path.exists(npz):
        from .ingest_h5 import (
            load_split_from_reference_dir,
            reference_artifacts_present,
        )

        if reference_artifacts_present(data_dir):
            return load_split_from_reference_dir(data_dir, split)
    data = VisDialSplit.load(npz)
    vocab = Vocabulary.load(os.path.join(data_dir, "visdial_params.json"))
    return data, vocab
