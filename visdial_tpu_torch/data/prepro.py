"""Offline dialog preprocessing without nltk (port of
visdial_tpu/data/prepro.py): the tokenizer, and the CLI that turns
VisDial-format JSON into the loader's npz/json artifacts.

Reads VisDial-format JSON (the released v0.9/v1.0 schema:
``{"data": {"questions": [...], "answers": [...], "dialogs": [...]}}`` with
per-dialog ``image_id``, ``caption`` and per-round ``question``/``answer``/
``answer_options``/``gt_index`` indices into the shared string lists),
tokenizes, builds the vocabulary from the train split only (min count 5,
sorted lexicographically), encodes and pads, keeps the deduplicated
candidate-answer list + per-round option indices, and writes

    visdial_data_<split>.npz   (VisDialSplit arrays, train / val / test)
    visdial_params.json        (word2ind)

round_valid marks the rankable rounds (a full candidate list and a ground
truth), round_scoreable the rounds with a full candidate list (the v1.0
test split's submission rounds, which have no ground truth).  Image
features come from a sidecar ``.npz`` (or ``.h5``, read through h5py where
it is installed) written by ``python -m visdial_tpu_torch.data.prepro_img``;
``--img_feats_<split> ''`` writes zero features.  The README's real-data
recipe runs this CLI without features, then prepro_img on the split's
image ids, then this CLI again with the features.

Tokenization: the shared tokenizer lowercases and runs nltk's word
tokenizer, and the port runs without nltk.  This module carries the same
rules: its own copy of the shared module's regex sentence split, then, per
sentence, the regex passes of nltk's NLTKWordTokenizer (the tokenizer
behind word_tokenize; parentheses are not converted).  Where nltk's punkt
data is installed the shared tokenizer splits sentences with punkt instead,
which can differ on multi-sentence text with abbreviations; VisDial
questions and answers are single sentences.

Usage:
    python -m visdial_tpu_torch.data.prepro \
        --train_json visdial_0.9_train.json --val_json visdial_0.9_val.json \
        [--test_json visdial_1.0_test.json] \
        [--img_feats_train feats_train.npz --img_feats_val feats_val.npz] \
        --out_dir data
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

from .dataset import VisDialSplit, Vocabulary
from .ingest_h5 import require_h5py

# visdial_tpu/data/prepro.py's data-free sentence split: after sentence-final
# punctuation and whitespace, except after the abbreviations punkt keeps
# mid-sentence (the input is lowercased)
_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_ABBREVS = frozenset((
    "mr.", "mrs.", "ms.", "dr.", "prof.", "st.", "mt.", "u.s.", "u.k.",
    "a.m.", "p.m.", "e.g.", "i.e.", "etc.", "vs.", "approx.", "ft.", "in.",
))


def _sentences(text: str) -> list[str]:
    parts = []
    for p in _SENT_RE.split(text):
        if not p:
            continue
        if parts and parts[-1].rsplit(None, 1)[-1] in _ABBREVS:
            parts[-1] = parts[-1] + " " + p
        else:
            parts.append(p)
    return parts


_STARTING_QUOTES = [
    (re.compile("([\u00ab\u201c\u2018\u201e]|[`]+)"), r" \1 "),
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
    (re.compile(r"(?i)(\')(?!re|ve|ll|m|t|s|d|n)(\w)\b"), r"\1 \2"),
]
_PUNCTUATION = [
    (re.compile(r'([^\.])(\.)([\]\)}>"\'' "\u00bb\u201d\u2019 " r"]*)\s*$"), r"\1 \2 \3 "),
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.{2,}"), r" \g<0> "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r"[\u2012-\u2015]"), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"[*]"), r" \g<0> "),
]
_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile("([\u00bb\u201d\u2019])"), r" \1 "),
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"\s+"), " "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_CONTRACTIONS = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
    r"(?i) ('t)(?#X)(is)\b",
    r"(?i) ('t)(?#X)(was)\b",
)]


def word_tokenize(text: str) -> list[str]:
    """nltk's NLTKWordTokenizer().tokenize(text), for one sentence."""
    for regexp, sub in _STARTING_QUOTES + _PUNCTUATION:
        text = regexp.sub(sub, text)
    for regexp, sub in (_PARENS_BRACKETS, _DOUBLE_DASHES):
        text = regexp.sub(sub, text)
    text = " " + text + " "
    for regexp, sub in _ENDING_QUOTES:
        text = regexp.sub(sub, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


def tokenize(text: str) -> list[str]:
    """Lowercased word tokens, as visdial_tpu.data.prepro.tokenize gives
    them without punkt data."""
    return [t for sent in _sentences(str(text).lower())
            for t in word_tokenize(sent)]


def load_visdial_json(path: str) -> dict:
    with open(path) as f:
        raw = json.load(f)
    data = raw["data"] if "data" in raw else raw
    return {
        "questions": data["questions"],
        "answers": data["answers"],
        "dialogs": data["dialogs"],
    }


def _encode_rows(token_lists, vocab: Vocabulary, max_len: int):
    arr = np.zeros((len(token_lists), max_len), np.int32)
    lens = np.zeros(len(token_lists), np.int32)
    for i, toks in enumerate(token_lists):
        arr[i], lens[i] = vocab.encode(toks, max_len)
    return arr, lens


def build_split(data: dict, vocab: Vocabulary, cfg_caps: dict,
                img_feat: np.ndarray | None, num_rounds: int = 10,
                num_options: int = 100) -> VisDialSplit:
    """Encode one split against a (frozen) vocabulary."""
    Lq, La, Lc = cfg_caps["ques"], cfg_caps["ans"], cfg_caps["cap"]
    dialogs = data["dialogs"]
    q_tok = [tokenize(q) for q in data["questions"]]
    a_tok = [tokenize(a) for a in data["answers"]]
    q_enc, q_len = _encode_rows(q_tok, vocab, Lq)
    a_enc, a_len = _encode_rows(a_tok, vocab, La)

    N = len(dialogs)
    ques = np.zeros((N, num_rounds, Lq), np.int32)
    ques_len = np.zeros((N, num_rounds), np.int32)
    ans = np.zeros((N, num_rounds, La), np.int32)
    ans_len = np.zeros((N, num_rounds), np.int32)
    cap = np.zeros((N, Lc), np.int32)
    cap_len = np.zeros(N, np.int32)
    opt_inds = np.zeros((N, num_rounds, num_options), np.int32)
    gt_ind = np.zeros((N, num_rounds), np.int32)
    round_valid = np.zeros((N, num_rounds), np.int32)
    round_scoreable = np.zeros((N, num_rounds), np.int32)
    img_ids = np.zeros(N, np.int64)

    # The dedup'd option list IS the global answer list (the released JSON
    # already shares answers by index — the reference's prepro dedups raw
    # strings into the same structure).
    opt_list, opt_list_len = a_enc, a_len

    for i, d in enumerate(dialogs):
        img_ids[i] = int(d.get("image_id", i))
        cap[i], cap_len[i] = vocab.encode(tokenize(d.get("caption", "")), Lc)
        # v0.9-style train dialogs always carry num_rounds fully annotated
        # rounds; v1.0 val/test dialogs may have fewer rounds, or rounds
        # missing the answer (test) or the candidate list.  Short dialogs
        # are zero-padded; round_valid marks RANKABLE rounds (full
        # candidate list + gt) and gates disc loss and retrieval metrics.
        # Gen training masks on answer presence instead (gen_loss), so an
        # answer-only round still trains the LM.  (Behavior of record —
        # the empty-mount rule in SURVEY.md §0: decide + document.)
        rounds = d["dialog"][:num_rounds]
        for r, turn in enumerate(rounds):
            qi, ai = int(turn["question"]), int(turn.get("answer", -1))
            ques[i, r], ques_len[i, r] = q_enc[qi], q_len[qi]
            if ai >= 0:
                ans[i, r], ans_len[i, r] = a_enc[ai], a_len[ai]
            opts = [int(o) for o in
                    turn.get("answer_options", [])[:num_options]]
            if len(opts) == num_options:
                opt_inds[i, r] = opts
                # full candidate list -> scoreable (dumped by --save_ranks)
                # even without gt: the v1.0 TEST split's submission rounds
                round_scoreable[i, r] = 1
                gt = turn.get("gt_index")
                if gt is None and ai >= 0:
                    # some exports store the answer id, not the slot
                    gt = opts.index(ai)
                if gt is not None:
                    gt_ind[i, r] = int(gt)
                    # content check only when the (redundant) answer field
                    # is present — some exports omit it, gt_index alone is
                    # enough to rank
                    assert ai < 0 or opts[gt_ind[i, r]] == ai, (
                        f"dialog {i} round {r}: gt_index does not point at "
                        "the ground-truth answer")
                    round_valid[i, r] = 1

    if img_feat is None:
        img_feat = np.zeros((N, 1), np.float32)
    assert img_feat.shape[0] == N, (
        f"{img_feat.shape[0]} image features for {N} dialogs")

    return VisDialSplit(
        ques=ques, ques_len=ques_len, ans=ans, ans_len=ans_len,
        cap=cap, cap_len=cap_len,
        opt_list=opt_list, opt_list_len=opt_list_len,
        opt_inds=opt_inds, gt_ind=gt_ind,
        img_feat=img_feat.astype(np.float32), img_ids=img_ids,
        round_valid=round_valid, round_scoreable=round_scoreable,
    ).validate()


def load_img_feats(path: str, split: str,
                   spatial: bool = False) -> np.ndarray | None:
    """fc7 (N, 4096) by default; with spatial=True the pool5 map written by
    prepro_img --save_pool5 ((N, 7, 7, 512)), flattened to (N, 25088) for
    the img_spatial encoder pathway."""
    if not path:
        return None
    keys = ([f"pool5_{split}", "pool5"] if spatial
            else [f"images_{split}", "features"])
    def pick(available):
        key = next((k for k in keys if k in available), None)
        if key is None:
            raise ValueError(
                f"{path}: no {'/'.join(keys)} array for split {split!r} "
                f"(have: {sorted(available)}); --img_spatial needs a pool5 "
                "map from prepro_img --save_pool5" if spatial else
                f"{path}: no {'/'.join(keys)} array for split {split!r} "
                f"(have: {sorted(available)})")
        return key

    if path.endswith((".h5", ".hdf5")):
        h5py = require_h5py()
        with h5py.File(path, "r") as f:
            feats = np.asarray(f[pick(list(f))], np.float32)
    else:
        with np.load(path) as z:
            feats = np.asarray(z[pick(z.files)], np.float32)
    return feats.reshape(len(feats), -1) if spatial else feats


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train_json", required=True)
    p.add_argument("--val_json", required=True)
    p.add_argument("--test_json", type=str, default="",
                   help="optional v1.0 test split (submission rounds carry "
                        "options but no gt — scoreable, not rankable)")
    p.add_argument("--img_feats_train", type=str, default="")
    p.add_argument("--img_feats_val", type=str, default="")
    p.add_argument("--img_feats_test", type=str, default="")
    p.add_argument("--out_dir", type=str, default="data")
    p.add_argument("--min_count", type=int, default=5)
    p.add_argument("--max_ques_len", type=int, default=16)
    p.add_argument("--max_ans_len", type=int, default=8)
    p.add_argument("--max_cap_len", type=int, default=40)
    p.add_argument("--num_rounds", type=int, default=10)
    p.add_argument("--num_options", type=int, default=100)
    p.add_argument("--img_spatial", action="store_true",
                   help="store the pool5 spatial map (flattened 7x7x512) "
                        "from the feature files instead of fc7 — pairs "
                        "with Config.img_spatial")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    caps = {"ques": args.max_ques_len, "ans": args.max_ans_len,
            "cap": args.max_cap_len}

    train = load_visdial_json(args.train_json)
    val = load_visdial_json(args.val_json)

    # Vocabulary from the TRAIN split only (reference: prepro.py builds the
    # vocab on train; val OOV becomes <UNK>).
    corpus = ([tokenize(q) for q in train["questions"]]
              + [tokenize(a) for a in train["answers"]]
              + [tokenize(d.get("caption", "")) for d in train["dialogs"]])
    vocab = Vocabulary.build(corpus, min_count=args.min_count)
    vocab.save(os.path.join(args.out_dir, "visdial_params.json"))
    print(f"vocab: {vocab.size} entries (min_count={args.min_count}) "
          f"sha256={vocab.content_hash()}")

    splits = [("train", train, args.img_feats_train),
              ("val", val, args.img_feats_val)]
    if args.test_json:
        splits.append(("test", load_visdial_json(args.test_json),
                       args.img_feats_test))
    for split, data, feats_path in splits:
        feats = load_img_feats(feats_path, split, spatial=args.img_spatial)
        out = build_split(data, vocab, caps, feats,
                          num_rounds=args.num_rounds,
                          num_options=args.num_options)
        path = os.path.join(args.out_dir, f"visdial_data_{split}.npz")
        out.save(path)
        print(f"{split}: {out.num_dialogs} dialogs -> {path}")



if __name__ == "__main__":
    main()
