"""Ingest the reference's on-disk artifacts (h5 + json) directly (port of
visdial_tpu/data/ingest_h5.py).

The reference's offline pipeline writes three artifacts (reference:
data/prepro.py writers, data/prepro_img.lua writer; schema documented in
SURVEY.md §3.4 — "the h5/json artifacts are the contract"):

  * ``visdial_data.h5``     — per-split datasets ``ques_<split>``,
    ``ques_length_<split>``, ``ans_<split>``, ``ans_length_<split>``,
    ``cap_<split>``, ``cap_length_<split>``, ``opt_<split>`` (per-round
    candidate rows into the option list), ``opt_list_<split>`` +
    ``opt_length_<split>`` (deduplicated option tokens/lengths),
    ``ans_index_<split>`` (ground truth), ``img_pos_<split>`` (dialog →
    image-feature row).
  * ``visdial_params.json`` — ``word2ind``/``ind2word``, image order lists.
  * ``data_img.h5``         — ``images_<split>`` VGG-16 fc7 features.

This module maps those artifacts onto :class:`VisDialSplit`/
:class:`Vocabulary` so train/evaluate/generate consume reference-produced
data with no conversion step.  The index bases are explicit and
auto-detected, not guessed silently:

  * token ids: 0 = pad in both worlds — taken as-is.
  * option rows (``opt_<split>``): 1-based iff their max equals the option
    list length (detected; 0-based accepted too).
  * ``ans_index_<split>``: either the GT's *position* among the K candidates
    or the GT's *row* in the option list; detected by checking that every
    value matches the candidate row at that position, falling back to
    row-matching.
  * ``img_pos_<split>``: base detected the same way; absent means identity.
  * ``<START>``/``<END>``: the reference's dataloader appends them at
    vocabSize+1/+2 at runtime (they are not in visdial_params.json); we do
    the same when missing.

h5py is imported at first use.  Where it is not installed, reading an h5
file raises an ImportError that says so and names the npz route: repack the artifacts once with this CLI where
h5py exists, or write the npz from the VisDial JSON with
``python -m visdial_tpu_torch.data.prepro``.

CLI (one-time repack into the native npz/json artifacts)::

    python -m visdial_tpu_torch.data.ingest_h5 --data_h5 visdial_data.h5 \
        --params_json visdial_params.json --img_h5 data_img.h5 \
        --out_dir data/ --splits train,val
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .dataset import (
    END_TOKEN,
    START_TOKEN,
    UNK_TOKEN,
    VisDialSplit,
    Vocabulary,
)


def require_h5py():
    """The h5py module, imported now; where it is missing, an ImportError
    that says so and names the npz route."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading the reference's h5 artifacts needs h5py, which is not "
            "installed here: repack them once into npz/json with `python -m "
            "visdial_tpu_torch.data.ingest_h5` where h5py is installed, or "
            "write the npz from the VisDial JSON with `python -m "
            "visdial_tpu_torch.data.prepro`, and pass that directory as "
            "--data_dir") from e
    return h5py


def _get(h5, *names, required=True):
    for n in names:
        if n in h5:
            return np.asarray(h5[n])
    if required:
        raise KeyError(f"none of {names} found in h5 (have: {list(h5)})")
    return None


def load_reference_vocab(params_json: str) -> Vocabulary:
    """visdial_params.json -> Vocabulary, appending <START>/<END> when the
    file carries only the prepro vocab (the reference's dataloader appends
    them at vocabSize+1/+2 at runtime)."""
    with open(params_json) as f:
        params = json.load(f)
    if "word2ind" in params:
        word2ind = {w: int(i) for w, i in params["word2ind"].items()}
    elif "ind2word" in params:
        word2ind = {w: int(i) for i, w in params["ind2word"].items()}
    else:
        raise KeyError("visdial_params.json has neither word2ind nor ind2word")
    if UNK_TOKEN not in word2ind:
        word2ind[UNK_TOKEN] = max(word2ind.values()) + 1
    for special in (START_TOKEN, END_TOKEN):
        if special not in word2ind:
            word2ind[special] = max(word2ind.values()) + 1
    return Vocabulary(word2ind=word2ind)


def _detect_opt_base(opt: np.ndarray, num_rows: int) -> int:
    """1 iff the indices are Lua 1-based rows into a num_rows-long table.

    0 appearing anywhere proves 0-based; a value equal to num_rows proves
    1-based.  When neither bound is hit (possible only on tiny data — real
    v0.9 candidate arrays cover the full option list), 1-based wins because
    the reference artifacts are written for Lua consumers.
    """
    mx, mn = int(opt.max()), int(opt.min())
    if mn == 0 and mx <= num_rows - 1:
        return 0
    if mn >= 1 and mx == num_rows:
        return 1
    if mn >= 1 and mx <= num_rows:
        return 1  # ambiguous: prefer the Lua convention (documented above)
    raise ValueError(
        f"table indices out of range: min={mn} max={mx} rows={num_rows}")


def _detect_pos_base(pos: np.ndarray, num_rows: int) -> int:
    """Index base for img_pos — unlike option rows there is no content
    check available, so only an UNAMBIGUOUS bound is accepted: a silent
    wrong guess would pair every dialog with the wrong image features.
    """
    mx, mn = int(pos.max()), int(pos.min())
    if mn == 0 and mx <= num_rows - 1:
        return 0
    if mn >= 1 and mx == num_rows:
        return 1
    raise ValueError(
        f"img_pos base is ambiguous (min={mn}, max={mx}, feature rows="
        f"{num_rows}): neither 0 nor the row count appears. Repack the "
        "artifacts with explicit 0-based img_pos (e.g. via "
        "`python -m visdial_tpu_torch.data.ingest_h5` on a corrected file) "
        "rather than risking silently shifted image features.")


def _gt_positions(ans_index: np.ndarray, opt_rows: np.ndarray) -> np.ndarray:
    """ans_index (N, R) -> GT position in [0, K).

    Detects the storage convention (SURVEY.md §0: choose + document, never
    guess silently).  The row-of-opt-list convention is tried first because
    it verifies content — the claimed GT row must appear among the K
    candidate rows of EVERY round, which a positional index with a large
    option list cannot satisfy by accident.  The position-among-candidates
    convention (values all in [base, K+base)) is the fallback.
    opt_rows must already be 0-based.
    """
    k = opt_rows.shape[2]
    for base in (1, 0):  # Lua artifacts are 1-based; try that first
        rows = ans_index - base
        if rows.min() >= 0:
            eq = opt_rows == rows[..., None]
            if eq.any(axis=2).all():
                return eq.argmax(axis=2).astype(np.int32)
    for base in (1, 0):
        pos = ans_index - base
        if pos.min() >= 0 and pos.max() < k:
            return pos.astype(np.int32)
    raise ValueError("cannot interpret ans_index under any known convention")


def load_reference_split(data_h5: str, params_json: str, img_h5: str,
                         split: str) -> tuple[VisDialSplit, Vocabulary]:
    """Read one split of the reference artifacts into our dataclasses."""
    h5py = require_h5py()
    vocab = load_reference_vocab(params_json)
    with h5py.File(data_h5, "r") as h:
        ques = _get(h, f"ques_{split}").astype(np.int32)
        ques_len = _get(h, f"ques_length_{split}",
                        f"ques_len_{split}").astype(np.int32)
        ans = _get(h, f"ans_{split}").astype(np.int32)
        ans_len = _get(h, f"ans_length_{split}",
                       f"ans_len_{split}").astype(np.int32)
        cap = _get(h, f"cap_{split}").astype(np.int32)
        cap_len = _get(h, f"cap_length_{split}",
                       f"cap_len_{split}").astype(np.int32)
        opt_list = _get(h, f"opt_list_{split}", "opt_list").astype(np.int32)
        opt_list_len = _get(h, f"opt_length_{split}", f"opt_len_{split}",
                            "opt_length", required=False)
        opt_rows = _get(h, f"opt_{split}").astype(np.int64)
        ans_index = _get(h, f"ans_index_{split}").astype(np.int64)
        img_pos = _get(h, f"img_pos_{split}", required=False)
    if opt_list_len is None:
        opt_list_len = (opt_list != 0).sum(axis=1)
    opt_list_len = np.asarray(opt_list_len).astype(np.int32)

    base = _detect_opt_base(opt_rows, opt_list.shape[0])
    opt_rows = opt_rows - base
    gt_ind = _gt_positions(ans_index, opt_rows)

    with h5py.File(img_h5, "r") as h:
        img = _get(h, f"images_{split}", f"images_{split}_fc7",
                   "images").astype(np.float32)
    n = ques.shape[0]
    if img_pos is not None:
        img_pos = np.asarray(img_pos).astype(np.int64)
        pos_base = _detect_pos_base(img_pos, img.shape[0])
        img_feat = img[img_pos - pos_base]
        img_ids = img_pos - pos_base
    else:
        assert img.shape[0] >= n, (
            f"{img.shape[0]} image rows for {n} dialogs and no img_pos")
        img_feat = img[:n]
        img_ids = np.arange(n, dtype=np.int64)

    split_obj = VisDialSplit(
        ques=ques, ques_len=ques_len, ans=ans, ans_len=ans_len,
        cap=cap, cap_len=cap_len,
        opt_list=opt_list, opt_list_len=opt_list_len,
        opt_inds=opt_rows.astype(np.int32), gt_ind=gt_ind,
        img_feat=img_feat, img_ids=np.asarray(img_ids, dtype=np.int64),
    ).validate()
    return split_obj, vocab


def reference_artifacts_present(data_dir: str) -> bool:
    return (os.path.exists(os.path.join(data_dir, "visdial_data.h5"))
            and os.path.exists(os.path.join(data_dir, "visdial_params.json"))
            and os.path.exists(os.path.join(data_dir, "data_img.h5")))


def load_split_from_reference_dir(data_dir: str, split: str):
    """Loader hook: a data_dir holding the three reference artifacts is a
    valid dataset directory (used by dataset.load_split as a fallback)."""
    return load_reference_split(
        os.path.join(data_dir, "visdial_data.h5"),
        os.path.join(data_dir, "visdial_params.json"),
        os.path.join(data_dir, "data_img.h5"),
        split,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Repack reference h5/json artifacts into native npz/json")
    p.add_argument("--data_h5", required=True)
    p.add_argument("--params_json", required=True)
    p.add_argument("--img_h5", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--splits", default="train,val")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    # refuse to clobber the INPUT reference artifact: out_dir == the
    # artifacts' own directory would overwrite visdial_params.json with
    # the native vocab payload, destroying the reference file's ind2word
    # and image-order lists irrecoverably
    out_params = os.path.join(args.out_dir, "visdial_params.json")
    if (os.path.exists(out_params) and os.path.exists(args.params_json)
            and os.path.samefile(out_params, args.params_json)):
        p.error(f"--out_dir would overwrite the input --params_json "
                f"({args.params_json}); choose a different out_dir")
    vocab = None
    for split in args.splits.split(","):
        data, vocab = load_reference_split(
            args.data_h5, args.params_json, args.img_h5, split)
        out = os.path.join(args.out_dir, f"visdial_data_{split}.npz")
        data.save(out)
        print(f"{split}: {data.num_dialogs} dialogs, "
              f"{data.opt_list.shape[0]} unique options -> {out}")
    vocab.save(os.path.join(args.out_dir, "visdial_params.json"))
    print(f"vocab: {vocab.size} rows -> "
          f"{os.path.join(args.out_dir, 'visdial_params.json')}")


if __name__ == "__main__":
    main()
