"""Text tokenization for the serving path without nltk (port of
visdial_tpu/data/prepro.py::tokenize).

The shared tokenizer lowercases and runs nltk's word tokenizer, and the
machine with the card has no nltk.  This module carries the same rules:
its own copy of the shared module's regex sentence split, then, per
sentence, the regex
passes of nltk's NLTKWordTokenizer (the tokenizer behind word_tokenize;
parentheses are not converted).  Where nltk's punkt data is installed the
shared tokenizer splits sentences with punkt instead, which can differ on
multi-sentence text with abbreviations; VisDial questions are single
sentences.
"""

from __future__ import annotations

import re

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
