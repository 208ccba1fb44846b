"""CER / WER metrics.

Matches the reference definitions (model_v1/valid.py:49-75):
  CER = sum(editdistance(pred, gt)) / sum(len(gt))            over characters
  WER = same over word tokens after punctuation isolation
        (format_string_for_wer, model_v1/utils/utils.py:176-179).

The port's copy of ``htr_vt_tpu/text/metrics.py``: edit distances run in the
module's pure-Python Levenshtein (the reference package's C++ extension is
not carried over), with the same aggregation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

_WER_PUNCT = re.compile(r'([\[\]{}/\\()\"\'&+*=<>?.;:,!\-—_€#%°])')
_WER_SPACE = re.compile(r"([ \n])+")


def format_string_for_wer(s: str) -> str:
    """Punctuation-splitting tokenizer used before WER (reference verbatim
    semantics, model_v1/utils/utils.py:176-179)."""
    s = _WER_PUNCT.sub(r" \1 ", s)
    return _WER_SPACE.sub(" ", s).strip()


def _python_levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def batch_edit_distance(preds: List[List[int]], refs: List[List[int]]) -> np.ndarray:
    """Per-pair Levenshtein distances over integer symbol sequences."""
    assert len(preds) == len(refs)
    return np.asarray([_python_levenshtein(p, r) for p, r in zip(preds, refs)],
                      np.int64)


def _chars_to_ids(s: str) -> List[int]:
    return [ord(c) for c in s]


def _words_to_ids(words: List[str], vocab: Dict[str, int]) -> List[int]:
    return [vocab.setdefault(w, len(vocab)) for w in words]


@dataclass
class RecognitionMetrics:
    """Streaming CER/WER accumulator with the reference's aggregation."""

    total_char_ed: int = 0
    total_char_len: int = 0
    total_word_ed: int = 0
    total_word_len: int = 0
    # per-sample normalized sums (the reference also tracks these as norm_ED)
    norm_char_ed: float = 0.0
    norm_word_ed: float = 0.0
    count: int = 0

    def update(self, preds: Sequence[str], refs: Sequence[str]) -> None:
        char_p = [_chars_to_ids(p) for p in preds]
        char_r = [_chars_to_ids(r) for r in refs]
        ed = batch_edit_distance(char_p, char_r)
        vocab: Dict[str, int] = {}
        word_p, word_r = [], []
        for p, r in zip(preds, refs):
            word_p.append(_words_to_ids(format_string_for_wer(p).split(" "), vocab))
            word_r.append(_words_to_ids(format_string_for_wer(r).split(" "), vocab))
        wed = batch_edit_distance(word_p, word_r)

        for i, r in enumerate(refs):
            self.total_char_ed += int(ed[i])
            self.total_char_len += len(r)
            self.norm_char_ed += 1.0 if len(r) == 0 else ed[i] / len(r)
            nw = len(word_r[i])
            self.total_word_ed += int(wed[i])
            self.total_word_len += nw
            self.norm_word_ed += 1.0 if nw == 0 else wed[i] / nw
            self.count += 1

    @property
    def cer(self) -> float:
        return self.total_char_ed / max(1, self.total_char_len)

    @property
    def wer(self) -> float:
        return self.total_word_ed / max(1, self.total_word_len)


def cer_wer(preds: Sequence[str], refs: Sequence[str]) -> Tuple[float, float]:
    m = RecognitionMetrics()
    m.update(preds, refs)
    return m.cer, m.wer


def per_sample_cer_wer(pred: str, ref: str) -> Tuple[float, float]:
    """Per-sample normalized CER/WER as written into predictions.json by the
    reference test harness (model_v1/test.py inline DP Levenshtein)."""
    ced = batch_edit_distance([_chars_to_ids(pred)], [_chars_to_ids(ref)])[0]
    vocab: Dict[str, int] = {}
    wp = _words_to_ids(format_string_for_wer(pred).split(" "), vocab)
    wr = _words_to_ids(format_string_for_wer(ref).split(" "), vocab)
    wed = batch_edit_distance([wp], [wr])[0]
    cer = 1.0 if len(ref) == 0 else ced / len(ref)
    wer = 1.0 if len(wr) == 0 else wed / len(wr)
    return float(cer), float(wer)
