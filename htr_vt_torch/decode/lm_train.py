"""N-gram language model estimation -> ARPA file.

The reference's LM path assumes an externally built KenLM ARPA file
(model_window/test_with_kenlm.py). This module closes the toolchain gap:
estimate a word- or character-level n-gram LM with absolute-discount (Katz
style) backoff directly from training labels and write standard ARPA, which
both the native scorer (native/ngram_lm.cpp) and kenlm itself can load.

    from htr_vt_torch.decode.lm_train import train_ngram_arpa
    train_ngram_arpa(train_labels, "iam_word3.arpa", order=3, level="word")

The port's own copy of ``htr_vt_tpu/decode/lm_train.py``, held to it by
``tests/test_torch_port_decode_lm.py``.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"


def _tokenize(text: str, level: str) -> List[str]:
    if level == "word":
        return text.split()
    # char level: spaces become a visible token so the LM models word breaks
    return ["<sp>" if c == " " else c for c in text]


def train_ngram_arpa(texts: Sequence[str], out_path: str, order: int = 3,
                     level: str = "word", discount: float = 0.75,
                     unk_logprob: float = -6.0) -> Dict[int, int]:
    """Estimate and write an ARPA LM. Returns {n: num_ngrams}.

    Absolute discounting with backoff:
      p(w|ctx) = max(c(ctx,w) - D, 0)/c(ctx) + bow(ctx) * p(w|ctx')
      bow(ctx) = D * N1+(ctx) / c(ctx)
    """
    counts: List[Counter] = [Counter() for _ in range(order + 1)]
    for text in texts:
        toks = [BOS] + _tokenize(text, level) + [EOS]
        for n in range(1, order + 1):
            for i in range(len(toks) - n + 1):
                counts[n][tuple(toks[i:i + n])] += 1

    # context totals and continuation type counts
    ctx_total: List[Dict[Tuple, int]] = [defaultdict(int) for _ in range(order + 1)]
    ctx_types: List[Dict[Tuple, int]] = [defaultdict(int) for _ in range(order + 1)]
    for n in range(1, order + 1):
        for gram, c in counts[n].items():
            ctx_total[n][gram[:-1]] += c
            ctx_types[n][gram[:-1]] += 1

    # probabilities (log10) per order, and backoff weights per context
    probs: List[Dict[Tuple, float]] = [dict() for _ in range(order + 1)]
    bows: List[Dict[Tuple, float]] = [dict() for _ in range(order + 1)]

    unigram_total = sum(counts[1].values())
    for gram, c in counts[1].items():
        p = max(c - discount, 0.0) / unigram_total
        # redistribute discounted unigram mass uniformly over the vocab
        p += discount * len(counts[1]) / unigram_total / len(counts[1])
        probs[1][gram] = math.log10(p)

    for n in range(2, order + 1):
        for gram, c in counts[n].items():
            ctx = gram[:-1]
            total = ctx_total[n][ctx]
            p_high = max(c - discount, 0.0) / total
            bow_mass = discount * ctx_types[n][ctx] / total
            p_low = 10 ** _lookup(probs, gram[1:], unk_logprob)
            probs[n][gram] = math.log10(p_high + bow_mass * p_low)
        # backoff weight stored with the (n-1)-gram context entry
        for ctx, total in ctx_total[n].items():
            bows[n - 1][ctx] = math.log10(
                max(discount * ctx_types[n][ctx] / total, 1e-10))

    # <s> needs a unigram entry (prob irrelevant, ARPA convention -99)
    probs[1].setdefault((BOS,), -99.0)
    probs[1].setdefault((UNK,), unk_logprob)

    ngram_counts = {n: len(probs[n]) for n in range(1, order + 1)}
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n in range(1, order + 1):
            f.write(f"ngram {n}={ngram_counts[n]}\n")
        for n in range(1, order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for gram in sorted(probs[n]):
                lp = probs[n][gram]
                bow = bows[n].get(gram)
                line = f"{lp:.6f}\t{' '.join(gram)}"
                if n < order and bow is not None:
                    line += f"\t{bow:.6f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")
    if out_path.endswith(".htlm"):
        # Caller asked for the compiled form directly: the ARPA text above
        # was written to out_path; recompile it in place (decode/lm_compile).
        from htr_vt_torch.decode.lm import NgramScorer
        NgramScorer(out_path).save_binary(out_path)
    return ngram_counts


def _lookup(probs: List[Dict[Tuple, float]], gram: Tuple, unk: float) -> float:
    n = len(gram)
    if n >= 1 and gram in probs[n]:
        return probs[n][gram]
    if n > 1:
        return _lookup(probs, gram[1:], unk)
    return unk


def chars_for_lm(text: str) -> str:
    """Map a text to the char-level token stream used by level='char' LMs
    (for scoring with NgramScorer, which splits on whitespace)."""
    return " ".join(_tokenize(text, "char"))
