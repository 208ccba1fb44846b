"""CTC beam-search decoding.

Two algorithms:

- ``prefix_beam_search``: proper CTC prefix beam search with prefix merging
  (blank/non-blank probability split). This is the framework's primary beam
  decoder — strictly better than the reference's.
- ``simple_beam_search``: the reference's naive frame-wise top-k beam without
  prefix merging (model_window/test_with_kenlm.py:25-43), kept for output
  parity with the KenLM eval script.

Both run on host over [T, C] log-probs (decode is off the training path; the
device ships only final logits).

The port's own copy of ``htr_vt_tpu/decode/beam.py``, held to it by
``tests/test_torch_port_decode_lm.py``.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

NEG_INF = -float("inf")


def _logaddexp(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def prefix_beam_search(log_probs: np.ndarray, beam_width: int = 10,
                       blank: int = 0, top_k_per_frame: int = 16,
                       lm_score: Optional[Callable[[Tuple[int, ...]], float]] = None,
                       lm_weight: float = 0.0) -> List[Tuple[Tuple[int, ...], float]]:
    """Standard CTC prefix beam search.

    Returns up to beam_width (prefix, total_log_prob) sorted best-first.
    ``lm_score(prefix)`` is an optional incremental language-model bonus added
    (scaled by lm_weight) when a prefix is extended.
    """
    t_total, c = log_probs.shape
    # beams: prefix -> (p_blank, p_non_blank)
    beams = {(): (0.0, NEG_INF)}
    for t in range(t_total):
        frame = log_probs[t]
        if top_k_per_frame < c:
            cand = np.argpartition(-frame, top_k_per_frame)[:top_k_per_frame]
        else:
            cand = np.arange(c)
        if blank not in cand:
            cand = np.append(cand, blank)
        next_beams: dict = defaultdict(lambda: (NEG_INF, NEG_INF))
        for prefix, (pb, pnb) in beams.items():
            total = _logaddexp(pb, pnb)
            for ci in cand:
                p = float(frame[ci])
                if ci == blank:
                    nb, nn = next_beams[prefix]
                    next_beams[prefix] = (_logaddexp(nb, total + p), nn)
                    continue
                last = prefix[-1] if prefix else None
                if ci == last:
                    # repeat: extends only from blank-ending paths...
                    nprefix = prefix + (ci,)
                    nb, nn = next_beams[nprefix]
                    ext = pb + p
                    if lm_score is not None and lm_weight:
                        ext += lm_weight * lm_score(nprefix)
                    next_beams[nprefix] = (nb, _logaddexp(nn, ext))
                    # ...while same-symbol continuation stays on the prefix
                    nb, nn = next_beams[prefix]
                    next_beams[prefix] = (nb, _logaddexp(nn, pnb + p))
                else:
                    nprefix = prefix + (ci,)
                    nb, nn = next_beams[nprefix]
                    ext = total + p
                    if lm_score is not None and lm_weight:
                        ext += lm_weight * lm_score(nprefix)
                    next_beams[nprefix] = (nb, _logaddexp(nn, ext))
        scored = sorted(next_beams.items(),
                        key=lambda kv: -_logaddexp(kv[1][0], kv[1][1]))
        beams = dict(scored[:beam_width])
    out = [(prefix, _logaddexp(pb, pnb)) for prefix, (pb, pnb) in beams.items()]
    return sorted(out, key=lambda x: -x[1])


def simple_beam_search(log_probs: np.ndarray, beam_width: int = 5,
                       top_k_per_frame: int = 5) -> List[Tuple[List[int], float]]:
    """The reference's naive beam (model_window/test_with_kenlm.py:25-43):
    per frame take top-k classes, extend every beam, keep beam_width by score;
    collapse repeats/blanks only afterwards."""
    beams: List[Tuple[List[int], float]] = [([], 0.0)]
    for frame in log_probs:
        top = np.argsort(-frame)[:top_k_per_frame]
        nxt = [(seq + [int(ci)], score + float(frame[ci]))
               for seq, score in beams for ci in top]
        nxt.sort(key=lambda x: -x[1])
        beams = nxt[:beam_width]
    return beams


def collapse_sequence(seq: Sequence[int], blank: int = 0) -> List[int]:
    out: List[int] = []
    prev = None
    for s in seq:
        if s != blank and s != prev:
            out.append(int(s))
        prev = s
    return out


def beam_search_batch(log_probs: np.ndarray, beam_width: int = 10,
                      blank: int = 0) -> List[List[Tuple[Tuple[int, ...], float]]]:
    """Per-sample prefix beam search over a [B, T, C] batch."""
    return [prefix_beam_search(lp, beam_width, blank) for lp in log_probs]


_FNV_PRIME = np.uint64(1099511628211)
_FNV_OFFSET = np.uint64(14695981039346656037)


def prefix_beam_search_batch(log_probs: np.ndarray, beam_width: int = 10,
                             blank: int = 0, top_k_per_frame: int = 16,
                             lm=None, lm_weight: float = 0.0,
                             lm_id_of_class: Optional[np.ndarray] = None
                             ) -> List[List[Tuple[Tuple[int, ...], float]]]:
    """Vectorized CTC prefix beam search over a [B, T, C] batch.

    Numpy re-formulation of ``prefix_beam_search`` (identical results — the
    equivalence is test-pinned): beams live in arrays, prefixes are tracked
    by 64-bit rolling hashes, and the blank/non-blank split, the
    same-symbol-continuation rule and prefix merging all become masked
    gather/scatter passes over a [B, K + K*F] candidate pool per frame.
    Replaces the reference's per-sample per-frame Python loop
    (model_window/test_with_kenlm.py:25-59, its eval hot spot).

    Prefix merging uses the fact that within one frame a collision can only
    pair an extend-candidate with a stay-candidate (extend/extend implies
    identical parent+char, stay/stay implies identical parents), so one
    adjacent logaddexp pass after a hash sort merges exactly.

    Optional fused LM: ``lm`` is a ``decode.lm.IndexedNgram``;
    ``lm_id_of_class[c]`` maps CTC class ids to LM token ids (<0 = skip).
    Each extension adds ``lm_weight * log10 p(char | running context)`` —
    O(order) per extension via the id-indexed C++ scorer instead of the
    O(prefix) full re-walk (round-2 verdict #4).
    """
    b, t_total, c = log_probs.shape
    k = beam_width
    f = min(top_k_per_frame, c)
    lp = log_probs.astype(np.float64)

    # Per-frame top-F candidate classes: [B, T, F]
    if f < c:
        cand_all = np.argpartition(-lp, f - 1, axis=2)[:, :, :f]
    else:
        cand_all = np.broadcast_to(np.arange(c), (b, t_total, c))  # read-only view

    NEG = NEG_INF
    tokens = np.zeros((b, k, t_total if t_total else 1), np.int32)
    lengths = np.zeros((b, k), np.int32)
    last = np.full((b, k), -1, np.int32)
    hashes = np.zeros((b, k), np.uint64)
    hashes[:] = _FNV_OFFSET + np.arange(k, dtype=np.uint64)  # unique sentinels
    hashes[:, 0] = _FNV_OFFSET
    p_b = np.full((b, k), NEG)
    p_nb = np.full((b, k), NEG)
    p_b[:, 0] = 0.0

    use_lm = lm is not None and lm_weight != 0.0
    if use_lm:
        ctx_len = max(lm.order - 1, 1)
        ctx = np.full((b, k, ctx_len), -1, np.int32)
        ctx[:, :, -1] = lm.bos_id
        lm_lut = np.asarray(lm_id_of_class, np.int32)

    bi = np.arange(b)[:, None]
    with np.errstate(invalid="ignore"):  # -inf + -inf etc.
        for t in range(t_total):
            frame = lp[:, t]                       # [B, C]
            cand = cand_all[:, t]                  # [B, F]
            pc = np.take_along_axis(frame, cand, axis=1)  # [B, F]
            total = np.logaddexp(p_b, p_nb)        # [B, K]

            # --- stay candidates (one per live beam) -----------------------
            stay_pb = total + frame[:, blank][:, None]
            # same-symbol continuation only when last is in this frame's
            # candidate set (mirrors the dict impl's iteration over cand)
            last_in = (cand[:, None, :] == last[:, :, None]).any(-1) & (last >= 0)
            last_p = np.take_along_axis(
                frame, np.maximum(last, 0), axis=1)  # [B, K]
            stay_pnb = np.where(last_in, p_nb + last_p, NEG)

            # --- extend candidates ([B, K, F]) -----------------------------
            is_rep = cand[:, None, :] == last[:, :, None]
            base = np.where(is_rep, p_b[:, :, None], total[:, :, None])
            ext = base + pc[:, None, :]
            ext = np.where(cand[:, None, :] == blank, NEG, ext)
            if use_lm:
                lm_words = lm_lut[cand]            # [B, F]
                q_ctx = np.broadcast_to(ctx[:, :, None, :],
                                        (b, k, f, ctx_len)).reshape(-1, ctx_len)
                q_w = np.broadcast_to(lm_words[:, None, :], (b, k, f)).reshape(-1)
                ok = q_w >= 0
                bonus = np.zeros(b * k * f)
                if ok.any():
                    bonus[ok] = lm.cond_batch(q_ctx[ok], q_w[ok])
                ext = ext + lm_weight * bonus.reshape(b, k, f)
            ext_hash = (hashes[:, :, None] * _FNV_PRIME) ^ \
                (cand[:, None, :].astype(np.uint64) + np.uint64(1))

            # --- pool: [B, K + K*F] ---------------------------------------
            pool_pb = np.concatenate([stay_pb, np.full((b, k * f), NEG)], 1)
            pool_pnb = np.concatenate([stay_pnb, ext.reshape(b, k * f)], 1)
            pool_hash = np.concatenate([hashes, ext_hash.reshape(b, k * f)], 1)
            pool_parent = np.concatenate(
                [np.broadcast_to(np.arange(k), (b, k)),
                 np.broadcast_to(np.repeat(np.arange(k), f), (b, k * f))], 1)
            pool_char = np.concatenate(
                [np.full((b, k), -1, np.int64),
                 np.broadcast_to(cand[:, None, :], (b, k, f)).reshape(b, k * f)
                 .astype(np.int64)], 1)

            # --- merge equal prefixes (adjacent after hash sort) ----------
            order = np.argsort(pool_hash, axis=1, kind="stable")
            pool_hash = np.take_along_axis(pool_hash, order, 1)
            pool_pb = np.take_along_axis(pool_pb, order, 1)
            pool_pnb = np.take_along_axis(pool_pnb, order, 1)
            pool_parent = np.take_along_axis(pool_parent, order, 1)
            pool_char = np.take_along_axis(pool_char, order, 1)
            eq = pool_hash[:, 1:] == pool_hash[:, :-1]
            zeros = np.zeros((b, 1), bool)
            is_first = np.concatenate([eq, zeros], 1)
            is_second = np.concatenate([zeros, eq], 1)
            nxt_pb = np.roll(pool_pb, -1, axis=1)
            nxt_pnb = np.roll(pool_pnb, -1, axis=1)
            pool_pb = np.where(is_first, np.logaddexp(pool_pb, nxt_pb), pool_pb)
            pool_pnb = np.where(is_first, np.logaddexp(pool_pnb, nxt_pnb),
                                pool_pnb)
            # the merged entry must carry the prefix identity; a stay entry
            # (char -1) merged with an extend entry adopts the extend's
            # parent/char so reconstruction works either way
            nxt_parent = np.roll(pool_parent, -1, axis=1)
            nxt_char = np.roll(pool_char, -1, axis=1)
            take_next = is_first & (pool_char == -1) & (nxt_char >= 0)
            pool_parent = np.where(take_next, nxt_parent, pool_parent)
            pool_char = np.where(take_next, nxt_char, pool_char)
            pool_pb = np.where(is_second, NEG, pool_pb)
            pool_pnb = np.where(is_second, NEG, pool_pnb)
            # A killed duplicate keeps -inf mass but must NOT keep the
            # survivor's hash: when beam_width exceeds the live candidate
            # count (tiny alphabets / small top_k_per_frame) the dead row is
            # re-selected as beam filler, and next frame THREE pool entries
            # share one hash — the adjacent-pair merge above only handles
            # pairs, so the third entry's mass would merge into a row that
            # is then killed (probability-mass loss vs prefix_beam_search).
            # Unique low-integer sentinels live in a space real 64-bit FNV
            # hashes essentially never occupy.
            n_pool = pool_hash.shape[1]
            kill_ids = (np.uint64(t) * np.uint64(n_pool) + np.uint64(1) +
                        np.arange(n_pool, dtype=np.uint64))[None, :]
            pool_hash = np.where(is_second, kill_ids, pool_hash)

            # --- select top-K by total ------------------------------------
            pool_total = np.logaddexp(pool_pb, pool_pnb)
            sel = np.argpartition(-pool_total, k - 1, axis=1)[:, :k]
            sel_total = np.take_along_axis(pool_total, sel, 1)
            ordk = np.argsort(-sel_total, axis=1, kind="stable")
            sel = np.take_along_axis(sel, ordk, 1)

            p_b = np.take_along_axis(pool_pb, sel, 1)
            p_nb = np.take_along_axis(pool_pnb, sel, 1)
            hashes = np.take_along_axis(pool_hash, sel, 1)
            parent = np.take_along_axis(pool_parent, sel, 1)
            newchar = np.take_along_axis(pool_char, sel, 1)

            tokens = np.take_along_axis(tokens, parent[:, :, None], 1)
            lengths = np.take_along_axis(lengths, parent, 1)
            last = np.take_along_axis(last, parent, 1)
            grew = newchar >= 0
            np.put_along_axis(
                tokens, np.minimum(lengths, tokens.shape[2] - 1)[:, :, None],
                np.where(grew, newchar, tokens[bi, np.arange(k)[None, :],
                                               np.minimum(lengths, tokens.shape[2] - 1)]
                         .astype(np.int64))[:, :, None].astype(np.int32), 2)
            lengths = lengths + grew
            last = np.where(grew, newchar.astype(np.int32), last)
            if use_lm:
                ctx = np.take_along_axis(ctx, parent[:, :, None], 1)
                new_ctx = np.concatenate(
                    [ctx[:, :, 1:],
                     lm_lut[np.maximum(newchar, 0)][:, :, None]], axis=2)
                ctx = np.where(grew[:, :, None], new_ctx, ctx)

    out: List[List[Tuple[Tuple[int, ...], float]]] = []
    totals = np.logaddexp(p_b, p_nb)
    for i in range(b):
        rows = [(tuple(int(x) for x in tokens[i, j, :lengths[i, j]]),
                 float(totals[i, j]))
                for j in range(k) if totals[i, j] > NEG]
        out.append(sorted(rows, key=lambda x: -x[1]))
    return out


def simple_beam_search_batch(log_probs: np.ndarray, beam_width: int = 5,
                             top_k_per_frame: int = 5
                             ) -> List[List[Tuple[List[int], float]]]:
    """Vectorized batch version of the reference-style naive beam: one numpy
    pass over [B, T, C] instead of a Python frame loop per sample (the
    reference's per-sample loop is its eval hot spot, SURVEY §3.5)."""
    b, t, c = log_probs.shape
    k = beam_width
    kf = min(top_k_per_frame, c)
    # [B, T, kf] per-frame top classes and scores
    top_idx = np.argpartition(-log_probs, kf - 1, axis=2)[:, :, :kf]
    top_val = np.take_along_axis(log_probs, top_idx, axis=2)

    seqs = np.zeros((b, 1, 0), np.int64)
    scores = np.zeros((b, 1), np.float64)
    for step in range(t):
        # extend every beam with every candidate: [B, nb*kf]
        ext = scores[:, :, None] + top_val[:, None, step, :]
        nb = ext.shape[1] * ext.shape[2]
        ext = ext.reshape(b, nb)
        keep = min(k, nb)
        sel = np.argpartition(-ext, keep - 1, axis=1)[:, :keep]
        scores = np.take_along_axis(ext, sel, axis=1)
        beam_src = sel // kf
        cand_src = sel % kf
        new_tok = np.take_along_axis(top_idx[:, step, :], cand_src, axis=1)
        seqs = np.concatenate(
            [np.take_along_axis(seqs, beam_src[:, :, None], axis=1),
             new_tok[:, :, None].astype(np.int64)], axis=2)
        order = np.argsort(-scores, axis=1)
        scores = np.take_along_axis(scores, order, axis=1)
        seqs = np.take_along_axis(seqs, order[:, :, None], axis=1)
    return [[(seqs[i, j].tolist(), float(scores[i, j]))
             for j in range(seqs.shape[1])] for i in range(b)]
