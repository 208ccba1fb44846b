"""Synthetic line images and the serving length mix, numpy only.

``line_images`` is a copy of ``chip_smoke.py:line_images`` with the band of
ink given per line. ``selftest_lengths`` copies the length arithmetic of
``htr_vt_torch/data/synthetic.py`` (``random_text``, ``selftest_max_len``,
``selftest_canvas_width`` and ``selftest_workload_mix``): the documented
serving mix, whose natural widths are 24 px a character plus 32.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

SELFTEST_ALPHABET = "abcdefghijklmnopqrstuvwxyz '"
SELFTEST_PX_PER_CHAR = 24
SELFTEST_PAD_PX = 32


def line_images(n: int, rng: np.random.Generator, width: int, height: int = 64,
                ink_lo: int = 64, ink_hi: int | None = None) -> np.ndarray:
    """[n, height, width, 1] float32 "handwriting": dark random strokes on
    white over a stretch of a text band that starts at column 0 and is
    ``ink_lo``..``ink_hi`` columns long (``width`` at most)."""
    ink_hi = width if ink_hi is None else min(ink_hi, width)
    ink_lo = min(ink_lo, ink_hi)
    img = np.ones((n, height, width), np.float32)
    ink_len = rng.integers(ink_lo, ink_hi + 1, n)
    cols = np.arange(width)[None, None, :] < ink_len[:, None, None]
    rows = (np.arange(height) >= height // 4) & (np.arange(height) < 3 * height // 4)
    ink = (rng.random((n, height, width), dtype=np.float32) < 0.2) & cols & rows[None, :, None]
    img[ink] = rng.uniform(0.0, 0.4, int(ink.sum())).astype(np.float32)
    return img[..., None]


def selftest_max_len(i: int, n: int) -> int:
    """Max text length for selftest line i of n: a 6..96-char ramp."""
    return max(5, 6 + (i * 90) // max(1, n - 1))


def canvas_width(n_chars: int, px_per_char: int = SELFTEST_PX_PER_CHAR,
                 pad: int = SELFTEST_PAD_PX) -> int:
    """Natural width of a line of ``n_chars`` characters."""
    return max(64, n_chars * px_per_char + pad)


def selftest_lengths(n: int = 4096, seed: int = 0,
                     alphabet: str = SELFTEST_ALPHABET, min_len: int = 4) -> List[int]:
    """The character counts of the selftest job of n lines: line i draws
    uniform in [min_len, selftest_max_len(i, n)] characters of ``alphabet``
    and strips the spaces at its ends, as ``random_text`` does."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(min_len, selftest_max_len(i, n) + 1))
        chars = [alphabet[int(j)] for j in rng.integers(0, len(alphabet), k)]
        text = "".join(chars).strip()
        out.append(len(text) if text else 1)
    return out


def route(widths: Sequence[int], buckets: Sequence[int]) -> List[int]:
    """Each width's bucket: the smallest that holds it, the widest catching
    the rest."""
    bs = sorted(buckets)
    return [next((b for b in bs if w <= b), bs[-1]) for w in widths]


def mix_widths(params: dict) -> List[int]:
    """The natural widths of one job, as the traffic file's ``widths``
    entry states them: ``{"fixed": W, "n": N}`` gives N lines of width W;
    ``{"selftest": {...}}`` the selftest ramp (``selftest_lengths``'
    arguments, and ``px_per_char`` / ``pad``)."""
    if "fixed" in params:
        return [int(params["fixed"])] * int(params["n"])
    p = dict(params["selftest"])
    px, pad = p.pop("px_per_char", SELFTEST_PX_PER_CHAR), p.pop("pad", SELFTEST_PAD_PX)
    return [canvas_width(k, px, pad) for k in selftest_lengths(**p)]
