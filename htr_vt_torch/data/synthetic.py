"""Synthetic line-image dataset.

Renders pseudo-handwritten text lines with cv2 Hershey fonts plus geometric
jitter, giving a fully self-contained, learnable OCR task for unit tests,
benchmarks and CI — the reference has no equivalent (it requires the real IAM
tgz), which makes its pipeline untestable without licensed data.

The port's own copy of ``htr_vt_tpu/data/synthetic.py``, held to it by
``tests/test_torch_port_loop.py``, with one change: cv2, which the card's
machine lacks, is imported inside the functions that render, and the font
tuple is built on first use, so the module imports without it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _fonts() -> Tuple[int, ...]:
    """cv2's four Hershey faces the renderer draws from, in a fixed order."""
    import cv2
    return (cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_COMPLEX,
            cv2.FONT_HERSHEY_DUPLEX, cv2.FONT_HERSHEY_TRIPLEX)


def render_line(text: str, height: int = 64, width: int = 512,
                rng: Optional[np.random.Generator] = None,
                return_drawn: bool = False, draw: bool = True,
                scale_range: Tuple[float, float] = (0.9, 1.3)):
    """Render ``text`` onto a white uint8 [height, width] canvas with random
    font/slant/thickness/baseline wobble. With ``return_drawn`` also returns
    how many characters actually landed on the canvas (rendering stops at the
    right edge), so callers can trim labels to the visible text.

    ``draw=False`` skips canvas allocation and rasterization but consumes the
    rng IDENTICALLY (putText itself draws from no randomness), so the drawn
    count matches a real render with the same rng — the cheap way to measure
    how much of a label fits (trim_to_canvas) without paying cv2.putText per
    glyph twice."""
    import cv2
    rng = rng or np.random.default_rng(abs(hash(text)) % (2**31))
    canvas = np.full((height, width), 255, np.uint8) if draw else None
    fonts = _fonts()
    font = fonts[int(rng.integers(0, len(fonts)))]
    scale = float(rng.uniform(*scale_range))
    thickness = int(rng.integers(1, 3))
    x = int(rng.integers(2, 8))
    base_y = int(height * 0.68)
    drawn = 0
    for ch in text:
        if ch == " ":
            x += int(12 * scale)
            drawn += 1
            continue
        y = base_y + int(rng.integers(-3, 4))
        if draw:
            cv2.putText(canvas, ch, (x, y), font, scale, 0, thickness,
                        cv2.LINE_AA)
        (w, _), _ = cv2.getTextSize(ch, font, scale, thickness)
        x += w + int(rng.integers(-2, 3))
        drawn += 1
        if x >= width - 10:
            break
    if return_drawn:
        return canvas, drawn
    return canvas


# --- serve --selftest workload (shared with tools/bench_serve_buckets.py so
# the benchmark's length mix IS the workload whose CER the selftest scores) --

SELFTEST_PX_PER_CHAR = 24
SELFTEST_PAD_PX = 32


def selftest_max_len(i: int, n: int) -> int:
    """Max text length for selftest line i of n: a 6..96-char ramp."""
    return max(5, 6 + (i * 90) // max(1, n - 1))


def selftest_canvas_width(n_chars: int) -> int:
    """Natural canvas width for a selftest line of n_chars characters."""
    return max(64, n_chars * SELFTEST_PX_PER_CHAR + SELFTEST_PAD_PX)


def random_text(rng: np.random.Generator, alphabet: str,
                min_len: int = 4, max_len: int = 28) -> str:
    n = int(rng.integers(min_len, max_len + 1))
    chars = [alphabet[int(i)] for i in rng.integers(0, len(alphabet), n)]
    text = "".join(chars).strip()
    return text if text else alphabet[0]


class SyntheticLineDataset:
    """Deterministic synthetic dataset: sample i always renders the same text
    with the same base glyphs (augmentation randomness stays in the loader)."""

    def __init__(self, size: int, alphabet: str = "abcdefghijklmnopqrstuvwxyz '",
                 seed: int = 0, height: int = 64, width: int = 512,
                 min_len: int = 4, max_len: int = 28,
                 trim_to_canvas: bool = False,
                 scale_range: Tuple[float, float] = (0.9, 1.3)):
        rng = np.random.default_rng(seed)
        # strip() in random_text means leading/trailing spaces vanish; keep
        # alphabet order stable for the codec.
        self.alphabet = sorted(set(alphabet))
        self.height, self.width = height, width
        self.labels: List[str] = [random_text(rng, alphabet, min_len, max_len)
                                  for _ in range(size)]
        self._seeds = rng.integers(0, 2**31, size=size)
        self.scale_range = tuple(scale_range)
        if trim_to_canvas:
            # Long texts can hit the right edge mid-string (render_line stops
            # there); trim each label to the characters that actually render
            # so image and label agree. Used by the multi-width recipe where
            # texts are sized for wide canvases (tools/train_multiwidth.py).
            # draw=False measures the glyph-advance loop with identical rng
            # consumption but no rasterization: construction stays O(text)
            # in getTextSize calls instead of paying a full render per
            # sample before training starts.
            for i in range(size):
                r = np.random.default_rng(int(self._seeds[i]))
                _, drawn = render_line(self.labels[i], height, width, r,
                                       return_drawn=True, draw=False,
                                       scale_range=self.scale_range)
                self.labels[i] = self.labels[i][:drawn].strip() or self.labels[i][:1]

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, str]:
        rng = np.random.default_rng(int(self._seeds[i]))
        return render_line(self.labels[i], self.height, self.width, rng,
                           scale_range=self.scale_range), self.labels[i]


def selftest_workload_mix(buckets, n: int = 4096, seed: int = 0,
                          alphabet: str = "abcdefghijklmnopqrstuvwxyz '"):
    """Bucket mix of the serve --selftest workload: line length uniform in
    [4, max_len] with max_len ramping 6..96 over the job, natural width =
    chars*24 + 32 (selftest_canvas_width), routed to the smallest bucket
    that holds the width (capped at the largest, like cli/serve.py's
    assign_width_buckets). This is the DOCUMENTED length mix behind every
    workload-effective serving number (bench.py serve_effective_img_s,
    tools/bench_serve_buckets.py): real IAM/READ/LAM line widths cannot be
    derived in-repo — the shipped .ln lists carry filenames only, no label
    text or image dims — so the selftest generator is the workload, and the
    same mix is what cli/serve.py --selftest scores for CER.

    Returns {bucket_width: fraction}.
    """
    rng = np.random.default_rng(seed)
    counts = {b: 0 for b in buckets}
    for i in range(n):
        text = random_text(rng, alphabet, min_len=4,
                           max_len=selftest_max_len(i, n))
        w = selftest_canvas_width(len(text))
        b = next((b for b in sorted(buckets) if w <= b), max(buckets))
        counts[b] += 1
    return {b: c / n for b, c in counts.items()}
