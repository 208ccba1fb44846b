"""Host-side line-image preprocessing.

Bit-compatible with the reference's load path (data/dataset.py:104-135):
grayscale -> aspect-preserving resize to height 64 (PIL default bicubic for
'L' images), width capped at 512 -> float32 in [0,1] -> right-pad with white
(1.0) to exactly 512. The fixed [64, 512] canvas is what gives the model its
static 128-token grid — a feature on TPU (one XLA program, §5 of SURVEY).

The port's own copy of ``htr_vt_tpu/data/image.py``, with one change: PIL,
which the card's machine lacks, is imported inside the three functions that
read or resize an image, so the bucket router ``assign_width_buckets``
imports without it.
"""

from __future__ import annotations

import numpy as np


def resize_keep_aspect(img: np.ndarray, max_w: int, max_h: int) -> np.ndarray:
    """Reference ``npThum``: new_h = max_h, new_w = min(w * max_h / h, max_w).
    Degenerate ultra-narrow inputs are clamped to 1 px (the reference would
    crash PIL with width 0)."""
    from PIL import Image
    h, w = img.shape[:2]
    new_w = max(1, min(int(w * max_h / h), max_w))
    return np.array(Image.fromarray(img).resize((new_w, max_h)))


def load_line_image(path: str, max_w: int = 512, max_h: int = 64) -> np.ndarray:
    """Load + resize + pad one line image. Returns float32 [max_h, max_w, 1]."""
    from PIL import Image
    img = np.array(Image.open(path).convert("L"))
    return prepare_line_image(img, max_w, max_h)


def prepare_line_image(img: np.ndarray, max_w: int = 512, max_h: int = 64) -> np.ndarray:
    img = resize_keep_aspect(img, max_w, max_h)
    data = img.astype(np.float32) / 255.0
    if data.ndim < 3:
        data = data[:, :, None]
    pad_w = max_w - data.shape[1]
    if pad_w > 0:
        data = np.pad(data, ((0, 0), (0, pad_w), (0, 0)), mode="constant",
                      constant_values=1.0)
    return data


def natural_line_width(path: str, max_h: int = 64) -> int:
    """Width the line would occupy after the aspect-preserving resize to
    ``max_h``, UNCAPPED — used to assign images to serving width buckets
    (cli/serve.py --width-buckets). Reads only the image header."""
    from PIL import Image
    with Image.open(path) as im:
        w, h = im.size
    return max(1, int(w * max_h / h))


def assign_width_buckets(widths, buckets):
    """Map each natural width to the smallest bucket >= it (the widest
    bucket catches everything longer — those lines are capped, exactly the
    reference's W=512 behavior generalized). Returns a bucket index list."""
    bs = sorted(buckets)
    out = []
    for w in widths:
        for bi, b in enumerate(bs):
            if w <= b:
                out.append(bi)
                break
        else:
            out.append(len(bs) - 1)
    return bs, out


def to_uint8(img_float: np.ndarray) -> np.ndarray:
    """[H,W,1] float in [0,1] -> [H,W] uint8 (augmentation operates on uint8,
    like the reference collate's PIL round-trip, data/dataset.py:16-17)."""
    return np.uint8(np.clip(img_float[..., 0] * 255.0, 0, 255))


def from_uint8(img_u8: np.ndarray) -> np.ndarray:
    return (img_u8.astype(np.float32) / 255.0)[..., None]
