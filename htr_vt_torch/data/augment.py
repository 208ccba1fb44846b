"""Host-side augmentation zoo.

Re-implements the reference's transform set (data/transform.py: Dilation,
Erosion, ElasticDistortion, RandomTransform, SignFlipping, DPIAdjusting,
GaussianNoise, Sharpen, ZoomRatio, Tightening) plus a grayscale ColorJitter
(torchvision isn't a dependency here) on top of cv2/numpy only — skimage is
not available, so the projective/elastic warps are expressed with cv2
homographies and remap fields with the same parameter distributions.

As in the reference (data/dataset.py:13-45), only projective +
erosion/dilation + jitter are wired into the default training collate, each
applied with 50% probability at batch level; the rest of the zoo is available
for custom pipelines. Everything operates on uint8 [H, W] grayscale arrays and
stays outside the jit boundary, overlapping with TPU compute via the
prefetching loader.

The port's own copy of ``htr_vt_tpu/data/augment.py``, held to it by
``tests/test_torch_port_loop.py``, with one change: cv2, which the card's
machine lacks, is imported inside the functions that call it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from htr_vt_torch.config import AugmentConfig

Rng = np.random.Generator


# ---------------------------------------------------------------------------
# Individual transforms
# ---------------------------------------------------------------------------
def dilation(img: np.ndarray, kernel_wh, iterations: int = 1) -> np.ndarray:
    """Stroke thickening (reference Dilation, transform.py:11-20)."""
    import cv2
    return cv2.dilate(img, np.ones(kernel_wh, np.uint8), iterations=iterations)


def erosion(img: np.ndarray, kernel_wh, iterations: int = 1) -> np.ndarray:
    """Stroke thinning (reference Erosion, transform.py:23-33)."""
    import cv2
    return cv2.erode(img, np.ones(kernel_wh, np.uint8), iterations=iterations)


def random_projective(img: np.ndarray, val: float, rng: Rng) -> np.ndarray:
    """Random projective distortion (reference RandomTransform,
    transform.py:151-224): jitter the four corners by up to ``val`` px in
    either the horizontal or the vertical direction (coin flip), warp with a
    white background sized to contain the quad, resize back to (h, w)."""
    import cv2
    h, w = img.shape[:2]
    dw, dh = (val, 0.0) if rng.integers(0, 2) == 0 else (0.0, val)

    rd = lambda d: rng.uniform(-d, d)
    fd = lambda d: rng.uniform(-dw, d)

    tl = (fd(dw), rd(dh))
    bl = (fd(dw), h - rd(dh))
    br = (w - fd(min(w * 3 / 4 - bl[0], dw)), h - rd(dh))
    tr = (w - fd(min(w * 3 / 4 - tl[0], dw)), rd(dh))
    quad = np.float32([tl, bl, br, tr])
    rect = np.float32([[0, 0], [0, h - 1], [w - 1, h - 1], [w - 1, 0]])

    # Shift so the jittered quad lies in positive coordinates, then warp into
    # a canvas that contains it fully (white fill), and scale back.
    minx, miny = quad[:, 0].min(), quad[:, 1].min()
    quad_shifted = quad - np.float32([minx, miny])
    out_w = int(np.ceil(quad_shifted[:, 0].max())) + 1
    out_h = int(np.ceil(quad_shifted[:, 1].max())) + 1
    m = cv2.getPerspectiveTransform(rect, quad_shifted)
    warped = cv2.warpPerspective(img, m, (out_w, out_h), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_CONSTANT, borderValue=255)
    return cv2.resize(warped, (w, h), interpolation=cv2.INTER_LINEAR)


def elastic_distortion(img: np.ndarray, rng: Rng,
                       grid: Tuple[int, int] = (6, 2),
                       magnitude: Tuple[int, int] = (6, 4),
                       min_sep: Tuple[int, int] = (2, 2)) -> np.ndarray:
    """OrigamiNet-faithful mesh warp (reference ElasticDistortion,
    transform.py:36-149): the image is cut into a grid x grid tile lattice;
    each INTERIOR lattice vertex gets an independent integer shift
    (dx, dy) ~ randint(-sm, magnitude) where sm caps the negative range so
    neighbouring vertices keep at least ``min_sep`` separation (the
    reference's sm_h/sm_v clamp); border vertices stay fixed. Each
    destination tile is then sampled from the bilinear interpolation of its
    four (possibly shifted) source corners — the same mapping PIL's
    Image.MESH + QUAD transform applies, expressed as a dst->src coordinate
    field for cv2.remap(BICUBIC).

    The reference never instantiates this class anywhere (unused in every
    SameTrCollate), so the grid/magnitude defaults here are this repo's
    choice, sized for 64px-high line images.
    """
    import cv2
    h, w = img.shape[:2]
    ht, vt = max(2, grid[0]), max(2, grid[1])
    xmag, ymag = magnitude
    min_h_sep, min_v_sep = min_sep
    tile_w = int(np.floor(w / float(ht)))
    tile_h = int(np.floor(h / float(vt)))
    if tile_w < 2 or tile_h < 2:
        return img

    # Lattice of tile-corner x/y lines; the last tile absorbs the remainder
    # (floor arithmetic, reference :55-58).
    xs = np.array([min(c * tile_w, w) for c in range(ht)] + [w], np.float32)
    ys = np.array([min(r * tile_h, h) for r in range(vt)] + [h], np.float32)

    # Interior-vertex shifts with the reference's separation clamp: the cap
    # looks at the previous tile's shift in the same row/column (:88-95).
    shift_x = np.zeros((vt + 1, ht + 1), np.float32)
    shift_y = np.zeros((vt + 1, ht + 1), np.float32)
    prev_row = [(0, 0)] * ht
    for r in range(vt):
        prev = (0, 0)
        for c in range(ht):
            sm_h = min(xmag, tile_w - (min_h_sep + prev[0])) if c > 0 else xmag
            sm_v = (min(ymag, tile_h - (min_v_sep + prev_row[c][1]))
                    if r > 0 else ymag)
            dx = int(rng.integers(-sm_h, xmag + 1))
            dy = int(rng.integers(-sm_v, ymag + 1))
            prev = (dx, dy)
            prev_row[c] = (dx, dy)
            # vertex (r+1, c+1) is tile (r, c)'s bottom-right corner; only
            # interior vertices move (last row/column shifts are computed by
            # the reference too but never applied, :105-111 polygon_indices)
            if r + 1 < vt and c + 1 < ht:
                shift_x[r + 1, c + 1] = dx
                shift_y[r + 1, c + 1] = dy

    # Source corner positions = lattice + shift; dst->src field per tile by
    # bilinear interpolation of the 4 corners over the destination rect.
    src_x = xs[None, :] + shift_x
    src_y = ys[:, None] + shift_y
    map_x = np.empty((h, w), np.float32)
    map_y = np.empty((h, w), np.float32)
    for r in range(vt):
        y0, y1 = int(ys[r]), int(ys[r + 1])
        if y1 <= y0:
            continue
        v = (np.arange(y0, y1, dtype=np.float32)[:, None] - ys[r]) / (ys[r + 1] - ys[r])
        for c in range(ht):
            x0, x1 = int(xs[c]), int(xs[c + 1])
            if x1 <= x0:
                continue
            u = (np.arange(x0, x1, dtype=np.float32)[None, :] - xs[c]) / (xs[c + 1] - xs[c])
            nw_x, ne_x = src_x[r, c], src_x[r, c + 1]
            sw_x, se_x = src_x[r + 1, c], src_x[r + 1, c + 1]
            nw_y, ne_y = src_y[r, c], src_y[r, c + 1]
            sw_y, se_y = src_y[r + 1, c], src_y[r + 1, c + 1]
            top_x = nw_x + u * (ne_x - nw_x)
            bot_x = sw_x + u * (se_x - sw_x)
            top_y = nw_y + u * (ne_y - nw_y)
            bot_y = sw_y + u * (se_y - sw_y)
            map_x[y0:y1, x0:x1] = top_x + v * (bot_x - top_x)
            map_y[y0:y1, x0:x1] = top_y + v * (bot_y - top_y)
    return cv2.remap(img, map_x, map_y, interpolation=cv2.INTER_CUBIC,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=255)


def sign_flipping(img: np.ndarray) -> np.ndarray:
    """Color inversion (reference SignFlipping, transform.py:227)."""
    return 255 - img


def dpi_adjusting(img: np.ndarray, factor: float) -> np.ndarray:
    """Scale resolution by ``factor`` (reference DPIAdjusting, transform.py:239)."""
    import cv2
    h, w = img.shape[:2]
    return cv2.resize(img, (max(1, int(round(w * factor))),
                            max(1, int(round(h * factor)))),
                      interpolation=cv2.INTER_LINEAR)


def gaussian_noise(img: np.ndarray, rng: Rng, std: float = 10.0) -> np.ndarray:
    """Additive gaussian noise (reference GaussianNoise, transform.py:253)."""
    noise = rng.normal(0.0, std, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def sharpen(img: np.ndarray, alpha: float = 0.5, strength: float = 0.5) -> np.ndarray:
    """Unsharp-mask style sharpening (reference Sharpen, transform.py:275)."""
    import cv2
    blurred = cv2.GaussianBlur(img, (3, 3), 1.0)
    sharp = img.astype(np.float32) + strength * (img.astype(np.float32) - blurred)
    out = (1 - alpha) * img.astype(np.float32) + alpha * sharp
    return np.clip(out, 0, 255).astype(np.uint8)


def zoom_ratio(img: np.ndarray, ratio_h: float, ratio_w: float) -> np.ndarray:
    """Shrink then pad back with white (reference ZoomRatio, transform.py:301)."""
    import cv2
    h, w = img.shape[:2]
    nh, nw = max(1, int(h * ratio_h)), max(1, int(w * ratio_w))
    small = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((h, w), 255, np.uint8)
    y0, x0 = (h - nh) // 2, (w - nw) // 2
    out[y0:y0 + nh, x0:x0 + nw] = small
    return out


def tightening(img: np.ndarray, threshold: int = 250) -> np.ndarray:
    """Crop white margins around ink (reference Tightening, transform.py:320)."""
    ink = img < threshold
    rows, cols = np.any(ink, axis=1), np.any(ink, axis=0)
    if not rows.any() or not cols.any():
        return img
    r0, r1 = np.where(rows)[0][[0, -1]]
    c0, c1 = np.where(cols)[0][[0, -1]]
    return img[r0:r1 + 1, c0:c1 + 1]


def color_jitter_gray(img: np.ndarray, rng: Rng, brightness: float = 0.4,
                      contrast: float = 0.4) -> np.ndarray:
    """Grayscale brightness/contrast jitter with torchvision's factor
    distribution (factor ~ U[max(0, 1-v), 1+v], random order). Saturation and
    hue are identities on single-channel images."""
    out = img.astype(np.float32)
    ops = []
    if brightness > 0:
        bf = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * bf)
    if contrast > 0:
        cf = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: (x - x.mean()) * cf + x.mean())
    rng.shuffle(ops)
    for op in ops:
        out = op(out)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Batch-level training augmentation (reference SameTrCollate, dataset.py:13-45)
# ---------------------------------------------------------------------------
def augment_batch(images: List[np.ndarray], cfg: AugmentConfig,
                  rng: Optional[Rng] = None) -> List[np.ndarray]:
    """Apply the reference's three 50%-probability batch-level augmentations
    to a list of uint8 [H, W] images. Decisions are batch-shared, parameters
    are per the reference (erosion/dilation kernel shared across the batch;
    projective and jitter randomness per image)."""
    if not cfg.enable:
        return images
    rng = rng or np.random.default_rng()

    if rng.random() < cfg.proba:
        images = [random_projective(im, cfg.proj, rng) for im in images]

    if rng.random() < cfg.proba:
        kh = int(rng.integers(1, cfg.dila_ero_max_kernel + 1))
        kw = int(rng.integers(1, cfg.dila_ero_max_kernel + 1))
        if rng.integers(0, 2) == 0:
            images = [erosion(im, (kw, kh), cfg.dila_ero_iter) for im in images]
        else:
            images = [dilation(im, (kw, kh), cfg.dila_ero_iter) for im in images]

    if rng.random() < cfg.proba:
        images = [color_jitter_gray(im, rng, cfg.jitter_brightness,
                                    cfg.jitter_contrast) for im in images]
    return images
