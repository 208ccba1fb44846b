"""The reference's side of a served line: its logits, the static int8
calibration worked out again, the gap by which a served transcription lies
below the reference's best reading, and the gap between two readings of
the logits."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from htrbench.reference.model import forward, quant_sites
from htrbench.reference.numerics import Calibrate, numerics

INF = float("inf")


@torch.no_grad()
def calibrate(P, m: dict, batches: Iterable[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The running abs-max at every A8W8 site over float32 eval forwards of
    ``batches`` ([B, H, W, 1] each)."""
    sites, emits = quant_sites(m)
    cal = Calibrate(sites, emits)
    for img in batches:
        forward(P, m, img, cal)
    return cal.amax


@torch.no_grad()
def logits(P, m: dict, images: torch.Tensor, num, block: int = 32) -> torch.Tensor:
    """Eval logits [N, T, C] of ``images`` [N, H, W, 1], ``block`` lines a
    forward."""
    return torch.cat([forward(P, m, images[i:i + block], num)
                      for i in range(0, images.shape[0], block)])


def model_numerics(m: dict, kind: str, amax=None):
    sites, emits = quant_sites(m)
    return numerics(kind, amax, sites, emits)


def served_gap(lg: np.ndarray, ids: Sequence[int]) -> float:
    """How far below the reference's best a served transcription lies.

    ``lg`` [T, C] the reference's logits of the line, ``ids`` the served
    characters' classes (blank 0 excluded). Over the CTC alignments of T
    frames that collapse to ``ids``, each frame's gap is the best logit of
    the frame minus the logit of the class the alignment puts there; the
    result is the least, over the alignments, of the widest gap along one
    (a bottleneck path through the CTC trellis). 0 where the reference's
    own greedy reading gives ``ids``; infinite where no alignment of T
    frames gives them."""
    lg = np.asarray(lg, np.float64)
    t_len = lg.shape[0]
    cost = lg.max(1, keepdims=True) - lg
    ext = np.zeros(2 * len(ids) + 1, np.int64)
    ext[1::2] = ids
    c = cost[:, ext]
    s = len(ext)
    skip = np.zeros(s, bool)
    skip[2:] = (ext[2:] != 0) & (ext[2:] != ext[:-2])
    best = np.full(s, INF)
    best[0] = c[0, 0]
    if s > 1:
        best[1] = c[0, 1]
    for t in range(1, t_len):
        prev = best.copy()
        prev[1:] = np.minimum(prev[1:], best[:-1])
        prev[2:] = np.where(skip[2:], np.minimum(prev[2:], best[:-2]), prev[2:])
        best = np.maximum(prev, c[t])
    return float(min(best[-1], best[-2] if s > 1 else INF))


def greedy_ids(lg: np.ndarray) -> List[int]:
    """The text that the frames' argmax of ``lg`` [T, C] collapses to under
    CTC (repeats merged, blanks dropped), as classes: how a control's
    logits are read."""
    top = np.asarray(lg).argmax(1)
    return [int(c) for t, c in enumerate(top) if c and (t == 0 or top[t - 1] != c)]


def rms_gap(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each line's root mean square gap between two readings of its logits
    [N, T, C]; the reference's are LayerNormed over the classes, so each
    frame's have a root mean square of 1."""
    return (prog.float() - ref.float()).square().mean(dim=(1, 2)).sqrt()


def ids_of(text: str, classes: Dict[str, int]) -> List[int]:
    return [classes[ch] for ch in text]
