"""Token masking for training (port of ``htr_vt_tpu/models/masking.py``).

Keep masks are float32 [B, L, 1], 1 = keep, 0 = replace with the learned
mask token. Draws come from an explicit ``torch.Generator`` on the tokens'
device, so no mask leaves or enters the host. The JAX and torch random
streams differ, so the masks match the JAX package in distribution, not
draw for draw; tests hand the model JAX's masks where they compare values.

The strategies: ``span`` (the flagship ``model_v1`` recipe), and the
tri-masked MMS trainer's ``span_old``, ``random``, ``block``,
``span_spacing`` and their union ``mms``. The block and spaced-span loops
place segments until a coverage target is met, as the JAX loops do, within
the same attempt budgets; their draws are made a chunk at a time, so the
placements run with no host sync (``block``) or one every
``SPAN_CHECK_EVERY`` attempts (``span_spacing``'s early exit).
"""

from __future__ import annotations

from typing import Optional

import torch

from htr_vt_torch.config import MaskConfig
from htr_vt_torch.parallel.mesh import rank_rows

MAX_PLACEMENTS = 48  # the JAX block loop's bound (masking.py:31)
# span_spacing: attempts between two host checks of full coverage.
SPAN_CHECK_EVERY = 32


def span_placements(length: int) -> int:
    """The spaced-span attempt budget, two attempts a token
    (``masking.py:34-40``)."""
    return max(MAX_PLACEMENTS, 2 * length)


def span_mask(generator: torch.Generator, batch: int, length: int,
              ratio: float, max_span: int) -> torch.Tensor:
    """Batch-shared fixed-length spans (``masking.py:43-59``):
    ``int(L * ratio) // max_span`` spans of exactly ``max_span`` tokens,
    starts uniform over the half-open [0, L - max_span), the same positions
    for the whole batch; overlaps allowed."""
    device = generator.device
    num_spans = int(length * ratio) // max(1, max_span)
    if num_spans <= 0 or ratio <= 0.0:
        return torch.ones((batch, length, 1), device=device)
    starts = torch.randint(0, length - max_span, (num_spans,),
                           generator=generator, device=device)
    pos = torch.arange(length, device=device)[None, :]
    covered = ((pos >= starts[:, None]) & (pos < starts[:, None] + max_span)).any(0)
    keep = 1.0 - covered.float()
    return keep[None, :, None].expand(batch, length, 1)


def span_old_mask(generator: torch.Generator, batch: int, length: int,
                  ratio: float, max_span: int) -> torch.Tensor:
    """``span_mask`` with starts uniform over the inclusive [0, L - s]
    (``masking.py:62-75``)."""
    device = generator.device
    s = min(max_span, length)
    num_spans = int(length * ratio) // max(1, max_span)
    if num_spans <= 0 or ratio <= 0.0 or max_span <= 0:
        return torch.ones((batch, length, 1), device=device)
    starts = torch.randint(0, length - s + 1, (num_spans,), generator=generator,
                           device=device)
    pos = torch.arange(length, device=device)[None, :]
    covered = ((pos >= starts[:, None]) & (pos < starts[:, None] + s)).any(0)
    return (1.0 - covered.float())[None, :, None].expand(batch, length, 1)


def random_mask(generator: torch.Generator, batch: int, length: int,
                ratio: float) -> torch.Tensor:
    """Exactly ``round(ratio * L)`` tokens masked per sample, the smallest
    of uniform noise (``masking.py:78-87``)."""
    device = generator.device
    num = int(round(ratio * length))
    if num <= 0:
        return torch.ones((batch, length, 1), device=device)
    noise = torch.rand((batch, length), generator=generator, device=device)
    kth = torch.sort(noise, dim=1).values[:, num - 1:num]
    return (1.0 - (noise <= kth).float())[:, :, None]


def block_mask(generator: torch.Generator, batch: int, length: int,
               ratio: float, min_block: int = 2) -> torch.Tensor:
    """Per-sample contiguous blocks (``masking.py:90-119``): each of
    ``MAX_PLACEMENTS`` placements draws a length in [min_block,
    remaining target] and a uniform start, and applies only to the samples
    still under ``round(ratio * L)`` masked tokens. All draws are made up
    front, so the loop never waits on the host."""
    device = generator.device
    target = int(round(ratio * length))
    if target <= 0:
        return torch.ones((batch, length, 1), device=device)
    pos = torch.arange(length, device=device)[None, :]
    u = torch.rand((MAX_PLACEMENTS, 2, batch), generator=generator, device=device)
    masked = torch.zeros((batch, length), dtype=torch.bool, device=device)
    for i in range(MAX_PLACEMENTS):
        covered = masked.sum(dim=1)
        hi = torch.clamp(torch.clamp_min(target - covered, 1), min_block, length)
        blk = min_block + torch.floor(u[i, 0] * (hi - min_block + 1)).long()
        start = torch.floor(u[i, 1] * (length - blk + 1)).long()
        seg = (pos >= start[:, None]) & (pos < (start + blk)[:, None])
        masked |= seg & (covered < target)[:, None]
    return (1.0 - masked.float())[:, :, None]


def span_spacing_mask(generator: torch.Generator, batch: int, length: int,
                      ratio: float, max_span: int) -> torch.Tensor:
    """Per-sample spaced spans (``masking.py:122-169``): a span of s in [1,
    max_span] tokens at a uniform start is accepted only where k tokens on
    each side are still unmasked (k = s up to ratio 0.4, 1 up to 0.7, else
    0), until ``round(ratio * L)`` are covered, within ``span_placements``
    attempts. The host checks for full coverage every
    ``SPAN_CHECK_EVERY`` attempts; an attempt after full coverage is a
    no-op, so the masks are those of the full budget."""
    device = generator.device
    target = int(round(ratio * length))
    if target <= 0:
        return torch.ones((batch, length, 1), device=device)
    max_span = max(1, min(max_span, length))
    fixed_k = None if ratio <= 0.4 else (1 if ratio <= 0.7 else 0)
    pos = torch.arange(length, device=device)[None, :]
    masked = torch.zeros((batch, length), dtype=torch.bool, device=device)
    budget = span_placements(length)
    for first in range(0, budget, SPAN_CHECK_EVERY):
        if first and not (masked.sum(dim=1) < target).any():
            break
        chunk = min(SPAN_CHECK_EVERY, budget - first)
        u = torch.rand((chunk, 2, batch), generator=generator, device=device)
        spans = torch.clamp_max(1 + torch.floor(u[:, 0] * max_span).long(), max_span)
        for s, ui in zip(spans, u[:, 1]):
            covered = masked.sum(dim=1)
            left = torch.floor(ui * (length - s + 1)).long()
            right = left + s - 1
            k = s if fixed_k is None else fixed_k
            win = (pos >= (left - k)[:, None]) & (pos <= (right + k)[:, None])
            conflict = (masked & win).any(dim=1)
            seg = (pos >= left[:, None]) & (pos <= right[:, None])
            masked |= seg & (~conflict & (covered < target))[:, None]
    return (1.0 - masked.float())[:, :, None]


def mms_mask(generator: torch.Generator, batch: int, length: int,
             cfg: MaskConfig) -> torch.Tensor:
    """The union of the random, block and spaced-span masks at the MMS
    sub-ratios (``masking.py:172-180``)."""
    return (random_mask(generator, batch, length, cfg.mms_random_ratio)
            * block_mask(generator, batch, length, cfg.mms_block_ratio)
            * span_spacing_mask(generator, batch, length, cfg.mms_span_ratio,
                                cfg.max_span_length))


def build_keep_mask(generator: torch.Generator, batch: int, length: int,
                    cfg: MaskConfig, mode: Optional[str] = None,
                    ratio: Optional[float] = None) -> torch.Tensor:
    """Dispatch by strategy name (``masking.py:183-205``); float32
    [B, L, 1] on the generator's device. ``mode`` / ``ratio`` override the
    config (the tri-masked trainer's per-forward pairs)."""
    mode = mode or cfg.mode
    ratio = cfg.ratio if ratio is None else ratio
    if mode == "none" or (ratio <= 0.0 and mode != "mms"):
        return torch.ones((batch, length, 1), device=generator.device)
    if mode == "span":
        return span_mask(generator, batch, length, ratio, cfg.max_span_length)
    if mode == "span_old":
        return span_old_mask(generator, batch, length, ratio, cfg.max_span_length)
    if mode == "random":
        return random_mask(generator, batch, length, ratio)
    if mode == "block":
        return block_mask(generator, batch, length, ratio)
    if mode == "span_spacing":
        return span_spacing_mask(generator, batch, length, ratio, cfg.max_span_length)
    if mode == "mms":
        return mms_mask(generator, batch, length, cfg)
    raise ValueError(f"unknown mask mode {mode!r}")


def apply_mask(tokens: torch.Tensor, keep: torch.Tensor,
               mask_token: torch.Tensor) -> torch.Tensor:
    """``x * keep + (1 - keep) * mask_token`` in the tokens' dtype
    (``masking.py:208-211``)."""
    keep = keep.to(tokens.dtype)
    return tokens * keep + (1.0 - keep) * mask_token.to(tokens.dtype)


def mask_tokens(tokens: torch.Tensor, cfg: MaskConfig, mask_token: torch.Tensor,
                train: bool, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, mode: Optional[str] = None,
                ratio: Optional[float] = None) -> torch.Tensor:
    """A model's train-mode token masking (``htr_vt.py:100-105``): in train
    mode with masking on, ``apply_mask`` with the injected ``keep`` or one
    drawn from ``generator`` by ``build_keep_mask`` (under data parallelism
    the global batch's mask, this rank's rows: ``parallel/mesh.py:
    rank_rows``); else the tokens as they are (a ``keep`` there raises)."""
    if train and cfg.mode != "none":
        if keep is None:
            keep = rank_rows(lambda n: build_keep_mask(generator, n, tokens.shape[1], cfg,
                                                       mode=mode, ratio=ratio),
                             tokens.shape[0])
        return apply_mask(tokens, keep, mask_token)
    if keep is not None:
        raise ValueError("a keep mask applies only in train mode with masking on")
    return tokens
