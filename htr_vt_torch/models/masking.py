"""Token masking for training (port of ``htr_vt_tpu/models/masking.py``).

Keep masks are float32 [B, L, 1], 1 = keep, 0 = replace with the learned
mask token. Draws come from an explicit ``torch.Generator`` on the tokens'
device, so no mask leaves or enters the host. The JAX and torch random
streams differ, so the masks match the JAX package in distribution, not
draw for draw; tests hand the model JAX's masks where they compare values.

Ported: ``span`` (the flagship ``model_v1`` recipe) and ``none``. The
per-sample strategies of the tri-masked MMS trainer wait for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from htr_vt_tpu.config import MaskConfig

# Strategies of the tri-masked MMS trainer, not ported yet.
_MMS_MODES = ("span_old", "random", "block", "span_spacing", "mms")


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


def build_keep_mask(generator: torch.Generator, batch: int, length: int,
                    cfg: MaskConfig, mode: Optional[str] = None,
                    ratio: Optional[float] = None) -> torch.Tensor:
    """Dispatch by strategy name (``masking.py:183-205``); float32
    [B, L, 1] on the generator's device."""
    mode = mode or cfg.mode
    ratio = cfg.ratio if ratio is None else ratio
    if mode == "none" or (ratio <= 0.0 and mode != "mms"):
        return torch.ones((batch, length, 1), device=generator.device)
    if mode == "span":
        return span_mask(generator, batch, length, ratio, cfg.max_span_length)
    if mode in _MMS_MODES:
        raise NotImplementedError(
            f"mask mode {mode!r} is not ported to htr_vt_torch yet (ROADMAP.md "
            "queue 1, item 10: the tri-masked MMS trainer)")
    raise ValueError(f"unknown mask mode {mode!r}")


def apply_mask(tokens: torch.Tensor, keep: torch.Tensor,
               mask_token: torch.Tensor) -> torch.Tensor:
    """``x * keep + (1 - keep) * mask_token`` in the tokens' dtype
    (``masking.py:208-211``)."""
    keep = keep.to(tokens.dtype)
    return tokens * keep + (1.0 - keep) * mask_token.to(tokens.dtype)
