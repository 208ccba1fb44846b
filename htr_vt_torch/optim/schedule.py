"""Learning-rate schedule (port of ``htr_vt_tpu/optim/schedule.py``)."""

from __future__ import annotations

import math


def warmup_cosine_lr(step: int, *, max_lr: float, warmup_iters: int,
                     total_iters: int, min_lr: float = 1e-7) -> float:
    """LR at integer ``step``: linear warmup, then a cosine whose phase is
    ``pi * step / (total - warmup)`` over the raw step, not (step - warmup),
    the reference's quirk (``schedule.py:16-23``)."""
    if step < warmup_iters:
        return max_lr * (step + 1.0) / (warmup_iters + 1.0)
    phase = math.pi * step / max(1, total_iters - warmup_iters)
    return min_lr + (max_lr - min_lr) * 0.5 * (1.0 + math.cos(phase))
