"""Exponential moving average of the full model state (port of
``htr_vt_tpu/optim/ema.py``): parameters *and* BatchNorm running
statistics, with the warmup-ramped decay ``min(decay, (1 + n) / (10 + n))``.
The EMA model is updated in place."""

from __future__ import annotations

import torch
from torch import nn


def ema_decay_at(num_updates: float, decay: float) -> float:
    return min(decay, (1.0 + num_updates) / (10.0 + num_updates))


@torch.no_grad()
def ema_update(ema_model: nn.Module, model: nn.Module, num_updates: float,
               decay: float) -> None:
    """``e = e * d + (1 - d) * p`` over every floating-point entry of the
    state_dict (``ema.py:23-27``): parameters and BN running statistics,
    not the fixed position table. Both models have one layout."""
    d = ema_decay_at(num_updates, decay)
    new = model.state_dict()
    ema = {k: v for k, v in ema_model.state_dict().items()
           if v.is_floating_point()}
    torch._foreach_mul_(list(ema.values()), d)
    torch._foreach_add_(list(ema.values()),
                        torch._foreach_mul([new[k] for k in ema], 1.0 - d))
