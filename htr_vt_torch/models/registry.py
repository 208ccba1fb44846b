"""Encoder registry (port of ``htr_vt_tpu/models/registry.py``).

Each reference variant is a named encoder recipe: a function that, given a
``ModelConfig`` and a device, returns the named token-mixing blocks applied
to the [B, N, D] token stream, as (JAX module name, module) pairs. One
model (``models/htr_vt.py:HTRVT``) hosts every recipe.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from torch import nn

_ENCODERS: Dict[str, Callable] = {}
# Standalone model classes of the JAX package (its build_model dispatches
# them): valid ``--encoder`` values that are not block recipes.
STANDALONE = ("swin", "svtr")


def register_encoder(name: str):
    def deco(fn):
        _ENCODERS[name] = fn
        return fn
    return deco


def build_encoder_blocks(cfg, device=None) -> List[Tuple[str, nn.Module]]:
    """The named block stack of ``cfg.encoder``."""
    import htr_vt_torch.models.variants  # noqa: F401  (registers every recipe)

    if cfg.encoder not in _ENCODERS:
        raise ValueError(f"unknown encoder {cfg.encoder!r}; available: "
                         f"{sorted(_ENCODERS)}")
    return _ENCODERS[cfg.encoder](cfg, device)


def available_encoders() -> List[str]:
    import htr_vt_torch.models.variants  # noqa: F401
    return sorted(set(_ENCODERS) | set(STANDALONE))
