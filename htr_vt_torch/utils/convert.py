"""Weights into the port, through the reference PyTorch layout.

The port's modules are named after the reference ``state_dict`` keys that
``htr_vt_tpu/utils/torch_convert.py`` maps, so both directions reuse its
numpy functions: a JAX tree goes through ``tree_to_reference_state_dict``,
and a reference ``.pth`` is normalised by a round trip through the tree
(which drops ``pos_embed``, ``num_batches_tracked`` and ``module.``
prefixes). Either loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from htr_vt_tpu.utils import torch_convert


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_jax_params(model: nn.Module, params, batch_stats) -> None:
    """Load a JAX ``HTRVT`` (params, batch_stats) tree of numpy arrays into
    the port's model, strictly."""
    sd = torch_convert.tree_to_reference_state_dict(params, batch_stats)
    model.load_state_dict(_tensors(sd), strict=True)


def load_reference_checkpoint(path: str, key: str = "state_dict_ema"
                              ) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` (``key``: 'state_dict_ema' or 'model', or
    a bare state_dict) as a state_dict that the port's model loads with
    ``strict=True``. Raises on keys the flagship layout does not have."""
    params, stats, unused = torch_convert.load_reference_checkpoint(path, key)
    if unused:
        raise ValueError(f"{path}: keys outside the flagship layout: {unused}")
    return _tensors(torch_convert.tree_to_reference_state_dict(params, stats))
