"""Weights into the port, through the reference PyTorch layout.

The port's modules are named after the reference ``state_dict`` keys that
``htr_vt_tpu/utils/torch_convert.py`` maps, so both directions reuse its
numpy functions: a JAX tree goes through ``tree_to_reference_state_dict``,
and a reference ``.pth`` is normalised by a round trip through the tree
(which drops ``pos_embed``, ``num_batches_tracked`` and ``module.``
prefixes). Either loads with ``load_state_dict(strict=True)``. The reverse,
port -> JAX tree, goes through ``reference_state_dict_to_tree``.

A JAX ``TrainState``'s optimizer state (optax ``mu``/``nu``/``count``) does
not convert yet; it waits for the port's checkpoints (ROADMAP.md queue 1,
item 7).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from htr_vt_tpu.utils import torch_convert


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_jax_params(model: nn.Module, params, batch_stats) -> None:
    """Load a JAX ``HTRVT`` (params, batch_stats) tree of numpy or JAX
    arrays into the port's model, strictly."""
    sd = torch_convert.tree_to_reference_state_dict(params, batch_stats)
    model.load_state_dict(_tensors(sd), strict=True)


def load_jax_train_state(model: nn.Module, ema_model: nn.Module, state) -> None:
    """Load a JAX ``TrainState`` (or any object with its ``params``,
    ``batch_stats``, ``ema_params`` and ``ema_batch_stats`` trees) into the
    model and its EMA copy, strictly."""
    load_jax_params(model, state.params, state.batch_stats)
    load_jax_params(ema_model, state.ema_params, state.ema_batch_stats)


def model_to_jax_tree(model: nn.Module) -> Tuple[Dict, Dict]:
    """The port's weights as a JAX ``HTRVT`` (params, batch_stats) pair of
    numpy trees. Raises on a state_dict key the flagship layout lacks."""
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    params, stats, unused = torch_convert.reference_state_dict_to_tree(sd)
    if unused:
        raise ValueError(f"keys outside the flagship layout: {unused}")
    return params, stats


def load_reference_checkpoint(path: str, key: str = "state_dict_ema"
                              ) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` (``key``: 'state_dict_ema' or 'model', or
    a bare state_dict) as a state_dict that the port's model loads with
    ``strict=True``. Raises on keys the flagship layout does not have."""
    params, stats, unused = torch_convert.load_reference_checkpoint(path, key)
    if unused:
        raise ValueError(f"{path}: keys outside the flagship layout: {unused}")
    return _tensors(torch_convert.tree_to_reference_state_dict(params, stats))
