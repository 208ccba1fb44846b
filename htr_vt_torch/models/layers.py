"""Shared building blocks (port of ``htr_vt_tpu/models/layers.py``).

Parameters are float32; each layer casts its weights to the compute dtype at
the call, as the JAX package's ``QDense`` does, so one state_dict serves a
bfloat16 and a float32 model alike.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def global_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameterless LayerNorm over every non-batch dimension, in float32
    (``layers.py:18-29``)."""
    x32 = x.float()
    dims = tuple(range(1, x.ndim))
    mean = x32.mean(dims, keepdim=True)
    var = x32.var(dims, keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def sincos_pos_embed_2d(embed_dim: int, grid_size: Tuple[int, int]) -> np.ndarray:
    """Fixed 2-D sin-cos positional embedding, float32 [gh*gw, embed_dim].

    Keeps the reference's w-first meshgrid quirk (``layers.py:32-47``): the
    first half of the embedding encodes the first meshgrid output."""
    gh, gw = grid_size
    grid_h = np.arange(gh, dtype=np.float32)
    grid_w = np.arange(gw, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, gh, gw])
    emb_a = _sincos_1d(embed_dim // 2, grid[0])
    emb_b = _sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_a, emb_b], axis=1).astype(np.float32)


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``QDense`` float path (``layers.py:66-100``): the product of input and
    weight in ``dtype``, rounded to ``dtype``, then the bias added in
    ``dtype``; a bias fused into the GEMM would round once instead."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> fc2 (``layers.py:104-132``, float path only;
    dropout is an eval identity)."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(dense(self.fc1, x, self.dtype), approximate="none")
        return dense(self.fc2, x, self.dtype)
