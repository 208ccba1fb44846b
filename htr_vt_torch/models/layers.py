"""Shared building blocks (port of ``htr_vt_tpu/models/layers.py``).

Parameters are float32; each layer casts its weights to the compute dtype at
the call, as the JAX package's ``QDense`` does, so one state_dict serves a
bfloat16 and a float32 model alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, drawing from
    ``generator``; the identity at rate 0 or in eval."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth (``layers.py:135-148``): in train mode a
    whole sample's branch is dropped with probability ``rate`` and kept ones
    are scaled by ``1 / (1 - rate)``; the identity at rate 0 or in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> dropout -> fc2 -> dropout
    (``layers.py:104-132``, float path only)."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype,
                 drop_rate: float = 0.0, device=None):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.fc1 = nn.Linear(dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.gelu(dense(self.fc1, x, self.dtype), approximate="none")
        x = dropout(x, self.drop_rate, train, generator)
        x = dense(self.fc2, x, self.dtype)
        return dropout(x, self.drop_rate, train, generator)
