"""Local-window and pooled-global attention blocks (port of
``htr_vt_tpu/models/localglobal.py``).

``model_sgm_localglobal`` stacks a plain 1-D window block, a shifted one and
two global blocks; ``model_lgp`` runs a local window attention and an
alpha-gated pooled-global attention side by side in every block. Unlike the
``model_window`` attention (``models/vit.py``) these windows carry no
relative-position bias, their shift rolls without any mask, and the zero
tokens that pad the sequence to a multiple of the window stay unmasked: the
reference's semantics, kept.

Over a model axis both attentions are sharded as ``models/vit.py:
Attention``: ``copy_to_model``, this rank's heads of qkv, attention over
them, proj's partial product summed over the model group (JAX's rules shard
``local_attn/proj`` and ``global_attn/proj``); lgp's ``fuse`` stays
replicated.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.models.layers import Mlp, dense, dropout, row_dense
from htr_vt_torch.models.vit import multi_head_attention, split_heads
from htr_vt_torch.parallel.mesh import copy_to_model

POOL_NORM_EPS = 1e-6  # flax LayerNorm's default


def linear_resize_tokens(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear interpolation along the token axis, as
    ``F.interpolate(mode="linear", align_corners=False)``
    (``localglobal.py:27-37``)."""
    b, n, d = x.shape
    if n == target_len:
        return x
    coords = ((torch.arange(target_len, device=x.device, dtype=torch.float32) + 0.5)
              * (n / target_len) - 0.5)
    lo = torch.clamp(torch.floor(coords).long(), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    w = torch.clamp(coords - lo, 0.0, 1.0).to(x.dtype)[None, :, None]
    return x[:, lo] * (1 - w) + x[:, hi] * w


class PlainWindowMHSA(nn.Module):
    """Non-overlapping 1-D window attention; ``shift`` rolls the sequence
    right before and back after, unmasked (``localglobal.py:40-78``)."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # the heads.
    model_shards = 1

    def __init__(self, dim: int, num_heads: int, window_size: int, dtype: torch.dtype,
                 shift: int = 0, qkv_bias: bool = True, proj_drop: float = 0.0,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = shift % window_size if window_size > 0 else 0
        self.dtype = dtype
        self.proj_drop = proj_drop
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        w, s = self.window_size, self.shift
        if s:
            x = torch.roll(x, s, dims=1)
        pad = (w - n % w) % w
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        n_pad = x.shape[1]
        sharded = self.model_shards > 1
        heads = self.num_heads // self.model_shards  # this rank's
        qkv = dense(self.qkv, copy_to_model(x) if sharded else x, self.dtype)
        width = qkv.shape[-1] // 3
        q, k, v = (split_heads(t.reshape(b * n_pad // w, w, width), heads)
                   for t in qkv.chunk(3, dim=-1))
        out = multi_head_attention(q, k, v, (c // self.num_heads)**-0.5, self.dtype)
        out = out.reshape(b, n_pad, width)[:, :n]
        if s:
            out = torch.roll(out, -s, dims=1)
        return dropout(row_dense(self.proj, out, self.dtype, sharded), self.proj_drop,
                       train, generator)


class PooledGlobalMHSA(nn.Module):
    """Average-pool the tokens to ``g_tokens`` -> LayerNorm without affine
    -> MHSA -> proj -> linear upsample -> the learned ``alpha`` gate
    (``localglobal.py:81-116``)."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # the heads.
    model_shards = 1

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 g_tokens: int = 64, qkv_bias: bool = True, proj_drop: float = 0.0,
                 alpha_init: float = 0.4, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.g_tokens = g_tokens
        self.dtype = dtype
        self.proj_drop = proj_drop
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.alpha = nn.Parameter(torch.tensor(float(alpha_init), device=device))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        g = min(self.g_tokens, max(1, n))
        if n % g == 0:
            z = x.reshape(b, g, n // g, c).mean(dim=2)
        else:
            z = linear_resize_tokens(x, g)
        z = F.layer_norm(z.float(), (c,), eps=POOL_NORM_EPS).to(self.dtype)
        sharded = self.model_shards > 1
        qkv = dense(self.qkv, copy_to_model(z) if sharded else z, self.dtype)
        q, k, v = (split_heads(t, self.num_heads // self.model_shards)
                   for t in qkv.chunk(3, dim=-1))
        y = multi_head_attention(q, k, v, (c // self.num_heads)**-0.5, self.dtype)
        y = dropout(row_dense(self.proj, y, self.dtype, sharded), self.proj_drop, train,
                    generator)
        y = linear_resize_tokens(y, n)
        return y * self.alpha.to(y.dtype)


class LocalBlock1D(nn.Module):
    """Pre-LN window MHSA + MLP (``localglobal.py:119-140``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, dtype: torch.dtype,
                 shifted: bool = False, mlp_ratio: float = 4.0, drop: float = 0.0,
                 layer_norm_eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = PlainWindowMHSA(dim, num_heads, window_size, dtype,
                                    shift=window_size // 2 if shifted else 0,
                                    proj_drop=drop, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate=drop, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        x = x + self.attn(self.norm1(x.float()).to(self.dtype), **kw)
        return x + self.mlp(self.norm2(x.float()).to(self.dtype), **kw)


class LocalGlobalParallelBlock(nn.Module):
    """norm -> (window MHSA || alpha-gated pooled-global MHSA) -> concat ->
    fuse -> +res -> norm -> MLP -> +res (``localglobal.py:143-175``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, dtype: torch.dtype,
                 g_tokens: int = 64, mlp_ratio: float = 4.0, drop: float = 0.0,
                 alpha_init: float = 0.4, layer_norm_eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.local_attn = PlainWindowMHSA(dim, num_heads, window_size, dtype,
                                          proj_drop=drop, device=device)
        self.global_attn = PooledGlobalMHSA(dim, num_heads, dtype, g_tokens=g_tokens,
                                            proj_drop=drop, alpha_init=alpha_init,
                                            device=device)
        self.fuse = nn.Linear(2 * dim, dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate=drop, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        y = self.norm1(x.float()).to(self.dtype)
        fused = dense(self.fuse, torch.cat([self.local_attn(y, **kw),
                                            self.global_attn(y, **kw)], dim=-1),
                      self.dtype)
        x = x + fused
        return x + self.mlp(self.norm2(x.float()).to(self.dtype), **kw)
