"""Global-attention ViT block (port of ``htr_vt_tpu/models/vit.py``).

Train mode adds the projection and MLP dropout and drop-path, each drawing
from an explicit ``torch.Generator``; the JAX attention has no dropout on
the attention weights, so neither has this one. The flagship ``vit`` recipe
has no LayerScale and a drop-path rate of 0.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from htr_vt_torch.models.layers import DropPath, Mlp, dense, dropout


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    """softmax(q k^T * scale) v (``vit.py:77-93``). q, k, v: [B, H, N, D]
    -> [B, N, H*D].

    The logits are the exact float32 products of the compute-dtype q and k
    (upcast operands = bf16 inputs with an f32 result), the softmax is
    float32, and the attention is cast back to v's dtype before ``· v``."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn.to(v.dtype), v)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d).to(out_dtype)


class Attention(nn.Module):
    """Global multi-head self-attention with a fused qkv projection
    (``vit.py:96-146``; no rel-bias, no int8)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype, proj_drop: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.proj_drop = proj_drop
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = dense(self.qkv, x, self.dtype)
        # [B, N, 3, H, D] -> 3 x [B, H, N, D]
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, head_dim).permute(
            2, 0, 3, 1, 4)
        out = multi_head_attention(q, k, v, head_dim**-0.5, self.dtype)
        out = dense(self.proj, out, self.dtype)
        return dropout(out, self.proj_drop, train, generator)


class Block(nn.Module):
    """Pre-norm transformer block (``vit.py:238-296``): float32 LayerNorms,
    the residual stream in the compute dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, layer_norm_eps: float, dtype: torch.dtype,
                 drop: float = 0.0, drop_path: float = 0.0, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, proj_drop=drop,
                              device=device)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate=drop,
                       device=device)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        y = self.attn(self.norm1(x.float()).to(self.dtype), **kw)
        x = x + self.drop_path1(y, **kw)
        y = self.mlp(self.norm2(x.float()).to(self.dtype), **kw)
        return x + self.drop_path2(y, **kw)
