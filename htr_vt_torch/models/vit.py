"""Global-attention ViT block (port of ``htr_vt_tpu/models/vit.py``).

Eval forward only: dropout and drop-path are identities there, and the
flagship ``vit`` recipe has no LayerScale, so neither appears here.
"""

from __future__ import annotations

import torch
from torch import nn

from htr_vt_torch.models.layers import Mlp, dense


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
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = dense(self.qkv, x, self.dtype)
        # [B, N, 3, H, D] -> 3 x [B, H, N, D]
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, head_dim).permute(
            2, 0, 3, 1, 4)
        out = multi_head_attention(q, k, v, head_dim**-0.5, self.dtype)
        return dense(self.proj, out, self.dtype)


class Block(nn.Module):
    """Pre-norm transformer block (``vit.py:238-296``): float32 LayerNorms,
    the residual stream in the compute dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, layer_norm_eps: float, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x.float()).to(self.dtype))
        x = x + self.mlp(self.norm2(x.float()).to(self.dtype))
        return x
