"""Global-attention ViT block (port of ``htr_vt_tpu/models/vit.py``).

Train mode adds the projection and MLP dropout and drop-path, each drawing
from an explicit ``torch.Generator``; the JAX attention has no dropout on
the attention weights, so neither has this one. The flagship ``vit`` recipe
has no LayerScale and a drop-path rate of 0.

``attn_impl`` picks the attention of each block as ``resolve_attn_impl``
decides: ``multi_head_attention`` (plain torch, the stock ops) or
``flash_mha`` (the K5 kernels, ``ops/flash_attn.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from htr_vt_torch.models.layers import DropPath, Mlp, dense, dropout
from htr_vt_torch.ops.flash_attn import flash_attention, takes_head_dim

ATTN_IMPLS = ("auto", "xla", "flash")


def resolve_attn_impl(impl: str, n: int, head_dim: int, fused: bool = False,
                      on_cuda: bool = False) -> str:
    """Pick the attention of a global-attention site (``vit.py:28-64``):
    ``"flash"`` (K5, streaming softmax over 128-key blocks, so the [B, H, N,
    N] matrix never reaches device memory) or ``"xla"`` (the stock ops).

    The JAX decisions, with "on a TPU" read as "the tensor is on CUDA":
    ``"auto"`` takes flash on CUDA when N >= 256 (the 1024/2048-px width
    buckets; the flagship's N = 128 stays on the stock ops) and N and
    head_dim are multiples of 128, and never where something is fused
    (dropout on the attention weights). An explicit ``"flash"`` is held to
    the same shape and fusion gates and raises on a shape it cannot take.
    One difference from JAX, which raises on an explicit ``"flash"`` off a
    TPU: here it is allowed on any device, and a CPU tensor runs the
    kernels' plain versions, as ``conv_impl="pallas"`` does on the CPU.
    ``"auto"`` routes to flash only a head_dim the kernels take
    (``ops/flash_attn.py:takes_head_dim``: every multiple of 128, so the
    decisions are JAX's), never one whose kernel would raise."""
    if impl == "xla":
        return "xla"
    if impl == "flash":
        if fused:
            raise ValueError("attn_impl='flash' cannot fuse bias/mask/dropout "
                             "inside attention at this site; use 'xla' or "
                             "'auto' (auto routes fused sites to the stock ops)")
        if n % 128 or head_dim % 128:
            raise ValueError(
                f"attn_impl='flash' needs N and head_dim to be multiples of "
                f"128 (kernel block constraint); got N={n}, head_dim="
                f"{head_dim} — use 'auto' to take the stock ops on such shapes")
        return "flash"
    if impl != "auto":
        raise ValueError(f"unknown attn_impl {impl!r} (auto | xla | flash)")
    if fused or n < 256 or n % 128 or not takes_head_dim(head_dim):
        return "xla"
    return "flash" if on_cuda else "xla"


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              out_dtype: torch.dtype) -> torch.Tensor:
    """Flash attention with ``multi_head_attention``'s contract, bias- and
    mask-free (``vit.py:67-74``): q, k, v [B, H, N, D] -> [B, N, H*D]."""
    out = flash_attention(q, k, v, scale)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d).to(out_dtype)


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
    (``vit.py:96-146``; no rel-bias, no int8). ``attn_drop`` only steers
    ``resolve_attn_impl``, as in JAX: no dropout acts on the weights."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, attn_impl: str = "auto", device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.proj_drop = proj_drop
        self.attn_drop = attn_drop
        self.attn_impl = attn_impl
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
        impl = resolve_attn_impl(self.attn_impl, n, head_dim,
                                 fused=self.attn_drop > 0 and train,
                                 on_cuda=x.is_cuda)
        mha = flash_mha if impl == "flash" else multi_head_attention
        out = mha(q, k, v, head_dim**-0.5, self.dtype)
        out = dense(self.proj, out, self.dtype)
        return dropout(out, self.proj_drop, train, generator)


class Block(nn.Module):
    """Pre-norm transformer block (``vit.py:238-296``): float32 LayerNorms,
    the residual stream in the compute dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, layer_norm_eps: float, dtype: torch.dtype,
                 drop: float = 0.0, drop_path: float = 0.0,
                 attn_drop: float = 0.0, attn_impl: str = "auto", device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, proj_drop=drop,
                              attn_drop=attn_drop, attn_impl=attn_impl,
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
