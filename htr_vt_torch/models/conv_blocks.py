"""Convolutional sequence-mixing blocks (port of
``htr_vt_tpu/models/conv_blocks.py``): the macaron conv mixers, Conformer
and SqueezeFormer.

- ``model_sgm_macaron(_2)``: ``ConvLocalMixer1D`` x2 ahead of the ViT stack;
- ``model_sgm_mms_conv``: Conformer blocks (half-FFN -> MHSA -> ConvModule
  -> half-FFN -> LN) with a GLU'd depthwise ConvModule under GroupNorm(1);
- ``model_sgm_mms_conv_squeeze``: SE-gated Conformer blocks in a two-stage
  temporal U-Net.

Depthwise 1-D convolutions are ``F.conv1d`` with ``groups = channels`` over
the token axis, padded as flax's ``"SAME"``; their bias is added after the
product in the compute dtype, as flax's ``nn.Conv`` does. The norms follow
flax: float32 statistics with the variance ``E[x^2] - E[x]^2``. With
``quant`` (int8 serving, eval only) a Conformer block's attention, FFN and
ConvModule pointwise linears are int8 sites; the depthwise conv stays float
(``conv_blocks.py:70-71``).

Over a model axis a Conformer block shards its attention
(``models/vit.py:Attention``) and the squeeze-excite's two linears, as
JAX's rules do (``attn/qkv``, ``attn/proj``, ``se/fc1``, ``se/fc2``); the
FFNs, the conv module and the macaron mixers stay replicated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.models.layers import (DropPath, dense, dropout, glu,
                                        lecun_normal_, quantize_linear, row_dense)
from htr_vt_torch.models.stem import BN_EPS, BatchNorm, batch_moments
from htr_vt_torch.models.vit import Attention
from htr_vt_torch.parallel.mesh import copy_to_model

FLAX_LN_EPS = 1e-6  # flax LayerNorm's default
CONV_MODULE_EPS = 1e-5  # the reference ConvModule's torch LayerNorm / GroupNorm


def depthwise_conv1d(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype
                     ) -> torch.Tensor:
    """flax ``nn.Conv(features=C, kernel_size=(k,), padding="SAME",
    feature_group_count=C)`` over x [B, N, C]: the product in ``dtype``,
    then the bias added in it."""
    k = conv.kernel_size[0]
    lo = (k - 1) // 2
    y = F.conv1d(F.pad(x.to(dtype).transpose(1, 2), (lo, k - 1 - lo)),
                 conv.weight.to(dtype), groups=conv.groups)
    return y.transpose(1, 2) + conv.bias.to(dtype)


def _depthwise(dim: int, kernel_size: int, device) -> nn.Conv1d:
    return nn.Conv1d(dim, dim, kernel_size, groups=dim, device=device)


class TokenBatchNorm(BatchNorm):
    """flax ``nn.BatchNorm`` over the channels of [B, N, C] tokens, float32
    out. Train mode normalises by the batch statistics over B and N (the
    biased variance; the global batch's under data parallelism,
    ``stem.py:batch_moments``) and moves the running statistics by ``0.9 *
    ra + 0.1 * batch`` in place (not inside a remat recompute); eval reads
    the running statistics."""

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            mean, ex2 = batch_moments(xf, (0, 1))
            var = torch.clamp_min(ex2 - mean.square(), 0.0)
            self.move_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return (xf - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias


def group_norm_1(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.GroupNorm(num_groups=1)`` over x [B, N, C]: each sample
    normalised over its N x C values in float32, then the per-channel scale
    and bias; float32 out."""
    xf = x.float()
    mean = xf.mean((1, 2), keepdim=True)
    var = torch.clamp_min(xf.square().mean((1, 2), keepdim=True) - mean.square(), 0.0)
    return (xf - mean) * (torch.rsqrt(var + gn.eps) * gn.weight) + gn.bias


class ConvLocalMixer1D(nn.Module):
    """LN -> Dense(2D) -> GLU -> depthwise conv(k) -> BN -> SiLU -> Dense ->
    dropout, residual (``conv_blocks.py:35-57``)."""

    def __init__(self, dim: int, dtype: torch.dtype, kernel_size: int = 7,
                 drop_rate: float = 0.1, device=None):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.norm = nn.LayerNorm(dim, eps=FLAX_LN_EPS, device=device)
        self.pw_in = nn.Linear(dim, 2 * dim, device=device)
        self.dwconv = _depthwise(dim, kernel_size, device)
        self.bn = TokenBatchNorm(dim, device=device)
        self.pw_out = nn.Linear(dim, dim, device=device)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        lecun_normal_(self.dwconv.weight, self.dwconv.kernel_size[0], generator)
        self.dwconv.bias.zero_()

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.norm(x.float()).to(self.dtype)
        y = glu(dense(self.pw_in, y, self.dtype))
        y = depthwise_conv1d(self.dwconv, y, self.dtype)
        y = F.silu(self.bn(y, train=train).to(self.dtype))
        y = dropout(dense(self.pw_out, y, self.dtype), self.drop_rate, train, generator)
        return x + y


class ConvModule(nn.Module):
    """Conformer conv module: LN -> pointwise -> GLU -> depthwise conv ->
    GroupNorm(1) -> SiLU -> pointwise -> dropout -> drop-path, residual
    inside (``conv_blocks.py:60-103``)."""

    def __init__(self, dim: int, dtype: torch.dtype, kernel_size: int = 3,
                 drop_rate: float = 0.1, drop_path: float = 0.0,
                 expansion: float = 1.0, device=None, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.quant = quant
        hidden = int(dim * expansion)
        self.use_glu = hidden % 2 == 0
        inner = hidden // 2 if self.use_glu else hidden
        self.norm = nn.LayerNorm(dim, eps=CONV_MODULE_EPS, device=device)
        self.pw1 = nn.Linear(dim, hidden, device=device)
        self.dw = _depthwise(inner, kernel_size, device)
        self.gn = nn.GroupNorm(1, inner, eps=CONV_MODULE_EPS, device=device)
        self.pw2 = nn.Linear(inner, dim, device=device)
        self.dp = DropPath(drop_path)
        if quant:
            quantize_linear(self.pw1)
            quantize_linear(self.pw2)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        for lin in (self.pw1, self.pw2):
            lecun_normal_(lin.weight, lin.in_features, generator)
        lecun_normal_(self.dw.weight, self.dw.kernel_size[0], generator)
        self.dw.bias.zero_()

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        quant = self.quant and not train
        y = self.norm(x.float()).to(self.dtype)
        y = dense(self.pw1, y, self.dtype, quant)
        if self.use_glu:
            y = glu(y)
        y = depthwise_conv1d(self.dw, y, self.dtype)
        y = F.silu(group_norm_1(self.gn, y).to(self.dtype))
        y = dropout(dense(self.pw2, y, self.dtype, quant), self.drop_rate, train,
                    generator)
        return x + self.dp(y, train=train, generator=generator)


class SqueezeExcite1D(nn.Module):
    """Mean over the tokens -> Dense -> SiLU -> Dense -> sigmoid channel
    gate (``conv_blocks.py:106-121``). Sharded over a model axis
    (``model_shards`` > 1) as ``layers.py:Mlp``: fc1 column-, fc2
    row-sharded."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # fc1's outputs and fc2's inputs.
    model_shards = 1

    def __init__(self, dim: int, dtype: torch.dtype, se_ratio: float = 0.25,
                 device=None):
        super().__init__()
        self.dtype = dtype
        hidden = max(8, int(dim * se_ratio))
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        for lin in (self.fc1, self.fc2):
            lecun_normal_(lin.weight, lin.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=1).to(self.dtype)
        sharded = self.model_shards > 1
        s = F.silu(dense(self.fc1, copy_to_model(s) if sharded else s, self.dtype))
        s = row_dense(self.fc2, s, self.dtype, sharded)
        return x * torch.sigmoid(s)[:, None, :].to(x.dtype)


def downsample_tokens(x: torch.Tensor) -> torch.Tensor:
    """Average-pool the token axis by 2 (``conv_blocks.py:124-129``)."""
    b, n, d = x.shape
    if n <= 1:
        return x
    return x.reshape(b, n // 2, 2, d).mean(dim=2)


def upsample_tokens(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Nearest-neighbour upsample back to ``target_len``
    (``conv_blocks.py:132-138``)."""
    n = x.shape[1]
    if n == target_len:
        return x
    return torch.repeat_interleave(x, target_len // n, dim=1)[:, :target_len]


class FeedForward(nn.Module):
    """Conformer FFN: lin1 -> SiLU -> lin2 -> dropout
    (``conv_blocks.py:203-221``)."""

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype,
                 drop_rate: float = 0.1, device=None, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.quant = quant
        self.lin1 = nn.Linear(dim, hidden_dim, device=device)
        self.lin2 = nn.Linear(hidden_dim, dim, device=device)
        if quant:
            quantize_linear(self.lin1)
            quantize_linear(self.lin2)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        quant = self.quant and not train
        y = dense(self.lin2, F.silu(dense(self.lin1, x, self.dtype, quant)), self.dtype,
                  quant)
        return dropout(y, self.drop_rate, train, generator)


class ConformerBlock(nn.Module):
    """Half-FFN -> MHSA -> ConvModule -> [SE] -> half-FFN -> final LN
    (``conv_blocks.py:224-273``); ``use_se`` makes it the SqueezeFormer
    block. One drop-path rate serves the three residual branches and the
    ConvModule."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 mlp_ratio: float = 4.0, ff_drop: float = 0.1, attn_drop: float = 0.0,
                 conv_drop: float = 0.1, conv_kernel: int = 3, drop_path: float = 0.0,
                 use_se: bool = False, layer_norm_eps: float = 1e-6,
                 attn_impl: str = "auto", device=None, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        hidden = int(dim * mlp_ratio)

        def norm():
            return nn.LayerNorm(dim, eps=layer_norm_eps, device=device)

        self.ffn1_norm, self.attn_norm = norm(), norm()
        self.ffn2_norm, self.final_norm = norm(), norm()
        self.ffn1 = FeedForward(dim, hidden, dtype, ff_drop, device=device, quant=quant)
        self.attn = Attention(dim, num_heads, True, dtype, proj_drop=ff_drop,
                              attn_drop=attn_drop, attn_impl=attn_impl, device=device,
                              quant=quant)
        self.conv = ConvModule(dim, dtype, conv_kernel, conv_drop, drop_path,
                               device=device, quant=quant)
        self.se = SqueezeExcite1D(dim, dtype, device=device) if use_se else None
        self.ffn2 = FeedForward(dim, hidden, dtype, ff_drop, device=device, quant=quant)
        self.dp = DropPath(drop_path)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)

        def branch(norm, f):
            return f(norm(x.float()).to(self.dtype), **kw)

        x = x + self.dp(0.5 * branch(self.ffn1_norm, self.ffn1), **kw)
        x = x + self.dp(branch(self.attn_norm, self.attn), **kw)
        x = self.conv(x, **kw)
        if self.se is not None:
            x = self.se(x)
        x = x + self.dp(0.5 * branch(self.ffn2_norm, self.ffn2), **kw)
        return self.final_norm(x.float()).to(x.dtype)


class SqueezeFormerEncoder(nn.Module):
    """Two-stage temporal U-Net of SE-gated Conformer blocks
    (``conv_blocks.py:141-200``): ``depth // 2`` blocks at N tokens, an
    average-pool to N / 2, the rest there, a nearest upsample back to N
    plus the stage-1 skip, and an affine LayerNorm. Drop-path rates follow
    ``linspace(0, drop_path_total, depth)`` across the two stages."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype, depth: int = 4,
                 mlp_ratio: float = 4.0, ff_drop: float = 0.1, attn_drop: float = 0.1,
                 conv_drop: float = 0.1, conv_kernel: int = 3,
                 drop_path_total: float = 0.1, layer_norm_eps: float = 1e-6,
                 attn_impl: str = "auto", device=None, quant: bool = False):
        super().__init__()
        d1 = max(1, depth // 2)
        d2 = max(1, depth - d1)
        dpr = np.linspace(0.0, drop_path_total, depth)

        def block(dp):
            return ConformerBlock(dim, num_heads, dtype, mlp_ratio, ff_drop, attn_drop,
                                  conv_drop, conv_kernel, float(dp), use_se=True,
                                  layer_norm_eps=layer_norm_eps, attn_impl=attn_impl,
                                  device=device, quant=quant)

        self.stage1 = [f"stage1_block{i}" for i in range(d1)]
        self.stage2 = [f"stage2_block{i}" for i in range(d2)]
        for i, name in enumerate(self.stage1):
            self.add_module(name, block(dpr[i]))
        for i, name in enumerate(self.stage2):
            self.add_module(name, block(dpr[d1 + i] if d1 + i < depth else 0.0))
        self.out_norm = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        n0 = x.shape[1]
        for name in self.stage1:
            x = getattr(self, name)(x, **kw)
        skip = x
        x = downsample_tokens(x)
        for name in self.stage2:
            x = getattr(self, name)(x, **kw)
        x = upsample_tokens(x, n0) + skip
        return self.out_norm(x.float()).to(x.dtype)
