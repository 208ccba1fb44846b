"""ResNet18 feature stem (port of ``htr_vt_tpu/models/stem.py``).

Collapses a [B, 1, 64, 512] line image to [B, C, 1, 128]; stride plan
(``stem.py:8``)::

    conv1 (2,1) -> maxpool3 (2,1) -> stage1 (2,1) -> stage2 (2,2)
    -> stage3 (2,2) -> maxpool3 (2,1)

Runs NCHW with channels_last memory. Eval BatchNorm uses the running
statistics in float32, folded into a per-channel (scale, shift) as
``FoldedBatchNorm`` gives it (``stem.py:139-143``); for the entry BN, which
the JAX stem applies in flax's ``(x - mean) * mul + beta`` order, the two
forms agree to float32 rounding. Train mode is the JAX stem's ``plain``
dataflow with flax's BatchNorm: batch statistics in float32 with the biased
variance ``E[x^2] - E[x]^2`` (clamped at 0), the normalised output cast to
the compute dtype, and the running statistics moved by ``0.9 * ra + 0.1 *
batch``; ``nn.BatchNorm2d`` would track the unbiased variance instead.
Convolutions are ``F.conv2d`` in the compute dtype. Module and parameter
names follow the reference state_dict (``patch_embed.layer1.0.conv1.weight``,
...), so a checkpoint converted by ``htr_vt_tpu/utils/torch_convert.py``
loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """BatchNorm state: ``weight``/``bias`` and ``running_mean``/
    ``running_var``, exactly the reference's keys (no
    ``num_batches_tracked``)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def scale_shift(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``scale = gamma / sqrt(var + eps)``, ``shift = beta - mean *
        scale``, float32 per channel, shaped to broadcast over NCHW."""
        scale = self.weight.float() * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias.float() - self.running_mean * scale
        return scale[:, None, None], shift[:, None, None]

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """flax ``nn.BatchNorm`` in train mode (float32 out): normalise by
        the batch statistics as ``(x - mean) * (gamma * rsqrt(var + eps)) +
        beta`` and move the running statistics in place (``stem.py:117-138``
        with flax's fast variance)."""
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dims)
        var = torch.clamp_min(xf.square().mean(dims) - mean.square(), 0.0)
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride, padding: int,
          dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(dtype), stride=stride, padding=padding)


def _proj_conv(conv: nn.Conv2d, x: torch.Tensor, stride: Tuple[int, int],
               dtype: torch.dtype) -> torch.Tensor:
    """The strided 1x1 projection as a subsample and a 1x1 conv: the same
    products and sums. CPU torch's backward of a strided 1x1 conv over a
    channels_last tensor corrupts memory; this form has none."""
    return F.conv2d(x[:, :, ::stride[0], ::stride[1]], conv.weight.to(dtype))


def _max_pool_3x3(x: torch.Tensor, stride: Tuple[int, int]) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=stride, padding=1)


class BasicBlock(nn.Module):
    """ResNet BasicBlock. Eval, the folded form (``stem.py:262-335``)::

        y1 = conv1(x);  y2 = conv2(bf16(relu(y1 * s1 + t1)))
        out = bf16(relu(y2 * s2 + t2 + (p * sp + tp | x)))   # f32 epilogue

    Train, the ``plain`` dataflow (``stem.py:192-214``), whose residual sum
    and ReLU run in the compute dtype::

        a = relu(bf16(bn1(conv1(x))));  y = bf16(bn2(conv2(a)))
        out = relu(y + (bf16(proj_bn(proj(x))) | x))
    """

    def __init__(self, cin: int, cout: int, stride: Tuple[int, int],
                 use_projection: bool, dtype: torch.dtype, device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.conv1 = nn.Conv2d(cin, cout, 3, bias=False, device=device)
        self.bn1 = BatchNorm(cout, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, bias=False, device=device)
        self.bn2 = BatchNorm(cout, device=device)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, cout, 1, bias=False, device=device),
            BatchNorm(cout, device=device)) if use_projection else None)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        if train:
            return self._train_forward(x)
        y1 = _conv(self.conv1, x, self.stride, 1, dt)
        s1, t1 = self.bn1.scale_shift()
        a = torch.relu(y1.float() * s1 + t1).to(dt)
        y2 = _conv(self.conv2, a, 1, 1, dt)
        s2, t2 = self.bn2.scale_shift()
        if self.downsample is not None:
            conv, bn = self.downsample
            sp, tp = bn.scale_shift()
            residual = _proj_conv(conv, x, self.stride, dt).float() * sp + tp
        else:
            residual = x.float()
        return torch.relu(y2.float() * s2 + t2 + residual).to(dt)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = _conv(self.conv1, x, self.stride, 1, dt)
        y = torch.relu(self.bn1.train_forward(y).to(dt))
        y = _conv(self.conv2, y, 1, 1, dt)
        y = self.bn2.train_forward(y).to(dt)
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn.train_forward(
                _proj_conv(conv, x, self.stride, dt)).to(dt)
        return torch.relu(y + residual)


class ResNet18Stem(nn.Module):
    """[B, 1, H, W] -> [B, embed_dim, H', W'] (``stem.py:347-464``, default
    widths [D/4, D/2, D] and stage strides)."""

    STAGE_STRIDES: Sequence[Tuple[int, int]] = ((2, 1), (2, 2), (2, 2))

    def __init__(self, embed_dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        widths = [embed_dim // 4, embed_dim // 2, embed_dim]
        self.conv1 = nn.Conv2d(1, widths[0], 3, bias=False, device=device)
        self.bn1 = BatchNorm(widths[0], device=device)
        cin = widths[0]
        for i, (w, stride) in enumerate(zip(widths, self.STAGE_STRIDES)):
            proj = stride != (1, 1) or cin != w
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, w, stride, proj, dtype, device=device),
                BasicBlock(w, w, (1, 1), False, dtype, device=device)))
            cin = w

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        x = _conv(self.conv1, x, (2, 1), 1, dt)
        if train:  # flax BN in f32, cast, then ReLU (stem.py:427-435)
            x = torch.relu(self.bn1.train_forward(x).to(dt))
        else:
            s1, t1 = self.bn1.scale_shift()
            x = torch.relu(x.float() * s1 + t1).to(dt)
        x = _max_pool_3x3(x, (2, 1))
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x, train=train)
        return _max_pool_3x3(x, (2, 1))
