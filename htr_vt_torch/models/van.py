"""The VAN height-reducing stems, van and van2 (port of
``htr_vt_tpu/models/van.py``).

A truncated ResNet18 stem leaves a [B, C', 4, W'] map; a 1x1 projection
lifts it to the model width where C' differs; VAN blocks (1x1 -> GELU ->
large-kernel attention gate -> 1x1 -> BN, residual) mix it; the mean over
the height collapses it to one row; a depthwise 1 x k mixer smooths along
the width. The result is [B, D, 1, W'], as the flagship stem's, and
``HTRVT`` gives its tokens a (1, N) sin-cos position table.

van:  stages [D/4 at (2, 2), D/2 at (2, 2)], no final pool: [B, D/2, 4, W/4].
van2: stages [D/4 at (2, 1), D/2 at (2, 2), D at (1, 2)]: [B, D, 4, W/4].

The truncated stem is built without the stem switches, as in JAX
(``van.py:111-113``): its convolutions, BatchNorms and pools are the stock
ops whatever ``conv_impl`` / ``pool_impl`` / ``bn_stats_impl`` say. The
depthwise and dilated convolutions are ``F.conv2d`` with groups (cuDNN on
the card); no Pallas kernel computes them in JAX. Runs NCHW; the
BatchNorms are flax's (biased batch variance, momentum 0.9).

Width-sharded (``parallel/mesh.py:shard_width``): the truncated stem runs
on the strip as ``models/stem.py`` describes; each depthwise window along
the width (the 5x5, the 7x7 dilated by 3, the 1 x k mixer) runs on the
strip extended by as many neighbour columns as it pads (2, 9, k // 2) and
its outputs there are cropped (``stem.py:_windowed``); the 1x1 convs, the
gate and the mean over the height read no neighbour; every BatchNorm sums
over the mesh. ``VanStem.width_halo`` is the widest of those halos, which
a strip of the quarter-width map must hold.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.models.layers import DropPath, conv2d, lecun_normal_
from htr_vt_torch.models.stem import BatchNorm, ResNet18Stem, _windowed

VAN_PLANS = {
    "van": (lambda d: [d // 4, d // 2], ((2, 2), (2, 2))),
    "van2": (lambda d: [d // 4, d // 2, d], ((2, 1), (2, 2), (1, 2))),
}


def _depthwise(d: int, k, padding, dilation=1, device=None) -> nn.Conv2d:
    return nn.Conv2d(d, d, k, padding=padding, dilation=dilation, groups=d,
                     bias=False, device=device)


def _width_window(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
                  sharded: bool) -> torch.Tensor:
    """``conv2d(conv, x)``; on a width strip, on the strip extended by the
    conv's W padding (the columns its window reaches past a neighbour's
    edge), those outputs cropped, NCHW."""
    return _windowed(lambda t: conv2d(conv, t, dtype), x, sharded, conv.padding[1],
                     torch.contiguous_format)


class LargeKernelAttention(nn.Module):
    """Depthwise 5x5 -> depthwise 7x7 dilated by 3 (padding 9) -> 1x1 ->
    BN, multiplied onto the input as a gate in its dtype, after the BN's
    float32 output is cast back (``van.py:30-49``). ``width_sharded``: x
    is a strip of columns (``_width_window``)."""

    width_sharded = False

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.dw = _depthwise(d, 5, 2, device=device)
        self.dwd = _depthwise(d, 7, 9, dilation=3, device=device)
        self.pw = nn.Conv2d(d, d, 1, bias=False, device=device)
        self.bn = BatchNorm(d, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        a = _width_window(self.dw, x, self.dtype, self.width_sharded)
        a = _width_window(self.dwd, a, self.dtype, self.width_sharded)
        a = conv2d(self.pw, a, self.dtype)
        return x * self.bn(a, train=train).to(x.dtype)


class VANBlock(nn.Module):
    """proj1 (1x1) -> exact GELU -> LKA -> proj2 (1x1) -> BN -> drop-path,
    residual (``van.py:52-69``). proj1 and proj2 carry biases and flax's
    default lecun-normal init."""

    def __init__(self, d: int, dtype: torch.dtype, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.proj1 = nn.Conv2d(d, d, 1, device=device)
        self.lka = LargeKernelAttention(d, dtype, device=device)
        self.proj2 = nn.Conv2d(d, d, 1, device=device)
        self.norm = BatchNorm(d, device=device)
        self.dp = DropPath(drop_path)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        for conv in (self.proj1, self.proj2):
            lecun_normal_(conv.weight, conv.in_channels, generator)
            conv.bias.zero_()

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = F.gelu(conv2d(self.proj1, x, self.dtype), approximate="none")
        y = self.lka(y, train=train)
        y = conv2d(self.proj2, y, self.dtype)
        y = self.norm(y, train=train).to(x.dtype)
        return x + self.dp(y, train=train, generator=generator)


class HorizontalMixer(nn.Module):
    """Depthwise 1 x k along the width -> 1x1 -> BN, residual, then exact
    GELU (``van.py:72-91``). ``width_sharded``: x is a strip of columns
    (``_width_window``)."""

    width_sharded = False

    def __init__(self, d: int, dtype: torch.dtype, kernel: int = 9, device=None):
        super().__init__()
        self.dtype = dtype
        self.dw = _depthwise(d, (1, kernel), (0, kernel // 2), device=device)
        self.pw = nn.Conv2d(d, d, 1, bias=False, device=device)
        self.bn = BatchNorm(d, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        y = _width_window(self.dw, x, self.dtype, self.width_sharded)
        y = conv2d(self.pw, y, self.dtype)
        y = self.bn(y, train=train).to(x.dtype)
        return F.gelu(x + y, approximate="none")


class VanStem(nn.Module):
    """Truncated ResNet -> 1x1 ``proj_in`` (where the last stage is not D
    wide) -> ``van_depth`` VAN blocks -> mean over the height ->
    ``hmix``: [B, 1, H, W] -> [B, D, 1, W'] (``van.py:94-122``)."""

    def __init__(self, embed_dim: int, dtype: torch.dtype, variant: str = "van",
                 van_depth: int = 2, hmix_kernel: int = 9, device=None):
        super().__init__()
        if variant not in VAN_PLANS:
            raise ValueError(f"unknown VAN variant {variant!r}")
        d = embed_dim
        widths, strides = VAN_PLANS[variant]
        widths = widths(d)
        self.resnet = ResNet18Stem(d, dtype, device=device, widths=widths,
                                   stage_strides=strides, final_maxpool=False)
        self.proj_in = (nn.Conv2d(widths[-1], d, 1, bias=False, device=device)
                        if widths[-1] != d else None)
        self.van_depth = van_depth
        for i in range(van_depth):
            setattr(self, f"van{i}", VANBlock(d, dtype, device=device))
        self.hmix = HorizontalMixer(d, dtype, hmix_kernel, device=device)
        self.dtype = dtype

    @property
    def width_halo(self) -> int:
        """The most neighbour columns a window of the quarter-width map reads
        (the dilated 7x7's 9 at the defaults)."""
        convs = [self.hmix.dw] + [getattr(self, f"van{i}").lka.dwd
                                  for i in range(self.van_depth)]
        return max(c.padding[1] for c in convs)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.resnet(x, train=train)
        if self.proj_in is not None:
            x = conv2d(self.proj_in, x, self.dtype)
        for i in range(self.van_depth):
            x = getattr(self, f"van{i}")(x, train=train, generator=generator)
        x = x.mean(dim=2, keepdim=True)  # adaptive average pool H -> 1
        return self.hmix(x, train=train)
