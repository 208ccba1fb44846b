"""Per-channel BatchNorm statistics through the hand-written CUDA kernel
(port of ``htr_vt_tpu/ops/bn_stats.py``).

    sum, sumsq = bn_stats(x)              (csrc/bn_stats.cu on the card)
  backward, in ``BNStats``:
    dx = x.dtype(g_sum + 2 * x * g_sumsq)   (plain torch, float32 inside)

x is an NCHW activation stored channels-last (physically [B, H, W, C]);
the sums run over B, H and W in float32. ``bn_stats`` launches its kernel
for a CUDA tensor and runs ``bn_stats_reference`` for a CPU tensor; nothing
else decides, and a failed build or launch raises. The wrapper never copies
x into channels-last: a tensor in another layout raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Column-sum partials the first pass may write: one [2C] row per block.
MAX_BLOCKS = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: float32 [C] sum and sum of squares of
    an NCHW tensor over N, H and W (``bn_stats_reference``,
    ``bn_stats.py:142-146``)."""
    xf = x.float()
    return xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))


def check_channels_last(fn: str, name: str, x: torch.Tensor) -> None:
    """The stem kernels' layout rule: a 4-d tensor, bf16 or float32,
    channels-last and contiguous, C a multiple of 8, 16-byte aligned."""
    if x.dim() != 4:
        raise ValueError(f"{fn}: {name} must be 4-d NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: {name} must be bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{fn}: {name} must be channels-last contiguous "
                         "(the kernel reads [B, H, W, C]; no copy is made)")
    c = x.shape[1]
    if c % 8 or c // 8 > 1024:
        raise ValueError(f"{fn}: {name} needs C % 8 == 0 and C <= 8192, got C={c}")
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def check_folded_terms(fn: str, x: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> None:
    """The folded BN terms a stem kernel applies to x [B, C, H, W]:
    contiguous float32 [C] on x's device, 16-byte aligned."""
    c = x.shape[1]
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) or not v.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous float32 ({c},)")
        if v.device != x.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
        if v.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sumsq) float32 [C] of x [B, C, H, W] over B, H and W.

    CUDA tensors launch ``csrc/bn_stats.cu`` on the current stream (bf16 or
    float32, channels-last, C % 8 == 0) and add one to
    ``bn_stats.launches``; CPU tensors run ``bn_stats_reference``. Any other
    device raises."""
    if x.device.type == "cpu":
        return bn_stats_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats: no kernel for device {x.device}")
    check_channels_last("bn_stats", "x", x)
    b, c, h, w = x.shape
    from htr_vt_torch._build import check_launch, library
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((MAX_BLOCKS, 2 * c), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().htrvt_bn_stats(x.data_ptr(), out[0].data_ptr(),
                                       out[1].data_ptr(), partial.data_ptr(),
                                       b * h * w, c, MAX_BLOCKS,
                                       _DTYPE_CODES[x.dtype], stream)
    check_launch("bn_stats", err)
    bn_stats.launches += 1
    return out[0], out[1]


bn_stats.launches = 0  # kernel launches; the CPU path never counts


class BNStats(torch.autograd.Function):
    """Differentiable ``bn_stats``: the kernel forward, and the exact
    backward ``g_sum + 2 * x * g_sumsq`` in float32, cast back to x's dtype
    as JAX's VJP does (``bn_stats.py:122-127``): in bf16 the statistics
    path's gradient is rounded."""

    @staticmethod
    def forward(ctx, x):
        s, q = bn_stats(x)
        ctx.save_for_backward(x)
        return s, q

    @staticmethod
    def backward(ctx, g_sum, g_sumsq):
        (x,) = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        gx = g_sum.float().view(shape) + 2.0 * x.float() * g_sumsq.float().view(shape)
        return gx.to(x.dtype)
