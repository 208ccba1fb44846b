"""Per-channel BatchNorm statistics through the hand-written CUDA kernel
(port of ``htr_vt_tpu/ops/bn_stats.py``).

    sum, sumsq = bn_stats(x)              (csrc/bn_stats.cu on the card)
  backward, in ``BNStats``:
    dx = x.dtype(g_sum + 2 * x * g_sumsq)   (plain torch, float32 inside)

x is an NCHW activation stored channels-last (physically [B, H, W, C]),
any C; the sums run over B, H and W in float32. ``bn_stats`` launches its
kernel for a CUDA tensor and runs ``bn_stats_reference`` for a CPU tensor;
nothing else decides, and a failed build or launch raises. The wrapper never
copies x into channels-last: a tensor in another layout raises. The kernel
is one launch whose grid ``stats_geometry`` sizes to the card; its partial
rows and the slices' tickets live in a scratch cached per device and stream
(the last SCRATCH_STREAMS streams).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Tuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's blocks (``csrc/bn_stats.cu``): 1024 threads, slices of at most
# 32 groups of 8 channels, about one block a SM over all slices.
THREADS = 1024
MAX_SLICE_GROUPS = 32
BLOCKS_PER_SM = 1
# (device index, stream) -> (partial rows, tickets), the most recently used
# last; the tickets are 0 between calls: the last block of each slice puts
# its own back. At most SCRATCH_STREAMS entries are kept (on a 132-SM card an
# entry holds 0.2 MB at the flagship's entry site).
SCRATCH_STREAMS = 8
_SCRATCH: OrderedDict = OrderedDict()


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: float32 [C] sum and sum of squares of
    an NCHW tensor over N, H and W (``bn_stats_reference``,
    ``bn_stats.py:142-146``)."""
    xf = x.float()
    return xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))


def check_layout(fn: str, name: str, x: torch.Tensor) -> None:
    """A 4-d tensor, bf16 or float32, channels-last and contiguous."""
    if x.dim() != 4:
        raise ValueError(f"{fn}: {name} must be 4-d NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: {name} must be bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{fn}: {name} must be channels-last contiguous "
                         "(the kernel reads [B, H, W, C]; no copy is made)")


def check_channels_last(fn: str, name: str, x: torch.Tensor) -> None:
    """The layout rule of the stem kernels that read rows through TMA or
    16-byte vectors (K3f/K3b, K4f/K4d/K4w): ``check_layout``, at most
    MAX_CHANNELS channels, 16-byte aligned. Any C: a wrapper hands its
    kernel a copy padded to ``padded_channels(C)`` when C % 8 != 0."""
    check_layout(fn, name, x)
    c = x.shape[1]
    if padded_channels(c) > MAX_CHANNELS:
        raise ValueError(f"{fn}: {name} needs C <= {MAX_CHANNELS}, got C={c}")
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned")


# K3/K4 read channels-last rows through TMA, whose global strides are
# multiples of 16 bytes: C a multiple of 8 (bf16). Their wrappers zero-pad
# any other C up to the next multiple and slice the real channels back out.
CHANNEL_MULTIPLE = 8
MAX_CHANNELS = 8192


def padded_channels(c: int) -> int:
    """C rounded up to a multiple of CHANNEL_MULTIPLE."""
    return -(-c // CHANNEL_MULTIPLE) * CHANNEL_MULTIPLE


def pad_channels(x: torch.Tensor, c_to: int) -> torch.Tensor:
    """x [B, C, H, W] (any layout) as a channels-last copy of ``c_to``
    channels whose last ``c_to - C`` are zero; x itself when c_to == C."""
    b, c, h, w = x.shape
    if c == c_to:
        return x
    out = torch.empty((b, c_to, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    out[:, c:].zero_()
    out[:, :c].copy_(x)
    return out


def pad_terms(v: Optional[torch.Tensor], c_to: int) -> Optional[torch.Tensor]:
    """A folded BN term [C] padded with zeros to [c_to] (None stays None):
    a padded channel's prologue is relu(0 * 0 + 0) = 0."""
    if v is None or v.numel() == c_to:
        return v
    return torch.cat([v, v.new_zeros(c_to - v.numel())])


def take_channels(y: torch.Tensor, c: int) -> torch.Tensor:
    """The first ``c`` channels of a channels-last y [B, C', H, W], as a
    channels-last contiguous tensor (y itself when C' == c)."""
    if y.shape[1] == c:
        return y
    return y[:, :c].contiguous(memory_format=torch.channels_last)


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


def stats_geometry(c: int, n: int, sms: int) -> Tuple[int, int, int]:
    """(slices, channel groups of 8 a slice, blocks a slice) of the kernel
    for C = c over n rows on a card of ``sms`` SMs: the fewest slices of at
    most MAX_SLICE_GROUPS groups, cut evenly, and BLOCKS_PER_SM blocks a SM
    shared out over the slices (at least one a slice, and no more than the
    rows fill)."""
    groups = -(-c // 8)
    slices = -(-groups // MAX_SLICE_GROUPS)
    slice_groups = -(-groups // slices)
    rows = THREADS // slice_groups
    blocks = max(1, min(BLOCKS_PER_SM * sms // slices, -(-n // rows)))
    return slices, slice_groups, blocks


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scratch(device: torch.device, stream: int, floats: int, slices: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cached partial rows (at least ``floats``) and zeroed tickets (at
    least ``slices``) of ``device`` and ``stream`` (the current stream),
    grown when too small. Past SCRATCH_STREAMS streams the least recently
    used entry is dropped: its tensors were allocated on their own stream,
    so the caching allocator hands their memory out again only behind that
    stream's queued kernels."""
    key = (device.index, stream)
    partial, tickets = _SCRATCH.pop(key, (None, None))
    if partial is None or partial.numel() < floats:
        partial = torch.empty(floats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < slices:
        tickets = torch.zeros(slices, dtype=torch.int32, device=device)
    _SCRATCH[key] = (partial, tickets)
    while len(_SCRATCH) > SCRATCH_STREAMS:
        _SCRATCH.popitem(last=False)
    return partial, tickets


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sumsq) float32 [C] of x [B, C, H, W] over B, H and W.

    CUDA tensors launch ``csrc/bn_stats.cu`` on the current stream (bf16 or
    float32, channels-last, any C; one kernel) and add one to
    ``bn_stats.launches``; CPU tensors run ``bn_stats_reference``. Any other
    device raises."""
    if x.device.type == "cpu":
        return bn_stats_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats: no kernel for device {x.device}")
    check_layout("bn_stats", "x", x)
    b, c, h, w = x.shape
    from htr_vt_torch._build import check_launch, library
    with torch.cuda.device(x.device):
        slices, slice_groups, blocks = stats_geometry(
            c, b * h * w, _sm_count(x.device.index))
        stream = torch.cuda.current_stream().cuda_stream
        partial, tickets = _scratch(x.device, stream,
                                    slices * blocks * 2 * 8 * slice_groups, slices)
        out = torch.empty((2, c), dtype=torch.float32, device=x.device)
        err = library().htrvt_bn_stats(x.data_ptr(), out[0].data_ptr(),
                                       out[1].data_ptr(), partial.data_ptr(),
                                       tickets.data_ptr(), b * h * w, c,
                                       slice_groups, blocks,
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
