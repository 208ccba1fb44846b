"""BatchNorm-apply + ReLU + 3x3/(2,1) max-pool through hand-written CUDA
kernels, forward and backward (port of ``htr_vt_tpu/ops/pool_fused.py``).

    y = maxpool3x3_{(2,1), pad 1}(relu(T(x * scale + shift)))   T = x.dtype

``pool_bn_relu_fwd`` (``csrc/pool_fused.cu``, K3f) reads x once and writes
the half-height y; the normalised tensor never exists in memory.
``pool_bn_relu_bwd`` (K3b) recomputes it, routes each window's gradient to
its first maximal tap in scan order (XLA's select-and-scatter rule, -inf
padding), adds the routed gradients in the element dtype tap by tap, then
gives the ReLU's half gradient at an exact 0 (``jnp.maximum``'s rule) and
emits dx with the dscale/dshift reductions. ``max_pool_bn_relu`` is the
differentiable composition (``PoolBNReLU``).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; nothing else decides. The forward goes through the
custom op ``htrvt::pool_bn_relu_fwd`` (``ops/library.py``) on both devices,
so an exported program holds it; the backward is a direct launch. x must be channels-last.
K3b reads g channels-last or as contiguous NCHW, the layout the stem's
backward hands it (the strided projection's backward writes NCHW), so
neither wrapper copies at C % 8 == 0; ``PoolBNReLU`` copies g only when it
has another layout (``PoolBNReLU.grad_copies`` counts those copies). At any
other C the kernels' TMA rows do not fit, and each wrapper hands its kernel
channels-last copies of x (and g) zero-padded to the next multiple of 8,
with scale and shift padded by 0: a padded channel is relu(0 * 0 + 0) = 0
and gets no gradient, and the real channels' elements are read and
computed as in an aligned call. The real channels are sliced back out.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from htr_vt_torch.ops import library as htrvt_ops
from htr_vt_torch.ops.bn_stats import (_DTYPE_CODES, check_aligned,
                                       check_channels_last, check_channels_last_now,
                                       check_folded_terms, pad_channels, pad_terms,
                                       padded_channels, take_channels)

# Column-sum partials K3b's first pass may write: one [2C] row per block,
# added by csrc/stem_common.cuh:sum_partials.
MAX_BLOCKS = 1024


def _bn_relu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_pre, a): a_pre = x * scale + shift in float32 (two roundings),
    a = relu(x.dtype(a_pre))."""
    a_pre = x.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    return a_pre, torch.relu(a_pre.to(x.dtype))


def max_pool_bn_relu_reference(x: torch.Tensor, scale: torch.Tensor,
                               shift: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel (``max_pool_bn_relu_reference``,
    ``pool_fused.py:294-301``): x [B, C, H, W], scale/shift float32 [C] ->
    [B, C, H/2, W] in x.dtype. ``max_pool2d`` pads with -inf."""
    _, a = _bn_relu(x, scale, shift)
    return F.max_pool2d(a, kernel_size=3, stride=(2, 1), padding=1)


def routed_grad_reference(g: torch.Tensor, x: torch.Tensor,
                          scale: torch.Tensor, shift: torch.Tensor
                          ) -> torch.Tensor:
    """The gradient at a_pre = x * scale + shift, float32 [B, C, H, W], in
    the order of ``_pool_bwd_kernel`` (``pool_fused.py:72-149``): each
    window's first maximal tap in scan order claims its gradient, the taps
    add into the padded gradient in x.dtype one after another, and the
    float32 ReLU backward gives half the gradient where a_pre == 0."""
    b, c, h, w = x.shape
    ho = h // 2
    a_pre, a = _bn_relu(x, scale, shift)
    ap = F.pad(a, (1, 1, 1, 1), value=float("-inf"))

    def tap(kh, kw):
        return ap[:, :, kh:kh + 2 * ho:2, kw:kw + w]

    m = F.max_pool2d(a, kernel_size=3, stride=(2, 1), padding=1)
    claimed = torch.zeros_like(m, dtype=torch.bool)
    da = torch.zeros_like(ap)
    for kh in range(3):
        for kw in range(3):
            eq = (tap(kh, kw) == m) & ~claimed
            claimed |= eq
            da[:, :, kh:kh + 2 * ho:2, kw:kw + w] += torch.where(eq, g, 0.0).to(g.dtype)
    daf = da[:, :, 1:h + 1, 1:w + 1].float()
    return torch.where(a_pre > 0, daf, torch.where(a_pre < 0, 0.0, 0.5 * daf))


def pool_bn_relu_bwd_reference(g: torch.Tensor, x: torch.Tensor,
                               scale: torch.Tensor, shift: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: the gradient g [B, C, H/2, W]
    of y -> (dx [B, C, H, W] in x.dtype, dscale, dshift float32 [C]), from
    ``routed_grad_reference``."""
    daf = routed_grad_reference(g, x, scale, shift)
    dx = (daf * scale.view(1, -1, 1, 1)).to(x.dtype)
    return dx, (daf * x.float()).sum((0, 2, 3)), daf.sum((0, 2, 3))


def _check(fn: str, x: torch.Tensor, scale: torch.Tensor,
           shift: torch.Tensor) -> None:
    check_channels_last(fn, "x", x)
    if x.shape[2] % 2:
        raise ValueError(f"{fn}: H must be even, got {x.shape[2]}")
    check_folded_terms(fn, x, scale, shift)


def pool_bn_relu_fwd(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """``maxpool3x3_{(2,1)}(relu(T(x * scale + shift)))``: x [B, C, H, W]
    channels-last (H even, any C), scale/shift float32 [C] ->
    [B, C, H/2, W] channels-last in x.dtype.

    Calls the op ``htrvt::pool_bn_relu_fwd`` (``ops/library.py``): CUDA
    tensors launch K3f (``csrc/pool_fused.cu``) on the current stream and
    add one to ``pool_bn_relu_fwd.launches``; CPU tensors run
    ``max_pool_bn_relu_reference``. Any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pool_bn_relu_fwd: no kernel for device {x.device}")
    if x.device.type == "cuda":
        _check("pool_bn_relu_fwd", x, scale, shift)
    return htrvt_ops.pool_bn_relu_fwd(x, scale, shift)


def launch_pool_bn_relu_fwd(x: torch.Tensor, scale: torch.Tensor,
                            shift: torch.Tensor) -> torch.Tensor:
    """K3f on the current stream (the CUDA implementation of
    ``htrvt::pool_bn_relu_fwd``); at C % 8 != 0 on zero-padded copies. An
    exported program calls it without the wrapper, so the real tensor's
    layout and addresses are checked here."""
    check_channels_last_now("pool_bn_relu_fwd", "x", x)
    check_aligned("pool_bn_relu_fwd", x=x, scale=scale, shift=shift)
    b, c_real, h, w = x.shape
    c = padded_channels(c_real)
    if c != c_real:
        x, scale, shift = pad_channels(x, c), pad_terms(scale, c), pad_terms(shift, c)
    from htr_vt_torch._build import check_launch, library
    y = torch.empty((b, c, h // 2, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().htrvt_pool_bn_relu_fwd(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(), b, h,
            w, c, _DTYPE_CODES[x.dtype], stream)
    check_launch("pool_bn_relu_fwd", err)
    pool_bn_relu_fwd.launches += 1
    return y if c == c_real else take_channels(y, c_real)


pool_bn_relu_fwd.launches = 0  # kernel launches; the CPU path never counts


def nchw_grad_ok(g: torch.Tensor) -> bool:
    """Whether K3b reads ``g`` [B, C, H/2, W] as contiguous NCHW: its
    tensor map needs rows of a multiple of 16 bytes and a 16-byte-aligned
    base."""
    return (g.dim() == 4 and g.is_contiguous()
            and g.shape[3] * g.element_size() % 16 == 0 and g.data_ptr() % 16 == 0)


def pool_bn_relu_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Backward of ``pool_bn_relu_fwd``: g [B, C, H/2, W] channels-last or
    contiguous NCHW (``nchw_grad_ok``; at C % 8 != 0 any layout, as the
    padded copy is made from it) and x as the forward's, of one dtype ->
    (dx channels-last in x.dtype, dscale, dshift float32 [C]).

    CUDA tensors launch K3b (``csrc/pool_fused.cu``) on the current stream
    and add one to ``pool_bn_relu_bwd.launches``; CPU tensors run
    ``pool_bn_relu_bwd_reference``. Any other device raises."""
    if x.device.type == "cpu":
        return pool_bn_relu_bwd_reference(g, x, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"pool_bn_relu_bwd: no kernel for device {x.device}")
    _check("pool_bn_relu_bwd", x, scale, shift)
    check_aligned("pool_bn_relu_bwd", x=x, scale=scale, shift=shift)
    b, c, h, w = x.shape
    if tuple(g.shape) != (b, c, h // 2, w) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"pool_bn_relu_bwd: g must be {x.dtype} {(b, c, h // 2, w)} "
                         f"on {x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    c_real, c = c, padded_channels(c)
    if c != c_real:  # the padded copy of g is channels-last
        g, x = pad_channels(g, c), pad_channels(x, c)
        scale, shift = pad_terms(scale, c), pad_terms(shift, c)
    # A tensor that is both is laid out alike either way.
    g_nchw = not g.is_contiguous(memory_format=torch.channels_last)
    if g_nchw and not nchw_grad_ok(g):
        raise ValueError("pool_bn_relu_bwd: g must be channels-last, or contiguous NCHW "
                         "with W * itemsize % 16 == 0 and a 16-byte-aligned base "
                         f"(strides {g.stride()}, W {w}); no copy is made")
    if g.data_ptr() % 16:
        raise ValueError("pool_bn_relu_bwd: g must be 16-byte aligned")
    from htr_vt_torch._build import check_launch, library
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((MAX_BLOCKS, 2 * c), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().htrvt_pool_bn_relu_bwd(
            g.data_ptr(), x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            dx.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            partial.data_ptr(), b, h, w, c, MAX_BLOCKS, int(g_nchw),
            _DTYPE_CODES[x.dtype], stream)
    check_launch("pool_bn_relu_bwd", err)
    pool_bn_relu_bwd.launches += 1
    if c == c_real:
        return dx, out[0], out[1]
    return take_channels(dx, c_real), out[0, :c_real], out[1, :c_real]


pool_bn_relu_bwd.launches = 0  # kernel launches; the CPU path never counts


class PoolBNReLU(torch.autograd.Function):
    """``max_pool_bn_relu`` with K3f forward and K3b backward, differentiable
    in x, scale and shift (``_pool_op``, ``pool_fused.py:266-280``)."""

    grad_copies = 0  # backward calls whose g K3b could not read as it came

    @staticmethod
    def forward(ctx, x, scale, shift):
        ctx.save_for_backward(x, scale, shift)
        return pool_bn_relu_fwd(x, scale, shift)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift = ctx.saved_tensors
        if (g.is_cuda and not g.is_contiguous(memory_format=torch.channels_last)
                and not nchw_grad_ok(g)):
            PoolBNReLU.grad_copies += 1
            g = g.contiguous(memory_format=torch.channels_last)
        return pool_bn_relu_bwd(g, x, scale, shift)


def max_pool_bn_relu(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """``maxpool3x3_{(2,1), pad 1}(relu(T(x * scale + shift)))``, fused:
    x [B, C, H, W] channels-last (H even), scale/shift float32 [C] (the
    folded BN terms) -> [B, C, H/2, W] in x.dtype."""
    return PoolBNReLU.apply(x, scale.float().contiguous(), shift.float().contiguous())
