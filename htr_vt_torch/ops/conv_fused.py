"""3x3 convolution with a BatchNorm-apply + ReLU prologue, and its two
gradients, through hand-written CUDA kernels (port of
``htr_vt_tpu/ops/conv_fused.py``), the folded dataflow's conv.

    y = conv3x3(pad0(T(max(x * scale + shift, 0))), k)      T = x.dtype

stride 1, the zero pad applied after the prologue. Without scale/shift
there is no prologue: ``y = conv3x3(pad0(x), k)``.

- ``conv3x3_bn_relu_fwd`` (K4f, ``csrc/conv_fused.cu``) reads raw x and
  applies the prologue once per pixel of each tile it loads (in bf16, a
  wgmma kernel fed by TMA; in float32, FFMA); the normalised tensor never
  exists in memory.
- ``conv3x3_bn_relu_dgrad`` (K4d) is the conv of g with the rotated kernel,
  float32 da, then the prologue's backward as ``_dgrad_kernel`` computes it
  (``conv_fused.py:230-283``): da' = da where ``x * scale + shift > 0``
  (strict, so 0 at a tie), ``dx = T(da' * scale)``, ``dscale = sum da' *
  x``, ``dshift = sum da'``; da is never rounded to T first (in bf16, K4f's
  wgmma kernel over g with the prologue's backward as its epilogue; in
  float32, FFMA).
- ``conv3x3_bn_relu_wgrad`` (K4w): ``dk = sum_p xn[p + tap] * g[p]`` in
  float32, the prologue applied to the raw x on load (in bf16, a wgmma
  kernel fed by TMA that normalises each halo pixel once for all nine
  taps; in float32, FFMA).

``conv3x3_bn_relu`` is the differentiable entry (``ConvBNReLU``): stride 1
takes the kernels, any other stride the stock ``F.conv2d`` route, as JAX
takes ``_xla_reference`` (``conv_fused.py:599-607``).

The ReLU's gradient at a tie differs between the two routes on purpose:
``conv_impl="pallas"`` (these kernels, and on the CPU their plain versions)
gives 0 where ``x * scale + shift == 0``, as the TPU kernel does, while
``conv_impl="auto"`` (autograd through ``conv3x3_bn_relu_reference``,
``torch.maximum``) gives one half, as ``jnp.maximum``.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; nothing else decides. Weights are in the
``nn.Conv2d`` layout [Cout, Cin, 3, 3] and in x's dtype; the wrappers lay
them out for the kernels, and the weight gradient comes back in the same
layout. x and g must be channels-last: the wrappers never copy them, and
the backward makes only the incoming gradient channels-last
(``ConvBNReLU.grad_copies`` counts the times that was a copy).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from htr_vt_torch.ops.bn_stats import (_DTYPE_CODES, check_channels_last,
                                       check_folded_terms, pad_channels, pad_terms,
                                       padded_channels, take_channels)


def _c(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _prologue(x: torch.Tensor, scale: torch.Tensor,
              shift: torch.Tensor) -> torch.Tensor:
    """``T(max(x * scale + shift, 0))``, the multiply and the add rounded
    apart in float32. The maximum's gradient at a tie is one half."""
    xn = x.float() * _c(scale) + _c(shift)
    return torch.maximum(xn, xn.new_zeros(())).to(x.dtype)


def conv3x3_bn_relu_reference(x: torch.Tensor, weight: torch.Tensor,
                              scale: Optional[torch.Tensor] = None,
                              shift: Optional[torch.Tensor] = None,
                              stride: Sequence[int] = (1, 1)) -> torch.Tensor:
    """Plain version of the forward kernel (``_xla_reference``,
    ``conv_fused.py:497-507``): x [B, Cin, H, W], weight [Cout, Cin, 3, 3]
    (cast to x.dtype), scale/shift float32 [Cin] or None (no prologue) ->
    [B, Cout, H / sh, W / sw], padding 1, ``F.conv2d`` in x.dtype."""
    if scale is not None:
        x = _prologue(x, scale, shift)
    return F.conv2d(x, weight.to(x.dtype), stride=tuple(stride), padding=1)


def conv3x3_dgrad_reference(g: torch.Tensor, weight: torch.Tensor,
                            x: torch.Tensor, scale: Optional[torch.Tensor],
                            shift: Optional[torch.Tensor], prologue: bool
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the dgrad kernel (``_dgrad_kernel``,
    ``conv_fused.py:230-283``): g [B, Cout, H, W], weight [Cout, Cin, 3, 3],
    the forward's raw x [B, Cin, H, W] -> (dx in x.dtype, dscale, dshift
    float32 [Cin]; zeros without the prologue). da is float32 from the
    float32 values of g and weight; the ReLU mask is the strict
    ``x * scale + shift > 0``."""
    da = torch.nn.grad.conv2d_input(tuple(x.shape), weight.float(), g.float(),
                                    padding=1)
    if not prologue:
        zeros = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        return da.to(x.dtype), zeros, zeros.clone()
    xf = x.float()
    da = torch.where(xf * _c(scale) + _c(shift) > 0, da, 0.0)
    return ((da * _c(scale)).to(x.dtype), (da * xf).sum((0, 2, 3)),
            da.sum((0, 2, 3)))


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor,
                            scale: Optional[torch.Tensor],
                            shift: Optional[torch.Tensor], prologue: bool
                            ) -> torch.Tensor:
    """Plain version of the wgrad kernel (``_wgrad_kernel``,
    ``conv_fused.py:286-322``): the forward's raw x [B, Cin, H, W] and g
    [B, Cout, H, W] -> dk float32 [Cout, Cin, 3, 3], the sum over pixels of
    ``xn[p + tap] * g[p]`` with xn the prologue's output in x.dtype."""
    xn = _prologue(x, scale, shift) if prologue else x
    return torch.nn.grad.conv2d_weight(xn.float(), (g.shape[1], x.shape[1], 3, 3),
                                       g.float(), padding=1)


def _check(fn: str, x: torch.Tensor, weight: torch.Tensor,
           scale: Optional[torch.Tensor], shift: Optional[torch.Tensor]) -> None:
    check_channels_last(fn, "x", x)
    cin = x.shape[1]
    if (weight.dim() != 4 or tuple(weight.shape[1:]) != (cin, 3, 3)
            or weight.dtype != x.dtype or weight.device != x.device):
        raise ValueError(f"{fn}: weight must be {x.dtype} [Cout, {cin}, 3, 3] on "
                         f"{x.device}, got {weight.dtype} {tuple(weight.shape)} on "
                         f"{weight.device}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{fn}: scale and shift go together")
    if scale is not None:
        check_folded_terms(fn, x, scale, shift)


def _check_grad(fn: str, g: torch.Tensor, x: torch.Tensor, cout: int) -> None:
    check_channels_last(fn, "g", g)
    b, _, h, w = x.shape
    if tuple(g.shape) != (b, cout, h, w) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{fn}: g must be {x.dtype} {(b, cout, h, w)} on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _pad_weight(weight: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """weight [Cout, Cin, 3, 3] with zero rows and columns up to [cout, cin]."""
    if tuple(weight.shape[:2]) == (cout, cin):
        return weight
    return F.pad(weight, (0, 0, 0, 0, 0, cin - weight.shape[1],
                          0, cout - weight.shape[0]))


def conv3x3_bn_relu_fwd(x: torch.Tensor, weight: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3(pad0(T(max(x * scale + shift, 0))), weight)``, stride 1: x
    [B, Cin, H, W] channels-last (bf16 or float32, any Cin), weight
    [Cout, Cin, 3, 3] in x.dtype (any Cout), scale/shift float32 [Cin]
    or both None -> [B, Cout, H, W] channels-last in x.dtype.

    CUDA tensors launch K4f (``csrc/conv_fused.cu``) on the current stream
    and add one to ``conv3x3_bn_relu_fwd.launches``; CPU tensors run
    ``conv3x3_bn_relu_reference``. Any other device raises."""
    if x.device.type == "cpu":
        return conv3x3_bn_relu_reference(x, weight, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu_fwd: no kernel for device {x.device}")
    _check("conv3x3_bn_relu_fwd", x, weight, scale, shift)
    b, cin_real, h, w = x.shape
    cout_real = weight.shape[0]
    cin, cout = padded_channels(cin_real), padded_channels(cout_real)
    aligned = (cin, cout) == (cin_real, cout_real)
    if not aligned:
        x, scale, shift = pad_channels(x, cin), pad_terms(scale, cin), pad_terms(shift, cin)
        weight = _pad_weight(weight, cout, cin)
    from htr_vt_torch._build import check_launch, library
    wb = weight.permute(2, 3, 0, 1).contiguous()  # [3, 3, Cout, Cin]
    y = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().htrvt_conv3x3_fwd(
            x.data_ptr(), wb.data_ptr(), _ptr(scale), _ptr(shift), y.data_ptr(),
            b, h, w, cin, cout, int(scale is not None), _DTYPE_CODES[x.dtype],
            stream)
    check_launch("conv3x3_bn_relu_fwd", err)
    conv3x3_bn_relu_fwd.launches += 1
    return y if aligned else take_channels(y, cout_real)


conv3x3_bn_relu_fwd.launches = 0  # kernel launches; the CPU path never counts


def conv3x3_bn_relu_dgrad(g: torch.Tensor, weight: torch.Tensor, x: torch.Tensor,
                          scale: Optional[torch.Tensor] = None,
                          shift: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """The input gradient of ``conv3x3_bn_relu_fwd``: g [B, Cout, H, W] and
    the forward's raw x, both channels-last and of one dtype (any Cin and
    Cout) -> (dx channels-last in x.dtype, dscale, dshift float32 [Cin];
    zeros without the prologue).

    CUDA tensors launch K4d on the current stream (with the prologue, and
    its fixed-order second pass over the pixel tiles' partial sums) and add one to
    ``conv3x3_bn_relu_dgrad.launches``; CPU tensors run
    ``conv3x3_dgrad_reference``. Any other device raises."""
    prologue = scale is not None
    if x.device.type == "cpu":
        return conv3x3_dgrad_reference(g, weight, x, scale, shift, prologue)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu_dgrad: no kernel for device {x.device}")
    _check("conv3x3_bn_relu_dgrad", x, weight, scale, shift)
    b, cin_real, h, w = x.shape
    cout_real = weight.shape[0]
    _check_grad("conv3x3_bn_relu_dgrad", g, x, cout_real)
    cin, cout = padded_channels(cin_real), padded_channels(cout_real)
    aligned = (cin, cout) == (cin_real, cout_real)
    if not aligned:
        g, x, weight = pad_channels(g, cout), pad_channels(x, cin), _pad_weight(weight, cout, cin)
        scale, shift = pad_terms(scale, cin), pad_terms(shift, cin)
    from htr_vt_torch._build import check_launch, library
    code = _DTYPE_CODES[x.dtype]
    # wb[dh, dw, ci, co] = k[co, ci, 2 - dh, 2 - dw], the rotated kernel
    wb = weight.flip(2, 3).permute(2, 3, 1, 0).contiguous()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    sums = torch.zeros((2, cin), dtype=torch.float32, device=x.device)
    partial = None
    if prologue:
        rows = library().htrvt_conv3x3_dgrad_rows(b, h, w, code)
        partial = torch.empty((rows, 2 * cin), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().htrvt_conv3x3_dgrad(
            g.data_ptr(), wb.data_ptr(), x.data_ptr(), _ptr(scale), _ptr(shift),
            dx.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), _ptr(partial),
            b, h, w, cin, cout, int(prologue), code, stream)
    check_launch("conv3x3_bn_relu_dgrad", err)
    conv3x3_bn_relu_dgrad.launches += 1
    if aligned:
        return dx, sums[0], sums[1]
    return take_channels(dx, cin_real), sums[0, :cin_real], sums[1, :cin_real]


conv3x3_bn_relu_dgrad.launches = 0  # kernel launches; the CPU path never counts


def conv3x3_bn_relu_wgrad(x: torch.Tensor, g: torch.Tensor,
                          scale: Optional[torch.Tensor] = None,
                          shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weight gradient of ``conv3x3_bn_relu_fwd``: the forward's raw x
    and g [B, Cout, H, W], both channels-last and of one dtype (any Cin and
    Cout) -> float32 [Cout, Cin, 3, 3] (a permuted view of the kernel's
    [3, 3, Cin, Cout]).

    CUDA tensors launch K4w on the current stream (split over pixels, the
    splits added in a fixed order) and add one to
    ``conv3x3_bn_relu_wgrad.launches``; CPU tensors run
    ``conv3x3_wgrad_reference``. Any other device raises."""
    prologue = scale is not None
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g, scale, shift, prologue)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_bn_relu_wgrad: no kernel for device {x.device}")
    check_channels_last("conv3x3_bn_relu_wgrad", "x", x)
    b, cin_real, h, w = x.shape
    cout_real = g.shape[1] if g.dim() == 4 else -1
    _check_grad("conv3x3_bn_relu_wgrad", g, x, cout_real)
    if (scale is None) != (shift is None):
        raise ValueError("conv3x3_bn_relu_wgrad: scale and shift go together")
    if prologue:
        check_folded_terms("conv3x3_bn_relu_wgrad", x, scale, shift)
    cin, cout = padded_channels(cin_real), padded_channels(cout_real)
    aligned = (cin, cout) == (cin_real, cout_real)
    if not aligned:
        x, g = pad_channels(x, cin), pad_channels(g, cout)
        scale, shift = pad_terms(scale, cin), pad_terms(shift, cin)
    from htr_vt_torch._build import check_launch, library
    code = _DTYPE_CODES[x.dtype]
    splits = library().htrvt_conv3x3_wgrad_splits(b, h, w, cin, cout, code)
    dk = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, 9 * cin * cout), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().htrvt_conv3x3_wgrad(
            x.data_ptr(), g.data_ptr(), _ptr(scale), _ptr(shift), dk.data_ptr(),
            _ptr(partial), b, h, w, cin, cout, splits, int(prologue), code, stream)
    check_launch("conv3x3_bn_relu_wgrad", err)
    conv3x3_bn_relu_wgrad.launches += 1
    if not aligned:
        dk = dk[:, :, :cin_real, :cout_real]
    return dk.permute(3, 2, 0, 1)


conv3x3_bn_relu_wgrad.launches = 0  # kernel launches; the CPU path never counts


class ConvBNReLU(torch.autograd.Function):
    """``conv3x3_bn_relu`` at stride 1 with K4f forward and K4d/K4w
    backward, differentiable in x, weight and (with the prologue) scale
    and shift (``_fused_conv``, ``conv_fused.py:510-539``)."""

    grad_copies = 0  # backward calls whose g had to be copied to channels-last

    @staticmethod
    def forward(ctx, x, weight, scale, shift):
        ctx.save_for_backward(x, weight, scale, shift)
        return conv3x3_bn_relu_fwd(x, weight, scale, shift)

    @staticmethod
    def backward(ctx, g):
        x, weight, scale, shift = ctx.saved_tensors
        if not g.is_contiguous(memory_format=torch.channels_last):
            ConvBNReLU.grad_copies += 1
            g = g.contiguous(memory_format=torch.channels_last)
        dx = dk = dscale = dshift = None
        need_x, need_w, need_s, need_t = ctx.needs_input_grad
        if need_x or need_s or need_t:
            dx, dscale, dshift = conv3x3_bn_relu_dgrad(g, weight, x, scale, shift)
            if scale is None:
                dscale = dshift = None
        if need_w:
            dk = conv3x3_bn_relu_wgrad(x, g, scale, shift).to(
                weight.dtype, memory_format=torch.contiguous_format)
        return dx, dk, dscale, dshift


def conv3x3_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                    scale: Optional[torch.Tensor] = None,
                    shift: Optional[torch.Tensor] = None,
                    stride: Sequence[int] = (1, 1)) -> torch.Tensor:
    """``conv3x3(pad0(T(max(x * scale + shift, 0))), weight)``, padding 1
    (``conv3x3_bn_relu``, ``conv_fused.py:582-610``): x [B, Cin, H, W]
    channels-last, weight [Cout, Cin, 3, 3] (cast to x.dtype), scale/shift
    [Cin] (the folded BN terms) or None for no prologue, in which case they
    get no gradient. Stride (1, 1) goes through the kernels
    (``ConvBNReLU``); any other stride through ``F.conv2d``."""
    if tuple(stride) != (1, 1):
        return conv3x3_bn_relu_reference(x, weight, scale, shift, stride=stride)
    weight = weight.to(x.dtype)
    if scale is None:
        return ConvBNReLU.apply(x, weight, None, None)
    return ConvBNReLU.apply(x, weight, scale.float().contiguous(),
                            shift.float().contiguous())
