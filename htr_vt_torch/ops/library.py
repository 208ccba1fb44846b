"""The serving path's forward kernels as ``torch.library`` custom ops, so
that a program exported with ``torch.export`` holds them and, when it runs
on the card, launches them (``htr_vt_torch/deploy.py``):

    htrvt::pool_bn_relu_fwd     K3f  csrc/pool_fused.cu   ops/pool_fused.py
    htrvt::conv3x3_bn_relu_fwd  K4f  csrc/conv_fused.cu   ops/conv_fused.py
    htrvt::flash_attention_fwd  K5f  csrc/flash_attn.cu   ops/flash_attn.py
    htrvt::conv_int8            Q1   csrc/conv_int8.cu    ops/quant.py

Each op has three implementations:

- CUDA: the kernel's launch on the current stream (its module's
  ``launch_*``), which checks the real tensors' layout and addresses and
  adds one to the wrapper's ``.launches``;
- CPU: the kernel's plain twin;
- fake: the output's shape, dtype and strides, computed without data. On
  a CUDA tensor it is the kernel's layout: channels-last for K3f, K4f and
  Q1; K5f's o is a [B, N, H, D] tensor seen as [B, H, N, D], its l and m
  contiguous float32 [B, H, N]. On a CPU tensor the plain twin itself runs
  on the fake tensors, so its layout is the CPU implementation's.

The wrappers in ``ops/*.py`` check shapes and dtypes (and strides, outside
an export trace, where a fake tensor's strides need not be the card's) and
call the op on either device; nothing on the way to it reads a data
pointer, so a trace on fake tensors reaches the op and records it. The backward kernels
(K3b, K4d, K4w, K5dkv, K5dq) and K1/K2 stay direct launches: no serving
program reaches them, and they are not exportable.

Importing this module registers the ops; ``torch.export.load`` of an
artifact that holds them needs it imported first. It imports the kernel
modules only inside the implementations, which those modules' wrappers
call.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Tuple

import torch
from torch import Tensor

NAMESPACE = "htrvt"


def _ops(name: str):
    return importlib.import_module(f"htr_vt_torch.ops.{name}")


def _channels_last(shape, dtype, device) -> Tensor:
    return torch.empty(shape, dtype=dtype, device=device,
                       memory_format=torch.channels_last)


# --- K3f ---------------------------------------------------------------------
@torch.library.custom_op(f"{NAMESPACE}::pool_bn_relu_fwd", mutates_args=(),
                         device_types="cuda")
def pool_bn_relu_fwd(x: Tensor, scale: Tensor, shift: Tensor) -> Tensor:
    """``maxpool3x3_{(2,1)}(relu(T(x * scale + shift)))``: x [B, C, H, W]
    -> [B, C, H/2, W] (``ops/pool_fused.py:pool_bn_relu_fwd``)."""
    return _ops("pool_fused").launch_pool_bn_relu_fwd(x, scale, shift)


@pool_bn_relu_fwd.register_kernel("cpu")
def _(x, scale, shift):
    return _ops("pool_fused").max_pool_bn_relu_reference(x, scale, shift)


@pool_bn_relu_fwd.register_fake
def _(x, scale, shift):
    if x.device.type != "cuda":
        return _ops("pool_fused").max_pool_bn_relu_reference(x, scale, shift)
    b, c, h, w = x.shape
    return _channels_last((b, c, h // 2, w), x.dtype, x.device)


# --- K4f ---------------------------------------------------------------------
@torch.library.custom_op(f"{NAMESPACE}::conv3x3_bn_relu_fwd", mutates_args=(),
                         device_types="cuda")
def conv3x3_bn_relu_fwd(x: Tensor, weight: Tensor, scale: Optional[Tensor],
                        shift: Optional[Tensor]) -> Tensor:
    """``conv3x3(pad0(T(max(x * scale + shift, 0))), weight)``, stride 1:
    x [B, Cin, H, W], weight [Cout, Cin, 3, 3] -> [B, Cout, H, W]
    (``ops/conv_fused.py:conv3x3_bn_relu_fwd``)."""
    return _ops("conv_fused").launch_conv3x3_bn_relu_fwd(x, weight, scale, shift)


@conv3x3_bn_relu_fwd.register_kernel("cpu")
def _(x, weight, scale, shift):
    return _ops("conv_fused").conv3x3_bn_relu_reference(x, weight, scale, shift)


@conv3x3_bn_relu_fwd.register_fake
def _(x, weight, scale, shift):
    if x.device.type != "cuda":
        return _ops("conv_fused").conv3x3_bn_relu_reference(x, weight, scale, shift)
    b, _, h, w = x.shape
    return _channels_last((b, weight.shape[0], h, w), x.dtype, x.device)


# --- K5f ---------------------------------------------------------------------
@torch.library.custom_op(f"{NAMESPACE}::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor,
                        scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """(o, l, m) of softmax(q k^T * scale) v, q, k, v [B, H, N, D]
    (``ops/flash_attn.py:flash_attention_fwd``)."""
    return _ops("flash_attn").launch_flash_attention_fwd(q, k, v, scale)


@flash_attention_fwd.register_kernel("cpu")
def _(q, k, v, scale):
    return _ops("flash_attn").flash_attention_reference(q, k, v, scale)


@flash_attention_fwd.register_fake
def _(q, k, v, scale):
    if q.device.type != "cuda":
        return _ops("flash_attn").flash_attention_reference(q, k, v, scale)
    b, h, n, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    l = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    return o, l, torch.empty_like(l)


# --- Q1 ----------------------------------------------------------------------
@torch.library.custom_op(f"{NAMESPACE}::conv_int8", mutates_args=(),
                         device_types="cuda")
def conv_int8(src: Tensor, w_packed: Tensor, sx: Tensor, dq: Optional[Tensor],
              stride: List[int], padding: int, out_dtype: torch.dtype,
              prologue_scale: Optional[Tensor],
              prologue_shift: Optional[Tensor]) -> Tensor:
    """The A8W8 conv: s8 ``src``, or a bf16 one (through the BN + ReLU
    prologue when given) quantized with ``sx``; ``w_packed`` [O, kh, kw, I]
    s8; ``dq = sx * sw`` -> [B, O, Ho, Wo] in ``out_dtype``
    (``ops/quant.py:conv_int8_cuda``)."""
    return _ops("quant").launch_conv_int8(src, w_packed, sx, dq, stride, padding,
                                          out_dtype, prologue_scale, prologue_shift)


def _conv_int8_plain(src, w_packed, sx, dq, stride, padding, out_dtype,
                     prologue_scale, prologue_shift):
    q8 = _ops("quant")
    prologue = None if prologue_scale is None else (prologue_scale, prologue_shift)
    x, xq = (None, src) if src.dtype == torch.int8 else (src, None)
    return q8.conv_int8_reference(x, w_packed.permute(0, 3, 1, 2), sx, dq, stride,
                                  padding, out_dtype, xq=xq, prologue=prologue)


conv_int8.register_kernel("cpu")(_conv_int8_plain)


@conv_int8.register_fake
def _(src, w_packed, sx, dq, stride, padding, out_dtype, prologue_scale,
      prologue_shift):
    if src.device.type != "cuda":
        return _conv_int8_plain(src, w_packed, sx, dq, stride, padding, out_dtype,
                                prologue_scale, prologue_shift)
    b, _, h, w = src.shape
    co, kh, kw, _ = w_packed.shape
    ho = (h + 2 * padding - kh) // stride[0] + 1
    wo = (w + 2 * padding - kw) // stride[1] + 1
    return _channels_last((b, co, ho, wo), out_dtype, src.device)
