"""3x3 convolution with a BatchNorm-apply + ReLU prologue (port of
``htr_vt_tpu/ops/conv_fused.py``), the folded dataflow's conv.

For now this holds only the plain version, ``conv3x3_bn_relu_reference``:
``conv(T(max(x * scale + shift, 0)))`` with the zero padding applied after
the prologue (``_xla_reference``, ``conv_fused.py:497-507, 613-624``). The
hand-written conv trio that replaces the Pallas kernels (K4f/K4d/K4w) is
still to be ported (ROADMAP.md queue 2, K4); until then
``build_model`` refuses ``conv_impl="pallas"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3_bn_relu_reference(x: torch.Tensor, weight: torch.Tensor,
                              scale: torch.Tensor, shift: torch.Tensor
                              ) -> torch.Tensor:
    """x [B, Cin, H, W], weight [Cout, Cin, 3, 3] (cast to x.dtype),
    scale/shift float32 [Cin] -> [B, Cout, H, W], stride 1, padding 1. The
    prologue's ReLU is ``torch.maximum`` against 0, whose gradient at a tie
    is one half, as ``jnp.maximum``'s."""
    xn = x.float() * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    xn = torch.maximum(xn, xn.new_zeros(()))
    return F.conv2d(xn.to(x.dtype), weight.to(x.dtype), padding=1)
