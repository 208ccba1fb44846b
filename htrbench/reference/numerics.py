"""How the reference computes its products: in float32, in a lower
precision (the controls), or as the static A8W8 scheme.

A model forward hands every convolution, linear and attention product to
one of these objects, named by its site (``patch_embed.layer1.0.conv2``,
``blocks.0.attn.qkv``, ...). ``emit`` sees each stem block's output, which
the A8W8 scheme hands to the next block as int8 codes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0      # float8_e4m3fn
FP8_GRAD_MAX = 57344.0  # float8_e5m2


class Float32:
    """Every product in float32 (TF32 must be off: ``tf32_off``)."""

    name = "float32"

    def conv(self, x, w, stride, padding, site: str, carried: bool = False):
        return F.conv2d(x, w, stride=stride, padding=padding)

    def linear(self, x, w, b, site: str):
        return F.linear(x, w, b)

    def matmul(self, a, b, site: str):
        return torch.matmul(a, b)

    def emit(self, out, site: str):
        return out, False


class tf32_off:
    """Inside, float32 products are float32 (no TF32) in cuBLAS and cuDNN."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


def _fp8(t: torch.Tensor, fmt=torch.float8_e4m3fn, top: float = FP8_MAX) -> torch.Tensor:
    """t rounded to float8 with one scale a tensor (its abs-max at the
    format's top), back in float32."""
    s = t.detach().abs().amax().clamp_min(1e-12) / top
    return (t / s).to(fmt).float() * s


class _GradFP8(torch.autograd.Function):
    """The identity whose gradient is rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, FP8_GRAD_MAX)


def _ste(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q forward, t's gradient backward."""
    return t + (q - t).detach()


class FP8(Float32):
    """The control of a bfloat16 configuration: every product's operands
    in float8 e4m3 (per-tensor scales), its gradients in e5m2, the sums in
    float32."""

    name = "fp8"

    def _q(self, t):
        return _ste(t, _fp8(t))

    def conv(self, x, w, stride, padding, site, carried=False):
        return _GradFP8.apply(F.conv2d(self._q(x), self._q(w), stride=stride, padding=padding))

    def linear(self, x, w, b, site):
        y = F.linear(self._q(x), self._q(w))
        return _GradFP8.apply(y if b is None else y + b)

    def matmul(self, a, b, site):
        return _GradFP8.apply(torch.matmul(self._q(a), self._q(b)))


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    return amax.float().clamp_min(1e-12) / qmax


def fake_quant(x: torch.Tensor, scale: torch.Tensor, qmax: float) -> torch.Tensor:
    """Symmetric integer codes ``clamp(round(x / s), -qmax, qmax)``, as
    float values times s."""
    return torch.clamp(torch.round(x.float() / scale), -qmax, qmax) * scale


def quant_channels(w: torch.Tensor, qmax: float) -> torch.Tensor:
    """One scale an output channel (dim 0), ``max |w_o| / qmax``."""
    s = _scale(w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True), qmax)
    return fake_quant(w, s, qmax)


class Calibrate(Float32):
    """Float32 products, recording the running abs-max of the input of
    every quantized site and of every block output that the next block
    takes as codes (``amax``)."""

    name = "calibrate"

    def __init__(self, int8_sites, emit_sites):
        self.int8_sites, self.emit_sites = set(int8_sites), set(emit_sites)
        self.amax: Dict[str, torch.Tensor] = {}

    def _record(self, site, x):
        m = x.detach().abs().amax().float()
        self.amax[site] = m if site not in self.amax else torch.maximum(self.amax[site], m)

    def conv(self, x, w, stride, padding, site, carried=False):
        if site in self.int8_sites:
            self._record(site, x)
        return super().conv(x, w, stride, padding, site)

    def linear(self, x, w, b, site):
        if site in self.int8_sites:
            self._record(site, x)
        return super().linear(x, w, b, site)

    def emit(self, out, site):
        if site in self.emit_sites:
            self._record(site, out)
        return out, False


class Static(Float32):
    """The static A8W8 scheme at ``bits`` (8: the configuration; 4: its
    control): at each quantized site the input takes the calibrated scale
    (``amax / qmax``, one a tensor) unless it already arrives as codes, the
    weight one scale an output channel (a stem conv's after its bfloat16
    cast), the product's sums exact in float32; a block output that the
    next block takes as codes is quantized with its own calibrated scale."""

    def __init__(self, amax: Dict[str, torch.Tensor], int8_sites, emit_sites,
                 bits: int = 8):
        self.amax, self.bits = amax, bits
        self.qmax = float(2 ** (bits - 1) - 1)
        self.int8_sites, self.emit_sites = set(int8_sites), set(emit_sites)
        self.name = f"int{bits}"
        self._w: Dict[str, torch.Tensor] = {}

    def _xq(self, site, x):
        return fake_quant(x, _scale(self.amax[site], self.qmax), self.qmax)

    def _wq(self, site, w, bf16: bool):
        if site not in self._w:
            src = w.to(torch.bfloat16).float() if bf16 else w
            self._w[site] = quant_channels(src, self.qmax)
        return self._w[site]

    def conv(self, x, w, stride, padding, site, carried=False):
        if site not in self.int8_sites:
            return F.conv2d(x, w, stride=stride, padding=padding)
        xq = x if carried else self._xq(site, x)
        return F.conv2d(xq, self._wq(site, w, True), stride=stride, padding=padding)

    def linear(self, x, w, b, site):
        if site not in self.int8_sites:
            return F.linear(x, w, b)
        return F.linear(self._xq(site, x), self._wq(site, w, False), b)

    def emit(self, out, site):
        if site in self.emit_sites:
            return self._xq(site, out), True
        return out, False


def numerics(kind: str, amax: Optional[Dict[str, torch.Tensor]] = None,
             int8_sites=(), emit_sites=()):
    """``float32``, ``fp8``, ``int8`` or ``int4`` (the last two need the
    calibrated ``amax``)."""
    if kind == "float32":
        return Float32()
    if kind == "fp8":
        return FP8()
    if kind in ("int8", "int4"):
        return Static(amax, int8_sites, emit_sites, bits=int(kind[3:]))
    raise ValueError(f"unknown numerics {kind!r}")
