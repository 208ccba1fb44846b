"""A8W8 int8 serving: quantizers, the int8 conv and dot, calibration and the
stage-1 pad (port of ``htr_vt_tpu/ops/quant.py``).

- Activations: one symmetric scale a tensor, ``sx = max(amax, 1e-12) /
  127``, from a calibrated abs-max (static) or one taken on the fly
  (dynamic). Weights: one scale an output channel, ``sw[o] = max |w[o]| /
  127``. ``q = clamp(round(x / s), -127, 127)``: true float32 division and
  round half to even, as ``jnp.round``.
- ``conv_int8`` / ``conv_int8_bf16``: the s8 x s8 -> s32 convolution,
  dequantized as ``f32(acc) * (sx * sw)`` or ``bf16(acc) * bf16(sx * sw)``
  (the s32 -> bf16 conversion goes through float32, as XLA's does), through
  the custom op ``htrvt::conv_int8`` (``ops/library.py``). A CUDA
  tensor launches Q1 (``csrc/conv_int8.cu``), the hand-written int8
  implicit-GEMM conv; a bf16 input with a calibrated scale is normalised
  (the optional BN-apply + ReLU prologue) and quantized by Q1's own
  quantize kernel first. A CPU tensor runs the plain version, a float64 convolution of the
  integer values (exact: every |acc| < 2^27) rounded to s32.
- ``dot_int8``: ``torch._int_mm`` for the s32 product (JAX leaves it to
  XLA's ``dot_general``), then the same dequant.
- Calibration: a quantized site keeps its abs-max in a buffer whose name
  ends in ``amax`` (``None`` until calibrated, so a float checkpoint loads
  strictly). ``site_mode`` reads JAX's three modes of ``activation_scale``
  (``quant.py:200-217``) from it: inside ``calibrating()`` the site records
  a running abs-max and runs float math ("calibrate"); a set buffer gives
  "static"; an unset one "dynamic".
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.ops import library as htrvt_ops
from htr_vt_torch.parallel.mesh import model_max, model_sum

QMAX = 127.0
SCALE_FLOOR = 1e-12
AMAX_SUFFIX = "amax"
# C codes of Q1's input and output element types (csrc/conv_int8.cu).
_IN_CODES = {torch.int8: 0, torch.bfloat16: 1}
_OUT_CODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
# Q1's shape contract: input channels in multiples of TILE_K, output
# channels in multiples of TILE_N (csrc/conv_int8.cu).
TILE_N = 128
TILE_K = 64
# Q1's routes by shape (csrc/conv_int8.cu:Route): mma.sync on gathered rows;
# wgmma fed by TMA; for a bf16 input, its quantize kernel, then wgmma (the
# gather route, too, runs after the quantize kernel for a bf16 input).
Q1_ROUTES = {0: "gather", 1: "wgmma", 2: "quantize+wgmma"}


# --------------------------------------------------------------- quantizers

def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax.float(), SCALE_FLOOR) / QMAX


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


def quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic int8 (``_quantize_tensor``, ``quant.py:27-32``):
    (q int8, scale float32 0-d)."""
    scale = _scale_of(x.float().abs().amax())
    return _quantize(x, scale), scale


def quantize_channels(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of a torch weight, output channels first
    ([N, K] linear or [O, I, kh, kw] conv), as ``_quantize_channels``
    (``quant.py:35-41``) quantizes flax's output-last kernel: (q int8,
    scale float32 [N])."""
    wf = w.float()
    scale = _scale_of(wf.abs().amax(dim=tuple(range(1, w.dim()))))
    shape = (-1,) + (1,) * (w.dim() - 1)
    return _quantize(wf, scale.view(shape)), scale


def quantize_static(x: torch.Tensor, amax: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8 with a calibrated abs-max (``_quantize_static``,
    ``quant.py:44-52``): (q int8, scale float32 0-d)."""
    scale = _scale_of(amax)
    return _quantize(x, scale), scale


# ------------------------------------------------------------- calibration

_CALIBRATING = [False]


@contextlib.contextmanager
def calibrating():
    """Inside, every quantized site records a running abs-max of its input
    into its buffer and runs float math (JAX's mutable ``quant_stats``)."""
    prev = _CALIBRATING[0]
    _CALIBRATING[0] = True
    try:
        yield
    finally:
        _CALIBRATING[0] = prev


def add_site(module: nn.Module, name: str) -> None:
    """Give ``module`` the quantized site ``name`` (an ``*amax`` buffer,
    unset)."""
    module.register_buffer(name, None)


def site_mode(module: nn.Module, name: str
              ) -> Tuple[str, Optional[torch.Tensor]]:
    """("calibrate", None) inside ``calibrating()``; ("static", amax) once
    the site is calibrated; else ("dynamic", None)."""
    if _CALIBRATING[0]:
        return "calibrate", None
    amax = getattr(module, name)
    return ("dynamic", None) if amax is None else ("static", amax)


def _sharded_amax(module: nn.Module, x: torch.Tensor, row_sharded: bool) -> torch.Tensor:
    """max |x|; the whole tensor's over the model group
    (``parallel/mesh.py:model_max``) where x is this rank's part of it: a
    row-sharded linear's input columns (``row_sharded``), or a width strip
    of a stem module that ``shard_width`` marked (``module.width_sharded``:
    the strip may carry halo columns, which are the image's too)."""
    m = x.float().abs().amax()
    return model_max(m) if row_sharded or getattr(module, "width_sharded", False) else m


def record_amax(module: nn.Module, name: str, x: torch.Tensor,
                row_sharded: bool = False) -> None:
    """The running max of |x| into the site's buffer (from 0 when unset),
    the whole tensor's where x is this rank's part of it
    (``_sharded_amax``), as every rank records it."""
    m = _sharded_amax(module, x, row_sharded)
    cur = getattr(module, name)
    setattr(module, name, m if cur is None else torch.maximum(cur, m))


def dynamic_amax(module: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
    """The abs-max that dynamic quantization takes of x: None (x's own, on
    the fly) except on a width strip of a stem module that ``shard_width``
    marked, where it is the whole image's (``_sharded_amax``), so the scale
    is one process's."""
    if not getattr(module, "width_sharded", False):
        return None
    return _sharded_amax(module, x, False)


def activation_scale(module: nn.Module, name: str, x: torch.Tensor,
                     row_sharded: bool = False) -> Tuple[str, Optional[torch.Tensor]]:
    """``activation_scale`` (``quant.py:200-217``): ``site_mode``, recording
    |x| first when calibrating (``record_amax``, ``row_sharded`` as
    there)."""
    mode, amax = site_mode(module, name)
    if mode == "calibrate":
        record_amax(module, name, x, row_sharded)
    return mode, amax


def quant_sites(model: nn.Module) -> Dict[str, Tuple[nn.Module, str]]:
    """state_dict key -> (module, buffer name) of every quantized site,
    calibrated or not."""
    out = {}
    for prefix, module in model.named_modules():
        for name in module._buffers:
            if name.endswith(AMAX_SUFFIX):
                out[f"{prefix}.{name}" if prefix else name] = (module, name)
    return out


def quant_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The calibrated abs-maxes, by state_dict key (JAX's ``quant_stats``
    collection)."""
    return {k: getattr(m, n) for k, (m, n) in quant_sites(model).items()
            if getattr(m, n) is not None}


def clear_quant_stats(model: nn.Module) -> None:
    """Every site back to unset (dynamic)."""
    for module, name in quant_sites(model).values():
        setattr(module, name, None)


def load_quant_stats(model: nn.Module, stats: Dict[str, torch.Tensor]) -> None:
    """Set the sites named in ``stats``; raises on a key that is no site."""
    sites = quant_sites(model)
    unknown = sorted(set(stats) - set(sites))
    if unknown:
        raise ValueError(f"not quantized sites of the model: {unknown}")
    device = next(model.parameters()).device
    for key, value in stats.items():
        module, name = sites[key]
        setattr(module, name, torch.tensor(float(value), dtype=torch.float32,
                                           device=device))


@torch.inference_mode()
def calibrate_quant_stats(model: nn.Module, image_batches: Iterable,
                          n_batches: int = 4) -> Dict[str, torch.Tensor]:
    """Static activation scales (``calibrate_quant_stats``,
    ``quant.py:220-255``): the sites start unset, then up to ``max(1,
    n_batches)`` float eval forwards over ``image_batches`` ([B, H, W, 1]
    float32 arrays or tensors, drawn no further than that) record a running
    abs-max. The model keeps them; returns ``quant_stats(model)``. A model
    whose width is sharded over the model axis (``parallel/mesh.py:
    shard_width``) takes each image's strip, as ``eval_step`` does
    (``rank_width``), and each site records the whole image's abs-max
    (``record_amax``), so every rank keeps one process's scales."""
    clear_quant_stats(model)
    device = next(model.parameters()).device
    with calibrating():
        for img in itertools.islice(image_batches, max(1, n_batches)):
            model(torch.as_tensor(img, dtype=torch.float32, device=device),
                  train=False)
    return quant_stats(model)


# ------------------------------------------------------------ the int8 GEMM

def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm``: [M, K] s8 x [K, N] s8 -> [M, N] s32. On the card
    cuBLASLt takes only M > 16 and K, N multiples of 8; another shape raises
    (there is no float fallback). Counts its CUDA calls in
    ``int_mm.launches``; a ``torch.export`` trace records the call and
    counts nothing."""
    if a.is_cuda:
        m, k = a.shape
        n = b.shape[1]
        if m <= 16 or k % 8 or n % 8:
            raise ValueError(f"dot_int8: [{m}, {k}] x [{k}, {n}] is outside "
                             "torch._int_mm's CUDA shapes (M > 16, K and N "
                             "multiples of 8)")
        if not torch.compiler.is_exporting():
            int_mm.launches += 1
    return torch._int_mm(a, b)


int_mm.launches = 0  # CUDA calls; the CPU path never counts


def weight_cache(module: nn.Module, key: str, w: torch.Tensor, make):
    """``make(w)`` for the weight ``w``, cached on ``module`` under ``key``
    while ``w`` keeps its storage, version, dtype and device (the quantized
    weights are a pure function of it). Under a ``torch.export`` trace,
    where ``w`` is a fake tensor with no storage, ``make(w)`` goes into the
    program instead, as JAX's ``QDense`` quantizes its kernel inside the
    exported program."""
    if torch.compiler.is_exporting():
        return make(w)
    cache = module.__dict__.setdefault("_quant_weights", {})
    tag = (w.data_ptr(), w._version, w.dtype, w.device)
    hit = cache.get(key)
    if hit is None or hit[0] != tag:
        with torch.no_grad():
            hit = (tag, make(w))
        cache[key] = hit
    return hit[1]


def linear_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the [K, N] column-major s8 operand ``_int_mm`` takes, sw [N]) of a
    linear's float32 weight [N, K]: QDense quantizes the parameter uncast
    (``layers.py:93``)."""
    q, s = quantize_channels(w)
    return q.t(), s


def row_linear_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``linear_weight`` of this rank's input columns [N, K / M] of a
    row-sharded linear: each output channel's scale is its abs-max over the
    whole input dimension (``parallel/mesh.py:model_max``), so the s8
    columns are one process's."""
    wf = w.float()
    scale = _scale_of(model_max(wf.abs().amax(dim=1)))
    return _quantize(wf, scale[:, None]).t(), scale


def dot_int8(x: torch.Tensor, wq_t: torch.Tensor, sw: torch.Tensor,
             amax: Optional[torch.Tensor] = None,
             dequant_dtype: torch.dtype = torch.float32,
             row_sharded: bool = False) -> torch.Tensor:
    """[..., K] x the quantized [K, N] weight (``linear_weight``) ->
    [..., N] in ``dequant_dtype`` (``dot_int8``, ``quant.py:91-105``): x
    quantized static with ``amax``, else dynamic; ``acc.to(dequant_dtype) *
    (sx * sw).to(dequant_dtype)``. ``row_sharded``: x holds this rank's K /
    M input columns and ``wq_t`` their rows (``row_linear_weight``); the
    dynamic abs-max is the whole input's and the int32 accumulators are
    summed over the model group before the dequant, exactly, so the output
    is one process's bit for bit."""
    if amax is None and row_sharded:
        amax = model_max(x.float().abs().amax())
    xq, sx = quantize_static(x, amax) if amax is not None else quantize_tensor(x)
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), wq_t)
    if row_sharded:
        acc = model_sum(acc)
    y = acc.to(dequant_dtype) * (sx * sw).to(dequant_dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


# ------------------------------------------------------------ the int8 conv

def conv_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(wq [O, I, kh, kw] s8, Q1's packing of it [O, kh, kw, I], sw [O]) of
    a conv weight as the stem hands it (its bf16 cast, ``stem.py:247``)."""
    q, s = quantize_channels(w)
    return q, q.permute(0, 2, 3, 1).contiguous(), s


def apply_prologue(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
                   ) -> torch.Tensor:
    """``max(T(T(x * T(scale)) + T(shift)), 0)`` in T = x.dtype, each
    operation rounded (``stem.py:250-256``)."""
    t = x.dtype
    a = x * scale.to(t).view(1, -1, 1, 1) + shift.to(t).view(1, -1, 1, 1)
    return torch.maximum(a, a.new_zeros(()))


def conv_s8_reference(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
                      padding: int) -> torch.Tensor:
    """Plain version of Q1's product: the s32 accumulator [B, O, Ho, Wo] of
    s8 xq [B, I, H, W] and s8 wq [O, I, kh, kw], zero padding. A float64
    convolution of the integer values is exact (|acc| <= 127^2 * 9 * 768 <
    2^27)."""
    # cuDNN could pick an inexact (FFT, Winograd) algorithm; ATen's own
    # im2col + GEMM sums the integer products exactly in float64
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.double(), wq.double(), stride=tuple(stride), padding=padding)
    return acc.round().to(torch.int32)


def dequantize(acc: torch.Tensor, dq: torch.Tensor, out_dtype: torch.dtype
               ) -> torch.Tensor:
    """Q1's epilogue: ``acc`` itself (int32), ``f32(acc) * dq`` (float32) or
    ``bf16(acc) * bf16(dq)`` (bfloat16), dq = sx * sw [O]."""
    if out_dtype == torch.int32:
        return acc
    return acc.to(out_dtype) * dq.to(out_dtype).view(1, -1, 1, 1)


def conv_int8_reference(x: Optional[torch.Tensor], wq: torch.Tensor,
                        sx: torch.Tensor, dq: torch.Tensor, stride, padding: int,
                        out_dtype: torch.dtype, *, xq: Optional[torch.Tensor] = None,
                        prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Plain version of Q1 on Q1's inputs: s8 ``xq``, or ``x`` (through
    ``apply_prologue`` when given) quantized with the scale ``sx``; then
    ``conv_s8_reference`` and ``dequantize``."""
    if xq is None:
        a = apply_prologue(x, *prologue) if prologue is not None else x
        xq = _quantize(a, sx)
    return dequantize(conv_s8_reference(xq, wq, stride, padding), dq, out_dtype)


def conv_int8_cuda(x: Optional[torch.Tensor], w_packed: torch.Tensor,
                   sx: torch.Tensor, dq: Optional[torch.Tensor], stride, padding: int,
                   out_dtype: torch.dtype, *, xq: Optional[torch.Tensor] = None,
                   prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Q1 (``csrc/conv_int8.cu``) on the current stream, through the op
    ``htrvt::conv_int8`` (``ops/library.py``): s8 ``xq``, or a bf16 ``x``
    that Q1 first normalises (``prologue``) and quantizes with ``sx`` into
    an s8 scratch tensor (its quantize kernel, in the same C call);
    [B, I, H, W] channels-last -> [B, O, Ho, Wo] channels-last in
    ``out_dtype`` (int32: the accumulator). ``w_packed`` [O, kh, kw, I] s8,
    dq = sx * sw float32 [O]. Adds one to ``conv_int8_cuda.launches``. I
    must be a multiple of 64 and O of 128 (every int8 site of the stem is):
    another shape raises."""
    src = xq if xq is not None else x
    if src.device.type != "cuda":
        raise ValueError(f"conv_int8_cuda: no kernel for device {src.device}")
    if src.dtype not in _IN_CODES or src.dim() != 4:
        raise ValueError(f"conv_int8_cuda: the input must be 4-d int8 or bfloat16, "
                         f"got {src.dtype} {tuple(src.shape)}")
    if not torch.compiler.is_exporting():  # a fake tensor's strides: the launch
        _check_q1_layout(src)
    ci = src.shape[1]
    co, _, _, ci_w = w_packed.shape
    if ci_w != ci or w_packed.dtype != torch.int8 or not w_packed.is_contiguous():
        raise ValueError(f"conv_int8_cuda: packed weight must be int8 [O, kh, kw, {ci}] "
                         f"contiguous, got {w_packed.dtype} {tuple(w_packed.shape)}")
    if ci % TILE_K or co % TILE_N:
        raise ValueError(f"conv_int8_cuda: {ci} -> {co} channels; Q1 takes input "
                         f"channels in multiples of {TILE_K} and output channels in "
                         f"multiples of {TILE_N}")
    pro_s, pro_t = (None, None) if prologue is None else prologue
    return htrvt_ops.conv_int8(src, w_packed, sx, dq, list(stride), padding, out_dtype,
                               pro_s, pro_t)


def _check_q1_layout(src: torch.Tensor) -> None:
    if not src.is_contiguous(memory_format=torch.channels_last) or src.data_ptr() % 16:
        raise ValueError("conv_int8_cuda: the input must be channels-last contiguous "
                         "and 16-byte aligned")


def q1_route(in_dtype: torch.dtype, b: int, ci: int, co: int, kh: int, kw: int, stride,
             padding: int, ho: int, wo: int) -> str:
    """The route Q1 takes for a shape on the card (``Q1_ROUTES``)."""
    from htr_vt_torch._build import library
    return Q1_ROUTES[library().htrvt_conv_int8_route(
        _IN_CODES[in_dtype], b, ci, co, kh, kw, stride[0], stride[1], padding, ho, wo)]


def launch_conv_int8(src: torch.Tensor, w_packed: torch.Tensor, sx: torch.Tensor,
                     dq: Optional[torch.Tensor], stride, padding: int,
                     out_dtype: torch.dtype, prologue_scale: Optional[torch.Tensor],
                     prologue_shift: Optional[torch.Tensor]) -> torch.Tensor:
    """Q1's launch (the CUDA implementation of ``htrvt::conv_int8``). An
    exported program calls it without the wrapper, so the real input's
    layout and address are checked here."""
    _check_q1_layout(src)
    b, ci, h, w = src.shape
    co, kh, kw, _ = w_packed.shape
    sh, sw_ = stride
    ho = (h + 2 * padding - kh) // sh + 1
    wo = (w + 2 * padding - kw) // sw_ + 1
    y = torch.empty((b, co, ho, wo), dtype=out_dtype, device=src.device,
                    memory_format=torch.channels_last)
    sx = sx.float().reshape(1).contiguous()
    dq_ptr = 0 if dq is None else dq.float().contiguous().data_ptr()
    pro_s = pro_t = None
    if prologue_scale is not None:
        pro_s = prologue_scale.to(torch.bfloat16).float().contiguous()
        pro_t = prologue_shift.to(torch.bfloat16).float().contiguous()
    scratch = (None if src.dtype == torch.int8 else
               torch.empty_like(src, dtype=torch.int8, memory_format=torch.channels_last))
    from htr_vt_torch._build import check_launch, library
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().htrvt_conv_int8(
            src.data_ptr(), _IN_CODES[src.dtype], sx.data_ptr(),
            0 if pro_s is None else pro_s.data_ptr(),
            0 if pro_t is None else pro_t.data_ptr(),
            w_packed.data_ptr(), dq_ptr, y.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), _OUT_CODES[out_dtype],
            b, h, w, ci, co, kh, kw, sh, sw_, padding, ho, wo, stream)
    check_launch("conv_int8", err)
    conv_int8_cuda.launches += 1
    return y


conv_int8_cuda.launches = 0  # kernel launches; the CPU path never counts


def conv_int8_any(x, w: torch.Tensor, stride, padding: int, out_dtype: torch.dtype,
                  *, amax=None, xq=None, sx=None, prologue=None,
                  weight_dtype: Optional[torch.dtype] = None,
                  module: Optional[nn.Module] = None, key: str = "") -> torch.Tensor:
    """The int8 conv of ``conv_int8`` / ``conv_int8_bf16`` with the stem's
    prologue folded in: x [B, I, H, W] channels-last (None when the
    pre-quantized ``xq``/``sx`` is given), w [O, I, kh, kw] quantized after
    a cast to ``weight_dtype`` (the stem quantizes its bf16-cast kernels).
    x goes through ``apply_prologue(x, *prologue)`` when given, then is
    quantized static with ``amax`` or dynamic. Both devices call the op
    ``htrvt::conv_int8``: a CUDA tensor launches Q1 (a bf16 x with ``amax``
    is normalised and quantized by Q1 itself); a CPU tensor runs
    ``conv_int8_reference``. ``module``/``key`` cache the quantized
    weight."""
    def make(p):
        return conv_weight(p if weight_dtype is None else p.to(weight_dtype))

    _, w_packed, sw = (weight_cache(module, key, w, make) if module is not None
                        else make(w))
    src = xq if xq is not None else x
    fused = (xq is None and amax is not None and src.is_cuda
             and src.dtype == torch.bfloat16)
    if xq is None and not fused:
        a = apply_prologue(x, *prologue) if prologue is not None else x
        xq, sx = quantize_static(a, amax) if amax is not None else quantize_tensor(a)
        prologue = None
    elif fused:
        sx = _scale_of(amax)
    dq = sx * sw
    if src.device.type == "cpu":
        return htrvt_ops.conv_int8(xq, w_packed, sx, dq, list(stride), padding,
                                   out_dtype, None, None)
    return conv_int8_cuda(None if xq is not None else x, w_packed, sx, dq, stride,
                          padding, out_dtype, xq=xq, prologue=prologue)


def conv_int8(x, w, stride=(1, 1), padding: int = 1, amax=None, xq=None, sx=None,
              **kw) -> torch.Tensor:
    """NCHW conv with A8W8 quantization, float32 out (``conv_int8``,
    ``quant.py:55-75``)."""
    return conv_int8_any(x, w, stride, padding, torch.float32, amax=amax, xq=xq,
                         sx=sx, **kw)


def conv_int8_bf16(x, w, stride=(1, 1), padding: int = 1, amax=None, xq=None,
                   sx=None, **kw) -> torch.Tensor:
    """``conv_int8`` with the bf16 dequant epilogue (``conv_int8_bf16``,
    ``quant.py:78-88``)."""
    return conv_int8_any(x, w, stride, padding, torch.bfloat16, amax=amax, xq=xq,
                         sx=sx, **kw)


def max_pool_s8(xq: torch.Tensor) -> torch.Tensor:
    """The 3x3/(2,1) max-pool, padding 1, of an s8 tensor, exact
    (``stem.py:397-400``): the int8 values ride a bf16 carrier (integers up
    to 256 are exact there) and come back; the carrier's -inf padding
    stands for JAX's -128, since every window holds an element of the
    image."""
    y = F.max_pool2d(xq.to(torch.bfloat16), kernel_size=3, stride=(2, 1), padding=1)
    return y.to(torch.int8).contiguous(memory_format=torch.channels_last)


# ----------------------------------------------------------- the stage-1 pad

_STEM = "patch_embed."


def pad_stage1_tree(sd: Dict[str, torch.Tensor], to: int = 256
                    ) -> Dict[str, torch.Tensor]:
    """Zero-pad the ResNet18 stem's stage-1 width in the port's state_dict
    (``pad_stage1_tree``, ``quant.py:108-174``): conv output channels, BN
    biases and running means by 0, BN gammas and variances by 1, and
    stage 2's entry convs' input channels by 0, so every padded channel is
    relu(0) = 0 through the stage and the live channels are unchanged. A
    new dict; already padded entries pass through (idempotent)."""
    out = dict(sd)

    def pad(key, dims, value=0.0):
        t = out[key]
        for d in dims:
            if t.shape[d] < to:
                shape = list(t.shape)
                shape[d] = to - t.shape[d]
                t = torch.cat([t, t.new_full(shape, value)], dim=d)
        out[key] = t

    def pad_bn(prefix):
        if prefix + ".weight" not in out:
            return
        pad(prefix + ".weight", (0,), 1.0)
        pad(prefix + ".bias", (0,))
        pad(prefix + ".running_mean", (0,))
        pad(prefix + ".running_var", (0,), 1.0)

    s1b1, s1b2, s2b1 = (_STEM + n for n in ("layer1.0", "layer1.1", "layer2.0"))
    pad(s1b1 + ".conv1.weight", (0,))
    pad(s1b1 + ".conv2.weight", (0, 1))
    if s1b1 + ".downsample.0.weight" in out:
        pad(s1b1 + ".downsample.0.weight", (0,))
    for bn in (".bn1", ".bn2", ".downsample.1"):
        pad_bn(s1b1 + bn)
    pad(s1b2 + ".conv1.weight", (0, 1))
    pad(s1b2 + ".conv2.weight", (0, 1))
    pad_bn(s1b2 + ".bn1")
    pad_bn(s1b2 + ".bn2")
    pad(s2b1 + ".conv1.weight", (1,))
    if s2b1 + ".downsample.0.weight" in out:
        pad(s2b1 + ".downsample.0.weight", (1,))
    return out


def stage1_pad_applies(cfg) -> bool:
    """The int8 stage-1 pad applies where it buys tiling
    (``_stage1_pad_applies``, ``htr_vt.py:38-45``): int8 with a pad, a
    stage-1 width >= 128 off the 128 grid (the flagship's 192), padded up."""
    s1 = cfg.embed_dim // 4
    return (cfg.quant == "int8" and bool(cfg.quant_stage1_pad)
            and s1 >= 128 and s1 % 128 != 0 and cfg.quant_stage1_pad > s1)


def serving_arrays(cfg, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A training state_dict adapted to the serving model of ``cfg``
    (``serving_arrays``, ``quant.py:177-197``): the stage-1 pad where it
    applies on the ResNet18 stem, else ``sd`` itself."""
    if getattr(cfg, "stem", "resnet18") == "resnet18" and stage1_pad_applies(cfg):
        return pad_stage1_tree(sd, cfg.quant_stage1_pad)
    return sd
