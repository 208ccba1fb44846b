"""Shared building blocks (port of ``htr_vt_tpu/models/layers.py``).

Parameters are float32; each layer casts its weights to the compute dtype at
the call, as the JAX package's ``QDense`` does, so one state_dict serves a
bfloat16 and a float32 model alike. A linear made a quantized site
(``quantize_linear``) runs QDense's int8 path in eval (``dense(...,
quant=True)``); its calibrated abs-max is the buffer ``amax``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.ops import quant as q8
from htr_vt_torch.parallel.mesh import (Shard, all_reduce_sum, copy_to_model,
                                        gather_from_model, gather_model, model_world,
                                        rank_cols, rank_rows, reduce_from_model)

# The standard deviation of a unit normal truncated at +-2, which flax's
# truncated-normal initialisers divide out.
TRUNC_NORMAL_STD = 0.87962566103423978


def global_layer_norm(x: torch.Tensor, eps: float = 1e-5,
                      width_sharded: bool = False) -> torch.Tensor:
    """Parameterless LayerNorm over every non-batch dimension, in float32
    (``layers.py:18-29``). ``width_sharded``: x is this rank's strip of an
    image whose width the model axis shards, and the statistics are the
    whole image's: the mean from the sums over the model group, then the
    variance from the summed squares of ``x - mean``, the two passes of
    ``var(correction=0)``."""
    x32 = x.float()
    dims = tuple(range(1, x.ndim))
    if not width_sharded:
        mean = x32.mean(dims, keepdim=True)
        var = x32.var(dims, keepdim=True, correction=0)
    else:
        n = x32[0].numel() * model_world()[1]
        mean = all_reduce_sum(x32.sum(dims, keepdim=True), "model") / n
        var = all_reduce_sum((x32 - mean).square().sum(dims, keepdim=True), "model") / n
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def sincos_pos_embed_2d(embed_dim: int, grid_size: Tuple[int, int]) -> np.ndarray:
    """Fixed 2-D sin-cos positional embedding, float32 [gh*gw, embed_dim].

    Keeps the reference's w-first meshgrid quirk (``layers.py:32-47``): the
    first half of the embedding encodes the first meshgrid output."""
    gh, gw = grid_size
    grid_h = np.arange(gh, dtype=np.float32)
    grid_w = np.arange(gw, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    grid = grid.reshape([2, 1, gh, gw])
    emb_a = _sincos_1d(embed_dim // 2, grid[0])
    emb_b = _sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_a, emb_b], axis=1).astype(np.float32)


def sincos_pos_embed_1d(embed_dim: int, length: int) -> np.ndarray:
    """1-D sin-cos embedding over ``length`` positions, float32 [length,
    embed_dim] (``layers.py:50-53``; the encoder-decoder's target
    positions)."""
    return _sincos_1d(embed_dim, np.arange(length, dtype=np.float32)).astype(np.float32)


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def quantize_linear(layer: nn.Linear) -> nn.Linear:
    """Make ``layer`` a quantized site (QDense with ``quant=True``): an
    unset ``amax`` buffer."""
    q8.add_site(layer, "amax")
    return layer


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
          quant: bool = False) -> torch.Tensor:
    """``QDense`` (``layers.py:66-100``). Float: the product of input and
    weight in ``dtype``, rounded to ``dtype``, then the bias added in
    ``dtype``; a bias fused into the GEMM would round once instead. With
    ``quant`` (int8 serving) the site's mode decides (``ops/quant.py:
    site_mode``): calibrating records |x| and runs the float path; else
    ``dot_int8`` of x (static with the calibrated abs-max, else dynamic)
    and the float32 weight quantized per output channel, dequantized in
    ``dtype``, then the bias."""
    if quant:
        mode, amax = q8.activation_scale(layer, "amax", x)
        if mode != "calibrate":
            wq_t, sw = q8.weight_cache(layer, "weight", layer.weight, q8.linear_weight)
            y = q8.dot_int8(x, wq_t, sw, amax=amax, dequant_dtype=dtype)
            return y if layer.bias is None else y + layer.bias.to(dtype)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` in x's dtype, the constant rounded to it
    first (``layers.py:119-127``). The constant is a 0-dim host tensor: a
    CUDA kernel takes it as a scalar argument, with no copy to the device
    (which would synchronize the host)."""
    return x * torch.sigmoid(torch.tensor(1.702, dtype=x.dtype) * x)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv`` in ``dtype`` (NCHW here): the convolution of input
    and weight in ``dtype`` with the module's stride, padding, dilation and
    groups, then the bias added in ``dtype``, as ``dense`` does."""
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), stride=conv.stride,
                 padding=conv.padding, dilation=conv.dilation, groups=conv.groups)
    return y if conv.bias is None else y + conv.bias.to(dtype)[:, None, None]


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            model_sharded: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: in train mode keep each element with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``, drawing from
    ``generator`` (the global batch's mask under data parallelism,
    ``parallel/mesh.py:rank_rows``; with ``model_sharded``, x's last
    dimension is this rank's columns of a tensor sharded over the model
    axis, and the mask is those columns of the whole width's,
    ``rank_cols``); the identity at rate 0 or in eval."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    lead, width = x.shape[1:-1], x.shape[-1]

    def draw(n):
        if not model_sharded:
            return torch.rand((n,) + x.shape[1:], generator=generator, device=x.device)
        return rank_cols(lambda w: torch.rand((n,) + lead + (w,), generator=generator,
                                              device=x.device), width)

    mask = rank_rows(draw, x.shape[0]) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def partial_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
                  quant: bool = False) -> torch.Tensor:
    """A row-sharded ``dense`` across the model axis: this rank's partial
    product of x and the weight's input columns, in ``dtype`` and widened
    to float32, summed over the model group in float32
    (``reduce_from_model``), rounded to ``dtype`` once, then the
    (replicated) bias added in ``dtype``. ``dense`` rounds its product once
    too, so the tensor-parallel output is one rounding from one process's;
    a sum of ``dtype`` partials would round each of them first. The sum
    moves 4 bytes an output element, twice bf16's. With ``quant`` (int8
    serving) the site's mode decides as in ``dense``: the abs-maxes are the
    whole input's and the weight's scales its whole rows', and the int32
    products are summed over the model group (``ops/quant.py:dot_int8``),
    so the output is one process's bit for bit. Calibrating, the site
    gathers its input's columns and its weight and runs ``dense``'s float
    product whole, so that every abs-max recorded after it is one
    process's too (calibration runs a few eval batches)."""
    if quant:
        mode, amax = q8.activation_scale(layer, "amax", x, row_sharded=True)
        if mode == "calibrate":
            w = gather_model(layer.weight, Shard("row", 1))
            y = F.linear(gather_from_model(x).to(dtype), w.to(dtype))
            return y if layer.bias is None else y + layer.bias.to(dtype)
        wq_t, sw = q8.weight_cache(layer, "weight", layer.weight, q8.row_linear_weight)
        y = q8.dot_int8(x, wq_t, sw, amax=amax, dequant_dtype=dtype, row_sharded=True)
        return y if layer.bias is None else y + layer.bias.to(dtype)
    y = F.linear(x.to(dtype).float(), layer.weight.to(dtype).float())
    y = reduce_from_model(y).to(dtype)
    return y if layer.bias is None else y + layer.bias.to(dtype)


def row_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, sharded: bool,
              quant: bool = False) -> torch.Tensor:
    """``partial_dense`` where the layer is row-sharded over the model axis
    (``sharded``), else ``dense``."""
    return (partial_dense(layer, x, dtype, quant) if sharded
            else dense(layer, x, dtype, quant))


class DropPath(nn.Module):
    """Per-sample stochastic depth (``layers.py:135-148``): in train mode a
    whole sample's branch is dropped with probability ``rate`` and kept ones
    are scaled by ``1 / (1 - rate)`` (the global batch's draw under data
    parallelism); the identity at rate 0 or in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (1,) * (x.ndim - 1)
        mask = rank_rows(lambda n: torch.rand((n,) + shape, generator=generator,
                                              device=x.device), x.shape[0]) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> dropout -> fc2 -> dropout
    (``layers.py:104-132``). With ``quant`` both linears are int8 sites in
    eval, and ``quick_gelu`` then takes ``x * sigmoid(1.702 x)`` for the
    GELU; train mode is the float path. Sharded over a model axis
    (``model_shards`` > 1): ``copy_to_model``, this rank's fc1 columns,
    GELU and the hidden dropout on them, fc2's partial product summed over
    the model group (``partial_dense``, int8 too), its bias, then the
    dropout."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # fc1's outputs and fc2's inputs.
    model_shards = 1

    def __init__(self, dim: int, hidden_dim: int, dtype: torch.dtype,
                 drop_rate: float = 0.0, device=None, quant: bool = False,
                 quick_gelu: bool = False):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.quant = quant
        self.quick_gelu = quick_gelu
        self.fc1 = nn.Linear(dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, device=device)
        if quant:
            quantize_linear(self.fc1)
            quantize_linear(self.fc2)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        quant = self.quant and not train
        gelu = quick_gelu if quant and self.quick_gelu else F.gelu
        if self.model_shards > 1:  # fc1 column-, fc2 row-sharded: this rank's hidden units
            x = gelu(dense(self.fc1, copy_to_model(x), self.dtype, quant))
            x = dropout(x, self.drop_rate, train, generator, model_sharded=True)
            return dropout(partial_dense(self.fc2, x, self.dtype, quant), self.drop_rate,
                           train, generator)
        x = dense(self.fc1, x, self.dtype, quant)
        x = dropout(gelu(x), self.drop_rate, train, generator)
        x = dense(self.fc2, x, self.dtype, quant)
        return dropout(x, self.drop_rate, train, generator)


class LayerScale(nn.Module):
    """Learnable per-channel residual scale ``gamma``, initialised to
    ``init_value`` (``layers.py:151-158``)."""

    def __init__(self, dim: int, init_value: float = 1e-5, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def drop_path_schedule(rate: float, depth: int) -> Sequence[float]:
    """Linearly increasing stochastic-depth rates, 0 to ``rate`` over
    ``depth`` blocks (``layers.py:161-166``)."""
    if depth <= 1:
        return [rate] * depth
    return [rate * i / (depth - 1) for i in range(depth)]


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, rescaled so that the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_uniform_conv_(w: torch.Tensor,
                         generator: Optional[torch.Generator]) -> None:
    """flax's ``xavier_uniform`` on a torch [out, in / groups, kh, kw] conv
    weight: the fans are flax's, each channel count times the receptive
    field kh * kw."""
    cout, cin, kh, kw = w.shape
    limit = math.sqrt(6.0 / ((cin + cout) * kh * kw))
    w.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def jax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's default initialisers over every submodule:
    ``variance_scaling(2, fan_out, normal)`` for 2-D convolutions
    (``stem.py:36``), xavier-uniform for linears, ones / zeros for
    LayerNorms, zeros for every bias, normal(0.02) for a ``mask_token``
    (BatchNorm keeps its constructor state); then each module with other
    schemes (lecun-normal convolutions and linears, truncated-normal bias
    tables, embeddings) applies them in its ``reset_jax_init``."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            cout, _, kh, kw = m.weight.shape
            m.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            limit = math.sqrt(6.0 / (m.in_features + m.out_features))
            m.weight.uniform_(-limit, limit, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name, p in model.named_parameters():
        if name.split(".")[-1] == "mask_token":
            p.normal_(0.0, 0.02, generator=generator)
    for m in model.modules():
        if hasattr(m, "reset_jax_init"):
            m.reset_jax_init(generator)


def glu(x: torch.Tensor) -> torch.Tensor:
    """``a * sigmoid(b)`` over the two halves of the last axis."""
    a, b = x.chunk(2, dim=-1)
    return a * torch.sigmoid(b)
