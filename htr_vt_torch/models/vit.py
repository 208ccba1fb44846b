"""ViT encoder blocks (port of ``htr_vt_tpu/models/vit.py``): the global
attention, the 1-D windowed attention of ``model_window`` and the pre-norm
block over either.

Train mode adds the projection and MLP dropout and drop-path, each drawing
from an explicit ``torch.Generator``; the JAX attention has no dropout on
the attention weights, so neither has this one.

``attn_impl`` picks the global attention of each block as
``resolve_attn_impl`` decides: ``multi_head_attention`` (plain torch, the
stock ops) or ``flash_mha`` (the K5 kernels, ``ops/flash_attn.py``). A site
with a relative-position bias or a mask fuses it into the attention, so it
stays on the stock ops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.models.layers import (DropPath, LayerScale, Mlp, dense,
                                        dropout, quantize_linear, row_dense)
from htr_vt_torch.ops.flash_attn import flash_attention, takes_head_dim
from htr_vt_torch.parallel.mesh import copy_to_model

ATTN_IMPLS = ("auto", "xla", "flash")
MASKED_LOGIT = -1e9


def resolve_attn_impl(impl: str, n: int, head_dim: int, fused: bool = False,
                      on_cuda: bool = False) -> str:
    """Pick the attention of a global-attention site (``vit.py:28-64``):
    ``"flash"`` (K5, streaming softmax over 128-key blocks, so the [B, H, N,
    N] matrix never reaches device memory) or ``"xla"`` (the stock ops).

    The JAX decisions, with "on a TPU" read as "the tensor is on CUDA":
    ``"auto"`` takes flash on CUDA when N >= 256 (the 1024/2048-px width
    buckets; the flagship's N = 128 stays on the stock ops) and N and
    head_dim are multiples of 128, and never where something is fused
    (dropout on the attention weights). An explicit ``"flash"`` is held to
    the same shape and fusion gates and raises on a shape it cannot take.
    One difference from JAX, which raises on an explicit ``"flash"`` off a
    TPU: here it is allowed on any device, and a CPU tensor runs the
    kernels' plain versions, as ``conv_impl="pallas"`` does on the CPU.
    ``"auto"`` routes to flash only a head_dim the kernels take
    (``ops/flash_attn.py:takes_head_dim``: every multiple of 128, so the
    decisions are JAX's), never one whose kernel would raise."""
    if impl == "xla":
        return "xla"
    if impl == "flash":
        if fused:
            raise ValueError("attn_impl='flash' cannot fuse bias/mask/dropout "
                             "inside attention at this site; use 'xla' or "
                             "'auto' (auto routes fused sites to the stock ops)")
        if n % 128 or head_dim % 128:
            raise ValueError(
                f"attn_impl='flash' needs N and head_dim to be multiples of "
                f"128 (kernel block constraint); got N={n}, head_dim="
                f"{head_dim} — use 'auto' to take the stock ops on such shapes")
        return "flash"
    if impl != "auto":
        raise ValueError(f"unknown attn_impl {impl!r} (auto | xla | flash)")
    if fused or n < 256 or n % 128 or not takes_head_dim(head_dim):
        return "xla"
    return "flash" if on_cuda else "xla"


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              out_dtype: torch.dtype) -> torch.Tensor:
    """Flash attention with ``multi_head_attention``'s contract, bias- and
    mask-free (``vit.py:67-74``): q, k, v [B, H, N, D] -> [B, N, H*D]."""
    out = flash_attention(q, k, v, scale)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d).to(out_dtype)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, out_dtype: torch.dtype,
                         bias: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v (``vit.py:77-93``). q, k, v: [..., H,
    N, D] -> [..., N, H*D] (any leading batch dims); bias broadcasts to
    [..., H, N, N]; mask (True = keep) sets the logits it drops to -1e9.

    The logits are the exact float32 products of the compute-dtype q and k
    (upcast operands = bf16 inputs with an f32 result), the softmax is
    float32, and the attention is cast back to v's dtype before ``· v``."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        attn = attn + bias.float()
    if mask is not None:
        attn = torch.where(mask, attn, MASKED_LOGIT)
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn.to(v.dtype), v)
    *lead, h, n, d = out.shape
    return out.transpose(-3, -2).reshape(*lead, n, h * d).to(out_dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C / H]."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def relative_bias(table: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """[1, H, n, n] from a (2 * size - 1, H) table indexed by the reference's
    ``(j - i) + size - 1`` (``vit.py:129-133,178-182``)."""
    pos = torch.arange(n, device=table.device)
    return table[pos[None, :] - pos[:, None] + size - 1].permute(2, 0, 1)[None]


class Attention(nn.Module):
    """Global multi-head self-attention with a fused qkv projection
    (``vit.py:96-146``, float path). ``attn_drop`` only steers
    ``resolve_attn_impl``, as in JAX: no dropout acts on the weights.
    ``rel_bias_len`` > 0 adds a learned relative-position bias over the
    whole sequence, a (2 * rel_bias_len - 1, H) table initialised to zeros
    (the global blocks of ``model_window``); a longer sequence raises.
    ``quant``: qkv and proj are int8 sites in eval (``layers.py:dense``).

    Sharded over a model axis (``model_shards`` = M > 1,
    ``parallel/mesh.py:shard_model``): ``copy_to_model``, this rank's qkv
    rows (q, k and v of H / M heads) and ``rel_bias`` columns, attention
    over those heads, proj's partial product over their columns summed
    over the model group (``layers.py:partial_dense``; int8 as well), its
    bias, then the dropout."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # the heads.
    model_shards = 1

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype, proj_drop: float = 0.0,
                 attn_drop: float = 0.0, attn_impl: str = "auto",
                 rel_bias_len: int = 0, device=None, quant: bool = False):
        super().__init__()
        self.quant = quant
        self.num_heads = num_heads
        self.dtype = dtype
        self.proj_drop = proj_drop
        self.attn_drop = attn_drop
        self.attn_impl = attn_impl
        self.rel_bias_len = rel_bias_len
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        if rel_bias_len:
            self.rel_bias = nn.Parameter(
                torch.zeros(2 * rel_bias_len - 1, num_heads, device=device))
        self.proj = nn.Linear(dim, dim, device=device)
        if quant:
            quantize_linear(self.qkv)
            quantize_linear(self.proj)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        heads = self.num_heads // self.model_shards
        quant = self.quant and not train
        if self.model_shards > 1:
            x = copy_to_model(x)
        qkv = dense(self.qkv, x, self.dtype, quant)
        # [B, N, 3, H, D] -> 3 x [B, H, N, D]
        q, k, v = qkv.reshape(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
        bias = None
        if self.rel_bias_len:
            if n > self.rel_bias_len:
                raise ValueError(f"sequence length {n} exceeds rel_bias_len "
                                 f"{self.rel_bias_len}")
            bias = relative_bias(self.rel_bias, n, self.rel_bias_len)
        impl = resolve_attn_impl(self.attn_impl, n, head_dim,
                                 fused=(self.attn_drop > 0 and train)
                                 or bias is not None,
                                 on_cuda=x.is_cuda)
        if impl == "flash":
            out = flash_mha(q, k, v, head_dim**-0.5, self.dtype)
        else:
            out = multi_head_attention(q, k, v, head_dim**-0.5, self.dtype, bias=bias)
        out = row_dense(self.proj, out, self.dtype, self.model_shards > 1, quant)
        return dropout(out, self.proj_drop, train, generator)


class WindowAttention1D(nn.Module):
    """1-D windowed attention with a learned relative-position bias
    (``vit.py:149-235``): the N tokens are cut into windows of
    ``window_size``; with ``shift`` the sequence rolls left by
    ``window_size // 2`` first and back after. A sequence that the window
    does not divide is right-padded to a multiple and the padded keys are
    masked. ``wrap_shift`` (the reference's semantics, the default) lets the
    last shifted window mix the sequence's head and tail; False masks those
    pairs, Swin-style.

    Sharded over a model axis (``model_shards`` = M > 1), as ``Attention``:
    ``copy_to_model``, this rank's H / M heads of qkv and their
    ``rel_bias`` columns, the same windows and masks, and proj's partial
    product summed over the model group."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # the heads.
    model_shards = 1

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: bool,
                 qkv_bias: bool, dtype: torch.dtype, proj_drop: float = 0.0,
                 wrap_shift: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.dtype = dtype
        self.proj_drop = proj_drop
        self.wrap_shift = wrap_shift
        self.rel_bias = nn.Parameter(
            torch.zeros(2 * window_size - 1, num_heads, device=device))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        """The table's truncated normal(0.02), cut at two deviations."""
        nn.init.trunc_normal_(self.rel_bias, 0.0, 0.02, -0.04, 0.04, generator=generator)

    def _mask(self, b: int, n: int, n_pad: int, device) -> Optional[torch.Tensor]:
        """[B * Np / w, 1, w, w] True = keep, or None where nothing is
        masked (``vit.py:201-223``)."""
        w, shift = self.window_size, self.shift
        pos = torch.arange(n_pad, device=device)
        mask = None
        if shift and not self.wrap_shift:
            last = pos // w == n_pad // w - 1
            orig_seg = (pos + shift) % n_pad >= n_pad - shift
            seg = torch.where(last, orig_seg.long(), 0).reshape(n_pad // w, w)
            mask = seg[:, :, None] == seg[:, None, :]
        if n_pad > n:
            valid = torch.roll(pos < n, -shift) if shift else pos < n
            key_ok = valid.reshape(n_pad // w, w)[:, None, :]
            mask = key_ok if mask is None else mask & key_ok
        return None if mask is None else mask[:, None].repeat(b, 1, 1, 1)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        w, shift = self.window_size, self.shift
        head_dim = c // self.num_heads
        h = self.num_heads // self.model_shards  # this rank's heads
        n_pad = -(-n // w) * w
        if n_pad > n:
            x = F.pad(x, (0, 0, 0, n_pad - n))
        if shift:
            x = torch.roll(x, -shift, dims=1)
        if self.model_shards > 1:
            x = copy_to_model(x)
        qkv = dense(self.qkv, x, self.dtype)

        def windows(t):  # [B, Np, h * hd] -> [B * Np / w, h, w, hd]
            return split_heads(t.reshape(b * n_pad // w, w, h * head_dim), h)

        q, k, v = (windows(t) for t in qkv.chunk(3, dim=-1))
        out = multi_head_attention(q, k, v, head_dim**-0.5, self.dtype,
                                   bias=relative_bias(self.rel_bias, w, w),
                                   mask=self._mask(b, n, n_pad, x.device))
        out = out.reshape(b, n_pad, h * head_dim)
        if shift:
            out = torch.roll(out, shift, dims=1)
        out = row_dense(self.proj, out[:, :n], self.dtype, self.model_shards > 1)
        return dropout(out, self.proj_drop, train, generator)


class Block(nn.Module):
    """Pre-norm transformer block (``vit.py:238-296``): float32 LayerNorms,
    the residual stream in the compute dtype. ``attention``: ``"global"``,
    ``"window"`` or ``"window_shifted"``; ``init_values`` adds LayerScale
    to both branches. ``quant`` makes the global attention's and the MLP's
    linears int8 sites (the windowed attention stays float, as in JAX) and
    ``quick_gelu`` the int8 MLP's GELU."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool, layer_norm_eps: float, dtype: torch.dtype,
                 drop: float = 0.0, drop_path: float = 0.0,
                 attn_drop: float = 0.0, attn_impl: str = "auto",
                 attention: str = "global", window_size: int = 16,
                 rel_bias_len: int = 0, init_values: Optional[float] = None,
                 device=None, quant: bool = False, quick_gelu: bool = False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        if attention == "global":
            self.attn = Attention(dim, num_heads, qkv_bias, dtype, proj_drop=drop,
                                  attn_drop=attn_drop, attn_impl=attn_impl,
                                  rel_bias_len=rel_bias_len, device=device,
                                  quant=quant)
        elif attention in ("window", "window_shifted"):
            self.attn = WindowAttention1D(dim, num_heads, window_size,
                                          attention == "window_shifted", qkv_bias,
                                          dtype, proj_drop=drop, device=device)
        else:
            raise ValueError(f"unknown attention kind {attention!r}")
        if init_values:
            self.ls1 = LayerScale(dim, init_values, device=device)
            self.ls2 = LayerScale(dim, init_values, device=device)
        else:
            self.ls1 = self.ls2 = nn.Identity()
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate=drop,
                       device=device, quant=quant, quick_gelu=quick_gelu)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(train=train, generator=generator)
        y = self.attn(self.norm1(x.float()).to(self.dtype), **kw)
        x = x + self.drop_path1(self.ls1(y), **kw)
        y = self.mlp(self.norm2(x.float()).to(self.dtype), **kw)
        return x + self.drop_path2(self.ls2(y), **kw)
