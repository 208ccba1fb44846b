"""ResNet18 feature stem (port of ``htr_vt_tpu/models/stem.py``).

Collapses a [B, 1, 64, 512] line image to [B, C, 1, 128]; the default
stride plan (``stem.py:8``)::

    conv1 (2,1) -> maxpool3 (2,1) -> stage1 (2,1) -> stage2 (2,2)
    -> stage3 (2,2) -> maxpool3 (2,1)

Runs NCHW with channels_last memory. Two BatchNorm dataflows share one set
of parameters, as in JAX (``stem.py:174-194``):

- ``folded``: every BN yields a float32 per-channel (scale, shift)
  (``BatchNorm.fold``, JAX's ``FoldedBatchNorm``, ``stem.py:96-143``) that
  the next conv's prologue or the block's float32 epilogue applies. Eval
  always runs it (running statistics); train runs it with batch
  statistics when ``conv_dataflow="folded"`` or ``bn_stats_impl="pallas"``.
  Its ReLUs are ``torch.maximum`` against 0, whose gradient at a tie is one
  half, as ``jnp.maximum``'s.
- ``plain`` (train only): flax's BatchNorm, normalise then conv, the BN
  output cast to the compute dtype and the residual sum and ReLU in it.

Train statistics are float32 with the biased variance ``E[x^2] - E[x]^2``
(clamped at 0), and the running statistics move by ``0.9 * ra + 0.1 *
batch``; ``nn.BatchNorm2d`` would track the unbiased variance instead.
Under data parallelism (``htr_vt_torch/parallel/mesh.py``) the statistics
are the global batch's, as XLA computes them over the global array: the
per-channel sums and the element count are all-reduced before the mean and
variance are formed (``global_sums``), so the running statistics move
alike on every rank. The ranks of one data index hold the same rows, so a
model axis adds nothing to those sums, except where the stem's width is
sharded over it (``parallel/mesh.py:shard_width``): each rank then holds a
strip of columns, and the sums run over the whole mesh. JAX never reads
``ParallelConfig.sync_batch_norm`` and its BN is always global; the port
does not read it either. Inside a remat recompute (``models/remat.py``)
the running statistics stay put.
With ``bn_stats_impl="pallas"`` the sums come from the K2 kernel
(``ops/bn_stats.py``); with ``pool_impl="pallas"`` the entry's
BN-apply + ReLU + max-pool is the K3f/K3b kernel pair
(``ops/pool_fused.py``); with ``conv_impl="pallas"`` every stride-1 3x3
conv of the blocks is the K4f/K4d/K4w kernel trio (``ops/conv_fused.py``),
conv2 with the (s1, t1) prologue and a second block's conv1 without one.
``"auto"`` and ``"xla"`` take the stock ops, as ``"auto"`` does in JAX
(``stem.py:67-79``). The other convolutions (the entry conv, the strided
conv1s, the 1x1 projections) are ``F.conv2d`` in the compute dtype.
Width-sharded (``width_sharded``, set by ``shard_width``): every 3x3
window reads its neighbours' edge columns (``parallel/mesh.py:
halo_extend``). A window at W-stride 1 (the entry conv, the pools, stage
1's conv1, every stride-1 conv; the K3 and K4 kernels among them) runs
unchanged on the strip extended by a column on each inner side and its
outputs at the halo are cropped (``_windowed``): the kernels' BN prologue
comes before their padding, so the image's edges keep the op's own
padding. A W-stride-2 conv takes one column from the left, zeros at the
image's edge, and pads nothing on W (``_conv_w2``), so that its outputs
stay centred on even global columns; the strided 1x1 projection needs no
halo. BN statistics are taken on the cropped outputs only. Under int8
serving the sites route as the float ones: Q1 runs unchanged on a
halo-extended strip (its BN prologue, too, comes before its padding, so
the halo carries the neighbour's raw columns), an s8 carry crosses
``halo_extend`` as int8 with its scale, the s8 max-pool is windowed, and a
W-stride-2 int8 conv takes its left column and its zero rows explicitly
and pads nothing (``_left_column``). Every abs-max the int8 sites take
on a strip is the max over the model group (``ops/quant.py:
record_amax``, ``dynamic_amax``), so the scales are one process's.

Module and parameter names follow the reference state_dict
(``patch_embed.layer1.0.conv1.weight``, ...), so a checkpoint
converted by ``htr_vt_torch/utils/torch_convert.py`` loads with
``strict=True``.

int8 serving (``quant``, eval only; ``stem.py:217-335, 372-406``): each
block conv whose channels tile (``_int8_pays``, or a stage-1 entry conv of
a 256-padded stage 1) is an A8W8 site (``ops/quant.py``: the Q1 kernel on
the card); every other conv is the stock one, whatever ``conv_impl`` says,
and the block epilogues run in the compute dtype. With a stage 1 of at
least 256 channels on the 128 grid, bn1 + ReLU are quantized before the
entry max-pool, which pools the s8 values, and each block but the last
hands the next an s8 carry (q, scale) in static mode.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.models import remat
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.ops.bn_stats import BNStats
from htr_vt_torch.ops.conv_fused import (conv3x3_bn_relu,
                                         conv3x3_bn_relu_reference)
from htr_vt_torch.ops.pool_fused import max_pool_bn_relu
from htr_vt_torch.parallel.mesh import (all_reduce_sum, data_world, halo_extend,
                                        world_size)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _c(v: torch.Tensor) -> torch.Tensor:
    """A per-channel [C] vector shaped to broadcast over NCHW."""
    return v.view(-1, 1, 1)


def _relu_max(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: the gradient at an exact 0 is one half."""
    return torch.maximum(x, x.new_zeros(()))


def global_sums(s: torch.Tensor, q: torch.Tensor, n, mesh: bool = False):
    """Per-channel (sum, sum of squares) and the element count over the
    global batch: at data size 1 as given, else all three summed over the
    data axis in one differentiable all-reduce (K2's SPMD psum,
    ``htr_vt_tpu/ops/bn_stats.py:98-103``). Ranks of one data index hold
    the same rows, so the model axis is summed over only with ``mesh``:
    inside a width-sharded stem, whose model ranks hold strips of one
    image, the three are summed over every rank of the mesh. A BN after the
    tokens' gather (the conv blocks' over tokens) must not: its model ranks
    hold the same tokens, and the sum's backward would count each gradient
    M times."""
    size = world_size() if mesh else data_world()[1]
    if size == 1:
        return s, q, n
    c = s.shape[0]
    packed = all_reduce_sum(torch.cat([s, q, s.new_full((1,), float(n))]),
                            "mesh" if mesh else "data")
    return packed[:c], packed[c:2 * c], packed[2 * c]


def batch_moments(xf: torch.Tensor, dims, mesh: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x^2]) of float32 ``xf`` over ``dims``: the ``mean`` calls on
    one rank, else the global batch's from the all-reduced sums
    (``global_sums``; ``mesh`` as there)."""
    if (world_size() if mesh else data_world()[1]) == 1:
        return xf.mean(dims), xf.square().mean(dims)
    s, q, n = global_sums(xf.sum(dims), xf.square().sum(dims),
                          math.prod(xf.shape[d] for d in dims), mesh)
    return s / n, q / n


class BatchNorm(nn.Module):
    """BatchNorm state: ``weight``/``bias`` and ``running_mean``/
    ``running_var``, exactly the reference's keys (no
    ``num_batches_tracked``). ``width_sharded``: its statistics are summed
    over the whole mesh (``global_sums``)."""

    width_sharded = False

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    @torch.no_grad()
    def move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``ra = 0.9 * ra + 0.1 * batch`` in place, except inside a remat
        recompute, whose forward already moved them once."""
        if remat.recomputing():
            return
        m = BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def fold(self, x: Optional[torch.Tensor] = None, *,
             stats_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        """JAX's ``FoldedBatchNorm`` (``stem.py:108-143``): ``scale = gamma /
        sqrt(var + eps)``, ``shift = beta - mean * scale``, float32 [C].

        Without x, the running statistics (eval). With x [B, C, H, W], train
        mode: the batch statistics ``mu = s / n``, ``var = max(q / n -
        mu^2, 0)`` from the K2 kernel's sums (``stats_impl="pallas"``) or
        from float32 means, and the running statistics move in place."""
        if x is None:
            mu, var = self.running_mean, self.running_var
        else:
            if stats_impl == "pallas":
                s, q = BNStats.apply(x)
                s, q, n = global_sums(s, q, x.numel() // x.shape[1], self.width_sharded)
                mu = s / n
                var = _relu_max(q / n - mu.square())
            else:
                mu, ex2 = batch_moments(x.float(), (0, 2, 3), self.width_sharded)
                var = _relu_max(ex2 - mu.square())
            self.move_running(mu, var)
        scale = self.weight.float() * torch.rsqrt(var + BN_EPS)
        return scale, self.bias.float() - mu * scale

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """flax ``nn.BatchNorm`` over [B, C, H, W], float32 out: the batch
        statistics in train mode (``train_forward``), else ``(x - mean) *
        (gamma * rsqrt(var + eps)) + beta`` on the running statistics, as
        flax's ``_normalize`` rounds it (the VAN and SVTR BatchNorms)."""
        if train:
            return self.train_forward(x)
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        return (x.float() - _c(self.running_mean)) * _c(mul) + _c(self.bias)

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """flax ``nn.BatchNorm`` in train mode (float32 out): normalise by
        the batch statistics as ``(x - mean) * (gamma * rsqrt(var + eps)) +
        beta`` and move the running statistics in place (``stem.py:117-138``
        with flax's fast variance)."""
        xf = x.float()
        mean, ex2 = batch_moments(xf, (0, 2, 3), self.width_sharded)
        var = torch.clamp_min(ex2 - mean.square(), 0.0)
        self.move_running(mean, var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride, padding: int,
          dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(dtype), stride=stride, padding=padding)


def _proj_conv(conv: nn.Conv2d, x: torch.Tensor, stride: Tuple[int, int],
               dtype: torch.dtype) -> torch.Tensor:
    """The strided 1x1 projection as a subsample and a 1x1 conv: the same
    products and sums. CPU torch's backward of a strided 1x1 conv over a
    channels_last tensor corrupts memory; this form has none."""
    return F.conv2d(x[:, :, ::stride[0], ::stride[1]], conv.weight.to(dtype))


def _max_pool_3x3(x: torch.Tensor, stride: Tuple[int, int]) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=stride, padding=1)


def _windowed(op, x, sharded: bool, halo: int = 1,
              memory_format=torch.channels_last) -> torch.Tensor:
    """``op`` (a window at W-stride 1 that pads ``halo`` columns on each
    side: a 3x3 window's 1) on x; on a width strip, run on the strip
    extended by ``halo`` neighbour columns on each inner side, the outputs
    at those columns cropped (channels-last, as the kernels read it, or
    ``memory_format``). x may be an s8 carry (q, scale), whose int8 values
    cross the exchange."""
    if not sharded:
        return op(x)
    if isinstance(x, tuple):
        ext, lo, hi = halo_extend(x[0], halo, halo)
        y = op((ext, x[1]))
    else:
        ext, lo, hi = halo_extend(x, halo, halo)
        y = op(ext)
    return y[..., lo:y.shape[-1] - hi].contiguous(memory_format=memory_format)


def _conv_w2(x: torch.Tensor, weight: torch.Tensor, stride: Tuple[int, int],
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 3x3 conv at W-stride 2, padding 1, in x's dtype (a bias added in
    it), on a width strip (an even number of columns from an even global
    column): one column from the left neighbour or zeros at the image's
    edge, and no padding on W, so output j reads the strip's columns 2j -
    1 ... 2j + 1, as on the whole image."""
    ext, lo, _ = halo_extend(x, 1, 0)
    if not lo:
        ext = F.pad(ext, (1, 0))
    ext = ext.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(ext, weight.to(x.dtype), stride=stride, padding=(1, 0))
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


def _left_column(x):
    """A width strip (a tensor or an s8 carry (q, scale)) as a W-stride-2
    3x3 conv with padding 0 reads it: one column from the left neighbour
    (zeros at the image's edge) and a zero row above and below, channels
    last. Zeros padded before the quantization are zeros after it, so an
    int8 conv without a prologue gives ``_conv_w2``'s outputs."""
    q = x[0] if isinstance(x, tuple) else x
    ext, lo, _ = halo_extend(q, 1, 0)
    ext = F.pad(ext, (0 if lo else 1, 0, 1, 1)).contiguous(memory_format=torch.channels_last)
    return (ext, x[1]) if isinstance(x, tuple) else ext


def _int8_pays(cin: int, cout: int) -> bool:
    """Whether a conv runs int8 (``stem.py:48-63``): both widths on the 128
    grid and at least 256."""
    return cin % 128 == 0 and cout % 128 == 0 and min(cin, cout) >= 256


class BasicBlock(nn.Module):
    """ResNet BasicBlock. The ``folded`` dataflow (``stem.py:215-335``),
    eval and train, with its float32 epilogue::

        y1 = conv1(x);  y2 = conv2(bf16(max(y1 * s1 + t1, 0)))
        out = bf16(max(y2 * s2 + t2 + (p * sp + tp | x), 0))

    The ``plain`` train dataflow (``stem.py:192-214``), whose residual sum
    and ReLU run in the compute dtype::

        a = relu(bf16(bn1(conv1(x))));  y = bf16(bn2(conv2(a)))
        out = relu(y + (bf16(proj_bn(proj(x))) | x))

    Train mode takes ``plain`` only when ``dataflow="plain"``,
    ``conv_impl != "pallas"`` and ``bn_stats_impl != "pallas"``
    (``stem.py:192-194``). With ``conv_impl="pallas"`` the folded convs go
    through ``conv3x3_bn_relu`` (``stem.py:262-267, 281-283``): conv1
    without a prologue (the kernel at stride 1, ``F.conv2d`` otherwise),
    conv2 with (s1, t1); the epilogue stays eager, as it stays an XLA
    fusion in JAX.

    ``quant`` (eval only): the int8 dataflow of ``_quant_forward``.
    ``quant_entry`` makes a stage-1 entry conv (conv1, proj) int8 too;
    ``emit_quant`` returns the s8 carry in static mode.

    ``width_sharded``: x is a strip of columns; every 3x3 conv reads the
    neighbours' edge columns (``_windowed``, ``_conv_w2``)."""

    width_sharded = False

    def __init__(self, cin: int, cout: int, stride: Tuple[int, int],
                 use_projection: bool, dtype: torch.dtype, device=None, *,
                 dataflow: str = "plain", bn_stats_impl: str = "auto",
                 conv_impl: str = "auto", quant: bool = False,
                 quant_entry: bool = False, emit_quant: bool = False):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.dataflow = dataflow
        self.bn_stats_impl = bn_stats_impl
        self.conv_impl = conv_impl
        self.quant = quant
        self.emit_quant = quant and emit_quant
        sites = {"conv1": (cin, cout), "conv2": (cout, cout), "proj": (cin, cout)}
        self.int8_sites = set()
        if quant:
            for site, (c_in, c_out) in sites.items():
                entry = (quant_entry and site != "conv2" and c_out % 128 == 0
                         and c_out >= 256 and c_in % 64 == 0)
                if (site != "proj" or use_projection) and (_int8_pays(c_in, c_out)
                                                           or entry):
                    self.int8_sites.add(site)
                    q8.add_site(self, f"{site}_amax")
            if self.emit_quant:
                q8.add_site(self, "out_amax")
        self.conv1 = nn.Conv2d(cin, cout, 3, bias=False, device=device)
        self.bn1 = BatchNorm(cout, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, bias=False, device=device)
        self.bn2 = BatchNorm(cout, device=device)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, cout, 1, bias=False, device=device),
            BatchNorm(cout, device=device)) if use_projection else None)

    def forward(self, x, *, train: bool = False):
        if self.quant and not train:
            return self._quant_forward(x)
        x = x.to(self.dtype)
        if (train and self.dataflow == "plain" and self.conv_impl != "pallas"
                and self.bn_stats_impl != "pallas"):
            return self._plain_train_forward(x)
        return self._folded_forward(x, train)

    def _qconv(self, site: str, x, weight: torch.Tensor, stride,
               prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """One conv of the int8 dataflow (``stem.py:217-262``): the stock
        conv at a float site; at an int8 site the s8 carry goes straight in,
        else x (after the BN + ReLU prologue in the compute dtype) is
        quantized by the site's mode, or recorded with the float conv run
        when calibrating. bf16 out. On a width strip each site routes as
        the float stem's convs: W-stride 1 on the halo-extended strip
        (``_windowed``), W-stride 2 (conv1, which has no prologue) through
        ``_conv_w2`` at a float site and ``_left_column`` at an int8 one."""
        dt = self.dtype
        wide = self.width_sharded
        if site not in self.int8_sites:
            if isinstance(x, tuple):
                raise ValueError(f"{site}: an s8 carry reaches a float conv "
                                 "(an int8 stem at these widths is not a JAX "
                                 "configuration either)")
            if wide and stride[1] == 2:
                return _conv_w2(x, weight.to(dt), stride)
            scale, shift = prologue if prologue is not None else (None, None)
            return _windowed(lambda t: conv3x3_bn_relu_reference(
                t, weight.to(dt), scale, shift, stride=stride), x, wide)
        if wide and stride[1] == 2:
            return self._qconv_int8(site, _left_column(x), weight, stride, prologue, 0)
        return _windowed(lambda t: self._qconv_int8(site, t, weight, stride, prologue, 1),
                         x, wide)

    def _qconv_int8(self, site: str, x, weight: torch.Tensor, stride, prologue,
                    padding: int):
        """An int8 site's conv at ``padding`` on x, a tensor or an s8 carry."""
        dt = self.dtype
        kw = dict(weight_dtype=dt, module=self, key=site)
        if isinstance(x, tuple):
            return q8.conv_int8_bf16(None, weight, stride, padding, xq=x[0], sx=x[1], **kw)
        name = f"{site}_amax"
        mode, amax = q8.site_mode(self, name)
        if mode == "static":
            return q8.conv_int8_bf16(x, weight, stride, padding, amax=amax,
                                     prologue=prologue, **kw)
        a = q8.apply_prologue(x, *prologue) if prologue is not None else x
        if mode == "calibrate":
            q8.record_amax(self, name, a)
            return F.conv2d(a, weight.to(dt), stride=tuple(stride), padding=padding)
        return q8.conv_int8_bf16(a, weight, stride, padding,
                                 amax=q8.dynamic_amax(self, a), **kw)

    def _quant_forward(self, x):
        """The int8 serving block (``stem.py:286-335``): x bf16, or the
        previous block's s8 carry (q, scale); epilogue and residual in the
        compute dtype; the projection int8 (f32 dequant, then the cast)
        where its site is, from the carry with the bf16 dequant. Returns
        the s8 carry of its output in static mode when ``emit_quant``,
        else the output in the compute dtype."""
        dt = self.dtype
        pre = x if isinstance(x, tuple) else None
        if pre is None:
            x = x.to(dt)
        y1 = self._qconv("conv1", x, self.conv1.weight, self.stride)
        s1, t1 = self.bn1.fold()
        y2 = self._qconv("conv2", y1, self.conv2.weight, (1, 1), (s1, t1))
        s2, t2 = self.bn2.fold()
        if self.downsample is not None:
            conv, bn = self.downsample
            kw = dict(weight_dtype=dt, module=self, key="proj")
            if pre is not None:
                p = q8.conv_int8_bf16(None, conv.weight, self.stride, 0, xq=pre[0],
                                      sx=pre[1], **kw)
            else:
                mode = None
                if "proj" in self.int8_sites:
                    mode, amax = q8.activation_scale(self, "proj_amax", x)
                    if mode == "dynamic":
                        amax = q8.dynamic_amax(self, x)
                if mode in ("static", "dynamic"):
                    p = q8.conv_int8(x, conv.weight, self.stride, 0, amax=amax,
                                     **kw).to(dt)
                else:
                    p = _proj_conv(conv, x, self.stride, dt)
            sp, tp = bn.fold()
            residual = p.to(dt) * _c(sp).to(dt) + _c(tp).to(dt)
        elif pre is not None:
            residual = pre[0].to(dt) * pre[1].to(dt)
        else:
            residual = x
        out = _relu_max(y2.to(dt) * _c(s2).to(dt) + _c(t2).to(dt) + residual)
        if self.emit_quant:
            mode, amax = q8.activation_scale(self, "out_amax", out)
            if mode == "static":
                return q8.quantize_static(out, amax)
        return out

    def _folded_forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype

        def fold(bn: BatchNorm, y: torch.Tensor):
            return bn.fold(y if train else None, stats_impl=self.bn_stats_impl)

        conv = (conv3x3_bn_relu if self.conv_impl == "pallas"
                else conv3x3_bn_relu_reference)
        y1 = self._conv1(lambda t: conv(t, self.conv1.weight, stride=self.stride), x)
        s1, t1 = fold(self.bn1, y1)
        y2 = _windowed(lambda t: conv(t, self.conv2.weight, s1, t1), y1,
                       self.width_sharded)
        s2, t2 = fold(self.bn2, y2)
        if self.downsample is not None:
            conv, bn = self.downsample
            p = _proj_conv(conv, x, self.stride, dt)
            sp, tp = fold(bn, p)
            residual = p.float() * _c(sp) + _c(tp)
        else:
            residual = x.float()
        return _relu_max(y2.float() * _c(s2) + _c(t2) + residual).to(dt)

    def _conv1(self, op, x: torch.Tensor) -> torch.Tensor:
        """conv1 (``op``, its stride the block's) on x or its strip."""
        if self.width_sharded and self.stride[1] == 2:
            return _conv_w2(x, self.conv1.weight, self.stride)
        return _windowed(op, x, self.width_sharded)

    def _plain_train_forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self._conv1(lambda t: _conv(self.conv1, t, self.stride, 1, dt), x)
        y = torch.relu(self.bn1.train_forward(y).to(dt))
        y = _windowed(lambda t: _conv(self.conv2, t, 1, 1, dt), y, self.width_sharded)
        y = self.bn2.train_forward(y).to(dt)
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn.train_forward(
                _proj_conv(conv, x, self.stride, dt)).to(dt)
        return torch.relu(y + residual)


class ResNet18Stem(nn.Module):
    """[B, 1, H, W] -> [B, widths[-1], H', W'] (``stem.py:347-464``). The
    default plan is the flagship's: widths [D/4, D/2, D], stage strides
    ``STAGE_STRIDES`` and a final max-pool, [B, 1, 64, 512] -> [B, D, 1,
    128]. The VAN stems and Swin truncate it as data (``stem.py:352-358``):
    two stages [D/4, D/2] at (2, 2), (2, 2) without the final pool, or van2's
    [D/4, D/2, D] at (2, 1), (2, 2), (1, 2). conv1 is D/4 wide whatever the
    widths; a stage whose width or stride differs from its input's opens
    with the 1x1 projection (``needs_proj``, ``stem.py:444``).

    The entry BN + ReLU + max-pool takes one of three branches
    (``stem.py:408-435``): ``pool_impl="pallas"``, the folded BN (its
    statistics by ``bn_stats_impl``) and the fused K3f/K3b pool;
    ``bn_stats_impl="pallas"`` alone, the K2 statistics, a stock
    normalise + ReLU and a stock pool; else flax's BatchNorm (train) or the
    running statistics (eval, the same fold), ReLU and a stock pool.

    ``quant`` (eval only) runs the blocks' int8 dataflow. With a stage 1 of
    >= 256 channels on the 128 grid (``s1_int8_entry``) and the stock pool,
    the entry is bn1 + ReLU in float32, and in static mode its quantization
    (site ``pool_amax``) and the max-pool of the s8 values
    (``ops/quant.py:max_pool_s8``) feed the s8 chain; calibrate and dynamic
    pool the float values.

    ``width_sharded`` (``parallel/mesh.py:shard_width``): x is this rank's
    strip of columns and so is the output; every window reads the
    neighbours' edge columns, K3's the raw conv1 columns, since it applies
    the BN + ReLU itself."""

    width_sharded = False
    STAGE_STRIDES: Sequence[Tuple[int, int]] = ((2, 1), (2, 2), (2, 2))

    def __init__(self, embed_dim: int, dtype: torch.dtype, device=None, *,
                 dataflow: str = "plain", pool_impl: str = "auto",
                 bn_stats_impl: str = "auto", conv_impl: str = "auto",
                 widths: Optional[Sequence[int]] = None,
                 stage_strides: Sequence[Tuple[int, int]] = STAGE_STRIDES,
                 final_maxpool: bool = True, quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.pool_impl = pool_impl
        self.bn_stats_impl = bn_stats_impl
        self.final_maxpool = final_maxpool
        c = embed_dim // 4
        widths = [c, embed_dim // 2, embed_dim] if widths is None else list(widths)
        self.n_stages = len(widths)
        s1_int8_entry = quant and widths[0] % 128 == 0 and widths[0] >= 256
        self.s8_pool = s1_int8_entry and pool_impl != "pallas"
        if self.s8_pool:
            q8.add_site(self, "pool_amax")
        self.conv1 = nn.Conv2d(1, c, 3, bias=False, device=device)
        self.bn1 = BatchNorm(c, device=device)
        cin = c
        for i, (w, stride) in enumerate(zip(widths, stage_strides)):
            stride = tuple(stride)
            proj = stride != (1, 1) or cin != w
            kw = dict(device=device, dataflow=dataflow, bn_stats_impl=bn_stats_impl,
                      conv_impl=conv_impl, quant=quant,
                      quant_entry=s1_int8_entry and i == 0)
            last = i == self.n_stages - 1
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, w, stride, proj, dtype, **kw,
                           emit_quant=s1_int8_entry),
                BasicBlock(w, w, (1, 1), False, dtype, **kw,
                           emit_quant=s1_int8_entry and not last)))
            cin = w

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        # [B, 1, H, W] with the strides of a channels-last tensor (the
        # channel's stride 1) even at C = 1, where both layouts count as
        # contiguous and a view may carry any channel stride (0 from a numpy
        # image's new axis): cuDNN then writes conv1's output channels-last,
        # as the fused kernels read it.
        def entry(t):
            if t.stride(1) != 1:
                t = t.permute(0, 2, 3, 1).clone(
                    memory_format=torch.contiguous_format).permute(0, 3, 1, 2)
            return _conv(self.conv1, t, (2, 1), 1, dt)

        wide = self.width_sharded
        x = _windowed(entry, x.to(dt), wide)
        stats = x if train else None
        if self.s8_pool and not train:
            s1, t1 = self.bn1.fold()
            a = _relu_max(x.float() * _c(s1) + _c(t1))
            mode, amax = q8.site_mode(self, "pool_amax")
            if mode == "calibrate":
                q8.record_amax(self, "pool_amax", a.to(dt))
            if mode == "static":
                xq, sx = q8.quantize_static(a, amax)
                x = (_windowed(q8.max_pool_s8, xq, wide), sx)
            else:
                x = _windowed(lambda t: _max_pool_3x3(t, (2, 1)), a.to(dt), wide)
        elif self.pool_impl == "pallas":
            s1, t1 = self.bn1.fold(stats, stats_impl=self.bn_stats_impl)
            x = _windowed(lambda t: max_pool_bn_relu(t, s1, t1), x, wide)
        else:
            if train and self.bn_stats_impl != "pallas":
                # flax BN in f32, cast, then ReLU (stem.py:427-435)
                x = torch.relu(self.bn1.train_forward(x).to(dt))
            else:
                s1, t1 = self.bn1.fold(stats, stats_impl=self.bn_stats_impl)
                x = _relu_max(x.float() * _c(s1) + _c(t1)).to(dt)
            x = _windowed(lambda t: _max_pool_3x3(t, (2, 1)), x, wide)
        for i in range(self.n_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, train=train)
        if not self.final_maxpool:
            return x
        return _windowed(lambda t: _max_pool_3x3(t, (2, 1)), x, wide)
