"""HTR-VT-Swin (port of ``htr_vt_tpu/models/swin.py``): a truncated ResNet
-> 1x1 projection -> three 2-D Swin stages with height-only patch merging
-> height pooling -> CTC head.

    image [B, H, W, 1] -> stem [B, d/2, 4, W/4] -> proj [B, d, 4, W/4]
    -> tokens [B, 4 * W/4, d] (row-major, as the JAX reshape of NHWC)
    -> (train) token masking -> stage 0 at (4, W/4), windows (4, 8)
    -> merge0 -> stage 1 at (2, W/4), windows (2, 8) -> merge1
    -> stage 2 at (1, W/4), windows (1, 8) -> mean over the height
    -> combine_fc + exact GELU + dropout 0.1 -> head -> logits [B, W/4, C]

Odd blocks of a stage shift their windows by half a window: the map rolls
by (-sh, -sw) before attention and by (sh, sw) after, and a [nW, N, N] mask
keeps tokens of different original regions apart (``swin.py:48-66``). The
windows are taken batch-major, [B, nWh, nWw, wh, ww, C], and the mask
broadcasts over the batch through a view. The relative-position bias
gathers a ((2 wh - 1)(2 ww - 1), H) table by ``_rel_bias_index``, whose row
offset is scaled by 2 ww - 1. Index, masks and bias depend on the token
grid only; they are made from the input's shape and cached per (grid,
window, device), so one model takes any width whose token row the windows
divide. Attention is the plain ``multi_head_attention``, never flash, as
in JAX.

Over a model axis a block keeps its heads' rows of qkv and columns of
``rel_bias`` and its MLP units (JAX's rules shard ``qkv``, ``mlp/fc1`` and
``mlp/fc2``); the heads' outputs are gathered (``gather_from_model``) for
the replicated ``proj``, which JAX's rules leave whole. With the image's
width sharded over the model axis (``parallel/mesh.py:shard_width``), the
stem and ``proj`` run on this rank's strip of columns
(``models/stem.py``) and their tokens are gathered on the width before
masking; the Swin stages, their windows and the merges see the whole map
on every rank of the model group.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.config import ModelConfig
from htr_vt_torch.models import masking
from htr_vt_torch.models.layers import (Mlp, conv2d, dense, dropout, jax_init_,
                                        lecun_normal_, xavier_uniform_conv_)
from htr_vt_torch.models.sgm import SGMHead
from htr_vt_torch.models.stem import ResNet18Stem
from htr_vt_torch.models.vit import multi_head_attention, split_heads
from htr_vt_torch.parallel.mesh import check_width, copy_to_model, gather_from_model

COMBINE_DROP = 0.1


def _rel_bias_index(wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position index inside a (wh, ww) window
    (``swin.py:35-45``): [wh * ww, wh * ww] into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _shift_mask(h: int, w: int, wh: int, ww: int, sh: int, sw: int
                ) -> Optional[np.ndarray]:
    """[nW, wh * ww, wh * ww] bool, True = allowed: after a cyclic shift,
    tokens from different original regions must not attend to each other
    (``swin.py:48-66``); None without a shift."""
    if sh == 0 and sw == 0:
        return None
    img = np.zeros((h, w), np.int32)
    cnt = 0
    h_slices = [(0, h - wh), (h - wh, h - sh), (h - sh, h)] if sh else [(0, h)]
    w_slices = [(0, w - ww), (w - ww, w - sw), (w - sw, w)] if sw else [(0, w)]
    for hs, he in h_slices:
        for ws, we in w_slices:
            img[hs:he, ws:we] = cnt
            cnt += 1
    wins = img.reshape(h // wh, wh, w // ww, ww).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, wh * ww)
    return wins[:, :, None] == wins[:, None, :]


class SwinBlock2D(nn.Module):
    """LN -> (shifted) 2-D window attention with a relative-position bias
    -> residual -> LN -> MLP -> residual (``swin.py:69-129``). The shift is
    half the window on odd blocks, (0, 0) on even ones. Sharded over a
    model axis (``model_shards`` = M > 1): ``copy_to_model``, this rank's
    H / M heads of qkv and their ``rel_bias`` columns, the windowed
    attention over them, the heads gathered (``gather_from_model``), then
    the replicated ``proj``; the MLP as ``layers.py:Mlp``."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # the heads.
    model_shards = 1

    def __init__(self, dim: int, num_heads: int, window: Tuple[int, int],
                 shift: Tuple[int, int], mlp_ratio: float, dtype: torch.dtype,
                 drop: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.window = tuple(window)
        self.shift = tuple(shift)
        self.dtype = dtype
        wh, ww = self.window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.rel_bias = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads, device=device))
        self.proj = nn.Linear(dim, dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate=drop, device=device)
        self._tables: Dict[Tuple, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        """The table's truncated normal(0.02), cut at two deviations."""
        nn.init.trunc_normal_(self.rel_bias, 0.0, 0.02, -0.04, 0.04, generator=generator)

    def tables(self, h: int, w: int, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the bias index [N * N], the shift mask [nW, 1, N, N] or None)
        of an (h, w) token grid, made once per grid and device (outside
        inference mode: a train forward's backward saves them, whichever
        forward made them first)."""
        key = (h, w, device)
        if key not in self._tables:
            with torch.inference_mode(False):
                self._tables[key] = self._make_tables(h, w, device)
        return self._tables[key]

    def _make_tables(self, h: int, w: int, device):
        wh, ww = self.window
        idx = torch.from_numpy(_rel_bias_index(wh, ww).reshape(-1)).to(device)
        mask = _shift_mask(h, w, wh, ww, *self.shift)
        if mask is not None:
            mask = torch.from_numpy(mask)[:, None].to(device)
        return idx, mask

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = hw
        wh, ww = self.window
        sh, sw = self.shift
        b, n, c = x.shape
        if n != h * w or h % wh or w % ww:
            raise ValueError(f"a ({h}, {w}) grid of {n} tokens does not take "
                             f"({wh}, {ww}) windows")
        heads, hd = self.num_heads // self.model_shards, c // self.num_heads
        nwin, nh, nw = wh * ww, h // wh, w // ww
        idx, mask = self.tables(h, w, x.device)

        shortcut = x
        y = self.norm1(x.float()).to(self.dtype).reshape(b, h, w, c)
        if sh or sw:
            y = torch.roll(y, (-sh, -sw), dims=(1, 2))
        # window partition, batch-major: [B * nWh * nWw, wh * ww, C]
        y = y.reshape(b, nh, wh, nw, ww, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, nwin, c)
        if self.model_shards > 1:
            y = copy_to_model(y)
        q, k, v = (split_heads(t, heads) for t in dense(self.qkv, y, self.dtype).chunk(3, -1))
        bias = self.rel_bias[idx].reshape(nwin, nwin, heads).permute(2, 0, 1)[None]
        if mask is not None:
            # [B * nW, H, N, N] as a view of the per-image [nW, 1, N, N] mask
            q, k, v = (t.reshape(b, nh * nw, heads, nwin, hd) for t in (q, k, v))
            bias = bias[None]
        out = multi_head_attention(q, k, v, hd**-0.5, self.dtype, bias=bias, mask=mask)
        out = out.reshape(b * nh * nw, nwin, heads * hd)
        if self.model_shards > 1:
            out = gather_from_model(out)
        out = dense(self.proj, out, self.dtype)
        # reverse the partition and the shift
        out = out.reshape(b, nh, nw, wh, ww, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        if sh or sw:
            out = torch.roll(out, (sh, sw), dims=(1, 2))
        x = shortcut + out.reshape(b, n, c)
        y = self.norm2(x.float()).to(self.dtype)
        return x + self.mlp(y, train=train, generator=generator)


class HeightOnlyPatchMerging(nn.Module):
    """(2, 1)-strided conv without bias + LN: halves the height, doubles the
    channels (``swin.py:132-149``)."""

    def __init__(self, dim: int, out_dim: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.reduce = nn.Conv2d(dim, out_dim, (2, 1), stride=(2, 1), bias=False,
                                device=device)
        self.norm = nn.LayerNorm(out_dim, eps=1e-6, device=device)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        xavier_uniform_conv_(self.reduce.weight, generator)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        h, w = hw
        b, _, c = x.shape
        y = conv2d(self.reduce, x.reshape(b, h, w, c).permute(0, 3, 1, 2), self.dtype)
        h2 = h // 2
        y = y.permute(0, 2, 3, 1).reshape(b, h2 * w, -1)
        return self.norm(y.float()).to(self.dtype), (h2, w)


class HTRSwin(nn.Module):
    """The standalone Swin recognizer (``swin.py:152-234``) with its
    constructor defaults: ``d_model`` 192, depths (1, 1, 2), heads (6, 6,
    6), windows (4, 8) / (2, 8) / (1, 8), ``mlp_ratio`` 2. With
    ``cfg.sgm.enable`` and a vocabulary the SGM head takes the combined
    features. Module names are the JAX ones (``stem``, ``proj``,
    ``stage{si}_block{i}``, ``merge{si}``, ``combine_fc``, ``head``).
    ``width_shards``: the model ranks that share the image's width
    (``parallel/mesh.py:shard_width``)."""

    width_shards = 1

    def __init__(self, cfg: ModelConfig, d_model: int = 192,
                 stage_depths: Sequence[int] = (1, 1, 2),
                 stage_heads: Sequence[int] = (6, 6, 6),
                 stage_windows: Sequence[Tuple[int, int]] = ((4, 8), (2, 8), (1, 8)),
                 mlp_ratio: float = 2.0, drop: float = 0.0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        self.dtype = dtype
        d = d_model
        self.stem = ResNet18Stem(d, dtype, device=device, widths=[d // 4, d // 2],
                                 stage_strides=((2, 2), (2, 2)), final_maxpool=False)
        self.proj = nn.Conv2d(d // 2, d, 1, bias=False, device=device)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.stage_depths = tuple(stage_depths)
        dim = d
        for si, (depth, heads, win) in enumerate(zip(stage_depths, stage_heads,
                                                     stage_windows)):
            for i in range(depth):
                shift = (0, 0) if i % 2 == 0 else (win[0] // 2, win[1] // 2)
                setattr(self, f"stage{si}_block{i}",
                        SwinBlock2D(dim, heads, win, shift, mlp_ratio, dtype, drop,
                                    device=device))
            if si < 2:
                setattr(self, f"merge{si}",
                        HeightOnlyPatchMerging(dim, 2 * dim, dtype, device=device))
                dim *= 2
        self.combine_fc = nn.Linear(dim, dim, device=device)
        self.head = nn.Linear(dim, cfg.nb_cls, device=device)
        self.sgm_head = None
        if cfg.sgm.enable and cfg.sgm.vocab_size > 0:
            self.sgm_head = SGMHead(dim, cfg.sgm.vocab_size, dtype,
                                    char_emb_dim=cfg.sgm.char_emb_dim, device=device)
        if generator is not None:
            jax_init_(self, generator)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        """flax's default lecun-normal on the 1x1 ``proj``."""
        lecun_normal_(self.proj.weight, self.proj.in_channels, generator)

    def forward(self, image: torch.Tensor, *, train: bool = False,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_mode: Optional[str] = None, mask_ratio: Optional[float] = None,
                sgm_batch: Optional[Dict[str, torch.Tensor]] = None,
                return_features: bool = False):
        """[B, H, W, 1] float32 -> logits [B, W/4, nb_cls] float32; the
        arguments and returns of ``HTRVT.forward`` (a width-sharded model
        takes this rank's strip [B, H, W / M, 1])."""
        cfg = self.cfg
        shards = self.width_shards
        if shards > 1:
            check_width(image.shape[2] * shards, shards)
        x = self.stem(image.float().permute(0, 3, 1, 2), train=train)
        x = conv2d(self.proj, x, self.dtype).permute(0, 2, 3, 1)
        if shards > 1:
            x = gather_from_model(x, dim=2)
        b, h, w, d = x.shape
        tokens = x.reshape(b, h * w, d)
        tokens = masking.mask_tokens(tokens, cfg.masking, self.mask_token, train, keep,
                                     generator, mask_mode, mask_ratio)
        hw = (h, w)
        for si, depth in enumerate(self.stage_depths):
            for i in range(depth):
                tokens = getattr(self, f"stage{si}_block{i}")(
                    tokens, hw, train=train, generator=generator)
            if si < 2:
                tokens, hw = getattr(self, f"merge{si}")(tokens, hw)
        feats = tokens.reshape(b, hw[0], hw[1], -1).mean(dim=1)
        return _combine_and_heads(self, feats, train, generator, sgm_batch,
                                  return_features)


def _combine_and_heads(model: nn.Module, feats: torch.Tensor, train: bool,
                       generator: Optional[torch.Generator],
                       sgm_batch: Optional[Dict[str, torch.Tensor]],
                       return_features: bool):
    """The standalone models' tail (``swin.py:211-234``, ``svtr.py:145-170``):
    ``combine_fc`` + exact GELU + dropout 0.1 on the height-pooled
    features, the float32 head, and the SGM head on the combined features
    (or their detached copy). Returns as ``HTRVT.forward`` does."""
    cfg = model.cfg
    feats = F.gelu(dense(model.combine_fc, feats, model.dtype), approximate="none")
    feats = dropout(feats, COMBINE_DROP, train, generator)
    logits = dense(model.head, feats, torch.float32)
    out = (logits, feats) if return_features else (logits,)
    if sgm_batch is not None:
        if model.sgm_head is None:
            raise ValueError("an SGM batch needs cfg.sgm.enable and cfg.sgm.vocab_size > 0")
        f = feats.detach() if cfg.sgm.detach_features else feats
        out += (model.sgm_head(f, sgm_batch["sgm_left"], sgm_batch["sgm_right"],
                               sgm_batch["sgm_tgt"], sgm_batch["sgm_mask"],
                               train=train, generator=generator),)
    return out[0] if len(out) == 1 else out
