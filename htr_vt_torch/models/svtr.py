"""SVTR (port of ``htr_vt_tpu/models/svtr.py``): a three-stage local/global
mixing recognizer.

    image [B, 64, 512, 1] -> two 3x3 stride-2 conv + BN + ReLU embeds
    -> tokens [B, 16 * 128, D0] -> (train) token masking
    -> stage 0 at (16, 128) -> merge0 (3x3 conv, stride (2, 1)) + LN
    -> stage 1 at (8, 128) -> merge1 + LN -> stage 2 at (4, 128)
    -> mean over the height -> combine_fc + exact GELU + dropout 0.1
    -> head -> logits [B, 128, nb_cls] float32

The first half of each stage's MixingBlocks attend locally (a (7, 11)
neighbourhood mask), the rest globally; both attend over every token of
the grid through the plain ``multi_head_attention`` (the local mask only
masks), as in JAX: at 64x512 the first stage's logits are [B, H, 2048,
2048] float32. The local masks depend on the grid only; they are made from
the input's shape and cached per (grid, device). Presets tiny / small /
base / large (``svtr.py:33-38``).

Over a model axis a MixingBlock is sharded as Swin's block
(``models/swin.py``): its heads' rows of qkv and its MLP units, the heads'
outputs gathered for the replicated ``proj``. With the image's width
sharded over the model axis (``parallel/mesh.py:shard_width``), the two
embeds run on this rank's strip of columns: each stride-2 conv takes one
column from its left neighbour (``models/stem.py:_conv_w2``), each BN sums
over the mesh, and the tokens are gathered on the width before masking;
the mixing blocks and the merges see the whole map.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from htr_vt_torch.config import ModelConfig
from htr_vt_torch.models.layers import Mlp, conv2d, dense, jax_init_
from htr_vt_torch.models.sgm import SGMHead
from htr_vt_torch.models.stem import BatchNorm, _conv_w2
from htr_vt_torch.models import masking
from htr_vt_torch.models.swin import _combine_and_heads
from htr_vt_torch.models.vit import multi_head_attention, split_heads
from htr_vt_torch.parallel.mesh import check_width, copy_to_model, gather_from_model

SVTR_PRESETS = {
    "tiny": dict(embed_dims=(64, 128, 256), depths=(3, 6, 3), num_heads=(2, 4, 8)),
    "small": dict(embed_dims=(96, 192, 256), depths=(3, 6, 6), num_heads=(3, 6, 8)),
    "base": dict(embed_dims=(128, 256, 384), depths=(3, 6, 9), num_heads=(4, 8, 12)),
    "large": dict(embed_dims=(192, 256, 512), depths=(3, 9, 9), num_heads=(6, 8, 16)),
}
# The reference's anti-blank-collapse head bias (svtr.py:153-156).
HEAD_BIAS_BLANK, HEAD_BIAS_OTHER = -3.0, 0.1


def local_neighborhood_mask(h: int, w: int, hk: int = 7, wk: int = 11) -> np.ndarray:
    """[H*W, H*W] bool, True where attention is allowed: |dh| <= hk // 2
    and |dw| <= wk // 2 (``svtr.py:41-49``)."""
    hi = np.arange(h * w) // w
    wi = np.arange(h * w) % w
    dh = np.abs(hi[:, None] - hi[None, :])
    dw = np.abs(wi[:, None] - wi[None, :])
    return (dh <= hk // 2) & (dw <= wk // 2)


class MixingBlock(nn.Module):
    """Pre-LN multi-head self-attention (its ``qkv`` without bias),
    optionally local-masked, + MLP(4x) (``svtr.py:52-84``). Sharded over a
    model axis (``model_shards`` = M > 1): ``copy_to_model``, this rank's
    H / M heads of qkv, attention over them under the same [N, N] mask,
    the heads gathered (``gather_from_model``), the replicated ``proj``;
    the MLP as ``layers.py:Mlp``."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # the heads.
    model_shards = 1

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 local: bool = False, local_k: Tuple[int, int] = (7, 11), device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.local = local
        self.local_k = tuple(local_k)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, 4 * dim, dtype, device=device)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def local_mask(self, h: int, w: int, device) -> torch.Tensor:
        """The [1, 1, N, N] neighbourhood mask of an (h, w) grid, made once
        per grid and device (outside inference mode: a train forward's
        backward saves it, whichever forward made it first)."""
        key = (h, w, device)
        if key not in self._masks:
            with torch.inference_mode(False):
                self._masks[key] = torch.from_numpy(
                    local_neighborhood_mask(h, w, *self.local_k))[None, None].to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor, hw: Tuple[int, int], *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c = x.shape[-1]
        sharded = self.model_shards > 1
        y = self.norm1(x.float()).to(self.dtype)
        q, k, v = (split_heads(t, self.num_heads // self.model_shards)
                   for t in dense(self.qkv, copy_to_model(y) if sharded else y,
                                  self.dtype).chunk(3, -1))
        mask = self.local_mask(*hw, x.device) if self.local else None
        out = multi_head_attention(q, k, v, (c // self.num_heads)**-0.5, self.dtype,
                                   mask=mask)
        x = x + dense(self.proj, gather_from_model(out) if sharded else out, self.dtype)
        y = self.norm2(x.float()).to(self.dtype)
        return x + self.mlp(y, train=train, generator=generator)


class SVTR(nn.Module):
    """The standalone SVTR recognizer of ``cfg.svtr_preset``
    (``svtr.py:87-170``), with the SGM head on its combined features under
    ``cfg.sgm.enable``. Module names are the JAX ones (``embed_conv1``,
    ``embed_bn1``, ``stage{si}_block{j}``, ``merge{si}``,
    ``merge{si}_norm``, ``combine_fc``, ``head``). ``width_shards``: the
    model ranks that share the image's width
    (``parallel/mesh.py:shard_width``)."""

    width_shards = 1

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        self.dtype = dtype
        preset = SVTR_PRESETS[cfg.svtr_preset]
        dims, depths, heads = preset["embed_dims"], preset["depths"], preset["num_heads"]
        self.dims, self.depths = dims, depths
        self.embed_conv1 = nn.Conv2d(1, dims[0] // 2, 3, stride=2, padding=1, device=device)
        self.embed_bn1 = BatchNorm(dims[0] // 2, device=device)
        self.embed_conv2 = nn.Conv2d(dims[0] // 2, dims[0], 3, stride=2, padding=1,
                                     device=device)
        self.embed_bn2 = BatchNorm(dims[0], device=device)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dims[0], device=device))
        for si in range(len(dims)):
            for j in range(depths[si]):
                setattr(self, f"stage{si}_block{j}",
                        MixingBlock(dims[si], heads[si], dtype, local=j < depths[si] // 2,
                                    device=device))
            if si < len(dims) - 1:
                setattr(self, f"merge{si}", nn.Conv2d(dims[si], dims[si + 1], 3,
                                                      stride=(2, 1), padding=1,
                                                      device=device))
                setattr(self, f"merge{si}_norm",
                        nn.LayerNorm(dims[si + 1], eps=1e-6, device=device))
        self.combine_fc = nn.Linear(dims[-1], dims[-1], device=device)
        self.head = nn.Linear(dims[-1], cfg.nb_cls, device=device)
        self.sgm_head = None
        if cfg.sgm.enable and cfg.sgm.vocab_size > 0:
            self.sgm_head = SGMHead(dims[-1], cfg.sgm.vocab_size, dtype,
                                    char_emb_dim=cfg.sgm.char_emb_dim, device=device)
        if generator is not None:
            jax_init_(self, generator)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        """The head bias: -3 on the blank, 0.1 elsewhere."""
        self.head.bias.fill_(HEAD_BIAS_OTHER)
        self.head.bias[0] = HEAD_BIAS_BLANK

    def forward(self, image: torch.Tensor, *, train: bool = False,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_mode: Optional[str] = None, mask_ratio: Optional[float] = None,
                sgm_batch: Optional[Dict[str, torch.Tensor]] = None,
                return_features: bool = False):
        """[B, H, W, 1] float32 -> logits [B, W/4, nb_cls] float32; the
        arguments and returns of ``HTRVT.forward`` (a width-sharded model
        takes this rank's strip [B, H, W / M, 1])."""
        dt = self.dtype
        shards = self.width_shards
        if shards > 1:
            check_width(image.shape[2] * shards, shards)
        x = image.permute(0, 3, 1, 2).to(dt)
        for conv, bn in ((self.embed_conv1, self.embed_bn1),
                         (self.embed_conv2, self.embed_bn2)):
            x = (_conv_w2(x, conv.weight, conv.stride, conv.bias) if shards > 1
                 else conv2d(conv, x, dt))
            x = torch.relu(bn(x, train=train).to(dt))
        x = x.permute(0, 2, 3, 1)
        if shards > 1:
            x = gather_from_model(x, dim=2)
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = masking.mask_tokens(tokens, self.cfg.masking, self.mask_token, train, keep,
                                     generator, mask_mode, mask_ratio)
        hw = (h, w)
        for si, depth in enumerate(self.depths):
            for j in range(depth):
                tokens = getattr(self, f"stage{si}_block{j}")(
                    tokens, hw, train=train, generator=generator)
            if si < len(self.dims) - 1:
                y = tokens.reshape(b, hw[0], hw[1], -1).permute(0, 3, 1, 2)
                y = conv2d(getattr(self, f"merge{si}"), y, dt)
                hw = (y.shape[2], y.shape[3])
                tokens = y.permute(0, 2, 3, 1).reshape(b, hw[0] * hw[1], -1)
                tokens = getattr(self, f"merge{si}_norm")(tokens.float()).to(dt)
        feats = tokens.reshape(b, hw[0], hw[1], -1).mean(dim=1)
        return _combine_and_heads(self, feats, train, generator, sgm_batch,
                                  return_features)
