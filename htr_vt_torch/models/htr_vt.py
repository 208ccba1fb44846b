"""The HTR-VT model (port of ``htr_vt_tpu/models/htr_vt.py``).

    image [B, H, W, 1] NHWC float32 in [0, 1]
    -> parameterless LayerNorm over the whole image
    -> ResNet18 stem -> tokens [B, N, D]
    -> (train) span masking with the learned mask token
    -> + fixed 2-D sin-cos position
    -> ``depth`` pre-norm ViT blocks -> LayerNorm -> head -> logit LayerNorm
    -> logits [B, N, nb_cls] float32

Matmuls and convolutions run in ``cfg.compute_dtype``; norms, softmax, the
head and the logits are float32. ``train`` is an explicit argument, as in
JAX, and ``module.training`` is never read: train mode means batch-statistic
BatchNorm, masking and dropout. SGM and remat are not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from htr_vt_torch.config import ModelConfig
from htr_vt_torch.models import masking
from htr_vt_torch.models.layers import global_layer_norm, sincos_pos_embed_2d
from htr_vt_torch.models.stem import ResNet18Stem
from htr_vt_torch.models.vit import ATTN_IMPLS, Block


class HTRVT(nn.Module):
    """Flagship ``model_v1`` recipe: ``encoder="vit"``, ``stem="resnet18"``,
    CTC head. ``generator`` seeds the JAX package's init schemes
    (``init_weights``); without one the weights keep torch's defaults."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        self.dtype = dtype
        d = cfg.embed_dim
        self.patch_embed = ResNet18Stem(
            d, dtype, device=device, dataflow=cfg.conv_dataflow,
            pool_impl=cfg.pool_impl, bn_stats_impl=cfg.bn_stats_impl,
            conv_impl=cfg.conv_impl)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        # fixed sin-cos tables, one per (grid, device), outside the state_dict
        self._pos_tables: Dict[Tuple, torch.Tensor] = {}
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                  cfg.layer_norm_eps, dtype, drop=cfg.drop_rate,
                  attn_drop=cfg.attn_drop_rate, attn_impl=cfg.attn_impl,
                  device=device)
            for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.head = nn.Linear(d, cfg.nb_cls, device=device)
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers: ``variance_scaling(2, fan_out,
        normal)`` for convolutions (``stem.py:36``), xavier-uniform for
        dense layers, normal(0.02) for ``mask_token``, ones/zeros for
        LayerNorms and biases (BatchNorm keeps its constructor state)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                cout, _, kh, kw = m.weight.shape
                m.weight.normal_(0.0, math.sqrt(2.0 / (kh * kw * cout)),
                                 generator=generator)
            elif isinstance(m, nn.Linear):
                limit = math.sqrt(6.0 / (m.in_features + m.out_features))
                m.weight.uniform_(-limit, limit, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.mask_token.normal_(0.0, 0.02, generator=generator)

    def pos_table(self, grid: Tuple[int, int]) -> torch.Tensor:
        """The float32 [gh * gw, D] sin-cos table of ``grid`` on the model's
        device, made once per grid: one module serves every width, as the
        JAX package's per-width modules share one parameter set
        (``htr_vt.py:114-116``, ``tools/train_multiwidth.py:109-124``)."""
        device = self.mask_token.device
        key = (tuple(grid), device)
        table = self._pos_tables.get(key)
        if table is None:
            table = torch.from_numpy(
                sincos_pos_embed_2d(self.cfg.embed_dim, grid)).to(device)
            self._pos_tables[key] = table
        return table

    @property
    def pos_embed(self) -> torch.Tensor:
        """The table of the configured width's grid (``cfg.grid_size``)."""
        return self.pos_table(self.cfg.grid_size)

    def forward(self, image: torch.Tensor, *, train: bool = False,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, H, W, 1] float32 -> logits [B, N, nb_cls] float32, at any
        width the stem takes: the position table follows the image's grid,
        ``(H // patch_size[0], W // patch_size[1])``.

        ``train``: batch-statistic BatchNorm (moving the running statistics
        in place), token masking and dropout, drawing from ``generator``.
        ``keep``: a float [B, N, 1] keep mask to use in place of a drawn one
        (train mode with masking on only)."""
        cfg = self.cfg
        x = image.float()
        if cfg.input_layer_norm:
            x = global_layer_norm(x)
        x = self.patch_embed(x.permute(0, 3, 1, 2), train=train)  # NHWC -> NCHW
        b = x.shape[0]
        # NHWC token order, as the JAX reshape of [B, H', W', D]
        tokens = x.permute(0, 2, 3, 1).reshape(b, -1, cfg.embed_dim)
        n = tokens.shape[1]
        if train and cfg.masking.mode != "none":
            if keep is None:
                keep = masking.build_keep_mask(generator, b, n, cfg.masking)
            tokens = masking.apply_mask(tokens, keep, self.mask_token)
        elif keep is not None:
            raise ValueError("a keep mask applies only in train mode with "
                             "masking on")
        if cfg.use_abs_pos_embed:
            grid = (image.shape[1] // cfg.patch_size[0],
                    image.shape[2] // cfg.patch_size[1])
            tokens = tokens + self.pos_table(grid)[:n].to(self.dtype)
        for block in self.blocks:
            tokens = block(tokens, train=train, generator=generator)
        logits = self.head(self.norm(tokens.float()))
        if cfg.logit_layer_norm:
            logits = global_layer_norm(logits)
        return logits


STEM_IMPLS = ("auto", "xla", "pallas")
DATAFLOWS = ("plain", "folded")


def check_switches(cfg: ModelConfig) -> None:
    """The kernel switches, read as in JAX (``config.py:100-122``): for the
    stem, ``"pallas"`` names the hand-written kernel that replaces that
    Pallas kernel, ``"auto"`` and ``"xla"`` the stock ops; ``attn_impl``
    is ``auto | xla | flash`` (``models/vit.py:resolve_attn_impl``)."""
    for name, allowed in (("conv_impl", STEM_IMPLS),
                          ("pool_impl", STEM_IMPLS),
                          ("bn_stats_impl", STEM_IMPLS),
                          ("conv_dataflow", DATAFLOWS),
                          ("attn_impl", ATTN_IMPLS)):
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"{name}={getattr(cfg, name)!r}: expected one of "
                             f"{allowed}")


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> HTRVT:
    """Model factory, on the card unless ``device`` says otherwise (no card
    raises). Only the flagship recipe is ported; every other encoder, stem
    and head is still queued in ROADMAP.md."""
    if cfg.model_type != "ctc":
        raise NotImplementedError(
            f"model_type={cfg.model_type!r} is not ported to htr_vt_torch yet "
            "(ROADMAP.md queue 1, item 10: variant zoo, encoder_decoder)")
    if cfg.encoder != "vit" or cfg.stem != "resnet18":
        raise NotImplementedError(
            f"encoder={cfg.encoder!r} / stem={cfg.stem!r} is not ported to "
            "htr_vt_torch yet (ROADMAP.md queue 1, item 10: variant zoo)")
    if cfg.quant != "none":
        raise NotImplementedError(
            f"quant={cfg.quant!r} is not ported to htr_vt_torch yet "
            "(ROADMAP.md queue 1, item 11: int8 serving)")
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported to htr_vt_torch yet "
            "(ROADMAP.md queue 1, item 13: memory levers (remat))")
    check_switches(cfg)
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to "
                           "build the model on the CPU")
    return HTRVT(cfg, device=device, generator=generator)
