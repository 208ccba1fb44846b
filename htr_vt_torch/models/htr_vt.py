"""The HTR-VT model (port of ``htr_vt_tpu/models/htr_vt.py``).

    image [B, H, W, 1] NHWC float32 in [0, 1]
    -> parameterless LayerNorm over the whole image
    -> ResNet18 stem, or a VAN stem (``models/van.py``) -> tokens [B, N, D]
    -> (train) token masking with the learned mask token
    -> + fixed 2-D sin-cos position (a (1, N) grid behind a VAN stem)
    -> the encoder recipe's blocks (``models/variants.py``) -> LayerNorm
    -> head -> logit LayerNorm -> logits [B, N, nb_cls] float32
    -> (train, SGM) the SGM head's auxiliary loss on the normed features

Matmuls and convolutions run in ``cfg.compute_dtype``; norms, softmax, the
head and the logits are float32. ``train`` is an explicit argument, as in
JAX, and ``module.training`` is never read: train mode means batch-statistic
BatchNorm, masking and dropout. ``build_model`` also builds the JAX
package's standalone models: ``HTRSwin`` (``models/swin.py``), ``SVTR``
(``models/svtr.py``) and ``HTREncoderDecoder``
(``models/encoder_decoder.py``). ``quant="int8"`` is the A8W8 serving path
(``ops/quant.py``): the ResNet18 stem's tiling convs and the vit /
conformer / squeezeformer linears run int8 in eval, at a stage 1 padded to
``quant_stage1_pad`` where that applies; train mode is the float model.
``cfg.remat`` (``"blocks"``, ``"all"``) recomputes the encoder blocks' (and
under ``"all"`` the stem's) activations in the backward of a train forward
(``models/remat.py``). With the width sharded over the model axis
(``parallel/mesh.py:shard_width``), the image is this rank's strip of
columns: the input LayerNorm and the stem run on it, and the stem's tokens
are gathered over the model group, so masking, the position table, the
encoder and the head see the whole line on every rank of the group.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from htr_vt_torch.config import ModelConfig
from htr_vt_torch.models import masking, remat
from htr_vt_torch.models.layers import (global_layer_norm, jax_init_,
                                        sincos_pos_embed_2d)
from htr_vt_torch.models.registry import build_encoder_blocks
from htr_vt_torch.models.sgm import SGMHead
from htr_vt_torch.models.stem import ResNet18Stem
from htr_vt_torch.models.svtr import SVTR
from htr_vt_torch.models.swin import HTRSwin
from htr_vt_torch.models.van import VanStem
from htr_vt_torch.models.vit import ATTN_IMPLS
from htr_vt_torch.ops.quant import stage1_pad_applies
from htr_vt_torch.parallel.mesh import check_width, gather_from_model

VAN_STEMS = ("van", "van2")


class HTRVT(nn.Module):
    """The ResNet18 stem (a VAN stem under ``cfg.stem`` van / van2), the
    block recipe of ``cfg.encoder`` and the CTC head; with
    ``cfg.sgm.enable`` and a vocabulary size (the trainer sets it from the
    codec, ``train/loop.py``) also the SGM head, whose parameters then
    train, perturb and average with the others. ``generator`` seeds
    the JAX package's init schemes (``models/layers.py:jax_init_``);
    without one the weights keep torch's defaults.

    ``blocks[i]`` is the JAX module ``block_names[i]`` (``block0``,
    ``mixer0``, ``encoder``, ...). ``width_shards``: the model ranks that
    share the image's width (``parallel/mesh.py:shard_width``)."""

    width_shards = 1

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        self.dtype = dtype
        d = cfg.embed_dim
        if cfg.stem in VAN_STEMS:
            # built without the stem switches, as in JAX (htr_vt.py:71-74)
            self.patch_embed = VanStem(d, dtype, variant=cfg.stem, device=device)
        else:
            # int8 serving runs stage 1 at the padded width (htr_vt.py:73-90;
            # a training checkpoint loads through ops/quant.py:serving_arrays)
            widths = ((cfg.quant_stage1_pad, d // 2, d)
                      if stage1_pad_applies(cfg) else None)
            self.patch_embed = ResNet18Stem(
                d, dtype, device=device, dataflow=cfg.conv_dataflow,
                pool_impl=cfg.pool_impl, bn_stats_impl=cfg.bn_stats_impl,
                conv_impl=cfg.conv_impl, widths=widths, quant=cfg.quant == "int8")
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        # fixed sin-cos tables, one per (grid, device), outside the state_dict
        self._pos_tables: Dict[Tuple, torch.Tensor] = {}
        named = build_encoder_blocks(cfg, device)
        self.block_names = [name for name, _ in named]
        self.blocks = nn.ModuleList(block for _, block in named)
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, device=device)
        self.head = nn.Linear(d, cfg.nb_cls, device=device)
        self.sgm_head = None
        if cfg.sgm.enable and cfg.sgm.vocab_size > 0:
            self.sgm_head = SGMHead(d, cfg.sgm.vocab_size, dtype,
                                    char_emb_dim=cfg.sgm.char_emb_dim, device=device)
        if generator is not None:
            jax_init_(self, generator)

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
                generator: Optional[torch.Generator] = None,
                mask_mode: Optional[str] = None, mask_ratio: Optional[float] = None,
                sgm_batch: Optional[Dict[str, torch.Tensor]] = None,
                return_features: bool = False):
        """[B, H, W, 1] float32 -> logits [B, N, nb_cls] float32, at any
        width the stem takes: the position table follows the image's grid,
        ``(H // patch_size[0], W // patch_size[1])``, or ``(1, N)`` behind a
        VAN stem, whose tokens are one row (``htr_vt.py:110-115``). Width
        sharded over M model ranks, ``image`` is this rank's strip [B, H,
        W / M, 1] (``parallel/mesh.py:rank_width``), W the image's whole
        width, and the logits are the whole line's on every rank.

        ``train``: batch-statistic BatchNorm (moving the running statistics
        in place), token masking and dropout, drawing from ``generator``.
        ``mask_mode`` / ``mask_ratio`` override the config's strategy
        (``models/masking.py:build_keep_mask``). ``keep``: a float [B, N, 1]
        keep mask to use in place of a drawn one (train mode with masking
        on only).

        ``sgm_batch`` (``sgm_left``, ``sgm_right``, ``sgm_tgt``,
        ``sgm_mask``): also the SGM head's loss, on the normed features or
        their detached copy (``cfg.sgm.detach_features``). Returns, as the
        JAX ``__call__`` does (``htr_vt.py:138-152``): logits; (logits,
        sgm_loss) with an SGM batch; (logits, feats) with
        ``return_features``; (logits, feats, sgm_loss) with both."""
        cfg = self.cfg
        shards = self.width_shards
        if shards > 1:
            check_width(image.shape[2] * shards, shards,
                        getattr(self.patch_embed, "width_halo", 1))
        x = image.float()
        if cfg.input_layer_norm:
            x = global_layer_norm(x, width_sharded=shards > 1)
        # remat (htr_vt.py:63-69): under "blocks" each encoder block, under
        # "all" the stem too, recomputes its activations in the backward
        remat_stem = train and cfg.remat == "all"
        remat_blocks = train and cfg.remat in ("blocks", "all")
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        if remat_stem:
            x = remat.run(self.patch_embed, x, train=True)
        else:
            x = self.patch_embed(x, train=train)
        b = x.shape[0]
        # NHWC token order, as the JAX reshape of [B, H', W', D]; a width
        # strip's tokens gathered on W' first
        x = x.permute(0, 2, 3, 1)
        if shards > 1:
            x = gather_from_model(x, dim=2)
        tokens = x.reshape(b, -1, cfg.embed_dim)
        n = tokens.shape[1]
        tokens = masking.mask_tokens(tokens, cfg.masking, self.mask_token, train, keep,
                                     generator, mask_mode, mask_ratio)
        if cfg.use_abs_pos_embed:
            grid = ((1, n) if cfg.stem in VAN_STEMS else
                    (image.shape[1] // cfg.patch_size[0],
                     image.shape[2] * shards // cfg.patch_size[1]))
            tokens = tokens + self.pos_table(grid)[:n].to(self.dtype)
        for block in self.blocks:
            if remat_blocks:
                tokens = remat.run(block, tokens, train=True, generator=generator,
                                   replay=generator)
            else:
                tokens = block(tokens, train=train, generator=generator)
        feats = self.norm(tokens.float())
        logits = self.head(feats)
        if cfg.logit_layer_norm:
            logits = global_layer_norm(logits)
        out = (logits, feats) if return_features else (logits,)
        if sgm_batch is not None:
            if self.sgm_head is None:
                raise ValueError("an SGM batch needs cfg.sgm.enable and "
                                 "cfg.sgm.vocab_size > 0")
            f = feats.detach() if cfg.sgm.detach_features else feats
            out += (self.sgm_head(f, sgm_batch["sgm_left"], sgm_batch["sgm_right"],
                                  sgm_batch["sgm_tgt"], sgm_batch["sgm_mask"],
                                  train=train, generator=generator),)
        return out[0] if len(out) == 1 else out


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
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Model factory over the whole zoo, on the card unless ``device`` says
    otherwise (no card raises), dispatched as JAX's (``htr_vt.py:159-176``):
    ``model_type="encoder_decoder"`` builds ``HTREncoderDecoder`` around
    the ``HTRVT`` trunk; ``encoder="swin"`` and ``"svtr"`` the standalone
    ``HTRSwin`` and ``SVTR``; every other encoder ``HTRVT`` with the
    recipe's blocks, behind the ResNet18 or a VAN stem. ``cfg.remat``
    reaches ``HTRVT`` (and so the encoder-decoder's trunk); ``HTRSwin`` and
    ``SVTR`` take it and ignore it, as JAX's do."""
    check_switches(cfg)
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to "
                           "build the model on the CPU")
    kw = dict(device=device, generator=generator)
    if cfg.model_type == "encoder_decoder":
        from htr_vt_torch.models.encoder_decoder import HTREncoderDecoder
        return HTREncoderDecoder(cfg, cfg.ed_vocab_size, cfg.decoder_layers,
                                 cfg.decoder_heads, cfg.max_seq_len, **kw)
    if cfg.encoder == "swin":
        return HTRSwin(cfg, **kw)
    if cfg.encoder == "svtr":
        return SVTR(cfg, **kw)
    return HTRVT(cfg, **kw)
