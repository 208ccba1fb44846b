"""Encoder recipes, one registered function per reference variant (port of
``htr_vt_tpu/models/variants.py``): vit (``model_v1``), window
(``model_window``), macaron / macaron_2 (``model_sgm_macaron*``),
localglobal (``model_sgm_localglobal``), lgp and lgp_svtr (``model_lgp``),
conformer (``model_sgm_mms_conv``) and squeezeformer
(``model_sgm_mms_conv_squeeze``). Each returns (JAX module name, module)
pairs, so the converter (``utils/convert.py``) maps the port's
``blocks.<i>`` onto the JAX tree's names.

van and van2 register as in JAX (the baseline blocks behind a VAN stem,
``models/van.py``); swin and svtr are standalone models
(``models/htr_vt.py:build_model``). Dropout rates that the JAX recipes fix in code (macaron's 0.1, the
conformer family's) are fixed here too.
"""

from __future__ import annotations

import dataclasses

import torch

from htr_vt_torch.config import ModelConfig
from htr_vt_torch.models.conv_blocks import (ConformerBlock, ConvLocalMixer1D,
                                             SqueezeFormerEncoder)
from htr_vt_torch.models.layers import drop_path_schedule
from htr_vt_torch.models.localglobal import LocalBlock1D, LocalGlobalParallelBlock
from htr_vt_torch.models.registry import register_encoder
from htr_vt_torch.models.vit import Block

# Dropout of the macaron mixers and global blocks (variants.py:81-87).
MACARON_DROP = 0.1


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _int8(cfg: ModelConfig) -> bool:
    """The int8 switch JAX passes its vit, conformer and squeezeformer
    recipes (``variants.py:34-35, 168-169, 187``); every other recipe stays
    float under ``quant="int8"``."""
    return cfg.quant == "int8"


def _named(prefix, blocks):
    return [(f"{prefix}{i}", b) for i, b in enumerate(blocks)]


@register_encoder("vit")
def vit_blocks(cfg: ModelConfig, device=None):
    """``depth`` global-attention pre-norm blocks (``variants.py:26-37``)."""
    return _named("block", [
        Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
              cfg.layer_norm_eps, _dtype(cfg), drop=cfg.drop_rate,
              attn_drop=cfg.attn_drop_rate, attn_impl=cfg.attn_impl, device=device,
              quick_gelu=cfg.quant_gelu == "quick", quant=_int8(cfg))
        for _ in range(cfg.depth)])


@register_encoder("window")
def window_blocks(cfg: ModelConfig, device=None):
    """The first ``num_window_blocks`` blocks attend in windows, odd ones
    shifted; the rest are global with a full-sequence relative bias table,
    so they run on the stock ops and refuse a sequence past
    ``num_tokens``. Linear drop-path schedule (``variants.py:40-65``)."""
    dps = drop_path_schedule(cfg.drop_path_rate, cfg.depth)
    blocks = []
    for i in range(cfg.depth):
        if i < cfg.num_window_blocks:
            kind = "window_shifted" if i % 2 == 1 else "window"
        else:
            kind = "global"
        blocks.append(Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                            cfg.layer_norm_eps, _dtype(cfg), drop=cfg.drop_rate,
                            attn_drop=cfg.attn_drop_rate, drop_path=dps[i],
                            attention=kind, window_size=cfg.window_size,
                            rel_bias_len=cfg.num_tokens, device=device))
    return _named("block", blocks)


def _global_block(cfg: ModelConfig, device, drop=0.0, attn_drop=0.0, mlp_ratio=None,
                  num_heads=None):
    return Block(cfg.embed_dim, num_heads or cfg.num_heads, mlp_ratio or cfg.mlp_ratio,
                 True, cfg.layer_norm_eps, _dtype(cfg), drop=drop, attn_drop=attn_drop,
                 attn_impl=cfg.attn_impl, device=device)


def _mixers(cfg: ModelConfig, device):
    return _named("mixer", [
        ConvLocalMixer1D(cfg.embed_dim, _dtype(cfg), cfg.macaron_kernel, MACARON_DROP,
                         device=device)
        for _ in range(cfg.num_macaron_blocks)])


@register_encoder("macaron")
def macaron_blocks(cfg: ModelConfig, device=None):
    """Two ConvLocalMixer1D ahead of the global blocks, dropout 0.1 and
    mlp_ratio 3 (``variants.py:78-89``)."""
    return _mixers(cfg, device) + _named("block", [
        _global_block(cfg, device, MACARON_DROP, MACARON_DROP, mlp_ratio=3.0)
        for _ in range(cfg.depth)])


@register_encoder("macaron_2")
def macaron2_blocks(cfg: ModelConfig, device=None):
    """The same mixers; global blocks of 4 heads, mlp_ratio 4, no dropout
    (``variants.py:92-102``)."""
    return _mixers(cfg, device) + _named("block", [
        _global_block(cfg, device, mlp_ratio=4.0, num_heads=4)
        for _ in range(cfg.depth)])


@register_encoder("localglobal")
def localglobal_blocks(cfg: ModelConfig, device=None):
    """[local window, local shifted, global, global] (``variants.py:105-120``)."""
    def local(shifted):
        return LocalBlock1D(cfg.embed_dim, cfg.num_heads, cfg.local_window, _dtype(cfg),
                            shifted=shifted, mlp_ratio=cfg.mlp_ratio,
                            layer_norm_eps=cfg.layer_norm_eps, device=device)

    return _named("block", [local(False), local(True), _global_block(cfg, device),
                            _global_block(cfg, device)])


@register_encoder("lgp")
def lgp_blocks(cfg: ModelConfig, device=None):
    """Every block a parallel local || pooled-global block
    (``variants.py:123-136``)."""
    return _named("block", [
        LocalGlobalParallelBlock(cfg.embed_dim, cfg.num_heads, cfg.local_window,
                                 _dtype(cfg), g_tokens=cfg.global_pool_len,
                                 mlp_ratio=cfg.mlp_ratio,
                                 layer_norm_eps=cfg.layer_norm_eps, device=device)
        for _ in range(cfg.depth)])


@register_encoder("lgp_svtr")
def lgp_svtr_blocks(cfg: ModelConfig, device=None):
    """``num_window_blocks`` unshifted window blocks, then global ones, all
    with qkv bias; the global ones on ``attn_impl="auto"``, as JAX builds
    them (``variants.py:139-163``)."""
    return _named("block", [
        Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, True, cfg.layer_norm_eps,
              _dtype(cfg), drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate,
              attention="window" if i < cfg.num_window_blocks else "global",
              window_size=cfg.window_size, device=device)
        for i in range(cfg.depth)])


@register_encoder("conformer")
def conformer_blocks(cfg: ModelConfig, device=None):
    """Conformer blocks (``variants.py:166-178``)."""
    return _named("block", [
        ConformerBlock(cfg.embed_dim, cfg.num_heads, _dtype(cfg), cfg.mlp_ratio,
                       conv_kernel=cfg.conv_kernel, layer_norm_eps=cfg.layer_norm_eps,
                       attn_impl=cfg.attn_impl, device=device, quant=_int8(cfg))
        for _ in range(cfg.depth)])


@register_encoder("squeezeformer")
def squeezeformer_blocks(cfg: ModelConfig, device=None):
    """One two-stage SqueezeFormer encoder (``variants.py:181-193``)."""
    return [("encoder", SqueezeFormerEncoder(
        cfg.embed_dim, cfg.num_heads, _dtype(cfg), depth=cfg.depth,
        mlp_ratio=cfg.mlp_ratio, conv_kernel=cfg.conv_kernel,
        drop_path_total=cfg.drop_path_rate, layer_norm_eps=cfg.layer_norm_eps,
        attn_impl=cfg.attn_impl, device=device, quant=_int8(cfg)))]


# ---------------------------------------------------------------------------
# Per-variant ModelConfig presets (variants.py:196-223).
# ---------------------------------------------------------------------------
VARIANT_PRESETS = {
    "vit": {},
    "window": dict(use_abs_pos_embed=False, logit_layer_norm=False,
                   drop_path_rate=0.1),
    "macaron": {},
    "macaron_2": {},
    "localglobal": {},
    "lgp": dict(depth=3),
    "lgp_svtr": dict(depth=6, num_window_blocks=3, window_size=11),
    "conformer": dict(input_layer_norm=False),
    "squeezeformer": dict(drop_path_rate=0.1, input_layer_norm=False),
    "van": dict(stem="van"),
    "van2": dict(stem="van2"),
    "swin": {},
    "svtr": {},
}


def apply_variant_preset(cfg: ModelConfig) -> ModelConfig:
    preset = VARIANT_PRESETS.get(cfg.encoder, {})
    return dataclasses.replace(cfg, **preset) if preset else cfg


@register_encoder("van")
def van_blocks(cfg: ModelConfig, device=None):
    """The baseline global blocks behind the VAN stem (``variants.py:226-230``)."""
    return vit_blocks(cfg, device)


@register_encoder("van2")
def van2_blocks(cfg: ModelConfig, device=None):
    return vit_blocks(cfg, device)
