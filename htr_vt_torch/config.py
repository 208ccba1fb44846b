"""Typed configuration system.

Replaces the reference's two generations of ``option.py`` argparse trees
(reference: ``model_v1/utils/option.py``, ``data/utils/option.py:100-148``)
with frozen dataclasses plus dataset presets (IAM / READ2016 / LAM) and a CLI
bridge that accepts the reference's flag spellings.

Every reference variant directory becomes a named preset over these configs —
see ``htr_vt_tpu.registry`` for the variant -> config mapping.

The port's own copy of ``htr_vt_tpu/config.py``, kept in step with it
(``tests/test_torch_stem_kernels.py``); the port imports nothing of
``htr_vt_tpu``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Masking (span / random / block / MMS) — reference:
#   model_v1/model/HTR_VT.py:202-220 (span)
#   model_sgm_mms_attach/model/HTR_VT.py:222-343 (random/block/span_old/mms)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MaskConfig:
    mode: str = "span"  # span | random | block | span_old | mms | none
    ratio: float = 0.3
    max_span_length: int = 4
    # MMS-union sub-ratios (random / block / span components of the union).
    mms_random_ratio: float = 0.3
    mms_block_ratio: float = 0.2
    mms_span_ratio: float = 0.2


@dataclass(frozen=True)
class SGMConfig:
    """Semantic Guidance Module auxiliary loss (reference: model_sgm_2/model/sgm_head.py)."""

    enable: bool = False
    detach_features: bool = False  # attach vs detach variant (train.py:67 in mms_attach/detach)
    sgm_lambda: float = 1.0
    ctc_lambda: float = 0.1
    sub_len: int = 5  # context length S on each side
    warmup_iters: int = 0
    char_emb_dim: int = 256
    num_heads: int = 4
    # Set by the trainer once the codec exists: codec classes + 4 control
    # tokens (<pad>/<eos>/<bos_left>/<bos_right>).
    vocab_size: int = 0


@dataclass(frozen=True)
class ModelConfig:
    # Encoder family, resolved through htr_vt_tpu.registry:
    #   vit (model_v1) | window (model_window) | macaron | localglobal | lgp |
    #   conformer | squeezeformer | swin | svtr | van | van2
    encoder: str = "vit"
    # Feature stem: resnet18 (baseline) | van | van2 (VAN height reducers).
    stem: str = "resnet18"
    # Head family: ctc (reference default) | encoder_decoder (autoregressive;
    # reference flags model_v1/utils/option.py:70-101, model missing upstream).
    model_type: str = "ctc"
    decoder_layers: int = 6
    decoder_heads: int = 8
    max_seq_len: int = 256
    label_smoothing: float = 0.1
    ed_vocab_size: int = 0  # set by the trainer from the tokenizer
    nb_cls: int = 80
    img_size: Tuple[int, int] = (64, 512)  # (H, W)
    patch_size: Tuple[int, int] = (4, 64)  # (w_stride, h_stride) as in reference create_model
    embed_dim: int = 768
    depth: int = 4
    num_heads: int = 6
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-6
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # Windowed attention (model_window/model/HTR_VT.py:114-154): 1-D windows on
    # the first `num_window_blocks` blocks, shifted on odd blocks.
    window_size: int = 16
    num_window_blocks: int = 2
    use_abs_pos_embed: bool = True  # model_window drops the absolute PE
    logit_layer_norm: bool = True   # parameterless LN over logits (model_v1/model/HTR_VT.py:239)
    input_layer_norm: bool = True   # parameterless LN over the raw image (:224)
    # Macaron conv-mixer blocks before the ViT stack (model_sgm_macaron).
    num_macaron_blocks: int = 2
    macaron_kernel: int = 7
    # Local-global variants.
    local_window: int = 12
    global_pool_len: int = 64
    # Conformer / SqueezeFormer depthwise kernel (ConvModule default k=3,
    # model_sgm_mms_conv/model/HTR_VT.py:124).
    conv_kernel: int = 3
    # SVTR preset name (tiny/small/base) when encoder == "svtr".
    svtr_preset: str = "tiny"
    # Computation dtype for matmuls ("bfloat16" for TPU speed, "float32" for parity tests).
    compute_dtype: str = "bfloat16"
    # Stem conv implementation: auto | pallas | xla (models/stem.py:_use_pallas).
    conv_impl: str = "auto"
    # Stem BN dataflow: plain (normalize-then-conv, fastest full-step train,
    # round-4 bisect) | folded (per-channel scale/shift; forced by
    # conv_impl=pallas, bn_stats_impl=pallas and int8 serving).
    conv_dataflow: str = "plain"
    # Stem first-pool implementation: auto | pallas | xla (ops/pool_fused.py).
    pool_impl: str = "auto"
    # Train-BN stats reduce: auto | pallas | xla (ops/bn_stats.py — one-pass
    # Pallas sum/sumsq; "auto" resolves to XLA per the measured verdict in
    # docs/PERF.md round 3).
    bn_stats_impl: str = "auto"
    # Global-attention implementation: auto | xla | flash.
    # "flash" = the Pallas TPU flash-attention kernel (streaming softmax, no
    # [B,H,N,N] materialization). "auto" picks flash on TPU once the token
    # count makes the quadratic attn matrix an HBM problem (N >= 256, i.e.
    # the 1024/2048-px width buckets; the flagship's N=128 stays on XLA where
    # the fused attention emitter is already fine). models/vit.py:resolve_attn_impl.
    attn_impl: str = "auto"
    # Quantized INFERENCE: "none" | "int8" (dynamic A8W8, ops/quant.py).
    # Applies to the eval path of the resnet18 stem + global-attention ViT
    # (the flagship); training always runs the float path.
    quant: str = "none"
    # Zero-pad the stage1 width (192 -> this many channels) on the int8
    # serving path so its convs hit the int8 MXU tiling that `_int8_pays`
    # requires (256-multiples). In exact arithmetic the logits are
    # unchanged: pad kernels, BN shifts and running means are zero, pad
    # gammas/vars one, so padded channels carry zeros through the whole
    # stage (test-pinned, tests/test_quant.py; in bf16 the different conv
    # tilings reorder f32 accumulations, a noise term below the int8
    # quantization floor). 0 = off. Checkpoints trained at 192 load through
    # ops/quant.py:serving_arrays / pad_stage1_tree. Only consulted when
    # quant == "int8" on the resnet18 stem. Default on: measured 4,665 ->
    # 5,500 img/s at the 512-px serving shape (round 5, docs/PERF.md).
    quant_stage1_pad: int = 256
    # GELU on the quantized serving path: "quick" = x*sigmoid(1.702x), one
    # transcendental instead of erf's chain — measured +10% int8 serving
    # throughput (4,663 vs 4,248 img/s, docs/PERF.md); "exact" keeps erf.
    # Only consulted when quant != "none"; training/float eval always use
    # exact GELU.
    quant_gelu: str = "quick"
    # Rematerialization (jax.checkpoint via flax.linen.remat) — trades one
    # extra forward recompute for not keeping activations alive across the
    # backward pass. "none" keeps XLA's default liveness; "blocks" remats
    # each encoder block; "all" also remats the ResNet stem (whose [B, H/2,
    # W, C] activations dominate the training footprint). Training-only: the
    # eval/serving trace never pays the recompute. Enables larger batches or
    # wider width-buckets on a fixed HBM budget (no reference analog — the
    # torch stack holds every activation, README.md:38 "24G").
    remat: str = "none"  # none | blocks | all
    masking: MaskConfig = field(default_factory=MaskConfig)
    sgm: SGMConfig = field(default_factory=SGMConfig)

    @property
    def grid_size(self) -> Tuple[int, int]:
        # Reference: MaskedAutoencoderViT.__init__ grid over (W/pw, H/ph) given
        # img_size passed reversed ([H,W]) and patch (4,64):
        # grid = [64//4, 512//64] = [16, 8] -> 128 tokens.
        h, w = self.img_size
        pw, ph = self.patch_size
        return (h // pw, w // ph)

    @property
    def num_tokens(self) -> int:
        gh, gw = self.grid_size
        return gh * gw


# ---------------------------------------------------------------------------
# Optimization — reference: model_v1/train.py:94 (SAM(AdamW)),
# utils/utils.py:42-52 (warmup-cosine), utils/utils.py:128-173 (EMA).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class OptimConfig:
    max_lr: float = 1e-3
    min_lr: float = 1e-7
    warmup_iters: int = 1000
    total_iters: int = 100_000
    weight_decay: float = 0.5
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-8
    sam_rho: float = 0.05
    sam_adaptive: bool = False
    ema_decay: float = 0.9999
    # Reference EMA is updated with num_updates = nb_iter / 2 because SAM does
    # two passes per iteration (model_v1/train.py:128).
    ema_halved_updates: bool = True
    grad_clip_norm: float = 0.0  # 0 disables (reference does not clip)


@dataclass(frozen=True)
class AugmentConfig:
    """Host-side augmentation parameters (reference: model_v1/utils/option.py:33-65,
    applied batch-level in data/dataset.py:13-45)."""

    enable: bool = True
    proj: float = 8.0
    dila_ero_max_kernel: int = 3
    dila_ero_iter: int = 1
    # Saturation/hue jitter are not represented: the pipeline (like the
    # reference's) operates on grayscale 'L' images, where torchvision's
    # ColorJitter saturation/hue components are mathematically identity. The
    # CLI still accepts --jitter-saturation/--jitter-hue for flag parity.
    jitter_brightness: float = 0.4
    jitter_contrast: float = 0.4
    proba: float = 0.5


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "IAM"  # IAM | READ | LAM | SYNTH
    train_list: str = "./data/iam/train.ln"
    val_list: str = "./data/iam/val.ln"
    test_list: str = "./data/iam/test.ln"
    data_path: str = "./data/iam/lines/"
    img_size: Tuple[int, int] = (64, 512)  # (H, W)
    train_bs: int = 128
    val_bs: int = 8
    num_workers: int = 8
    # Batch sampling: "epoch" = epoch-shuffled, each sample exactly once per
    # epoch (reference DataLoader(shuffle=True) + cycle_data,
    # data/dataset.py:169-172); "iid" = per-batch i.i.d. draws.
    sampling: str = "epoch"
    # Force the fork's enumerated ASCII+Vietnamese alphabet instead of the
    # data-derived one (reference: model_v1/data/dataset.py:60-81; the
    # mms_detach variant reverts to data-derived).
    vietnamese_charset: bool = False
    max_label_len: Optional[int] = None
    # Synthetic dataset knobs (for tests/bench when no real data is mounted).
    synth_train_size: int = 512
    synth_eval_size: int = 64
    synth_alphabet: str = "abcdefghijklmnopqrstuvwxyz '"
    synth_seed: int = 0
    augment: AugmentConfig = field(default_factory=AugmentConfig)


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout. The reference is single-GPU (SURVEY §2.8); here data
    parallelism over ICI is first-class and additional axes are available for
    the dry-run multi-chip path."""

    data_axis: str = "data"
    model_axis: str = "model"
    # mesh_shape: None -> (num_devices,) pure DP.
    mesh_shape: Optional[Tuple[int, ...]] = None
    sync_batch_norm: bool = True  # cross-replica BN stats under DP


@dataclass(frozen=True)
class TrainConfig:
    out_dir: str = "./output"
    exp_name: str = "iam_htr_vt_tpu"
    seed: int = 123
    total_iters: int = 100_000
    eval_iters: int = 1000
    print_iters: int = 100
    resume: Optional[str] = None
    # Transfer learning (reference model_v1/utils/option.py:96-99): initialize
    # weights from a checkpoint without optimizer state/step; optionally only
    # the encoder trunk (stem + blocks + norm), keeping a fresh head.
    load_model: Optional[str] = None
    load_encoder_only: bool = False
    keep_checkpoints: int = 5
    use_wandb: bool = False
    wandb_project: str = "None"
    profile_dir: Optional[str] = None  # torch.profiler trace output
    # Number of masked forwards averaged per loss (tri-masked MMS trainer uses
    # 3: random/block/span — reference model_sgm_mms_attach/train.py:76-97).
    tri_masked: bool = False
    # Gradient accumulation: split each batch into `grad_accum` microbatches
    # inside the jitted SAM step (lax.scan), accumulate both SAM gradient
    # passes, update once. Exact SAM semantics are preserved: the
    # perturbation uses the mean gradient over the FULL effective batch, the
    # same global-norm math as the unaccumulated step. BN statistics advance
    # per microbatch (standard accumulation semantics). Lets the reference's
    # bs-128 recipes run on memory-tight configurations (long width-buckets,
    # small HBM) with identical optimizer math. 1 disables.
    grad_accum: int = 1
    donate_state: bool = True
    # Failure detection (the reference has none, SURVEY §5): after this many
    # consecutive non-finite losses the loop saves an emergency checkpoint and
    # aborts; 0 disables.
    max_nonfinite_steps: int = 3


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Dataset presets — reference: data/utils/option.py:100-148 subparsers
# (IAM nb_cls 80, READ 90, LAM 90) and run/*.sh recipes.
# ---------------------------------------------------------------------------
_DATASET_PRESETS: Dict[str, Dict[str, Any]] = {
    "IAM": dict(
        nb_cls=80,
        train_list="./data/iam/train.ln",
        val_list="./data/iam/val.ln",
        test_list="./data/iam/test.ln",
        data_path="./data/iam/lines/",
    ),
    "READ": dict(
        nb_cls=90,
        train_list="./data/read2016/train.ln",
        val_list="./data/read2016/val.ln",
        test_list="./data/read2016/test.ln",
        data_path="./data/read2016/lines/",
    ),
    "LAM": dict(
        nb_cls=90,
        train_list="./data/LAM/train.ln",
        val_list="./data/LAM/val.ln",
        test_list="./data/LAM/test.ln",
        data_path="./data/LAM/lines/",
    ),
    "SYNTH": dict(nb_cls=30),
}


def dataset_preset(name: str, base: Optional[ExperimentConfig] = None) -> ExperimentConfig:
    """Build an ExperimentConfig for a named dataset with reference defaults."""
    name = name.upper()
    if name not in _DATASET_PRESETS:
        raise ValueError(f"unknown dataset {name!r}; choose from {sorted(_DATASET_PRESETS)}")
    p = _DATASET_PRESETS[name]
    cfg = base or ExperimentConfig()
    model = dataclasses.replace(cfg.model, nb_cls=p["nb_cls"])
    data_kw = {k: v for k, v in p.items() if k != "nb_cls"}
    data = dataclasses.replace(cfg.data, dataset=name, **data_kw)
    return dataclasses.replace(cfg, model=model, data=data)


def iam_recipe() -> ExperimentConfig:
    """The reference IAM training recipe (run/iam.sh): bs 128, SAM(AdamW),
    max-lr 1e-3, wd 0.5, 100k iters, mask 0.4 span 8, img 512x64."""
    cfg = dataset_preset("IAM")
    model = dataclasses.replace(
        cfg.model, masking=MaskConfig(mode="span", ratio=0.4, max_span_length=8)
    )
    return dataclasses.replace(cfg, model=model)


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg


def config_from_dict(cls, d: Dict[str, Any]):
    """Inverse of config_to_dict for checkpoint round-trips."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            kw[f.name] = config_from_dict(f.type, v)
        elif f.name in _NESTED_FIELDS.get(cls.__name__, {}):
            kw[f.name] = config_from_dict(_NESTED_FIELDS[cls.__name__][f.name], v)
        elif isinstance(v, list):
            kw[f.name] = tuple(v)
        else:
            kw[f.name] = v
    return cls(**kw)


_NESTED_FIELDS = {
    "ExperimentConfig": dict(
        model=ModelConfig, optim=OptimConfig, data=DataConfig,
        train=TrainConfig, parallel=ParallelConfig,
    ),
    "ModelConfig": dict(masking=MaskConfig, sgm=SGMConfig),
    "DataConfig": dict(augment=AugmentConfig),
}
