"""CLI argument bridge.

Accepts the reference's flag spellings (model_v1/utils/option.py and the
upstream subparser generation data/utils/option.py:100-148) and produces a
typed ExperimentConfig. Dataset selection is a positional/--dataset argument
like the upstream ``python3 train.py ... IAM`` form.

The port's own copy of ``htr_vt_tpu/cli/args.py``, held to it recipe by
recipe by ``tests/test_torch_port_cli.py``, with three changes: the encoder
names and the variant presets are copied here (their JAX modules import
flax and jax), every flag parses as in JAX while ``build_model`` refuses
the encoders the port does not have yet, and ``--device`` (default
``cuda``) picks the device the entry points run on.
"""

from __future__ import annotations

import argparse
import dataclasses

from htr_vt_torch.config import (AugmentConfig, ExperimentConfig, MaskConfig,
                                 ModelConfig, SGMConfig, dataset_preset)

# The JAX package's encoder recipes (``models/registry.py:38-42``: the
# registered block recipes of ``models/variants.py`` plus swin and svtr).
ENCODERS = ("conformer", "lgp", "lgp_svtr", "localglobal", "macaron", "macaron_2",
            "squeezeformer", "svtr", "swin", "van", "van2", "vit", "window")

# Per-variant ModelConfig presets (``models/variants.py:196-218``).
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


def available_encoders():
    return sorted(ENCODERS)


def apply_variant_preset(cfg: ModelConfig) -> ModelConfig:
    preset = VARIANT_PRESETS.get(cfg.encoder, {})
    return dataclasses.replace(cfg, **preset) if preset else cfg


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("dataset", nargs="?", default="IAM",
                   choices=["IAM", "READ", "LAM", "SYNTH"],
                   help="dataset preset (sets nb_cls and data lists)")
    p.add_argument("--exp-name", type=str, default=None)
    p.add_argument("--out-dir", type=str, default="./output")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--resume", "--resume_checkpoint", dest="resume", type=str,
                   default=None)
    p.add_argument("--load-model", type=str, default=None,
                   help="initialize weights from a checkpoint (fresh optimizer)")
    p.add_argument("--load-encoder-only", action="store_true", default=False)

    # model
    p.add_argument("--encoder", type=str, default="vit",
                   help=f"encoder recipe: one of {available_encoders()}")
    p.add_argument("--nb-cls", type=int, default=None)
    p.add_argument("--img-size", type=int, nargs="+", default=[512, 64],
                   help="W H like the reference")
    p.add_argument("--mask-mode", type=str, default="span",
                   choices=["span", "span_old", "random", "block", "span_spacing",
                            "mms", "none"])
    p.add_argument("--mask-ratio", type=float, default=0.3)
    p.add_argument("--max-span-length", type=int, default=4)
    p.add_argument("--compute-dtype", type=str, default="bfloat16")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8"],
                   help="quantized INFERENCE path (not ported yet: int8 "
                        "raises, ROADMAP.md queue 1, item 11)")
    p.add_argument("--quant-gelu", type=str, default="quick",
                   choices=["quick", "exact"],
                   help="GELU flavor on the int8 serving path: quick = "
                        "sigmoid approximation (+10%% img/s), exact = erf")
    p.add_argument("--attn-impl", type=str, default="auto",
                   choices=["auto", "xla", "flash"],
                   help="global-attention implementation: flash = the "
                        "hand-written flash-attention kernels; auto = flash "
                        "on the card at N >= 256 tokens (the 1024/2048-px "
                        "width buckets), the stock ops otherwise")
    p.add_argument("--embed-dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=6)

    # encoder-decoder (reference model_v1/utils/option.py:70-101)
    p.add_argument("--model-type", type=str, default="ctc",
                   choices=["ctc", "encoder_decoder"])
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--decoder-heads", type=int, default=8)
    p.add_argument("--max-seq-len", type=int, default=256)
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--generation-method", type=str, default="greedy",
                   choices=["greedy", "nucleus", "beam_search"])
    p.add_argument("--generation-temperature", type=float, default=0.7)
    p.add_argument("--repetition-penalty", type=float, default=1.3)
    p.add_argument("--top-p", type=float, default=0.9)

    # sgm
    p.add_argument("--sgm-enable", action="store_true", default=False)
    p.add_argument("--sgm-detach", action="store_true", default=False)
    p.add_argument("--sgm-lambda", type=float, default=1.0)
    p.add_argument("--ctc-lambda", type=float, default=0.1)
    p.add_argument("--sgm-sub-len", type=int, default=5)
    p.add_argument("--sgm-warmup-iters", type=int, default=0)

    # optimization
    p.add_argument("--train-bs", type=int, default=128)
    p.add_argument("--val-bs", type=int, default=8)
    p.add_argument("--max-lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.5)
    p.add_argument("--total-iter", type=int, default=100000)
    p.add_argument("--warm-up-iter", type=int, default=1000)
    p.add_argument("--eval-iter", type=int, default=1000)
    p.add_argument("--print-iter", type=int, default=100)
    p.add_argument("--ema-decay", type=float, default=0.9999)
    p.add_argument("--sam-rho", type=float, default=0.05)
    p.add_argument("--tri-masked", action="store_true", default=False)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into N microbatches inside the "
                        "SAM step (not ported yet: N > 1 raises, ROADMAP.md "
                        "queue 1, item 13)")
    p.add_argument("--remat", type=str, default="none",
                   choices=["none", "blocks", "all"],
                   help="recompute encoder blocks ('blocks') or blocks+stem "
                        "('all') in the backward (not ported yet: raises, "
                        "ROADMAP.md queue 1, item 13)")

    # data / augmentation
    p.add_argument("--train-data-list", type=str, default=None)
    p.add_argument("--val-data-list", type=str, default=None)
    p.add_argument("--test-data-list", type=str, default=None)
    p.add_argument("--data-path", type=str, default=None)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--synth-train-size", type=int, default=None,
                   help="SYNTH dataset: number of generated train lines")
    p.add_argument("--synth-eval-size", type=int, default=None,
                   help="SYNTH dataset: number of generated val/test lines")
    p.add_argument("--synth-alphabet", type=str, default=None,
                   help="SYNTH dataset: character set to draw texts from "
                        "(e.g. a READ-style ~90-class set)")
    p.add_argument("--proj", type=float, default=8)
    p.add_argument("--dila-ero-max-kernel", type=int, default=3)
    p.add_argument("--dila-ero-iter", type=int, default=1)
    p.add_argument("--jitter-brightness", type=float, default=0.4)
    p.add_argument("--jitter-contrast", type=float, default=0.4)
    # Accepted for reference flag parity; identity on grayscale line images
    # (torchvision ColorJitter saturation/hue are no-ops on 'L' inputs), so
    # they are not forwarded into AugmentConfig.
    p.add_argument("--jitter-saturation", type=float, default=0.4)
    p.add_argument("--jitter-hue", type=float, default=0.2)
    p.add_argument("--proba", type=float, default=0.5)
    p.add_argument("--sampling", type=str, default="epoch",
                   choices=["epoch", "iid"],
                   help="epoch = epoch-shuffled like the reference DataLoader; "
                        "iid = per-batch i.i.d. draws")
    p.add_argument("--no-augment", action="store_true", default=False)
    p.add_argument("--vietnamese-charset", action="store_true", default=False)
    p.add_argument("--max-label-len", type=int, default=None,
                   help="drop training lines with longer labels (reference mln filter)")

    # misc
    p.add_argument("--use-wandb", action="store_true", default=False)
    p.add_argument("--wandb-project", type=str, default="None")
    p.add_argument("--profile-dir", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="device the entry point runs on: cuda (the card) or cpu")
    return p


def args_to_config(args: argparse.Namespace) -> ExperimentConfig:
    cfg = dataset_preset(args.dataset)
    w, h = (args.img_size + [64])[:2] if len(args.img_size) >= 2 else (512, 64)
    img_size = (h, w)  # reference passes [W, H] on the CLI

    model = dataclasses.replace(
        cfg.model,
        encoder=args.encoder,
        nb_cls=args.nb_cls or cfg.model.nb_cls,
        img_size=img_size,
        compute_dtype=args.compute_dtype,
        quant=args.quant, quant_gelu=args.quant_gelu,
        attn_impl=args.attn_impl, remat=args.remat,
        embed_dim=args.embed_dim, depth=args.depth, num_heads=args.num_heads,
        model_type=args.model_type, decoder_layers=args.decoder_layers,
        decoder_heads=args.decoder_heads, max_seq_len=args.max_seq_len,
        label_smoothing=args.label_smoothing,
        masking=MaskConfig(mode=args.mask_mode, ratio=args.mask_ratio,
                           max_span_length=args.max_span_length),
        sgm=SGMConfig(enable=args.sgm_enable, detach_features=args.sgm_detach,
                      sgm_lambda=args.sgm_lambda, ctc_lambda=args.ctc_lambda,
                      sub_len=args.sgm_sub_len, warmup_iters=args.sgm_warmup_iters))
    model = apply_variant_preset(model)

    optim = dataclasses.replace(
        cfg.optim, max_lr=args.max_lr, weight_decay=args.weight_decay,
        warmup_iters=args.warm_up_iter, total_iters=args.total_iter,
        ema_decay=args.ema_decay, sam_rho=args.sam_rho)

    data_kw = dict(img_size=img_size, train_bs=args.train_bs, val_bs=args.val_bs,
                   num_workers=args.num_workers, sampling=args.sampling,
                   vietnamese_charset=args.vietnamese_charset,
                   max_label_len=args.max_label_len,
                   augment=AugmentConfig(
                       enable=not args.no_augment, proj=args.proj,
                       dila_ero_max_kernel=args.dila_ero_max_kernel,
                       dila_ero_iter=args.dila_ero_iter,
                       jitter_brightness=args.jitter_brightness,
                       jitter_contrast=args.jitter_contrast,
                       proba=args.proba))
    for flag, field in [("train_data_list", "train_list"), ("val_data_list", "val_list"),
                        ("test_data_list", "test_list"), ("data_path", "data_path"),
                        ("synth_train_size", "synth_train_size"),
                        ("synth_eval_size", "synth_eval_size"),
                        ("synth_alphabet", "synth_alphabet")]:
        v = getattr(args, flag)
        if v is not None:
            data_kw[field] = v
    data = dataclasses.replace(cfg.data, **data_kw)

    train = dataclasses.replace(
        cfg.train, out_dir=args.out_dir,
        exp_name=args.exp_name or f"{args.dataset.lower()}_{args.encoder}",
        seed=args.seed, total_iters=args.total_iter, eval_iters=args.eval_iter,
        print_iters=args.print_iter, resume=args.resume,
        use_wandb=args.use_wandb, wandb_project=args.wandb_project,
        profile_dir=args.profile_dir, tri_masked=args.tri_masked,
        grad_accum=args.grad_accum,
        load_model=args.load_model, load_encoder_only=args.load_encoder_only)

    return dataclasses.replace(cfg, model=model, optim=optim, data=data, train=train)
