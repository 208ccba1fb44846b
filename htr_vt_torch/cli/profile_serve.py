"""Where the serving or training step's time goes on the GPU: per-layer
times and the device time by kernel category.

    python -m htr_vt_torch.cli.profile_serve [--train] [--batch-size 128]
        [--steps 5] [--trace trace.json] [--bn-stats-impl pallas]
        [--pool-impl pallas] [--conv-impl pallas] [--width 2048]
        [--attn-impl auto|xla|flash]

Runs the flagship ``ModelConfig()`` (bf16, seeded random weights) on one
CUDA device, at ``--width`` px (default 512; 1024 and 2048 are the width
buckets, N = 256 and 512 tokens). Serving (default) profiles ``eval_step``
with the serving step's dummy labels; ``--train`` profiles the SAM
``train_step`` with the IAM recipe's span masking (ratio 0.4, max span 8)
and labels of length 1-96 at 512 px (S = 193), or up to the multi-width
recipe's ``28 * width / 512`` characters at a wider width
(``tools/train_multiwidth.py:81-83``). ``--bn-stats-impl``,
``--pool-impl`` and ``--conv-impl`` set the stem's kernel switches
(``ModelConfig.bn_stats_impl``, ``pool_impl``, ``conv_impl``): the first
two ``pallas`` is the fused-stem configuration, all three the fully fused
one. ``--attn-impl`` is ``ModelConfig.attn_impl``: ``auto`` takes the K5
flash-attention kernels at 1024 and 2048 px.

- per-layer medians by CUDA events: serving, the stem, the ViT blocks, the
  whole forward and ``eval_step``; training, one masked train-mode forward
  with its loss, one SAM pass (that forward and its gradient) and
  ``train_step``; and in both, one block's attention core as the model
  runs it and as the plain ``multi_head_attention`` (forward, or forward
  and backward in training), and the whole step again with every block on
  the plain attention (``attn_impl="xla"``), in the same call;
- the K5 launches per step;
- ``torch.profiler`` over ``--steps`` steps after warm-up: the kernels' own
  device time summed by category (``category``), each as ms/step and
  share, the ten largest kernels, and the device's busy share of the
  profiled span.

The last line of the output is a JSON summary of the same numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from htr_vt_torch import ExperimentConfig, MaskConfig, ModelConfig
from htr_vt_torch.cli.serve import DUMMY_LABEL_LEN
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.models.layers import dense, global_layer_norm
from htr_vt_torch.models.vit import (flash_mha, multi_head_attention,
                                     resolve_attn_impl)
from htr_vt_torch.ops import flash_attn
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, forward_loss, train_step

TRAIN_LMAX = 96  # labels of length 1-96 at 512 px: S = 193
K5 = (flash_attn.flash_attention_fwd, flash_attn.flash_attention_bwd_dkv,
      flash_attn.flash_attention_bwd_dq)

# (category, substrings of a kernel name), first match wins: cuDNN's conv
# kernels carry "gemm" in their names too, and casts run as elementwise
# kernels over a copy functor.
CATEGORIES = (
    ("ctc_alpha kernel", ("ctc_alpha",)),
    ("ctc_beta kernel", ("ctc_beta",)),
    ("flash attention kernels (K5f, K5dkv, K5dq)", ("flash_fwd", "flash_dkv",
                                                     "flash_dq")),
    ("bn_stats kernel (K2)", ("bn_stats",)),  # one kernel, its sum inside
    ("pool_bn_relu kernels (K3f, K3b)", ("pool_fwd_kernel", "pool_bwd_kernel")),
    ("conv3x3 kernels (K4f, K4d, K4w)", ("conv_fwd_wgmma", "conv_dgrad_wgmma",
                                         "wgrad_wgmma", "conv_f32_kernel",
                                         "wgrad_f32_kernel", "sum_splits")),
    ("stem kernels' partial sums", ("sum_partials",)),  # K3b's and K4d's
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "cublas")),
    ("max pooling", ("max_pool",)),
    ("optimizer and EMA (foreach)", ("multi_tensor",)),
    ("dtype casts and copies", ("copy",)),
    ("norms, softmax, reductions", ("norm", "softmax", "reduce")),
    ("elementwise", ("elementwise",)),
)


def category(kernel: str) -> str:
    name = kernel.lower()
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return "other"


def median_ms(fn: Callable[[], object], reps: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_us(row) -> float:
    return getattr(row, "self_device_time_total",
                   getattr(row, "self_cuda_time_total", 0.0))


def _switches(cfg: ModelConfig, args) -> ModelConfig:
    return dataclasses.replace(cfg, bn_stats_impl=args.bn_stats_impl,
                               pool_impl=args.pool_impl, conv_impl=args.conv_impl,
                               attn_impl=args.attn_impl,
                               img_size=(cfg.img_size[0], args.width))


def _train_lmax(width: int) -> int:
    return TRAIN_LMAX if width <= 512 else max(6, 28 * width // 512)


class plain_attention:
    """Every block of ``model`` on the plain attention (``attn_impl="xla"``)
    inside the ``with``."""

    def __init__(self, model):
        self.attns = [block.attn for block in model.blocks]

    def __enter__(self):
        self.saved = [a.attn_impl for a in self.attns]
        for a in self.attns:
            a.attn_impl = "xla"

    def __exit__(self, *exc):
        for a, impl in zip(self.attns, self.saved):
            a.attn_impl = impl


def _attention_layers(model, tokens, reps: int, train: bool) -> Dict[str, float]:
    """One block's attention core at the model's q, k, v: as the model runs
    it and as ``multi_head_attention``; with ``train`` forward and
    backward."""
    block = model.blocks[0]
    attn = block.attn
    with torch.no_grad():
        x = block.norm1(tokens.float()).to(block.dtype)
        b, n, c = x.shape
        d = c // attn.num_heads
        qkv = dense(attn.qkv, x, block.dtype).reshape(b, n, 3, attn.num_heads, d)
    impl = resolve_attn_impl(attn.attn_impl, n, d, on_cuda=x.is_cuda)
    out = {}
    for key, fn in (("attention_core", flash_mha if impl == "flash"
                     else multi_head_attention),
                    ("attention_core_plain", multi_head_attention)):
        if train:
            leaf = qkv.detach().clone().requires_grad_(True)
            g = torch.randn((b, n, c), device=x.device, dtype=block.dtype)

            def run():
                q, k, v = leaf.permute(2, 0, 3, 1, 4)
                fn(q, k, v, d**-0.5, block.dtype).backward(g)
        else:
            q, k, v = qkv.permute(2, 0, 3, 1, 4)

            def run():
                with torch.no_grad():
                    fn(q, k, v, d**-0.5, block.dtype)
        run()
        out[key] = median_ms(run, reps)
    out["attention_impl"] = impl
    return out


def _serve_case(args, device):
    """(per-layer ms, the step to profile) for ``eval_step``."""
    cfg = _switches(ModelConfig(), args)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    h, w = cfg.img_size
    b = args.batch_size
    image = torch.from_numpy(rng.random((b, h, w, 1), dtype=np.float32)).to(device)
    batch = {"image": image,
             "labels": torch.zeros((b, DUMMY_LABEL_LEN), dtype=torch.int32, device=device),
             "label_lengths": torch.zeros(b, dtype=torch.int32, device=device)}
    for _ in range(args.warmup):
        eval_step(model, batch)
    torch.cuda.synchronize()

    with torch.inference_mode():
        x = global_layer_norm(image).permute(0, 3, 1, 2)
        feats = model.patch_embed(x)
        tokens = feats.permute(0, 2, 3, 1).reshape(b, -1, cfg.embed_dim)

        def blocks():
            t = tokens
            for block in model.blocks:
                t = block(t)
            return t

        layers = {"stem": median_ms(lambda: model.patch_embed(x), args.reps),
                  "vit_blocks": median_ms(blocks, args.reps),
                  "forward": median_ms(lambda: model(image), args.reps)}
    layers.update(_attention_layers(model, tokens, args.reps, train=False))
    layers["eval_step"] = median_ms(lambda: eval_step(model, batch), args.reps)
    with plain_attention(model):
        layers["eval_step_plain_attention"] = median_ms(lambda: eval_step(model, batch),
                                                        args.reps)
    return layers, lambda: eval_step(model, batch)


def _train_case(args, device):
    """(per-layer ms, the step to profile) for the SAM ``train_step``."""
    model_cfg = _switches(ModelConfig(masking=MaskConfig(
        mode="span", ratio=0.4, max_span_length=8)), args)
    state = create_train_state(ExperimentConfig(model=model_cfg), device,
                               torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    h, w = model_cfg.img_size
    b = args.batch_size
    lmax = _train_lmax(w)
    labels = rng.integers(1, model_cfg.nb_cls, (b, lmax)).astype(np.int32)
    lengths = rng.integers(1, lmax + 1, b).astype(np.int32)
    labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
    batch = {"image": torch.from_numpy(rng.random((b, h, w, 1), dtype=np.float32)),
             "labels": torch.from_numpy(labels),
             "label_lengths": torch.from_numpy(lengths)}
    batch = {k: v.to(device) for k, v in batch.items()}
    for _ in range(args.warmup):
        train_step(state, batch)
    torch.cuda.synchronize()
    params = list(state.model.parameters())

    def sam_pass():
        torch.autograd.grad(forward_loss(state, batch), params, allow_unused=True)

    def forward():
        with torch.no_grad():
            forward_loss(state, batch)

    layers = {"train_forward_loss": median_ms(forward, args.reps),
              "sam_pass": median_ms(sam_pass, args.reps)}
    with torch.no_grad():
        x = global_layer_norm(batch["image"]).permute(0, 3, 1, 2)
        tokens = state.model.patch_embed(x).permute(0, 2, 3, 1).reshape(
            b, -1, model_cfg.embed_dim)
    layers.update(_attention_layers(state.model, tokens, args.reps, train=True))
    layers["train_step"] = median_ms(lambda: train_step(state, batch), args.reps)
    with plain_attention(state.model):
        layers["train_step_plain_attention"] = median_ms(
            lambda: train_step(state, batch), args.reps)
    return layers, lambda: train_step(state, batch)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train", action="store_true",
                   help="profile the SAM train_step instead of eval_step")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--steps", type=int, default=5, help="profiled steps")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--reps", type=int, default=10, help="CUDA-event repeats")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None, help="write a Chrome trace here")
    p.add_argument("--bn-stats-impl", default="auto",
                   choices=("auto", "xla", "pallas"),
                   help="the stem's BN statistics: pallas = the K2 kernel")
    p.add_argument("--pool-impl", default="auto", choices=("auto", "xla", "pallas"),
                   help="the stem's entry BN+ReLU+max-pool: pallas = K3f/K3b")
    p.add_argument("--conv-impl", default="auto", choices=("auto", "xla", "pallas"),
                   help="the stem's stride-1 3x3 convs: pallas = K4f/K4d/K4w")
    p.add_argument("--width", type=int, default=512,
                   help="image width in px (1024, 2048: the width buckets)")
    p.add_argument("--attn-impl", default="auto", choices=("auto", "xla", "flash"),
                   help="the ViT attention: flash = K5f/K5dkv/K5dq ('auto' takes "
                        "them at N >= 256 tokens)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    what = "train_step" if args.train else "eval_step"
    layers, step = (_train_case if args.train else _serve_case)(args, device)
    b = args.batch_size
    print("[layers] ms: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in layers.items()), flush=True)

    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    k5_before = [f.launches for f in K5]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.steps):
            step()
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end) / args.steps
    k5_launches = {f.__name__: (f.launches - n) / args.steps
                   for f, n in zip(K5, k5_before)}
    if args.trace:
        prof.export_chrome_trace(args.trace)

    from torch.autograd import DeviceType
    rows = [row for row in prof.key_averages() if _device_us(row) > 0]
    # the kernels themselves; operators' rows, and the device ranges of the
    # program's spans (user annotations), would count their time twice
    rows = [row for row in rows if row.device_type == DeviceType.CUDA
            and not row.is_user_annotation] or rows
    kernels: List = [(row.key, _device_us(row) / 1e3 / args.steps)
                     for row in rows]
    if not kernels:
        raise SystemExit("profile_serve: the profiler recorded no device time")
    by_cat: Dict[str, float] = {}
    for name, ms in kernels:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    busy = sum(by_cat.values())
    print(f"[profile] {args.steps} {what}s at bs {b}, {args.width} px (bn_stats_impl="
          f"{args.bn_stats_impl}, pool_impl={args.pool_impl}, conv_impl="
          f"{args.conv_impl}, attn_impl={args.attn_impl}): kernels {busy:.3f} "
          f"ms/step of a {span_ms:.3f} ms span (device busy {busy / span_ms:.1%}); "
          f"K5 launches per step {k5_launches}")
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label:28s} {ms:9.3f} ms/step {ms / busy:6.1%}")
    for name, ms in sorted(kernels, key=lambda kv: -kv[1])[:10]:
        print(f"[kernel] {ms:8.3f} ms/step  {category(name):28s} {name[:110]}")
    summary = {"device": smi.splitlines()[0], "step": what, "batch": b,
               "bn_stats_impl": args.bn_stats_impl, "pool_impl": args.pool_impl,
               "conv_impl": args.conv_impl, "width": args.width,
               "attn_impl": args.attn_impl, "k5_launches_per_step": k5_launches,
               "layers_ms": layers,
               "span_ms": span_ms, "kernel_ms": busy,
               "categories_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1]))}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
