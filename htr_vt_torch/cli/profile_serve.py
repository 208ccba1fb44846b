"""Where the serving or training step's time goes on the GPU: per-layer
times and the device time by kernel category.

    python -m htr_vt_torch.cli.profile_serve [--train] [--batch-size 128]
        [--steps 5] [--trace trace.json]

Runs the flagship ``ModelConfig()`` (bf16, seeded random weights) on one
CUDA device. Serving (default) profiles ``eval_step`` with the serving
step's dummy labels; ``--train`` profiles the SAM ``train_step`` with the
IAM recipe's span masking (ratio 0.4, max span 8) and labels of length
1-96 (S = 193):

- per-layer medians by CUDA events: serving, the stem, the ViT blocks, the
  whole forward and ``eval_step``; training, one masked train-mode forward
  with its loss, one SAM pass (that forward and its gradient) and
  ``train_step``;
- ``torch.profiler`` over ``--steps`` steps after warm-up: the kernels' own
  device time summed by category (``category``), each as ms/step and
  share, the ten largest kernels, and the device's busy share of the
  profiled span.

The last line of the output is a JSON summary of the same numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from htr_vt_torch import ExperimentConfig, MaskConfig, ModelConfig
from htr_vt_torch.cli.serve import DUMMY_LABEL_LEN
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.models.layers import global_layer_norm
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, forward_loss, train_step

TRAIN_LMAX = 96  # labels of length 1-96: S = 193

# (category, substrings of a kernel name), first match wins: cuDNN's conv
# kernels carry "gemm" in their names too, and casts run as elementwise
# kernels over a copy functor.
CATEGORIES = (
    ("ctc_alpha kernel", ("ctc_alpha",)),
    ("ctc_beta kernel", ("ctc_beta",)),
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


def _serve_case(args, device):
    """(per-layer ms, the step to profile) for ``eval_step``."""
    cfg = ModelConfig()
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
    layers["eval_step"] = median_ms(lambda: eval_step(model, batch), args.reps)
    return layers, lambda: eval_step(model, batch)


def _train_case(args, device):
    """(per-layer ms, the step to profile) for the SAM ``train_step``."""
    model_cfg = ModelConfig(masking=MaskConfig(mode="span", ratio=0.4,
                                               max_span_length=8))
    state = create_train_state(ExperimentConfig(model=model_cfg), device,
                               torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    h, w = model_cfg.img_size
    b = args.batch_size
    labels = rng.integers(1, model_cfg.nb_cls, (b, TRAIN_LMAX)).astype(np.int32)
    lengths = rng.integers(1, TRAIN_LMAX + 1, b).astype(np.int32)
    labels[np.arange(TRAIN_LMAX)[None] >= lengths[:, None]] = 0
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
              "sam_pass": median_ms(sam_pass, args.reps),
              "train_step": median_ms(lambda: train_step(state, batch), args.reps)}
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
    print("[layers] ms: " + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()),
          flush=True)

    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.steps):
            step()
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end) / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    from torch.autograd import DeviceType
    rows = [row for row in prof.key_averages() if _device_us(row) > 0]
    # the kernels themselves; operators' rows would count their time twice
    rows = [row for row in rows if row.device_type == DeviceType.CUDA] or rows
    kernels: List = [(row.key, _device_us(row) / 1e3 / args.steps)
                     for row in rows]
    if not kernels:
        raise SystemExit("profile_serve: the profiler recorded no device time")
    by_cat: Dict[str, float] = {}
    for name, ms in kernels:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    busy = sum(by_cat.values())
    print(f"[profile] {args.steps} {what}s at bs {b}: kernels {busy:.3f} "
          f"ms/step of a {span_ms:.3f} ms span (device busy {busy / span_ms:.1%})")
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label:28s} {ms:9.3f} ms/step {ms / busy:6.1%}")
    for name, ms in sorted(kernels, key=lambda kv: -kv[1])[:10]:
        print(f"[kernel] {ms:8.3f} ms/step  {category(name):28s} {name[:110]}")
    summary = {"device": smi.splitlines()[0], "step": what, "batch": b,
               "layers_ms": layers,
               "span_ms": span_ms, "kernel_ms": busy,
               "categories_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1]))}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
