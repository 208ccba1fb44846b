"""Time one training step on the card and fingerprint its bits:
``python -m htr_vt_torch.cli.step_digest [--tree DIR] [--remat MODE]
[--grad-accum N] [--steps N]``.

The fully fused flagship (``ModelConfig()`` with the three stem switches,
IAM span masking, ``OptimConfig()``) from seeded weights takes ``--warmup``
+ ``--steps`` SAM steps on one seeded batch of ``--batch-size`` synthetic
lines. Prints the card's name and power limit, the median CUDA-event ms a
step, the peak device memory, and a SHA-256 of every step's metrics and the
final weights, EMA and AdamW state. Two trees (``--tree``: a checkout of
another commit, whose ``htr_vt_torch`` is imported in place of this one and
builds its own kernels) give equal digests when they compute the same bits,
so running it parent, change, change, parent on one card in turn compares
two commits' step in time and in bits. It uses only entry points that every
tree since the fully fused stem has.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=None, help="import htr_vt_torch from this checkout")
    p.add_argument("--remat", default="none", choices=("none", "blocks", "all"))
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
        for name in [m for m in sys.modules if m.split(".")[0] == "htr_vt_torch"]:
            del sys.modules[name]
    import numpy as np
    import torch

    import htr_vt_torch
    from htr_vt_torch import ExperimentConfig, MaskConfig, ModelConfig, OptimConfig
    from htr_vt_torch.config import TrainConfig
    from htr_vt_torch.train.state import create_train_state
    from htr_vt_torch.train.step import train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    model = dict(masking=MaskConfig(mode="span", ratio=0.4, max_span_length=8),
                 bn_stats_impl="pallas", pool_impl="pallas", conv_impl="pallas")
    if args.remat != "none":
        model["remat"] = args.remat
    train = TrainConfig(grad_accum=args.grad_accum) if args.grad_accum > 1 else TrainConfig()
    cfg = ExperimentConfig(model=ModelConfig(**model), optim=OptimConfig(), train=train)
    state = create_train_state(cfg, device,
                               torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed + 1)
    b, lmax = args.batch_size, 96
    image = np.clip(0.6 + 0.3 * rng.standard_normal((b, 64, 512, 1)), 0, 1).astype(np.float32)
    lengths = rng.integers(1, lmax + 1, b).astype(np.int32)
    labels = rng.integers(1, cfg.model.nb_cls, (b, lmax)).astype(np.int32)
    labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             (("image", image), ("labels", labels), ("label_lengths", lengths))}
    digest = hashlib.sha256()
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(args.warmup + args.steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = train_step(state, batch)
        end.record()
        end.synchronize()
        if i >= args.warmup:
            times.append(start.elapsed_time(end))
        for k in sorted(m):
            digest.update(m[k].float().cpu().numpy().tobytes())
    for module in (state.model, state.ema_model):
        for k, v in module.state_dict().items():
            digest.update(k.encode() + v.cpu().numpy().tobytes())
    for st in state.optimizer.state.values():
        for k in ("exp_avg", "exp_avg_sq"):
            digest.update(st[k].cpu().numpy().tobytes())
    print(json.dumps({"tree": htr_vt_torch.__file__, "remat": args.remat,
                      "grad_accum": args.grad_accum, "batch_size": b,
                      "ms_a_step": statistics.median(times), "times": times,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                      "digest": digest.hexdigest(), "card": smi}), flush=True)


if __name__ == "__main__":
    main()
