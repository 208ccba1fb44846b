"""Weights from the seed, made on the device in a few large calls.

One normal draw covers every tensor; each tensor takes its own mean and
spread: the variances of the port's own initialisers (``models/layers.py:
jax_init_``: He's over the fan-out for the convolutions, Glorot's for the
linears, 0.02 for the mask token), and small spreads around the
initial values of the norms, the biases and the BatchNorm running
statistics, so that the folded BatchNorms and the biases are not trivial
and the activations keep their size through the stem and the encoder.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _moments(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if name.endswith("running_var"):
        return 1.0, 0.1
    if len(shape) == 4:  # conv [O, I, kh, kw]
        return 0.0, math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    if len(shape) == 2:  # linear [out, in]
        return 0.0, math.sqrt(2.0 / (shape[0] + shape[1]))
    if name == "mask_token":
        return 0.0, 0.02
    if name.endswith("weight"):  # a norm's scale
        return 1.0, 0.1
    return 0.0, 0.02 if ("attn" in name or "mlp" in name or name.startswith("head")) else 0.1


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``shapes`` from ``seed``: the same seed gives the
    same tensors on the same kind of device."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    moments = torch.tensor([_moments(n, shapes[n]) for n in names], dtype=torch.float32)
    reps = torch.tensor(sizes)
    mean = torch.repeat_interleave(moments[:, 0], reps).to(device)
    std = torch.repeat_interleave(moments[:, 1], reps).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(std).add_(mean)
    return {n: t.view(shapes[n]) for n, t in zip(names, torch.split(flat, sizes))}
