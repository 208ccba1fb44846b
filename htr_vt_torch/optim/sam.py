"""Sharpness-Aware Minimization around AdamW (port of
``htr_vt_tpu/optim/sam.py``).

The JAX train step is pure; here the perturbation is applied to the
parameters in place, and the train step keeps a copy of w to restore before
the AdamW update, because subtracting e(w) again is not exact in float.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch

from htr_vt_torch.config import OptimConfig
from htr_vt_torch.parallel.mesh import model_sum


def global_grad_norm(grads: Sequence[torch.Tensor],
                     params: Optional[Sequence[torch.Tensor]] = None,
                     adaptive: bool = False,
                     sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """L2 norm over all gradients in float32, a 0-d tensor; the adaptive
    form norms ``|p| * g`` (``sam.py:31-39``). ``sharded`` (a model sharded
    over a model axis, ``parallel/mesh.py:sharded_mask``): which gradients
    are this rank's part of a sharded parameter; their squares are summed
    over the model group, and the replicated ones, equal on every rank of
    it, counted once, so every rank reads the whole model's norm."""
    if adaptive:
        grads = [p.abs() * g for p, g in zip(params, grads)]
    if sharded is None:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    squares = [g.float().square().sum() for g in grads]
    part = sum(q for q, s in zip(squares, sharded) if s)
    return torch.sqrt(sum(q for q, s in zip(squares, sharded) if not s) + model_sum(part))


@torch.no_grad()
def sam_perturb(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                rho: float, adaptive: bool = False,
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Move ``params`` in place to ``w + e(w)`` with ``e(w) = rho * g /
    (||g|| + 1e-12)``, or ``rho * p^2 * g / ||.||`` in the adaptive form
    (``sam.py:42-52``); returns the gradient norm (``global_grad_norm``,
    ``sharded`` as there)."""
    gnorm = global_grad_norm(grads, params, adaptive, sharded)
    scale = rho / (gnorm + 1e-12)
    for p, g in zip(params, grads):
        e_w = p.square() * g * scale if adaptive else g * scale
        p.add_(e_w.to(p.dtype))
    return gnorm


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         sharded: Optional[Sequence[bool]] = None) -> None:
    """optax ``clip_by_global_norm``: scale every gradient by
    ``max_norm / ||g||`` where ``||g|| >= max_norm``, in place
    (``global_grad_norm``, ``sharded`` as there)."""
    gnorm = global_grad_norm(grads, sharded=sharded)
    scale = torch.where(gnorm < max_norm, 1.0, max_norm / gnorm)
    torch._foreach_mul_(list(grads), scale)


def make_base_optimizer(params: Iterable[torch.Tensor],
                        cfg: OptimConfig) -> torch.optim.AdamW:
    """AdamW with the reference hyperparameters (``sam.py:55-67``: betas
    (0.9, 0.99), eps 1e-8, decoupled weight decay 0.5 on every parameter).
    The train step sets the LR from ``warmup_cosine_lr`` before each
    update; torch's AdamW decays by ``lr * wd`` as optax's does."""
    return torch.optim.AdamW(params, lr=cfg.max_lr, betas=(cfg.beta1, cfg.beta2),
                             eps=cfg.eps, weight_decay=cfg.weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def zeros_for_unused(params: Sequence[torch.Tensor],
                     grads: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """Gradients with a zero tensor where a parameter got none: optax
    updates (and decays) every leaf, torch's AdamW skips a ``None``."""
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
