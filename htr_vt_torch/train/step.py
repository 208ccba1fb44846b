"""The train and eval steps (port of ``htr_vt_tpu/train/step.py``).

``train_step`` is one SAM iteration of the flagship ``model_v1`` recipe
(``step.py:150-195``), run eagerly and in place on a ``TrainState``:

    pass 1   loss and gradient at w, masked (fresh mask), BN stats moved
    perturb  w + e(w), e(w) = rho * g / ||g||
    pass 2   loss and gradient at w + e(w), fresh mask, BN stats moved again
    restore  w from a copy, then AdamW with the gradient of pass 2
    EMA      over parameters and BN stats, n = step / 2

On a CUDA device each pass runs the CTC alpha kernel in its forward and the
beta kernel in its backward: two launches of each per step.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from htr_vt_torch.ops.ctc import ctc_loss_auto
from htr_vt_torch.ops.decode import greedy_ids
from htr_vt_torch.optim.ema import ema_update
from htr_vt_torch.optim.sam import (clip_by_global_norm_, sam_perturb, set_lr,
                                    zeros_for_unused)
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.train.state import TrainState, check_ported


def _put(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=device)
            for k in ("image", "labels", "label_lengths")}


def forward_loss(state: TrainState, batch: Mapping[str, torch.Tensor]
                 ) -> torch.Tensor:
    """One masked train-mode forward and the batch-mean CTC loss
    (``_forward_loss``, ``step.py:37-84``, single mask, no SGM)."""
    logits = state.model(batch["image"], train=True, generator=state.generator)
    return ctc_loss_auto(logits, batch["labels"], batch["label_lengths"]).mean()


def _grads(loss: torch.Tensor, params) -> list:
    return zeros_for_unused(params, torch.autograd.grad(loss, params,
                                                        allow_unused=True))


def train_step(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
    """One full SAM iteration; updates ``state`` in place.

    batch: ``image`` [B, H, W, 1] float32, ``labels`` [B, Lmax] and
    ``label_lengths`` [B] int, tensors or numpy arrays (moved to the
    model's device). Returns 0-d tensors on the device, not synchronised:
    ``loss`` (pass 1), ``loss_second`` and ``grad_norm``."""
    cfg = state.cfg
    check_ported(cfg)
    opt = cfg.optim
    model = state.model
    params = list(model.parameters())
    batch = _put(batch, params[0].device)

    loss1 = forward_loss(state, batch)
    grads1 = _grads(loss1, params)
    with torch.no_grad():
        w = [p.detach().clone() for p in params]
    gnorm = sam_perturb(params, grads1, opt.sam_rho, opt.sam_adaptive)
    del grads1

    loss2 = forward_loss(state, batch)
    grads2 = _grads(loss2, params)
    with torch.no_grad():
        torch._foreach_copy_(params, w)
    del w
    if opt.grad_clip_norm > 0:
        clip_by_global_norm_(grads2, opt.grad_clip_norm)
    for p, g in zip(params, grads2):
        p.grad = g
    set_lr(state.optimizer, warmup_cosine_lr(
        state.step, max_lr=opt.max_lr, warmup_iters=opt.warmup_iters,
        total_iters=opt.total_iters, min_lr=opt.min_lr))
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)

    n = state.step / 2.0 if opt.ema_halved_updates else float(state.step)
    ema_update(state.ema_model, model, n, opt.ema_decay)
    state.step += 1
    return {"loss": loss1.detach(), "loss_second": loss2.detach(),
            "grad_norm": gnorm}


@torch.inference_mode()
def eval_step(model: nn.Module, batch: Mapping) -> Dict[str, torch.Tensor]:
    """Eval forward on the model's current weights (``step.py:198-216``):
    eval BatchNorm and no masking, whatever the model last trained with.

    batch: ``image`` [B, H, W, 1] float32 in [0, 1], ``labels`` [B, Lmax]
    and ``label_lengths`` [B] int, as tensors or numpy arrays; they are moved
    to the model's device. Returns ``logits`` [B, T, C] float32,
    ``pred_ids`` [B, T] int32 frame argmax, ``loss_per_sample`` [B] and its
    batch mean ``loss``."""
    batch = _put(batch, next(model.parameters()).device)
    logits = model(batch["image"], train=False)
    loss_per_sample = ctc_loss_auto(logits, batch["labels"], batch["label_lengths"])
    return {"logits": logits, "pred_ids": greedy_ids(logits),
            "loss": loss_per_sample.mean(),
            "loss_per_sample": loss_per_sample}
