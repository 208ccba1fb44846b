"""The train and eval steps (port of ``htr_vt_tpu/train/step.py``).

``train_step`` is one SAM iteration (``step.py:150-195``), run eagerly and
in place on a ``TrainState``:

    pass 1   loss and gradient at w, masked (fresh mask), BN stats moved
    perturb  w + e(w), e(w) = rho * g / ||g||
    pass 2   loss and gradient at w + e(w), fresh mask, BN stats moved again
    restore  w from a copy, then AdamW with the gradient of pass 2
    EMA      over parameters and BN stats, n = step / 2

A pass's loss is one masked forward's, or with ``cfg.train.tri_masked``
the mean over the three forwards of ``TRI_MASK_MODES`` (the tri-masked MMS
trainer), the BN statistics moving through them in order. With the SGM
head on and an SGM batch, a forward's loss is ``ctc_lambda * CTC + gate *
sgm_lambda * SGM``, the gate 0 before ``sgm.warmup_iters`` steps. With
``cfg.train.grad_accum`` = g a pass runs g microbatches in turn; under data
parallelism each pass's gradient is averaged over the ranks
(``pass_loss_and_grads``).

On a CUDA device each forward runs the CTC alpha kernel and its backward
the beta kernel: two launches of each per step, six when tri-masked, g
times that under ``grad_accum``. An
encoder-decoder (``cfg.model.model_type``) trains on its teacher-forced
cross-entropy instead and runs no CTC; ``eval_step_ed`` evaluates it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from htr_vt_torch.models.encoder_decoder import generate, teacher_forcing_loss
from htr_vt_torch.ops.ctc import ctc_loss_auto
from htr_vt_torch.ops.decode import greedy_ids
from htr_vt_torch.optim.ema import ema_update
from htr_vt_torch.optim.sam import (clip_by_global_norm_, sam_perturb, set_lr,
                                    zeros_for_unused)
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.parallel.mesh import (all_reduce_mean_, all_reduce_model_sum_,
                                        data_world, sharded_mask, width_sharded_mask)
from htr_vt_torch.train.state import TrainState
from htr_vt_torch.utils.logging import span


# The tri-masked trainer's (mode, ratio) forwards (step.py:34).
TRI_MASK_MODES = (("random", 0.30), ("block", 0.20), ("span_old", 0.20))
SGM_KEYS = ("sgm_left", "sgm_right", "sgm_tgt", "sgm_mask")
# The encoder-decoder's teacher-forcing arrays (EDTokenizer.encode_for_training).
ED_KEYS = ("ed_input", "ed_output", "ed_lengths")


def _put(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    keys = ("image", "labels", "label_lengths") + tuple(
        k for k in SGM_KEYS + ED_KEYS if k in batch)
    return {k: _to_device(batch[k], device) for k in keys}


def _to_device(x, device) -> torch.Tensor:
    """``x`` on ``device``: a page-locked host tensor by a copy queued on the
    current stream, which does not block the host; anything else by
    ``torch.as_tensor`` (a tensor already there as it is)."""
    if isinstance(x, torch.Tensor) and x.is_pinned():
        return x.to(device, non_blocking=True)
    return torch.as_tensor(x, device=device)


def forward_loss(state: TrainState, batch: Mapping[str, torch.Tensor],
                 mask_mode: Optional[str] = None, mask_ratio: Optional[float] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One masked train-mode forward and its loss (``_forward_loss``,
    ``step.py:37-84``): the batch-mean CTC loss, and with the SGM head and
    an SGM batch ``ctc_lambda * CTC + gate * sgm_lambda * SGM``, the gate
    ``state.step >= sgm.warmup_iters`` read before the step's increment.
    Returns (loss, {"loss_ctc"[, "loss_sgm"]}). An encoder-decoder's loss
    is its teacher-forced cross-entropy (``step.py:43-53``), reported under
    ``loss_ctc`` as in JAX."""
    if state.cfg.model.model_type == "encoder_decoder":
        logits = state.model(batch["image"], batch["ed_input"], train=True,
                             generator=state.generator, mask_mode=mask_mode,
                             mask_ratio=mask_ratio)
        loss = teacher_forcing_loss(logits, batch["ed_output"],
                                    label_smoothing=state.cfg.model.label_smoothing)
        return loss, {"loss_ctc": loss}
    sgm = state.cfg.model.sgm
    use_sgm = sgm.enable and "sgm_tgt" in batch
    out = state.model(batch["image"], train=True, generator=state.generator,
                      mask_mode=mask_mode, mask_ratio=mask_ratio,
                      sgm_batch={k: batch[k] for k in SGM_KEYS} if use_sgm else None)
    logits, loss_sgm = out if use_sgm else (out, None)
    loss_ctc = ctc_loss_auto(logits, batch["labels"], batch["label_lengths"]).mean()
    if not use_sgm:
        return loss_ctc, {"loss_ctc": loss_ctc}
    gate = 1.0 if sgm.warmup_iters <= 0 or state.step >= sgm.warmup_iters else 0.0
    loss = sgm.ctc_lambda * loss_ctc + gate * sgm.sgm_lambda * loss_sgm
    return loss, {"loss_ctc": loss_ctc, "loss_sgm": loss_sgm}


def _grads(loss: torch.Tensor, params) -> list:
    return zeros_for_unused(params, torch.autograd.grad(loss, params,
                                                        allow_unused=True))


def _masked_pass(state: TrainState, batch: Mapping[str, torch.Tensor], params
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """One batch's loss, terms and gradient: one masked forward, or the
    tri-masked mean of three; each forward in a ``train.forward`` span and
    its gradient in a ``train.backward`` one."""
    if not state.cfg.train.tri_masked:
        with span("train.forward"):
            loss, terms = forward_loss(state, batch)
        with span("train.backward"):
            return loss, terms, _grads(loss, params)
    k = len(TRI_MASK_MODES)
    total, terms, grads = 0.0, {}, None
    for mode, ratio in TRI_MASK_MODES:
        with span("train.forward"):
            loss, parts = forward_loss(state, batch, mode, ratio)
        with span("train.backward"):
            g = _grads(loss / k, params)
        if grads is None:
            grads = list(g)
        else:
            torch._foreach_add_(grads, g)
        total = total + loss.detach()
        for name, v in parts.items():
            terms[name] = terms.get(name, 0.0) + v.detach() / k
    return total / k, terms, grads


def micro_batches(batch: Mapping[str, torch.Tensor], grad_accum: int) -> list:
    """``grad_accum`` contiguous slices of every batch key (image, labels,
    SGM and ED arrays); a batch that does not divide raises."""
    b = batch["image"].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch size {b} not divisible by grad_accum={grad_accum}")
    m = b // grad_accum
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(grad_accum)]


def pass_loss_and_grads(state: TrainState, batch: Mapping[str, torch.Tensor],
                        params) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """One SAM pass's loss, its terms and the gradient at the current
    weights (``make_loss_fn``, ``step.py:87-109``). Tri-masked: the mean of
    the three ``TRI_MASK_MODES`` forwards, run in order (each moves the BN
    statistics), each backward right after its forward so that one
    forward's activations are held at a time; the gradients of the three
    thirds are summed, which is the gradient of the mean. The terms are the
    forwards' means too.

    ``cfg.train.grad_accum`` = g > 1 (``_make_accum_grad_fn``,
    ``step.py:112-145``): the batch is cut into g contiguous microbatches
    (``micro_batches``), each run forward and backward in turn, so one
    microbatch's activations are live at a time; the BN statistics advance
    once a microbatch, in order; the gradient is the sum over microbatches
    divided by g, the loss and the terms the microbatches' means. Under
    data parallelism each rank cuts its own rows, the only split that moves
    no rows between ranks: microbatch i is rank 0's slice i, rank 1's slice
    i, ..., which is JAX's microbatch i of a row-permuted global batch (JAX
    cuts the global batch; the mean loss does not depend on row order).

    Under data parallelism the pass's gradient is then mean-all-reduced
    once over the data axis (never a microbatch at a time), and the loss
    and the terms too: with the BN sums summed over ranks in the forward
    and in its backward, this is the gradient of the global batch's mean
    loss, as JAX's replicated program computes it, and every rank reads the
    same values. Over a model axis a sharded parameter's gradient is its
    rank's part, and a replicated one comes out of ``copy_to_model`` /
    ``reduce_from_model`` equal on every rank of the model group; only a
    width-sharded stem's (``parallel/mesh.py:shard_width``) is summed over
    the model group first, since each rank's covers its strip of columns."""
    g = state.cfg.train.grad_accum
    if g == 1:
        loss, terms, grads = _masked_pass(state, batch, params)
    else:
        total, terms, grads = 0.0, {}, None
        for mb in micro_batches(batch, g):
            loss, parts, gi = _masked_pass(state, mb, params)
            if grads is None:
                grads = list(gi)
            else:
                torch._foreach_add_(grads, gi)
            del gi
            total = total + loss.detach()
            for name, v in parts.items():
                terms[name] = terms.get(name, 0.0) + v.detach()
        torch._foreach_div_(grads, float(g))
        loss = total / g
        terms = {name: v / g for name, v in terms.items()}
    stem = width_sharded_mask(state.model)
    if stem is not None:
        all_reduce_model_sum_([gr for gr, s in zip(grads, stem) if s])
    if data_world()[1] > 1:
        names = list(terms)
        scalars = torch.stack([loss.detach()] + [terms[n] for n in names])
        all_reduce_mean_(grads + [scalars])
        loss, terms = scalars[0], dict(zip(names, scalars[1:]))
    return loss, terms, grads


def train_step(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
    """One full SAM iteration; updates ``state`` in place.

    batch: ``image`` [B, H, W, 1] float32, ``labels`` [B, Lmax] and
    ``label_lengths`` [B] int, tensors or numpy arrays (moved to the
    model's device): under data parallelism this rank's rows of the global
    batch, and with the width sharded over the model axis this rank's strip
    of its image (``parallel/mesh.py:rank_width``). Returns 0-d tensors on
    the device, not synchronised: ``loss``
    (pass 1), ``loss_second`` and ``grad_norm``, global values on every
    rank (``pass_loss_and_grads``). SAM's perturbation, its norm and the
    clip read the pass's mean gradient, whatever ``grad_accum``; over a
    model axis the norm is the whole model's (``optim/sam.py:
    global_grad_norm``).

    Spans (``utils/logging.py``): the request ``train.step`` (``step``),
    holding each pass's ``train.forward`` / ``train.backward`` pairs,
    ``train.perturb`` (the weights' copy and ``sam_perturb``),
    ``train.update`` (restore, clip, lr, AdamW) and ``train.ema``."""
    cfg = state.cfg
    opt = cfg.optim
    model = state.model
    params = list(model.parameters())
    with span("train.step", request=True, step=state.step):
        batch = _put(batch, params[0].device)
        sharded = sharded_mask(model)
        loss1, terms1, grads1 = pass_loss_and_grads(state, batch, params)
        with span("train.perturb"):
            with torch.no_grad():
                w = [p.detach().clone() for p in params]
            gnorm = sam_perturb(params, grads1, opt.sam_rho, opt.sam_adaptive, sharded)
        del grads1

        loss2, _, grads2 = pass_loss_and_grads(state, batch, params)
        with span("train.update"):
            with torch.no_grad():
                torch._foreach_copy_(params, w)
            del w
            if opt.grad_clip_norm > 0:
                clip_by_global_norm_(grads2, opt.grad_clip_norm, sharded)
            for p, g in zip(params, grads2):
                p.grad = g
            set_lr(state.optimizer, warmup_cosine_lr(
                state.step, max_lr=opt.max_lr, warmup_iters=opt.warmup_iters,
                total_iters=opt.total_iters, min_lr=opt.min_lr))
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)

        n = state.step / 2.0 if opt.ema_halved_updates else float(state.step)
        with span("train.ema"):
            ema_update(state.ema_model, model, n, opt.ema_decay)
        state.step += 1
    metrics = {"loss": loss1.detach(), "loss_second": loss2.detach(),
               "grad_norm": gnorm}
    if "loss_sgm" in terms1:
        metrics.update(loss_sgm=terms1["loss_sgm"].detach(),
                       loss_ctc=terms1["loss_ctc"].detach())
    return metrics


@torch.inference_mode()
def eval_step(model: nn.Module, batch: Mapping) -> Dict[str, torch.Tensor]:
    """Eval forward on the model's current weights (``step.py:198-216``):
    eval BatchNorm and no masking, whatever the model last trained with.

    batch: ``image`` [B, H, W, 1] float32 in [0, 1], ``labels`` [B, Lmax]
    and ``label_lengths`` [B] int, as tensors or numpy arrays; they are moved
    to the model's device (a page-locked host tensor without blocking the
    host, ``_to_device``); a width-sharded model takes this rank's strip of
    the image (``parallel/mesh.py:rank_width``) and returns the whole
    line's results, the same on every rank of its model group. Returns
    ``logits`` [B, T, C] float32,
    ``pred_ids`` [B, T] int32 frame argmax, ``loss_per_sample`` [B] and its
    batch mean ``loss``. Spans (``utils/logging.py``): ``eval.h2d``,
    ``eval.forward``, ``eval.loss`` and ``eval.argmax``."""
    with span("eval.h2d"):
        batch = _put(batch, next(model.parameters()).device)
    with span("eval.forward"):
        logits = model(batch["image"], train=False)
    with span("eval.loss"):
        loss_per_sample = ctc_loss_auto(logits, batch["labels"], batch["label_lengths"])
        loss = loss_per_sample.mean()
    with span("eval.argmax"):
        pred_ids = greedy_ids(logits)
    return {"logits": logits, "pred_ids": pred_ids, "loss": loss,
            "loss_per_sample": loss_per_sample}


@torch.inference_mode()
def eval_step_ed(model: nn.Module, batch: Mapping) -> Dict[str, torch.Tensor]:
    """Encoder-decoder eval on the model's current weights (``step.py:
    229-244``): the teacher-forced loss on ``ed_input`` / ``ed_output``
    and greedy generation of ``ed_input.shape[1]`` positions. The image is
    encoded once and the memory serves both, where JAX encodes it twice: in
    eval mode (running BN statistics, no masking) the two encodings are
    the same, so the results are JAX's at half the trunk's launches.
    Returns ``pred_ids`` [B, L] int32 and the batch-mean ``loss``."""
    batch = _put(batch, next(model.parameters()).device)
    memory = model.encode(batch["image"])
    logits = model.decode_logits(memory, batch["ed_input"])
    loss = teacher_forcing_loss(logits, batch["ed_output"],
                                label_smoothing=model.cfg.label_smoothing)
    pred_ids = generate(model, None, method="greedy", max_len=batch["ed_input"].shape[1],
                        memory=memory)
    return {"pred_ids": pred_ids, "loss": loss}
