"""The eval step (port of ``htr_vt_tpu/train/step.py:eval_step``, :198-216).

The train step is not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from htr_vt_torch.ops.ctc import ctc_loss_auto
from htr_vt_torch.ops.decode import greedy_ids


@torch.inference_mode()
def eval_step(model: nn.Module, batch: Mapping) -> Dict[str, torch.Tensor]:
    """Eval forward on the model's current weights.

    batch: ``image`` [B, H, W, 1] float32 in [0, 1], ``labels`` [B, Lmax]
    and ``label_lengths`` [B] int, as tensors or numpy arrays; they are moved
    to the model's device. Returns ``logits`` [B, T, C] float32,
    ``pred_ids`` [B, T] int32 frame argmax, ``loss_per_sample`` [B] and its
    batch mean ``loss``."""
    device = next(model.parameters()).device
    put = lambda k: torch.as_tensor(batch[k], device=device)  # noqa: E731
    logits = model(put("image"))
    loss_per_sample = ctc_loss_auto(logits, put("labels"), put("label_lengths"))
    return {"logits": logits, "pred_ids": greedy_ids(logits),
            "loss": loss_per_sample.mean(),
            "loss_per_sample": loss_per_sample}
