"""Training state (port of ``htr_vt_tpu/train/state.py``).

The JAX ``TrainState`` is an immutable pytree that each step replaces; here
it holds live objects that the step updates in place: the model, its EMA
copy (parameters and BN running statistics), the AdamW optimizer and the
``torch.Generator`` that masking and dropout draw from. The SGM head, when
the model has one, is part of each: its parameters are in AdamW's group,
SAM's global norm and the EMA, as the JAX tree's ``sgm_head`` is.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from htr_vt_torch.config import ExperimentConfig
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.optim.sam import make_base_optimizer


def check_ported(cfg: ExperimentConfig) -> None:
    """Raise on the training features the port does not have yet."""
    item = None
    if cfg.train.grad_accum > 1:
        item = "item 13: memory levers (grad_accum)"
    elif cfg.model.remat != "none":
        item = "item 13: memory levers (remat)"
    if item:
        raise NotImplementedError(
            f"this training configuration is not ported to htr_vt_torch yet "
            f"(ROADMAP.md queue 1, {item})")


@dataclass
class TrainState:
    """Everything a train step reads and updates. ``step`` counts the
    completed steps."""

    cfg: ExperimentConfig
    model: nn.Module
    ema_model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(cfg: ExperimentConfig, device,
                       generator: torch.Generator) -> TrainState:
    """A model initialised from ``generator`` with the JAX package's
    schemes (any model ``build_model`` builds: an encoder-decoder needs
    ``cfg.model.ed_vocab_size``, which the trainer sets from its
    tokenizer), its EMA copy, and AdamW over every parameter. ``generator``
    stays in the state for masking and dropout, so it must live on
    ``device``."""
    check_ported(cfg)
    model = build_model(cfg.model, device=device, generator=generator)
    ema_model = copy.deepcopy(model)
    ema_model.requires_grad_(False)
    optimizer = make_base_optimizer(model.parameters(), cfg.optim)
    return TrainState(cfg=cfg, model=model, ema_model=ema_model,
                      optimizer=optimizer, generator=generator)
