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
from htr_vt_torch.parallel.mesh import (assert_same_on_every_rank, shard_model,
                                        shard_width)


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


def create_train_state(cfg: ExperimentConfig, device, generator: torch.Generator,
                       *, tensor_parallel: bool = True,
                       width_parallel: bool = False) -> TrainState:
    """A model initialised from ``generator`` with the JAX package's
    schemes (any model ``build_model`` builds: an encoder-decoder needs
    ``cfg.model.ed_vocab_size``, which the trainer sets from its
    tokenizer), its EMA copy, and AdamW over every parameter. ``generator``
    stays in the state for masking and dropout, so it must live on
    ``device``.

    Under data parallelism every rank calls this with one seed: the
    weights and the generator must agree on every rank, since the ranks
    then draw one global mask (``parallel/mesh.py:rank_rows``) and apply
    one averaged gradient. One checksum all-reduce holds them to it, on
    the whole weights. Over a model axis (``parallel/mesh.py:init_mesh``)
    the model is then sharded (``shard_model``; not with
    ``tensor_parallel=False``, which keeps every weight replicated), and
    the EMA copy and AdamW's moments are made from the shards, so they are
    sharded as their parameters. ``width_parallel``: the image's width is
    sharded over the model axis too (``shard_width``, both models: any
    model, float or int8, under any remat), and each step takes a rank's
    strip of columns (``rank_width``)."""
    model = build_model(cfg.model, device=device, generator=generator)
    assert_same_on_every_rank(list(model.state_dict().values())
                              + [generator.get_state()],
                              "the initial weights or the generator's state")
    if tensor_parallel:
        shard_model(model)
    if width_parallel:
        shard_width(model)
    ema_model = copy.deepcopy(model)
    ema_model.requires_grad_(False)
    optimizer = make_base_optimizer(model.parameters(), cfg.optim)
    return TrainState(cfg=cfg, model=model, ema_model=ema_model,
                      optimizer=optimizer, generator=generator)
