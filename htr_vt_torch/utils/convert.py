"""Weights into the port, through the reference PyTorch layout.

The port's modules are named after the reference ``state_dict`` keys that
``utils/torch_convert.py`` maps, so both directions reuse its
numpy functions: a JAX tree goes through ``tree_to_reference_state_dict``,
and a reference ``.pth`` is normalised by a round trip through the tree
(which drops ``pos_embed``, ``num_batches_tracked`` and ``module.``
prefixes). Either loads with ``load_state_dict(strict=True)``. The reverse,
port -> JAX tree, goes through ``reference_state_dict_to_tree``.

A JAX ``TrainState``'s optimizer state converts too. Its optax chain
(``htr_vt_tpu/optim/sam.py:55-67``: ``adamw`` on the warmup-cosine schedule,
behind ``clip_by_global_norm`` when clipping is on) keeps the Adam moments
``mu`` / ``nu`` as trees shaped like the parameters and one ``count``;
torch's AdamW keeps ``exp_avg`` / ``exp_avg_sq`` and a ``step`` per
parameter, which all hold that one count. The moments go through the same
layout map as the weights (they are elementwise, so a transposed kernel's
moments transpose with it). The port sets its LR from ``TrainState.step``
(``train/step.py``), where optax reads its schedule's own count: a state
converts only where the Adam count, the schedule count and ``step`` agree,
as they do in every state the JAX trainer writes. The JAX PRNG key has no
torch counterpart: the port's masking and dropout draw from its own
``torch.Generator``, so a converted state continues the JAX trajectory
only with the same keep masks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from htr_vt_torch.utils import torch_convert


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_jax_params(model: nn.Module, params, batch_stats) -> None:
    """Load a JAX ``HTRVT`` (params, batch_stats) tree of numpy or JAX
    arrays into the port's model, strictly."""
    sd = torch_convert.tree_to_reference_state_dict(params, batch_stats)
    model.load_state_dict(_tensors(sd), strict=True)


def load_jax_train_state(model: nn.Module, ema_model: nn.Module, state,
                         optimizer: Optional[torch.optim.Optimizer] = None
                         ) -> Optional[int]:
    """Load a JAX ``TrainState`` (or any object with its ``params``,
    ``batch_stats``, ``ema_params`` and ``ema_batch_stats`` trees, numpy or
    JAX arrays) into the model and its EMA copy, strictly. With
    ``optimizer`` (the port's AdamW over ``model.parameters()``), its
    ``opt_state`` too (``load_optax_state``); returns the step the port's
    ``TrainState.step`` takes, else None."""
    load_jax_params(model, state.params, state.batch_stats)
    load_jax_params(ema_model, state.ema_params, state.ema_batch_stats)
    if optimizer is None:
        return None
    step = int(np.asarray(state.step))
    load_optax_state(optimizer, model, state.opt_state, state.batch_stats, step)
    return step


def _adam_state(opt_state) -> Tuple[Any, Any]:
    """(the node holding ``mu``/``nu``/``count``, the schedule's ``count`` or
    None) of an optax chain state: nested tuples of named tuples."""
    adam, sched = None, None
    stack = [opt_state]
    while stack:
        node = stack.pop(0)
        fields = getattr(node, "_fields", ())
        if "mu" in fields and "nu" in fields:
            adam = node
        elif "count" in fields:
            sched = node.count
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optax state")
    return adam, sched


def _named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def load_optax_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                     opt_state, batch_stats, step: int) -> None:
    """optax ``mu`` / ``nu`` / ``count`` -> the AdamW state of ``optimizer``
    (``exp_avg`` / ``exp_avg_sq`` / ``step`` of every parameter of
    ``model``, in ``model.parameters()`` order, its param groups' order).
    ``batch_stats`` only fills the BN slots of the layout map. Raises where
    the Adam count, the schedule count and ``step`` disagree."""
    adam, sched = _adam_state(opt_state)
    count = int(np.asarray(adam.count))
    if count != step or (sched is not None and int(np.asarray(sched)) != step):
        raise ValueError(
            f"optax counts (Adam {count}, schedule "
            f"{None if sched is None else int(np.asarray(sched))}) differ from step "
            f"{step}: the port drives both the bias correction and the LR from one "
            "step")
    mu = torch_convert.tree_to_reference_state_dict(adam.mu, batch_stats)
    nu = torch_convert.tree_to_reference_state_dict(adam.nu, batch_stats)
    params = _named_params(model)
    order = [id(p) for group in optimizer.param_groups for p in group["params"]]
    index = {pid: i for i, pid in enumerate(order)}
    sd = optimizer.state_dict()
    sd["state"] = {}
    for name, p in params.items():
        if id(p) not in index:
            raise ValueError(f"{name} is not a parameter of the optimizer")
        sd["state"][index[id(p)]] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.from_numpy(np.array(mu[name], np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[name], np.float32)).to(p.device)}
    if len(sd["state"]) != len(order):
        raise ValueError("the optimizer holds parameters outside the model")
    optimizer.load_state_dict(sd)


def optax_moments(optimizer: torch.optim.Optimizer, model: nn.Module
                  ) -> Dict[str, Any]:
    """The reverse of ``load_optax_state``: {"mu", "nu"} numpy trees shaped
    like the JAX ``HTRVT`` params and the one ``count``, from the AdamW
    state (which must hold every parameter, at one step)."""
    sd = {k: v.detach().float().cpu().numpy().copy()
          for k, v in model.state_dict().items()}
    moments = {"exp_avg": dict(sd), "exp_avg_sq": dict(sd)}
    steps = set()
    for name, p in _named_params(model).items():
        st = optimizer.state[p]
        steps.add(int(st["step"]))
        for key in moments:
            moments[key][name] = st[key].detach().float().cpu().numpy().copy()
    if len(steps) != 1:
        raise ValueError(f"AdamW steps differ between parameters: {sorted(steps)}")
    out = {"count": np.int32(steps.pop())}
    for key, tree in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        params, _, unused = torch_convert.reference_state_dict_to_tree(moments[tree])
        if unused:
            raise ValueError(f"keys outside the flagship layout: {unused}")
        out[key] = params
    return out


def model_to_jax_tree(model: nn.Module) -> Tuple[Dict, Dict]:
    """The port's weights as a JAX ``HTRVT`` (params, batch_stats) pair of
    numpy trees. Raises on a state_dict key the flagship layout lacks."""
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    params, stats, unused = torch_convert.reference_state_dict_to_tree(sd)
    if unused:
        raise ValueError(f"keys outside the flagship layout: {unused}")
    return params, stats


def load_reference_checkpoint(path: str, key: str = "state_dict_ema"
                              ) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` (``key``: 'state_dict_ema' or 'model', or
    a bare state_dict) as a state_dict that the port's model loads with
    ``strict=True``. Raises on keys the flagship layout does not have."""
    params, stats, unused = torch_convert.load_reference_checkpoint(path, key)
    if unused:
        raise ValueError(f"{path}: keys outside the flagship layout: {unused}")
    return _tensors(torch_convert.tree_to_reference_state_dict(params, stats))
