"""Weights into the port, and back to the JAX tree.

The stem, mask token, final norm and head are named after the reference
``state_dict`` keys that ``utils/torch_convert.py`` maps, so both
directions reuse its numpy functions: a JAX tree goes through
``tree_to_reference_state_dict``, and a reference ``.pth`` is normalised by
a round trip through the tree (which drops ``pos_embed``,
``num_batches_tracked`` and ``module.`` prefixes). The encoder blocks of
every recipe and the SGM head carry the JAX module names below
``blocks.<i>`` (the JAX ``HTRVT.block_names[i]``) and ``sgm_head``, and map
leaf by leaf by module type (``encoder_layout``): a linear's ``weight`` is
the transposed ``kernel``, a depthwise ``Conv1d``'s [C, 1, k] weight the
flax [k, 1, C] kernel, a norm's ``weight`` its ``scale``, an embedding's
``weight`` its ``embedding``, a BatchNorm's running statistics the
``batch_stats`` ``mean`` / ``var``, and any other parameter (relative
bias tables, ``alpha``, ``dir_left`` / ``dir_right``, LayerScale's
``gamma``) keeps its name. Either direction loads with
``load_state_dict(strict=True)``.

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

from htr_vt_torch.models.stem import BatchNorm
from htr_vt_torch.utils import torch_convert


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))


def _depthwise(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 1, 0))  # torch [C, 1, k] <-> flax [k, 1, C]


def _same(w: np.ndarray) -> np.ndarray:
    return w


# Leaf names by module type: torch name -> (collection, JAX name, layout).
_LEAVES = (
    (nn.Linear, {"weight": ("params", "kernel", _linear),
                 "bias": ("params", "bias", _same)}),
    (nn.Conv1d, {"weight": ("params", "kernel", _depthwise),
                 "bias": ("params", "bias", _same)}),
    ((nn.LayerNorm, nn.GroupNorm), {"weight": ("params", "scale", _same),
                                    "bias": ("params", "bias", _same)}),
    (nn.Embedding, {"weight": ("params", "embedding", _same)}),
    (BatchNorm, {"weight": ("params", "scale", _same), "bias": ("params", "bias", _same),
                 "running_mean": ("batch_stats", "mean", _same),
                 "running_var": ("batch_stats", "var", _same)}),
)


def module_layout(module: nn.Module, path: Tuple[str, ...] = ()
                  ) -> Dict[str, Tuple[str, Tuple[str, ...], Any]]:
    """state_dict key of ``module`` -> (JAX collection, JAX path under
    ``path``, layout function) for each of its leaves, by module type
    (``_LEAVES``; any other parameter keeps its name). The layout function
    maps a value either way (a transpose that is its own inverse)."""
    out = {}
    for mname, m in module.named_modules():
        parts = tuple(mname.split(".")) if mname else ()
        rule = next((r for t, r in _LEAVES if isinstance(m, t)), None)
        leaves = [n for n, _ in m.named_parameters(recurse=False)]
        leaves += [n for n, _ in m.named_buffers(recurse=False)]
        for leaf in leaves:
            coll, jname, fn = rule[leaf] if rule else ("params", leaf, _same)
            out[f"{mname}.{leaf}" if mname else leaf] = (coll, path + parts + (jname,), fn)
    return out


def encoder_layout(model: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...], Any]]:
    """``module_layout`` of the encoder blocks (``blocks.<i>`` under the
    JAX name ``block_names[i]``) and of the SGM head."""
    out = {}
    parts = [(f"blocks.{i}", (name,), block)
             for i, (name, block) in enumerate(zip(model.block_names, model.blocks))]
    if getattr(model, "sgm_head", None) is not None:
        parts.append(("sgm_head", ("sgm_head",), model.sgm_head))
    for prefix, path, module in parts:
        out.update({f"{prefix}.{k}": v for k, v in module_layout(module, path).items()})
    return out


def load_jax_module(module: nn.Module, params, batch_stats=None) -> None:
    """Load the variables of one JAX module (its ``params`` and, for a
    BatchNorm inside, ``batch_stats`` subtree) into the port's module of
    the same recipe, strictly."""
    trees = {"params": params, "batch_stats": batch_stats}
    module.load_state_dict(_tensors({
        k: fn(np.asarray(_get(trees[coll], path)))
        for k, (coll, path, fn) in module_layout(module).items()}), strict=True)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def jax_tree_to_state_dict(model: nn.Module, params, batch_stats
                           ) -> Dict[str, np.ndarray]:
    """A JAX ``HTRVT`` (params, batch_stats) pair of any recipe -> the
    port's state_dict keys, numpy values. Also maps the optax moments,
    which are shaped like ``params`` (``batch_stats`` then fills the BN
    slots)."""
    layout = encoder_layout(model)
    roots = set(getattr(model, "block_names", ())) | {"sgm_head"}
    trunk = {k: v for k, v in params.items() if k not in roots}
    sd = torch_convert.tree_to_reference_state_dict(trunk, batch_stats)
    trees = {"params": params, "batch_stats": batch_stats}
    for key, (coll, path, fn) in layout.items():
        sd[key] = fn(np.asarray(_get(trees[coll], path)))
    return sd


def state_dict_to_jax_tree(model: nn.Module, sd: Dict[str, np.ndarray]
                           ) -> Tuple[Dict, Dict]:
    """The reverse of ``jax_tree_to_state_dict``: (params, batch_stats)
    numpy trees. Raises on a key that neither map knows."""
    layout = encoder_layout(model)
    params, stats, unused = torch_convert.reference_state_dict_to_tree(
        {k: v for k, v in sd.items() if k not in layout})
    if unused:
        raise ValueError(f"keys outside the port's layout: {unused}")
    trees = {"params": params, "batch_stats": stats}
    for key, (coll, path, fn) in layout.items():
        node = trees[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(np.asarray(sd[key]))
    return params, stats


def load_jax_params(model: nn.Module, params, batch_stats) -> None:
    """Load a JAX ``HTRVT`` (params, batch_stats) tree of numpy or JAX
    arrays, of any block recipe, into the port's model, strictly."""
    model.load_state_dict(_tensors(jax_tree_to_state_dict(model, params, batch_stats)),
                          strict=True)


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
    mu = jax_tree_to_state_dict(model, adam.mu, batch_stats)
    nu = jax_tree_to_state_dict(model, adam.nu, batch_stats)
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
        out[key] = state_dict_to_jax_tree(model, moments[tree])[0]
    return out


def model_to_jax_tree(model: nn.Module) -> Tuple[Dict, Dict]:
    """The port's weights as a JAX ``HTRVT`` (params, batch_stats) pair of
    numpy trees, for any block recipe and the SGM head."""
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    return state_dict_to_jax_tree(model, sd)


def load_reference_checkpoint(path: str, key: str = "state_dict_ema"
                              ) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` (``key``: 'state_dict_ema' or 'model', or
    a bare state_dict) as a state_dict that the port's model loads with
    ``strict=True``. Raises on keys the flagship layout does not have."""
    params, stats, unused = torch_convert.load_reference_checkpoint(path, key)
    if unused:
        raise ValueError(f"{path}: keys outside the flagship layout: {unused}")
    return _tensors(torch_convert.tree_to_reference_state_dict(params, stats))
