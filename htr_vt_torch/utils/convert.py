"""Weights into the port, and back to the JAX tree.

One map by module type covers every model ``build_model`` builds
(``module_layout``): a linear's ``weight`` is the transposed ``kernel``, a
2-D convolution's [out, in / groups, kh, kw] weight the flax [kh, kw, in /
groups, out] kernel, a depthwise ``Conv1d``'s [C, 1, k] weight the flax
[k, 1, C] kernel, a norm's ``weight`` its ``scale``, an embedding's
``weight`` its ``embedding``, a BatchNorm's running statistics the
``batch_stats`` ``mean`` / ``var``, and any other parameter (relative bias
tables, ``alpha``, ``dir_left`` / ``dir_right``, LayerScale's ``gamma``,
``mask_token``) keeps its name. Modules carry the JAX names, with three
exceptions that follow the reference state_dict the flagship's checkpoints
use: ``HTRVT.patch_embed`` is JAX's ``stem`` and its ``blocks.<i>`` the
JAX ``block_names[i]``; a ResNet18 stem's ``layer{s}.{b}`` is
``stage{s}_block{b + 1}``; a BasicBlock's ``downsample.0`` / ``.1`` are
``proj_conv`` / ``proj_bn``. So ``HTRVT`` at any recipe and stem,
``HTRSwin``, ``SVTR`` and ``HTREncoderDecoder`` (its trunk under
``encoder``) map leaf by leaf, and either direction loads with
``load_state_dict(strict=True)``. A reference ``.pth`` is read by
``utils/torch_convert.py`` (which drops ``pos_embed``,
``num_batches_tracked`` and ``module.`` prefixes).

An int8 model's calibrated abs-maxes (the buffers whose names end in
``amax``: ``amax`` of a linear, ``conv1_amax`` / ``conv2_amax`` /
``proj_amax`` / ``out_amax`` of a BasicBlock, the stem's ``pool_amax``)
are JAX's ``quant_stats`` collection under the same module paths and leaf
names (``load_jax_params(..., quant_stats)``, ``model_quant_stats``).

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

from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from htr_vt_torch.models.htr_vt import HTRVT
from htr_vt_torch.models.stem import BasicBlock, BatchNorm, ResNet18Stem
from htr_vt_torch.ops.quant import AMAX_SUFFIX, clear_quant_stats, load_quant_stats
from htr_vt_torch.utils import torch_convert

Array = np.ndarray


class Leaf(NamedTuple):
    """Where a state_dict entry lives in the JAX tree, and its layout each
    way."""

    coll: str  # "params" | "batch_stats" | "quant_stats"
    path: Tuple[str, ...]
    to_torch: Callable[[Array], Array]
    to_jax: Callable[[Array], Array]


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _linear(w: Array) -> Array:
    return np.transpose(w, (1, 0))


def _depthwise(w: Array) -> Array:
    return np.transpose(w, (2, 1, 0))  # torch [C, 1, k] <-> flax [k, 1, C]


def _conv_to_jax(w: Array) -> Array:
    return np.transpose(w, (2, 3, 1, 0))  # [out, in/g, kh, kw] -> [kh, kw, in/g, out]


def _conv_to_torch(w: Array) -> Array:
    return np.transpose(w, (3, 2, 0, 1))


def _same(w: Array) -> Array:
    return w


def _params(name, to_torch=_same, to_jax=None):
    return ("params", name, to_torch, to_jax or to_torch)


# Leaf names by module type: torch name -> (collection, JAX name, layouts).
_LEAVES = (
    (nn.Linear, {"weight": _params("kernel", _linear), "bias": _params("bias")}),
    (nn.Conv2d, {"weight": _params("kernel", _conv_to_torch, _conv_to_jax),
                 "bias": _params("bias")}),
    (nn.Conv1d, {"weight": _params("kernel", _depthwise), "bias": _params("bias")}),
    ((nn.LayerNorm, nn.GroupNorm), {"weight": _params("scale"), "bias": _params("bias")}),
    (nn.Embedding, {"weight": _params("embedding")}),
    (BatchNorm, {"weight": _params("scale"), "bias": _params("bias"),
                 "running_mean": ("batch_stats", "mean", _same, _same),
                 "running_var": ("batch_stats", "var", _same, _same)}),
)


def _children(module: nn.Module) -> Iterator[Tuple[str, Tuple[str, ...], nn.Module]]:
    """(state_dict prefix, JAX path parts, child) of each child of
    ``module``, with the renames of the module docstring."""
    for name, child in module.named_children():
        if isinstance(module, HTRVT) and name == "patch_embed":
            yield name, ("stem",), child
        elif isinstance(module, HTRVT) and name == "blocks":
            for i, (jname, block) in enumerate(zip(module.block_names, child)):
                yield f"{name}.{i}", (jname,), block
        elif isinstance(module, ResNet18Stem) and name.startswith("layer"):
            for b, block in enumerate(child):
                yield f"{name}.{b}", (f"stage{name[5:]}_block{b + 1}",), block
        elif isinstance(module, BasicBlock) and name == "downsample":
            yield f"{name}.0", ("proj_conv",), child[0]
            yield f"{name}.1", ("proj_bn",), child[1]
        else:
            yield name, (name,), child


def module_layout(module: nn.Module, path: Tuple[str, ...] = (),
                  unset_sites: bool = False) -> Dict[str, Leaf]:
    """state_dict key of ``module`` -> its ``Leaf`` under the JAX path
    ``path``, by module type (``_LEAVES``; any other parameter keeps its
    name; an ``*amax`` buffer is a ``quant_stats`` leaf of its own name)
    and the renames of ``_children``. ``unset_sites`` also lists the
    quantized sites not calibrated yet."""
    out = {}
    rule = next((r for t, r in _LEAVES if isinstance(module, t)), None)
    leaves = [n for n, _ in module.named_parameters(recurse=False)]
    leaves += [n for n, b in module._buffers.items()
               if b is not None or (unset_sites and n.endswith(AMAX_SUFFIX))]
    for leaf in leaves:
        if leaf.endswith(AMAX_SUFFIX):
            out[leaf] = Leaf("quant_stats", path + (leaf,), _same, _same)
            continue
        coll, jname, to_torch, to_jax = rule[leaf] if rule else _params(leaf)
        out[leaf] = Leaf(coll, path + (jname,), to_torch, to_jax)
    for prefix, parts, child in _children(module):
        out.update({f"{prefix}.{k}": v
                    for k, v in module_layout(child, path + parts, unset_sites).items()})
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def load_jax_module(module: nn.Module, params, batch_stats=None) -> None:
    """Load the variables of one JAX module (its ``params`` and, for a
    BatchNorm inside, ``batch_stats`` subtree) into the port's module of
    the same kind, strictly."""
    module.load_state_dict(_tensors(jax_tree_to_state_dict(module, params, batch_stats)),
                           strict=True)


def jax_tree_to_state_dict(model: nn.Module, params, batch_stats, quant_stats=None
                           ) -> Dict[str, np.ndarray]:
    """A JAX model's (params, batch_stats) pair, and ``quant_stats`` for
    the model's calibrated sites, -> the port's state_dict keys, numpy
    values. Also maps the optax moments, which are shaped like ``params``
    (``batch_stats`` then fills the BN slots)."""
    trees = {"params": params, "batch_stats": batch_stats, "quant_stats": quant_stats}
    return {key: leaf.to_torch(np.asarray(_get(trees[leaf.coll], leaf.path)))
            for key, leaf in module_layout(model).items()}


def _jax_trees(model: nn.Module, sd: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """The JAX collections (params, batch_stats, quant_stats) of a port
    state_dict. Raises on a key outside the model's layout."""
    layout = module_layout(model)
    unused = sorted(set(sd) - set(layout))
    if unused:
        raise ValueError(f"keys outside the port's layout: {unused}")
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}, "quant_stats": {}}
    for key, leaf in layout.items():
        node = trees[leaf.coll]
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = leaf.to_jax(np.asarray(sd[key]))
    return trees


def state_dict_to_jax_tree(model: nn.Module, sd: Dict[str, np.ndarray]
                           ) -> Tuple[Dict, Dict]:
    """The reverse of ``jax_tree_to_state_dict``: (params, batch_stats)
    numpy trees. Raises on a key outside the model's layout."""
    trees = _jax_trees(model, sd)
    return trees["params"], trees["batch_stats"]


def load_jax_params(model: nn.Module, params, batch_stats, quant_stats=None) -> None:
    """Load a JAX model's (params, batch_stats) tree of numpy or JAX
    arrays (any model ``build_model`` builds) into the port's, strictly;
    with ``quant_stats`` (an int8 model's calibration, padded tree or not)
    every site that JAX's collection holds is set first and the others are
    cleared."""
    if quant_stats is not None:
        stats = {}
        for key, leaf in module_layout(model, unset_sites=True).items():
            if leaf.coll == "quant_stats":
                try:
                    stats[key] = np.asarray(_get(quant_stats, leaf.path))
                except KeyError:
                    pass
        clear_quant_stats(model)
        load_quant_stats(model, stats)
    model.load_state_dict(
        _tensors(jax_tree_to_state_dict(model, params, batch_stats, quant_stats)),
        strict=True)


def model_quant_stats(model: nn.Module) -> Dict:
    """The port's calibrated abs-maxes as JAX's ``quant_stats`` tree of
    numpy scalars."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    return _jax_trees(model, sd)["quant_stats"]


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
    like the JAX model's params and the one ``count``, from the AdamW
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
    """The port's weights as the JAX model's (params, batch_stats) pair of
    numpy trees."""
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
