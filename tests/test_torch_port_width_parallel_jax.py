"""The port's ranks with the image's width sharded over the model axis
(``htr_vt_torch/parallel/mesh.py:shard_width``) against JAX at (1, 2) (two
``gloo`` processes; (2, 2), four, in ``_jax22.py``), as
``tests/test_parallel.py:180-199`` runs JAX: ``_setup``'s config (embed 64,
depth 1, two heads, 64x128 px, float32, batch 16, masking off), the
weights replicated, the image placed ``P("data", None, "model", None)`` on
a mesh of the conftest's virtual CPU devices against the batch placed by
rows (``P("data")``), from the same weights (a seeded init crossed into
JAX's tree with every norm and BN state randomised, ``utils/convert.py``)
and the same batches.

JAX's test holds the width-sharded loss to the row-sharded one, and that
is what JAX's partitioned program gets right: on the CPU its gradient on
the width-sharded image differs from its own row-sharded (and one-device)
gradient in every stem leaf, by a large share of the leaf, while the port's
ranks and the port's one process agree with the row-sharded one. So the
ranks' first loss is held to JAX's loss on the width-sharded image
(``make_loss_fn``, the forward of the step's first pass), and the steps to
JAX's jitted ``train_step`` on the row-sharded batch: the first at the
one-step bars of the port's SAM tests
(``test_torch_port_memory_levers.py:check_against_jax``; the gradient
norm at JAX's own first-step bar for a layout change), steps 2 and 3 at
JAX's drift bars for a layout change
(``tests/test_torch_port_tensor_parallel_jax.py``). The ranks start first
and run while JAX compiles.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                               ParallelConfig)
from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
from htr_vt_tpu.parallel.mesh import make_mesh
from htr_vt_tpu.train.step import make_loss_fn
from htr_vt_tpu.train.step import train_step as jax_train_step
from htr_vt_torch.config import config_to_dict
from htr_vt_torch.utils.convert import model_to_jax_tree
from test_torch_port_distributed import collect, start
from test_torch_port_memory_levers import (RANKS_STEADY_SHARE, STEP_RTOL, check_against_jax,
                                           jax_init, port_state)
from test_torch_port_model import port_config
from test_torch_port_tensor_parallel_jax import LOSS_DRIFT, STATE_L2
from test_torch_port_width_parallel import STEPS, WIDTH_WORKER, tiny_batch
from test_torch_port_zoo import _leaves
from test_torch_port_zoo_standalone import no_dropout


# The first step's gradient norm across a layout change: JAX's own bar
# (tests/test_parallel.py:62-63). On these batches JAX's row-sharded (2, 2)
# norm lies past the one-step 1e-4 from its own one-device norm, and the
# port's ranks lie nearer to the one-device norm than JAX's do.
LAYOUT_GRAD_NORM = 1e-3


def jax_cfg(mesh_shape, **model_kw) -> ExperimentConfig:
    """``tests/test_parallel.py:_setup``'s config on a ``mesh_shape`` mesh,
    with ``model_kw`` (another stem, encoder or remat) on top."""
    return ExperimentConfig(
        model=ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1,
                          num_heads=2, compute_dtype="float32",
                          masking=MaskConfig(mode="none"), **model_kw),
        optim=OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=50),
        parallel=ParallelConfig(mesh_shape=mesh_shape))


def _start_ranks(tmp_path, cfg, batches, dropout):
    """The ranks of ``cfg``'s mesh running the steps task on ``batches``
    from a JAX state (``jax_init``), started and not waited for; the
    state, the ranks, and the batches' leaves placed as JAX's width-sharded
    loss reads them (the image ``P("data", None, "model", None)``, the
    rest by rows), with the rows' placement."""
    mesh_shape = cfg.parallel.mesh_shape
    init = jax_init(cfg, 9, batches[0])
    task = dict(kind="steps", cfg=config_to_dict(port_config(cfg)), seed=0,
                tensor_parallel=False, init=port_state(cfg, init).model.state_dict(),
                batches=batches, probe=batches[0], no_dropout=not dropout)
    procs = start(WIDTH_WORKER, tmp_path, {"mesh_shape": mesh_shape, "tasks": {"w": task}},
                  ranks=mesh_shape[0] * mesh_shape[1])
    mesh = make_mesh(cfg.parallel, devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    image = NamedSharding(mesh, PartitionSpec("data", None, "model", None))
    rows = NamedSharding(mesh, PartitionSpec("data"))
    placed = {k: jax.device_put(jnp.asarray(v), image if k == "image" else rows)
              for k, v in batches[0].items()}
    return init, procs, placed, rows


def _width_loss(cfg, model, init, placed) -> float:
    """JAX's loss (the forward of the step's first pass) on ``placed``."""
    loss_fn = make_loss_fn(model, cfg)
    return float(jax.jit(lambda p, s, b: loss_fn(p, s, b, init.rng)[0])(
        init.params, init.batch_stats, placed))


def check_width_mesh(tmp_path, mesh_shape, bs=16, dropout=True, **model_kw):
    """The ranks at ``mesh_shape`` against JAX, on ``bs``-row batches, for
    the model of ``jax_cfg(mesh_shape, **model_kw)`` (any model JAX's
    ``build_model`` builds). ``dropout=False``: dropout and drop-path off
    on both stacks (the standalone models' combine dropout draws in train
    mode, and the two stacks draw apart)."""
    cfg = jax_cfg(mesh_shape, **model_kw)
    batches = [tiny_batch(80 + i, bs) for i in range(STEPS)]
    init, procs, placed, rows = _start_ranks(tmp_path, cfg, batches, dropout)
    model = jax_build_model(cfg.model)
    with contextlib.nullcontext() if dropout else no_dropout():
        width_loss = _width_loss(cfg, model, init, placed)
        step = jax.jit(functools.partial(jax_train_step, model, cfg))
        state, want, states = init, [], []
        for batch in batches:
            state, m = step(state, {k: jax.device_put(jnp.asarray(v), rows)
                                    for k, v in batch.items()})
            want.append({k: float(v) for k, v in m.items()})
            states.append(state)

    ranks = collect(procs, tmp_path)
    r, m = mesh_shape
    assert [(x["data"], x["model"]) for x in ranks] == [
        ((d, r), (j, m)) for d in range(r) for j in range(m)]
    r0 = ranks[0]["w"]
    for x in ranks[1:]:
        assert x["w"]["metrics"] == r0["metrics"]  # global values on every rank
    np.testing.assert_allclose(r0["metrics"][0]["loss"], width_loss, rtol=STEP_RTOL)
    port = port_state(cfg, init)
    port.model.load_state_dict(r0["first"]["model"])
    check_against_jax(r0["metrics"][0], port, want[0], states[0],
                      keys=("loss", "loss_second"), steady_share=RANKS_STEADY_SHARE)
    np.testing.assert_allclose(r0["metrics"][0]["grad_norm"], want[0]["grad_norm"],
                               rtol=LAYOUT_GRAD_NORM)
    np.testing.assert_allclose([x["loss"] for x in r0["metrics"]],
                               [x["loss"] for x in want], rtol=LOSS_DRIFT)
    port.model.load_state_dict(r0["last"]["model"])
    got = _leaves(model_to_jax_tree(port.model)[0])
    ref = _leaves(jax.tree.map(np.asarray, states[-1].params))
    num = sum(float(np.sum((got[k] - v) ** 2)) for k, v in ref.items())
    den = sum(float(np.sum(v ** 2)) for v in ref.values())
    assert (num / den) ** 0.5 < STATE_L2


# The ranks' eval logits against JAX's eval forward on the width-sharded
# image: float32 on both sides, sums in other orders, the zoo's eval bar
# (tests/test_torch_port_zoo_standalone.py:EVAL_TOL).
EVAL_TOL = dict(rtol=1e-5, atol=1e-5)


def check_width_forward(tmp_path, bs=8, dropout=True, **model_kw):
    """The ranks at (1, 2) against JAX's forward on the image placed
    ``P("data", None, "model", None)``, for the model of ``jax_cfg((1, 2),
    **model_kw)``: the ranks' ``eval_step`` logits (before any step)
    against JAX's eval logits, and their first train-mode loss (pass 1 of
    the first step) against JAX's loss, at the port's one-step SAM bar.
    ``dropout`` as ``check_width_mesh``. The stems whose one-process
    gradient already lies past the one-step bars from JAX's at this config
    (van2: loss_second 1.5e-4, grad_norm 6.9e-4, the port's one process
    against JAX's jitted step; a stem's conditioning, as
    ``tests/test_torch_port_sgm.py`` found) are held to JAX here by their
    forwards, and their steps to the port's one process
    (``tests/test_torch_port_width_parallel_van.py``, ``_swin_svtr.py``)."""
    cfg = jax_cfg((1, 2), **model_kw)
    init, procs, placed, _ = _start_ranks(tmp_path, cfg, [tiny_batch(80, bs)], dropout)
    model = jax_build_model(cfg.model)
    with contextlib.nullcontext() if dropout else no_dropout():
        width_loss = _width_loss(cfg, model, init, placed)
    logits = np.asarray(jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))(
            init.params, init.batch_stats, placed["image"]))
    ranks = collect(procs, tmp_path)
    for r in ranks:
        np.testing.assert_allclose(r["w"]["metrics"][0]["loss"], width_loss, rtol=STEP_RTOL)
        np.testing.assert_allclose(r["w"]["eval"]["logits"].numpy(), logits, **EVAL_TOL)


def test_width_sharded_ranks_match_jax_one_by_two(tmp_path):
    check_width_mesh(tmp_path, (1, 2))
