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

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                               ParallelConfig)
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
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


# The first step's gradient norm across a layout change: JAX's own bar
# (tests/test_parallel.py:62-63). On these batches JAX's row-sharded (2, 2)
# norm lies past the one-step 1e-4 from its own one-device norm, and the
# port's ranks lie nearer to the one-device norm than JAX's do.
LAYOUT_GRAD_NORM = 1e-3


def jax_cfg(mesh_shape) -> ExperimentConfig:
    """``tests/test_parallel.py:_setup``'s config on a ``mesh_shape`` mesh."""
    return ExperimentConfig(
        model=ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1,
                          num_heads=2, compute_dtype="float32",
                          masking=MaskConfig(mode="none")),
        optim=OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=50),
        parallel=ParallelConfig(mesh_shape=mesh_shape))


def check_width_mesh(tmp_path, mesh_shape):
    cfg = jax_cfg(mesh_shape)
    batches = [tiny_batch(80 + i) for i in range(STEPS)]
    init = jax_init(cfg, 9, batches[0])
    task = dict(kind="steps", cfg=config_to_dict(port_config(cfg)), seed=0,
                tensor_parallel=False, init=port_state(cfg, init).model.state_dict(),
                batches=batches, probe=batches[0])
    procs = start(WIDTH_WORKER, tmp_path, {"mesh_shape": mesh_shape, "tasks": {"w": task}},
                  ranks=mesh_shape[0] * mesh_shape[1])
    mesh = make_mesh(cfg.parallel, devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    image = NamedSharding(mesh, PartitionSpec("data", None, "model", None))
    rows = NamedSharding(mesh, PartitionSpec("data"))
    loss_fn = make_loss_fn(JaxHTRVT(cfg.model), cfg)
    width_loss = float(jax.jit(lambda b: loss_fn(init.params, init.batch_stats, b,
                                                 init.rng)[0])(
        {k: jax.device_put(jnp.asarray(v), image if k == "image" else rows)
         for k, v in batches[0].items()}))
    step = jax.jit(functools.partial(jax_train_step, JaxHTRVT(cfg.model), cfg))
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


def test_width_sharded_ranks_match_jax_one_by_two(tmp_path):
    check_width_mesh(tmp_path, (1, 2))
