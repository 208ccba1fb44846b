"""Two data ranks times two model ranks of the port (``mesh_shape=(2, 2)``,
four ``gloo`` processes on the CPU) against JAX's ``train_step`` with
``shard_params`` on a (2, 2) mesh of the conftest's virtual CPU devices, as
``tests/test_parallel.py:test_tensor_parallel_mesh_runs`` builds it: its
tiny config (embed 64, depth 1, two heads, 64x128 px, float32, batch 16,
``max_lr`` 1e-3), from the same weights (a seeded init crossed into JAX's
tree with every norm and BN state randomised), on the same batches.

The first step is held at the one-step bars of the port's SAM tests
(``test_torch_port_memory_levers.py:check_against_jax``: losses and
gradient norm 1e-4, every weight within Adam's sign-flip bound, the steady
elements within 2% of the LR); steps 2 and 3 at JAX's own drift bars for a
layout change (``tests/test_parallel.py:41-55,71-77``: the loss 3e-3, the
weights' global relative L2 1e-2). The same four ranks then run ``fit`` at
(2, 2) on a tiny SYNTH run.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                               ParallelConfig)
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.parallel.mesh import batch_sharding, make_mesh, shard_params
from htr_vt_tpu.train.step import train_step as jax_train_step
from htr_vt_torch.config import config_to_dict
from htr_vt_torch.utils.convert import model_to_jax_tree
from test_torch_port_distributed import collect, start
from test_torch_port_loop import tiny_experiment
from test_torch_port_memory_levers import (RANKS_STEADY_SHARE, check_against_jax, jax_init,
                                           port_state)
from test_torch_port_model import no_tensorboard, port_config  # noqa: F401
from test_torch_port_tensor_parallel import TP_WORKER, tiny_batch
from test_torch_port_zoo import _leaves

MESH, STEPS = (2, 2), 3
LOSS_DRIFT, STATE_L2 = 3e-3, 1e-2


def jax_cfg() -> ExperimentConfig:
    """``tests/test_parallel.py:_setup``'s config on a (2, 2) mesh."""
    return ExperimentConfig(
        model=ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1,
                          num_heads=2, compute_dtype="float32",
                          masking=MaskConfig(mode="none")),
        optim=OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=50),
        parallel=ParallelConfig(mesh_shape=MESH))


def test_two_by_two_matches_jax_sharded_train_step(tmp_path):
    cfg = jax_cfg()
    batches = [tiny_batch(70 + i) for i in range(STEPS)]
    init = jax_init(cfg, 8, batches[0])
    fit_cfg = tiny_experiment(tmp_path, "tp22", total=2)
    fit_cfg = dataclasses.replace(fit_cfg, parallel=dataclasses.replace(
        fit_cfg.parallel, mesh_shape=MESH))
    job = {"mesh_shape": MESH,
           "scenarios": {"jax": dict(cfg=config_to_dict(port_config(cfg)), seed=0,
                                     init=port_state(cfg, init).model.state_dict(),
                                     batches=batches)},
           "fit": [config_to_dict(fit_cfg)]}
    procs = start(TP_WORKER, tmp_path, job, ranks=4)  # JAX compiles meanwhile
    mesh = make_mesh(cfg.parallel, devices=jax.devices()[:4])
    state = init.replace(params=shard_params(init.params, mesh, cfg.parallel),
                         ema_params=shard_params(init.ema_params, mesh, cfg.parallel))
    qkv = state.params["block0"]["attn"]["qkv"]["kernel"]
    assert "model" in str(qkv.sharding.spec)
    bsh = batch_sharding(mesh, cfg.parallel)
    step = jax.jit(functools.partial(jax_train_step, JaxHTRVT(cfg.model), cfg))
    want, states = [], []
    for batch in batches:
        state, m = step(state, {k: jax.device_put(jnp.asarray(v), bsh)
                                for k, v in batch.items()})
        want.append({k: float(v) for k, v in m.items()})
        states.append(state)

    ranks = collect(procs, tmp_path)
    assert [(r["data"], r["model"]) for r in ranks] == [
        ((d, 2), (m, 2)) for d in range(2) for m in range(2)]
    # fit at (2, 2): every rank reads the same best CER and WER (eval gathers
    # the data ranks' rows), one run.log and a best_CER checkpoint
    assert all(r["fit"] == ranks[0]["fit"] for r in ranks)
    run = tmp_path / "tp22"
    assert sorted(os.listdir(run)).count("run.log") == 1 and (run / "best_CER").is_dir()
    r0 = ranks[0]["jax"]
    for r in ranks[1:]:
        assert r["jax"]["metrics"] == r0["metrics"]  # global values on every rank
    port = port_state(cfg, init)
    port.model.load_state_dict(r0["first"]["model"])
    check_against_jax(r0["metrics"][0], port, want[0], states[0],
                      steady_share=RANKS_STEADY_SHARE)

    np.testing.assert_allclose([m["loss"] for m in r0["metrics"]],
                               [m["loss"] for m in want], rtol=LOSS_DRIFT)
    port.model.load_state_dict(r0["last"]["model"])
    got = _leaves(model_to_jax_tree(port.model)[0])
    ref = _leaves(jax.tree.map(np.asarray, states[-1].params))
    num = sum(float(np.sum((got[k] - v) ** 2)) for k, v in ref.items())
    den = sum(float(np.sum(v ** 2)) for v in ref.values())
    assert (num / den) ** 0.5 < STATE_L2


def test_the_port_shards_like_jax():
    """The leaves JAX's rules shard over ``model`` are the ones the port
    shards (its qkv and fc1 biases too: a column-sharded linear's bias is
    its local columns'; and no rel_bias at this config)."""
    cfg = jax_cfg()
    mesh = make_mesh(cfg.parallel, devices=jax.devices()[:4])
    init = jax_init(cfg, 8, None)
    sharded = jax.tree_util.tree_flatten_with_path(
        shard_params(init.params, mesh, cfg.parallel))[0]
    jax_names = {"/".join(str(getattr(k, "key", k)) for k in path)
                 for path, leaf in sharded if "model" in str(leaf.sharding.spec)}
    from htr_vt_torch.parallel import mesh as tmesh
    model = port_state(cfg, init).model
    port_names = {n for n, p in model.named_parameters()
                  if tmesh.param_sharding_rules(n, p) is not None}
    assert jax_names == {"block0/attn/qkv/kernel", "block0/attn/proj/kernel",
                         "block0/mlp/fc1/kernel", "block0/mlp/fc2/kernel"}
    assert port_names == {"blocks.0.attn.qkv.weight", "blocks.0.attn.qkv.bias",
                          "blocks.0.attn.proj.weight", "blocks.0.mlp.fc1.weight",
                          "blocks.0.mlp.fc1.bias", "blocks.0.mlp.fc2.weight"}
