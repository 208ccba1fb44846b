"""The port's model axis over the zoo against JAX's (``shard_params``,
``htr_vt_tpu/parallel/mesh.py:104-135``) on the CPU:

- the layout: for every model JAX's rules shard, the leaves JAX's
  ``shard_params`` puts on the ``model`` axis against the ones the port's
  ``param_sharding_rules`` names, through the port's weight map
  (``utils/convert.py:model_to_jax_tree``). They differ by exactly the
  leaves the port shards beyond JAX's: a column-sharded linear's bias
  (its local columns) and a head-indexed relative-bias table, by head;
- two ``gloo`` ranks at ``mesh_shape=(1, 2)`` against JAX's sharded
  ``train_step`` on a (1, 2) mesh of the conftest's virtual CPU devices,
  for the three layouts where the port's rules once differed from JAX's
  (lgp's two attention projections, Swin's head-indexed table, the
  decoder's ``self_qkv``), from the same weights (a seeded init crossed
  into JAX's tree with every norm and BN state randomised), on the 16-row
  batches of ``tests/test_torch_port_tensor_parallel_jax.py`` (the
  encoder-decoder on four rows of ``tests/test_torch_port_ed.py``'s
  layout), masking off and dropout the identity on both stacks. The first
  step at the one-step bars of the port's SAM tests, steps 2 and 3 at
  JAX's drift bars for a layout change (that file's);
- JAX's sharded int8 ``eval_step`` (calibrated with its
  ``calibrate_quant_stats`` on the sharded weights) against the port's at
  (1, 2), at the port's int8 bar against JAX
  (``tests/test_torch_port_quant.py:PORT_REL``) with every frame's argmax
  equal.

The ranks start first (``test_torch_port_distributed.py:start``) and run
while JAX compiles.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                               ParallelConfig, SGMConfig)
from htr_vt_tpu.models import layers as jlayers
from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
from htr_vt_tpu.ops.quant import calibrate_quant_stats as jax_calibrate
from htr_vt_tpu.parallel.mesh import batch_sharding, make_mesh, shard_params
from htr_vt_tpu.train.step import eval_step as jax_eval_step
from htr_vt_tpu.train.step import train_step as jax_train_step
from htr_vt_torch.config import config_to_dict
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.parallel import mesh as tmesh
from htr_vt_torch.utils.convert import model_to_jax_tree
from test_torch_port_distributed import collect, start
from test_torch_port_memory_levers import (RANKS_STEADY_SHARE, check_against_jax, jax_init,
                                           port_state)
from test_torch_port_model import no_tensorboard, port_config  # noqa: F401
from test_torch_port_quant import PORT_REL
from test_torch_port_tensor_parallel import tiny_batch
from test_torch_port_tensor_parallel_jax import LOSS_DRIFT, STATE_L2
from test_torch_port_tensor_parallel_zoo import ed_batch, joined, line_batch
from test_torch_port_zoo import _leaves

MESH, STEPS = (1, 2), 3
TINY = dict(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1, num_heads=2,
            compute_dtype="float32", masking=MaskConfig(mode="none"))
ED = dict(model_type="encoder_decoder", ed_vocab_size=10, decoder_layers=1,
          decoder_heads=2, max_seq_len=16)
# Every model whose layout JAX's rules decide (the block recipes, the VAN
# stems' blocks, Swin, SVTR, the SGM conformer and the encoder-decoder).
LAYOUTS = {
    "vit": {}, "window": dict(encoder="window", depth=3),
    "macaron": dict(encoder="macaron"), "macaron_2": dict(encoder="macaron_2"),
    "localglobal": dict(encoder="localglobal"), "lgp": dict(encoder="lgp"),
    "lgp_svtr": dict(encoder="lgp_svtr", depth=2, num_window_blocks=1, window_size=11),
    "conformer": dict(encoder="conformer"),
    "sgm_conformer": dict(encoder="conformer", sgm=SGMConfig(enable=True, vocab_size=12)),
    "squeezeformer": dict(encoder="squeezeformer", depth=2),
    "van": dict(encoder="van", stem="van"), "van2": dict(encoder="van2", stem="van2"),
    "swin": dict(encoder="swin"), "svtr": dict(encoder="svtr"), "ed": ED,
}
# The leaves the port shards beyond JAX's, by the end of their JAX name.
EXTRA = ("qkv/bias", "fc1/bias", "rel_bias")
STEP_MODELS = {"lgp": dict(encoder="lgp", global_pool_len=12), "swin": dict(encoder="swin"),
               "ed": ED}

JAX_ZOO_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None  # TensorFlow's import, ~20 s
sys.path.insert(0, os.environ["HTRVT_REPO"])
from htr_vt_torch.config import ExperimentConfig, ModelConfig, config_from_dict
from htr_vt_torch.models import conv_blocks, layers, localglobal, sgm, swin, vit
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.parallel import mesh
from htr_vt_torch.train.checkpoint import load_module_state
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, train_step

# dropout and drop-path as the identity, as the test patches JAX's
for mod in (layers, vit, localglobal, conv_blocks, sgm, swin):
    mod.dropout = lambda x, rate, train, generator, model_sharded=False: x
layers.DropPath.forward = lambda self, x, **k: x

mesh.maybe_initialize_distributed()
job = torch.load(os.environ["HTRVT_JOB"], weights_only=False)
mesh.init_mesh((1, 2))
rank = mesh.world()[0]


def own(state):  # this rank's state, copied
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ema": {}, "adamw": {}, "step": state.step, "generator": None}


out = {}
for name, sc in job["steps"].items():
    state = create_train_state(config_from_dict(ExperimentConfig, sc["cfg"]), "cpu",
                               torch.Generator().manual_seed(0))
    for m in (state.model, state.ema_model):
        load_module_state(m, sc["init"])
    rec = {"metrics": [], "names": [n for n, _ in state.model.named_parameters()]}
    for batch in sc["batches"]:
        rec["metrics"].append({k: float(v) for k, v in train_step(state, batch).items()})
        if len(rec["metrics"]) == 1:
            rec["first"] = own(state)
    rec["last"] = own(state)
    out[name] = rec
sc = job["int8"]
model = build_model(config_from_dict(ModelConfig, sc["cfg"]), device="cpu")
model.load_state_dict(sc["weights"])
mesh.shard_model(model)
q8.calibrate_quant_stats(model, [sc["image"]], 1)
with torch.inference_mode():
    out["int8"] = eval_step(model, sc["batch"])["logits"]
torch.save(out, os.path.join(os.environ["HTRVT_OUT"], f"rank{rank}.pt"))
"""


def jax_cfg(**model_kw) -> ExperimentConfig:
    """``tests/test_torch_port_tensor_parallel_jax.py``'s config at (1, 2)."""
    return ExperimentConfig(model=ModelConfig(**{**TINY, **model_kw}),
                            optim=OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=50),
                            parallel=ParallelConfig(mesh_shape=MESH))


def jax_mesh(cfg):
    return make_mesh(cfg.parallel, devices=jax.devices()[:2])


def path_name(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_port_shards_like_jax(name):
    """JAX's ``shard_params`` on the port's weights in JAX's tree, against
    the port's rules read through the same map (each parameter filled with
    1 where the port shards it, 0 elsewhere): the port shards JAX's leaves
    and, beyond them, exactly the column biases and relative-bias tables
    (``EXTRA``); lgp's two attention ``proj``s and the decoder's
    ``self_qkv`` among JAX's."""
    cfg = jax_cfg(**LAYOUTS[name])
    model = build_model(port_config(cfg.model), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    params, _ = model_to_jax_tree(model)
    placed = jax.tree_util.tree_flatten_with_path(
        shard_params(params, jax_mesh(cfg), cfg.parallel))[0]
    jax_names = {path_name(path) for path, leaf in placed
                 if "model" in str(leaf.sharding.spec)}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.fill_(float(tmesh.param_sharding_rules(n, p) is not None))
    ones, _ = model_to_jax_tree(model)
    port_names = {k for k, v in _leaves(ones).items() if np.all(v == 1.0)}
    assert jax_names and jax_names <= port_names, sorted(jax_names - port_names)
    extra = port_names - jax_names
    assert extra == {k for k in port_names if k.endswith(EXTRA)}, sorted(extra)
    must = {"lgp": ("block0/local_attn/proj/kernel", "block0/global_attn/proj/kernel"),
            "ed": ("dec0/self_qkv/kernel",), "swin": ("stage0_block0/rel_bias",)}
    for leaf in must.get(name, ()):
        assert leaf in (port_names if leaf.endswith(EXTRA) else jax_names), leaf


@pytest.fixture(scope="module")
def jax_and_ranks(tmp_path_factory):
    """The ranks' steps and int8 logits, and JAX's sharded steps and int8
    eval on the same weights and batches."""
    tmp = tmp_path_factory.mktemp("tp_zoo_jax")
    steps = {}
    for name, kw in STEP_MODELS.items():
        cfg = jax_cfg(**kw)
        make = ed_batch if name == "ed" else tiny_batch
        batches = [make(80 + i) for i in range(STEPS)]
        init = jax_init(cfg, 8, None)
        steps[name] = dict(cfg=cfg, batches=batches, init=init)
    int8_cfg = dataclasses.replace(jax_cfg().model, quant="int8", depth=2)
    int8_model = build_model(port_config(int8_cfg), device="cpu",
                             generator=torch.Generator().manual_seed(9))
    int8_params, int8_stats = model_to_jax_tree(int8_model)
    image, int8_batch = line_batch(90, 128)["image"], line_batch(91, 128)
    job = {"steps": {name: dict(cfg=config_to_dict(port_config(s["cfg"])),
                                init=port_state(s["cfg"], s["init"]).model.state_dict(),
                                batches=s["batches"]) for name, s in steps.items()},
           "int8": dict(cfg=config_to_dict(port_config(int8_cfg)),
                        weights=int8_model.state_dict(), image=image, batch=int8_batch)}
    procs = start(JAX_ZOO_WORKER, tmp, job)

    with pytest.MonkeyPatch.context() as mp:  # the identity, as the ranks patch theirs
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlayers.DropPath, "__call__", lambda self, x, *a, **k: x)
        for name, s in steps.items():
            cfg = s["cfg"]
            jmesh = jax_mesh(cfg)
            init = s["init"]
            state = init.replace(params=shard_params(init.params, jmesh, cfg.parallel),
                                 ema_params=shard_params(init.ema_params, jmesh,
                                                         cfg.parallel))
            bsh = batch_sharding(jmesh, cfg.parallel)
            step = jax.jit(functools.partial(jax_train_step, jax_build_model(cfg.model), cfg))
            s["want"], s["states"] = [], []
            for batch in s["batches"]:
                state, m = step(state, {k: jax.device_put(jnp.asarray(v), bsh)
                                        for k, v in batch.items()})
                s["want"].append({k: float(v) for k, v in m.items()})
                s["states"].append(state)
    cfg8 = ExperimentConfig(model=int8_cfg, parallel=ParallelConfig(mesh_shape=MESH))
    jmesh = jax_mesh(cfg8)
    jmodel = jax_build_model(int8_cfg)
    base = {"params": shard_params(int8_params, jmesh, cfg8.parallel),
            "batch_stats": int8_stats}
    stats = jax_calibrate(jmodel, base, [image], 1)
    bsh = batch_sharding(jmesh, cfg8.parallel)
    logits = jax.jit(lambda p, s, b, q: jax_eval_step(
        jmodel, cfg8, p, s, b, extra_vars={"quant_stats": q})["logits"])(
        base["params"], base["batch_stats"],
        {k: jax.device_put(jnp.asarray(v), bsh) for k, v in int8_batch.items()}, stats)
    ranks = collect(procs, tmp)
    return dict(ranks=ranks, steps=steps, int8=np.asarray(logits))


@pytest.mark.parametrize("name", list(STEP_MODELS))
def test_the_port_at_1x2_matches_jax_sharded_train_step(jax_and_ranks, name):
    """Both ranks' metrics equal; the first step at the one-step bars
    (losses and gradient norm 1e-4, every weight within Adam's sign-flip
    bound, steady elements within 2% of the LR); three steps' losses at
    ``LOSS_DRIFT`` and the weights' relative L2 at ``STATE_L2``."""
    s = jax_and_ranks["steps"][name]
    r0, r1 = (r[name] for r in jax_and_ranks["ranks"])
    assert r0["metrics"] == r1["metrics"]
    first = joined([r0["first"], r1["first"]], r0["names"])
    last = joined([r0["last"], r1["last"]], r0["names"])
    port = port_state(s["cfg"], s["init"])
    port.model.load_state_dict(first["model"])
    check_against_jax(r0["metrics"][0], port, s["want"][0], s["states"][0],
                      steady_share=RANKS_STEADY_SHARE)
    np.testing.assert_allclose([m["loss"] for m in r0["metrics"]],
                               [m["loss"] for m in s["want"]], rtol=LOSS_DRIFT)
    port.model.load_state_dict(last["model"])
    got = _leaves(model_to_jax_tree(port.model)[0])
    ref = _leaves(jax.tree.map(np.asarray, s["states"][-1].params))
    num = sum(float(np.sum((got[k] - v) ** 2)) for k, v in ref.items())
    den = sum(float(np.sum(v ** 2)) for v in ref.values())
    assert (num / den) ** 0.5 < STATE_L2


def test_int8_at_1x2_matches_jax_sharded_eval_step(jax_and_ranks):
    """The port's calibrated int8 logits at (1, 2) on both ranks (equal)
    against JAX's sharded int8 ``eval_step`` on the same weights and
    calibration image: relative L2 under ``PORT_REL``, every frame's
    argmax equal."""
    r0, r1 = (r["int8"].numpy() for r in jax_and_ranks["ranks"])
    np.testing.assert_array_equal(r0, r1)
    want = jax_and_ranks["int8"]
    rel = np.linalg.norm(r0.astype(np.float64) - want) / np.linalg.norm(want)
    assert rel < PORT_REL, rel
    np.testing.assert_array_equal(r0.argmax(-1), want.argmax(-1))
