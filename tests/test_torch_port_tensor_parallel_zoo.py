"""The model axis over the rest of the zoo (``htr_vt_torch/parallel/mesh.py:
shard_model``) on the CPU: two ``gloo`` ranks at ``mesh_shape=(1, 2)`` (the
launch of ``tests/test_torch_port_distributed.py``) against one process of
the port, at the tiny float32 config of
``tests/test_torch_port_tensor_parallel.py`` (64x128 px, embed 64, two
heads, depth 1-3, dropout, drop-path and random masking on), each model
from one seed:

- the window, local-global, lgp, lgp_svtr, macaron, conformer and
  squeezeformer recipes, Swin and SVTR at ``build_model``'s sizes, the
  tri-masked SGM conformer and the encoder-decoder: the eval logits, three
  SAM steps (losses, gradient norm, every weight and the EMA) and the
  replicated parameters, EMA and AdamW moments equal on both ranks after
  them (a replicated table that each rank read only at its heads would
  drift apart here);
- the encoder-decoder's greedy and beam ids after the steps, equal to one
  process's;
- int8 serving (vit, conformer, squeezeformer): ``calibrate_quant_stats``
  and the eval logits, bit-equal to one process's for vit and conformer
  (every sharded site is an int8 product, whose int32 sums are exact); the
  squeezeformer's float squeeze-excite adds its fc2's two partial products
  in float32, so its logits are held at the port's int8 bar against JAX;
- checkpoints of lgp, Swin and the encoder-decoder saved at (1, 2),
  restored at (1, 2) bit for bit and into one process bit for bit.

The one-process references run in the test process while the ranks run.
JAX's sharded programs are in ``tests/test_torch_port_tensor_parallel_zoo_jax.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from htr_vt_torch.config import SGMConfig, TrainConfig, config_to_dict
from htr_vt_torch.models.encoder_decoder import generate
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.parallel import mesh
from htr_vt_torch.train.checkpoint import CheckpointManager
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import _put, eval_step, pass_loss_and_grads, train_step
from test_torch_port_distributed import collect, start
from test_torch_port_model import no_tensorboard  # noqa: F401
from test_torch_port_quant import PORT_REL
from test_torch_port_sgm import _batch as sgm_batch
from test_torch_port_tensor_parallel import (GRAD_ATOL, LATER_RTOL, LOGIT_ATOL, STEP_RTOL,
                                             assert_near, assert_same_bits, state_file,
                                             tiny_batch, tiny_cfg)

STEPS, SEED, B, ED_L = 3, 7, 4, 8
# One pass's gradient of a head-indexed relative-bias table (``rel_bias``),
# as a share of its leaf's largest element: each element sums B x windows x
# window^2 attention terms, an order the heads' split changes (every other
# leaf holds ``GRAD_ATOL``, 1e-5).
TABLE_GRAD_ATOL = 1e-4
# The bias of a convolution that feeds a train-mode BatchNorm has an exact
# gradient of zero (the BN removes any shift), so both layouts give it
# rounding noise: not compared (``tests/test_torch_port_zoo_sam.py:
# ZERO_GRADIENT``; the steps hold it to the sign-flip bound).
ZERO_GRADIENT = ("dwconv.bias", "embed_conv1.bias", "embed_conv2.bias", "proj2.bias")
SGM = SGMConfig(enable=True, sgm_lambda=0.7, ctc_lambda=0.2, sub_len=3, warmup_iters=0,
                char_emb_dim=16, vocab_size=12)
ED = dict(model_type="encoder_decoder", ed_vocab_size=10, decoder_layers=2,
          decoder_heads=2, max_seq_len=16, depth=1)
# Each recipe at its tiny size: window with one global block behind its two
# window blocks, lgp pooling to 12 tokens (32 % 12: the linear resize),
# lgp_svtr with one window block of 11 (the padded window).
MODELS = {
    "window": dict(encoder="window", depth=3),
    "localglobal": dict(encoder="localglobal"),
    "lgp": dict(encoder="lgp", depth=2, global_pool_len=12),
    "lgp_svtr": dict(encoder="lgp_svtr", depth=2, num_window_blocks=1, window_size=11),
    "macaron": dict(encoder="macaron", depth=1),
    "conformer": dict(encoder="conformer", depth=2),
    "squeezeformer": dict(encoder="squeezeformer", depth=2),
    "swin": dict(encoder="swin"),
    "svtr": dict(encoder="svtr"),
    "sgm": dict(encoder="conformer", depth=2, sgm=SGM),
    "ed": ED,
}
# Heads a rank of each sharded module's (two heads a layer at the tiny
# config; Swin's six and SVTR tiny's 2 / 4 / 8 at build_model's sizes).
HEADS = {"swin": [3], "svtr": [1, 2, 4]}
# Swin's and SVTR's lines at 64 px wide (a (4, 16) and a (16, 16) token grid),
# which their windows and masks take: the file's two costliest models.
NARROW = {"swin": 64, "svtr": 64}
CHECKPOINTED = ("lgp", "swin", "ed")
INT8 = ("vit", "conformer", "squeezeformer")
INT8_BIT_EQUAL = ("vit", "conformer")

ZOO_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None  # TensorFlow's import, ~20 s
sys.path.insert(0, os.environ["HTRVT_REPO"])
from htr_vt_torch.config import ExperimentConfig, ModelConfig, config_from_dict
from htr_vt_torch.models.encoder_decoder import generate
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.parallel import mesh
from htr_vt_torch.train.checkpoint import CheckpointManager
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import _put, eval_step, pass_loss_and_grads, train_step

mesh.maybe_initialize_distributed()
job = torch.load(os.environ["HTRVT_JOB"], weights_only=False)
mesh.init_mesh((1, 2))
rank = mesh.world()[0]


def own(state):  # this rank's state (its parts of the sharded parameters), copied
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema_model.state_dict().items()},
            "adamw": {i: {k: v.clone() for k, v in st.items()}
                      for i, st in state.optimizer.state_dict()["state"].items()},
            "step": state.step, "generator": state.generator.get_state()}


def local(state):
    return ([state.model.state_dict(), state.ema_model.state_dict()]
            + [st for st in state.optimizer.state_dict()["state"].values()])


def replicated_equal(state):
    mask = mesh.sharded_mask(state.model)
    moments = list(state.optimizer.state.values())
    tensors = []
    for p, e, st, sharded in zip(state.model.parameters(), state.ema_model.parameters(),
                                 moments, mask):
        if not sharded:
            tensors += [p, e, st["exp_avg"], st["exp_avg_sq"]]
    try:
        mesh.assert_same_on_every_rank(tensors, "the replicated parameters")
    except AssertionError as e:
        return str(e)
    return len(tensors) // 4


out = {"model": mesh.model_world()}
for name, sc in job["scenarios"].items():
    cfg = config_from_dict(ExperimentConfig, sc["cfg"])
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(sc["seed"]))
    rec = {}
    with torch.inference_mode():
        if cfg.model.model_type == "encoder_decoder":
            rec["logits"] = state.model(torch.as_tensor(sc["probe"]["image"]),
                                        torch.as_tensor(sc["probe"]["ed_input"]))
        else:
            rec["logits"] = eval_step(state.model, sc["probe"])["logits"]
    params = list(state.model.named_parameters())
    loss, _, grads = pass_loss_and_grads(state, _put(sc["probe"], "cpu"),
                                         [p for _, p in params])
    rec["pass_loss"] = float(loss.detach())
    rec["grads"] = {n: g for (n, _), g in zip(params, grads)}
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(sc["seed"]))
    rec["metrics"] = []
    for batch in sc["batches"]:
        rec["metrics"].append({k: float(v) for k, v in train_step(state, batch).items()})
        if len(rec["metrics"]) == 1:
            rec["first"] = own(state)
    rec["last"] = own(state)
    rec["names"] = [n for n, _ in state.model.named_parameters()]
    rec["replicated_equal"] = replicated_equal(state)
    rec["heads"] = sorted({m.num_heads // m.model_shards for m in state.model.modules()
                           if hasattr(type(m), "model_shards") and hasattr(m, "num_heads")})
    if cfg.model.model_type == "encoder_decoder":
        image = torch.as_tensor(sc["probe"]["image"])
        rec["greedy"] = generate(state.ema_model, image, max_len=sc["max_len"])
        rec["beam"] = generate(state.ema_model, image, method="beam_search",
                               max_len=sc["max_len"], beam_size=3)
    if sc.get("save"):
        mgr = CheckpointManager(sc["save"])
        mgr.save(state, cer=0.5, wer=0.5, best_cer=0.5, best_wer=0.5)
        back, _ = mgr.restore(sc["save"], create_train_state(
            cfg, "cpu", torch.Generator().manual_seed(sc["seed"] + 1)))
        rec["round_trip"] = all(torch.equal(a[k], b[k]) for a, b in zip(local(state), local(back))
                                for k in a) and back.step == state.step
    out[name] = rec
for name, sc in job["int8"].items():
    model = build_model(config_from_dict(ModelConfig, sc["cfg"]), device="cpu",
                        generator=torch.Generator().manual_seed(sc["seed"]))
    mesh.shard_model(model)
    stats = q8.calibrate_quant_stats(model, [sc["calib"]], 1)
    with torch.inference_mode():
        logits = eval_step(model, sc["probe"])["logits"]
    out["int8_" + name] = {"stats": stats, "logits": logits}
torch.save(out, os.path.join(os.environ["HTRVT_OUT"], f"rank{rank}.pt"))
"""


def joined(parts, names):
    """The one-process layout of the ranks' ``own`` states (``parts``, in
    rank order): each sharded parameter, its EMA and its AdamW moments put
    together (``parallel/mesh.py:unshard_tensors``), the rest rank 0's."""
    def whole(key, tensors):
        spec = mesh.param_sharding_rules(key, tensors[0])
        return mesh.unshard_tensors(tensors, spec) if spec else tensors[0]

    out = {k: parts[0][k] for k in ("step", "generator")}
    for part in ("model", "ema"):
        out[part] = {k: whole(k, [p[part][k] for p in parts]) for k in parts[0][part]}
    out["adamw"] = {i: {k: whole(names[i], [p["adamw"][i][k] for p in parts])
                        if v.dim() else v for k, v in st.items()}
                    for i, st in parts[0]["adamw"].items()}
    return out


def line_batch(seed, width):
    """``tiny_batch``'s rows at B and ``width`` px."""
    rng = np.random.default_rng(seed)
    return {"image": rng.random((B, 64, width, 1)).astype(np.float32),
            "labels": rng.integers(1, 8, (B, 4)).astype(np.int32),
            "label_lengths": np.full((B,), 4, np.int32)}


def ed_batch(seed, b=B):
    """An image batch with <sos>-led teacher-forcing input and its shifted
    output (``tests/test_torch_port_ed.py:_targets``' layout)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 10, (b, ED_L - 1))
    lengths = rng.integers(1, ED_L, b)
    tin, tout = np.zeros((b, ED_L), np.int32), np.zeros((b, ED_L), np.int32)
    for i, n in enumerate(lengths):
        tin[i, 0], tin[i, 1:n + 1] = 1, ids[i, :n]
        tout[i, :n], tout[i, n] = ids[i, :n], 2
    return {"image": rng.random((b, 64, 128, 1), dtype=np.float32),
            "labels": np.zeros((b, 4), np.int32), "label_lengths": np.zeros(b, np.int32),
            "ed_input": tin, "ed_output": tout, "ed_lengths": (lengths + 1).astype(np.int32)}


def scenario_cfg(name):
    """The model's config in one process (``mesh_shape`` None) and at (1, 2)."""
    cfg = tiny_cfg()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **MODELS[name]))
    if name == "sgm":
        cfg = dataclasses.replace(cfg, train=TrainConfig(tri_masked=True))
    return cfg, dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, mesh_shape=(1, 2)))


def scenario_batches(name):
    """(probe, the steps' batches)."""
    if name == "ed":
        return ed_batch(10), [ed_batch(30 + i) for i in range(STEPS)]
    if name == "sgm":
        return sgm_batch(10), [sgm_batch(30 + i) for i in range(STEPS)]
    width = NARROW.get(name, 128)
    return line_batch(10, width), [line_batch(30 + i, width) for i in range(STEPS)]


def int8_cfg(name):
    return dataclasses.replace(tiny_cfg().model, encoder=name, depth=2, quant="int8")


def snapshot(state):
    """``state_file`` copied: a state_dict holds the live tensors."""
    sf = state_file(state)
    return {"model": {k: v.clone() for k, v in sf["model"].items()},
            "ema": {k: v.clone() for k, v in sf["ema"].items()},
            "adamw": {i: {k: v.clone() for k, v in st.items()}
                      for i, st in sf["adamw"].items()},
            "step": sf["step"], "generator": sf["generator"].clone()}


def one_process(name):
    """The one-process run of a scenario: its eval logits, metrics a step,
    the state after the first and the last step (and the ED ids)."""
    cfg, _ = scenario_cfg(name)
    probe, batches = scenario_batches(name)
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(SEED))
    rec = {}
    with torch.inference_mode():
        if name == "ed":
            rec["logits"] = state.model(torch.as_tensor(probe["image"]),
                                        torch.as_tensor(probe["ed_input"]))
        else:
            rec["logits"] = eval_step(state.model, probe)["logits"]
    params = list(state.model.named_parameters())
    loss, _, grads = pass_loss_and_grads(state, _put(probe, "cpu"), [p for _, p in params])
    rec["pass_loss"] = float(loss.detach())
    rec["grads"] = {n: g for (n, _), g in zip(params, grads)}
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(SEED))
    rec["metrics"] = []
    for batch in batches:
        rec["metrics"].append({k: float(v) for k, v in train_step(state, batch).items()})
        if len(rec["metrics"]) == 1:
            rec["first"] = snapshot(state)
    rec["last"] = state_file(state)
    rec["names"] = [n for n, _ in state.model.named_parameters()]
    rec["lrs"] = [warmup_cosine_lr(i, max_lr=cfg.optim.max_lr,
                                   warmup_iters=cfg.optim.warmup_iters,
                                   total_iters=cfg.optim.total_iters,
                                   min_lr=cfg.optim.min_lr) for i in range(STEPS)]
    if name == "ed":
        image = torch.as_tensor(probe["image"])
        rec["greedy"] = generate(state.ema_model, image, max_len=ED_L)
        rec["beam"] = generate(state.ema_model, image, method="beam_search", max_len=ED_L,
                               beam_size=3)
    return rec


def one_process_int8(name):
    model = build_model(int8_cfg(name), device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    stats = q8.calibrate_quant_stats(model, [tiny_batch(50)["image"]], 1)
    with torch.inference_mode():
        logits = eval_step(model, tiny_batch(51))["logits"]
    return {"stats": stats, "logits": logits}


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """One launch of two ranks at (1, 2) for every model of this file; the
    one-process references run meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_zoo")
    scenarios = {}
    for name in MODELS:
        _, tp_cfg = scenario_cfg(name)
        probe, batches = scenario_batches(name)
        scenarios[name] = dict(cfg=config_to_dict(tp_cfg), seed=SEED, probe=probe,
                               batches=batches, max_len=ED_L,
                               save=(os.path.join(str(tmp), name)
                                     if name in CHECKPOINTED else None))
    int8 = {name: dict(cfg=config_to_dict(int8_cfg(name)), seed=SEED,
                       calib=tiny_batch(50)["image"], probe=tiny_batch(51))
            for name in INT8}
    procs = start(ZOO_WORKER, tmp, {"scenarios": scenarios, "int8": int8})
    one = {name: one_process(name) for name in MODELS}
    one.update({"int8_" + name: one_process_int8(name) for name in INT8})
    ranks = collect(procs, tmp)
    for name in MODELS:
        recs = [r[name] for r in ranks]
        names = recs[0]["names"]
        for key in ("first", "last"):
            recs[0][key + "_whole"] = joined([r[key] for r in recs], names)
        recs[0]["grads_whole"] = {n: joined([{"model": {n: r["grads"][n]}, "ema": {},
                                              "adamw": {}, "step": 0, "generator": None}
                                             for r in recs], names)["model"][n]
                                  for n in names}
    return dict(ranks=ranks, one=one, tmp=str(tmp))


@pytest.mark.parametrize("name", list(MODELS))
def test_each_model_at_1x2_against_one_process(zoo, name):
    """The eval logits; one train pass's loss and gradients (gathered) at
    the one-step bars, each leaf at ``GRAD_ATOL`` of its largest element, a
    relative-bias table at ``TABLE_GRAD_ATOL``; the first step's metrics at
    the one-step bars, every step's at JAX's drift bar; the weights and
    EMA after the first and the third step at ``assert_near``; both ranks'
    metrics and whole states equal; every rank holding half of each
    sharded module's heads."""
    r0, r1 = (r[name] for r in zoo["ranks"])
    one = zoo["one"][name]
    for r in (r0, r1):
        torch.testing.assert_close(r["logits"], one["logits"], rtol=0, atol=LOGIT_ATOL)
    assert r0["metrics"] == r1["metrics"]
    for key in one["metrics"][0]:
        got = [m[key] for m in r0["metrics"]]
        np.testing.assert_allclose(got[0], one["metrics"][0][key], rtol=STEP_RTOL,
                                   err_msg=key)
        np.testing.assert_allclose(got, [m[key] for m in one["metrics"]], rtol=LATER_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(r0["pass_loss"], one["pass_loss"], rtol=STEP_RTOL)
    for n, g in one["grads"].items():
        if n.endswith(ZERO_GRADIENT):
            continue
        bar = TABLE_GRAD_ATOL if n.endswith("rel_bias") else GRAD_ATOL
        torch.testing.assert_close(r0["grads_whole"][n], g, rtol=0,
                                   atol=bar * (float(g.abs().max()) or 1.0),
                                   msg=lambda m: f"{name} {n}: {m}")
    assert_near(r0["first_whole"], one["first"], one["lrs"][0], f"{name} step 1")
    assert_near(r0["last_whole"], one["last"], sum(one["lrs"]), f"{name} step {STEPS}")
    assert r0["heads"] == HEADS.get(name, [1]), r0["heads"]


@pytest.mark.parametrize("name", list(MODELS))
def test_replicated_parameters_stay_equal_on_both_ranks(zoo, name):
    """After three steps every replicated parameter, its EMA and its AdamW
    moments hold the same bits on both ranks (``assert_same_on_every_rank``
    in each rank, then each entry here; the BN statistics and the
    generator too): the gradients of what is not sharded are the model
    group's own, never one rank's."""
    for r in zoo["ranks"]:
        assert isinstance(r[name]["replicated_equal"], int), r[name]["replicated_equal"]
        assert r[name]["replicated_equal"] > 0
    r0, r1 = (r[name]["last"] for r in zoo["ranks"])
    names = zoo["ranks"][0][name]["names"]
    for part in ("model", "ema"):
        for k, v in r0[part].items():
            if mesh.param_sharding_rules(k, v) is None:
                assert torch.equal(v, r1[part][k]), (name, part, k)
    for i, st in r0["adamw"].items():
        if mesh.param_sharding_rules(names[i], st["exp_avg"]) is None:
            for k, v in st.items():
                assert torch.equal(v, r1["adamw"][i][k]), (name, names[i], k)
    assert torch.equal(r0["generator"], r1["generator"])


def test_encoder_decoder_ids_at_1x2(zoo):
    """Greedy and beam-3 ids from the EMA model after three steps: every
    rank's equal to one process's (each rank's caches hold its head)."""
    one = zoo["one"]["ed"]
    for r in zoo["ranks"]:
        assert torch.equal(r["ed"]["greedy"], one["greedy"])
        assert torch.equal(r["ed"]["beam"], one["beam"])


@pytest.mark.parametrize("name", INT8)
def test_int8_at_1x2_against_one_process(zoo, name):
    """``calibrate_quant_stats`` and the int8 eval logits at (1, 2): every
    statistic and logit bit-equal to one process's where every sharded site
    is an int8 product (vit, conformer). The squeezeformer's float
    squeeze-excite adds its fc2's two partial products in float32, so its
    statistics hold to float32 rounding, and an activation a few ulps from
    a rounding half takes the other int8 code: its logits are held at the
    port's int8 bar against JAX (``tests/test_torch_port_quant.py:
    PORT_REL``, relative L2) with every frame's argmax equal."""
    one = zoo["one"]["int8_" + name]
    for r in zoo["ranks"]:
        got = r["int8_" + name]
        assert got["stats"].keys() == one["stats"].keys()
        assert torch.equal(got["logits"], zoo["ranks"][0]["int8_" + name]["logits"])
        if name in INT8_BIT_EQUAL:
            for k, v in one["stats"].items():
                assert torch.equal(got["stats"][k], v), k
            assert torch.equal(got["logits"], one["logits"])
        else:
            for k, v in one["stats"].items():
                torch.testing.assert_close(got["stats"][k], v, rtol=1e-5, atol=0)
            rel = float((got["logits"] - one["logits"]).norm() / one["logits"].norm())
            assert rel < PORT_REL, rel
            assert torch.equal(got["logits"].argmax(-1), one["logits"].argmax(-1))


@pytest.mark.parametrize("name", CHECKPOINTED)
def test_checkpoints_move_between_the_layouts(zoo, name):
    """A (1, 2) checkpoint restores at (1, 2) bit for bit, and in one
    process to the gathered (1, 2) state bit for bit."""
    r0, r1 = (r[name] for r in zoo["ranks"])
    assert r0["round_trip"] and r1["round_trip"]
    cfg, _ = scenario_cfg(name)
    path = os.path.join(zoo["tmp"], name)
    back, _ = CheckpointManager(path).restore(path, create_train_state(
        cfg, "cpu", torch.Generator().manual_seed(SEED + 1)))
    assert_same_bits(state_file(back), r0["last_whole"], f"{name}: (1, 2) -> one process")
