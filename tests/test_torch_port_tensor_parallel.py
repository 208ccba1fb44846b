"""Tensor parallelism over the mesh's model axis (``htr_vt_torch/parallel/
mesh.py``: ``init_mesh``, ``shard_model``, ``copy_to_model`` /
``reduce_from_model``) on the CPU, at the tiny config of
``tests/test_parallel.py:_setup`` (embed 64, depth 1, two heads, 64x128 px,
float32, batch 16), with dropout, drop-path and random masking on:

- the layout alone: a shard and gather round trip is exact, the qkv shard
  of rank m is q, k and v of heads ``m * H / M ...`` of the whole weight,
  the name rules, every model sharding and running at a stand-in grid and
  heads the axis does not divide raising;
- two ``gloo`` ranks at ``mesh_shape=(1, 2)`` (the launch of
  ``tests/test_torch_port_distributed.py``) against one process of the
  port: the eval logits, one pass's loss and gradients (the replicated ones
  bit-equal on both ranks, the BN running statistics bit-equal to one
  process's: the data axis has size 1), three SAM steps (losses, gradient
  norm, every weight, the EMA and AdamW's moments), ``validate``, and
  checkpoints moved between the layouts both ways, bit for bit;
- ``fit`` at ``(1, 2)`` against ``fit`` in one process.

Two data ranks times two model ranks against JAX's sharded ``train_step``
are in ``tests/test_torch_port_tensor_parallel_jax.py``; the rest of the
zoo at (1, 2) in ``tests/test_torch_port_tensor_parallel_zoo.py`` and
``_zoo_jax.py``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from htr_vt_torch.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                                 config_to_dict)
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.parallel import mesh
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.train import loop
from htr_vt_torch.train.checkpoint import CheckpointManager
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, pass_loss_and_grads, train_step
from test_torch_port_distributed import launch
from test_torch_port_loop import tiny_experiment
from test_torch_port_model import no_tensorboard  # noqa: F401

B, STEPS, SEED = 16, 3, 5
ALPHABET = list("abcdefg")  # nb_cls 8
# (1, 2) against one process: the same arithmetic but for the order of the
# float32 sums that the model axis splits (each row-sharded product's two
# halves, added by the all-reduce; the SAM norm's squares). LOGIT_ATOL: the
# eval and train logits (LayerNormed, O(1)); STEP_RTOL: one pass's loss and
# the first step's losses and gradient norm (read up to 2e-7); GRAD_ATOL:
# one pass's gradients and the first step's AdamW moments outside the stem
# (``assert_near``), each leaf held
# to this share of its largest element (twice that for the second moment,
# a square); LATER_RTOL: the losses and gradient norms of steps 2 and 3,
# JAX's ~1e-3 drift (tests/test_parallel.py:41-55): from the second step the
# tiny stem turns Adam's sign flips into gradients 2.6e-4 apart (read at
# the second step's gradient norm, and reproduced exactly by one process
# whose proj and fc2 add their two halves' products as the model axis
# does); the weights and the EMA within 1e-5 of their value and Adam's
# sign-flip bound (2 x the summed LR: an element whose gradient is within
# float32 noise steps either way).
LOGIT_ATOL = 1e-5
STEP_RTOL = 1e-5
GRAD_ATOL = 1e-5
LATER_RTOL = 1e-3
WEIGHT_RTOL, FLIP_LRS = 1e-5, 2.01
# JAX's tiny optimizer of tests/test_torch_port_distributed.py (a first LR
# of 1e-6): at tests/test_parallel.py's (a first LR of 3.3e-4) this tiny
# stem is ill-conditioned, and a second step reads gradient norms 1e-2
# apart from rounding alone, so the parity is read where the weights
# barely move and the losses and gradient norms carry it.
OPTIM = OptimConfig(total_iters=100)

TP_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None  # TensorFlow's import, ~20 s
sys.path.insert(0, os.environ["HTRVT_REPO"])
from htr_vt_torch.config import ExperimentConfig, config_from_dict
from htr_vt_torch.eval.validate import validate
from htr_vt_torch.parallel import mesh
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.train import loop
from htr_vt_torch.train.checkpoint import CheckpointManager, load_module_state
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, pass_loss_and_grads, train_step

mesh.maybe_initialize_distributed()
job = torch.load(os.environ["HTRVT_JOB"], weights_only=False)
mesh.init_mesh(job["mesh_shape"])
rank = mesh.world()[0]
d, R = mesh.data_world()


def mine(batch):
    b = len(batch["image"]) // R
    return {k: v[d * b:(d + 1) * b] for k, v in batch.items()}


def whole(state):
    # the one-process layout, copied: a state_dict holds the live tensors
    adamw = mesh.gather_optimizer_state(state.model, state.optimizer)["state"]
    return {"model": {k: v.clone() for k, v in mesh.gather_state_dict(state.model).items()},
            "ema": {k: v.clone() for k, v in mesh.gather_state_dict(state.ema_model).items()},
            "adamw": {i: {k: v.clone() for k, v in st.items()} for i, st in adamw.items()},
            "step": state.step, "generator": state.generator.get_state()}


def fresh(sc):
    state = create_train_state(config_from_dict(ExperimentConfig, sc["cfg"]), "cpu",
                               torch.Generator().manual_seed(sc["seed"]))
    if sc.get("init") is not None:
        for m in (state.model, state.ema_model):
            load_module_state(m, sc["init"])
    return state


def local(state):
    return ([state.model.state_dict(), state.ema_model.state_dict()]
            + [st for st in state.optimizer.state_dict()["state"].values()])


out = {"world": mesh.world(), "data": mesh.data_world(), "model": mesh.model_world()}
for name, sc in job.get("scenarios", {}).items():
    rec = {}
    if sc.get("probe") is not None:
        state = fresh(sc)
        probe = {k: torch.as_tensor(v) for k, v in mine(sc["probe"]).items()}
        rec["logits"] = eval_step(state.model, probe)["logits"]
        params = [p for _, p in state.model.named_parameters()]
        names = [n for n, _ in state.model.named_parameters()]
        loss, _, grads = pass_loss_and_grads(state, probe, params)
        rec["pass_loss"] = float(loss.detach())
        rec["replicated"] = {n: g for n, g, s in zip(names, grads,
                                                    mesh.sharded_mask(state.model)) if not s}
        rec["grads"] = {n: mesh.gather_model(g, mesh.param_sharding_rules(n, g)) if
                        mesh.param_sharding_rules(n, g) else g for n, g in zip(names, grads)}
        rec["stats"] = {k: v.clone() for k, v in state.model.state_dict().items()
                        if "running" in k}
        rec["train_logits"] = state.model(probe["image"], train=True,
                                          generator=state.generator)
    state = fresh(sc)
    rec["metrics"] = []
    for batch in sc["batches"]:
        rec["metrics"].append({k: float(v) for k, v in train_step(state, mine(batch)).items()})
        if len(rec["metrics"]) == 1:
            rec["first"] = whole(state)
    rec["last"] = whole(state)
    if sc.get("val"):
        rec["val"] = validate(state.ema_model, iter(sc["val"]), CTCLabelConverter(sc["alphabet"]))
    if sc.get("save"):
        mgr = CheckpointManager(sc["save"])
        mgr.save(state, cer=0.5, wer=0.5, best_cer=0.5, best_wer=0.5)
        back, _ = mgr.restore(sc["save"], fresh(sc))
        rec["round_trip"] = all(torch.equal(a[k], b[k]) for a, b in zip(local(state), local(back))
                                for k in a) and back.step == state.step and torch.equal(
            back.generator.get_state(), state.generator.get_state())
    if sc.get("restore"):
        back, _ = CheckpointManager(sc["restore"]).restore(sc["restore"], fresh(sc))
        rec["restored"] = whole(back)
    out[name] = rec
out["fit"] = [loop.fit(config_from_dict(ExperimentConfig, c), device="cpu")
              for c in job.get("fit", [])]
torch.save(out, os.path.join(os.environ["HTRVT_OUT"], f"rank{rank}.pt"))
"""


def tiny_cfg(**model_kw) -> ExperimentConfig:
    """``tests/test_parallel.py:_setup``'s config in the port's types, with
    dropout, drop-path and random masking on."""
    kw = dict(drop_rate=0.1, drop_path_rate=0.1,
              masking=MaskConfig(mode="random", ratio=0.3))
    kw.update(model_kw)
    return ExperimentConfig(
        model=ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1,
                          num_heads=2, compute_dtype="float32", **kw),
        optim=OPTIM)


def tiny_batch(seed: int, bs: int = B) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.random((bs, 64, 128, 1)).astype(np.float32),
            "labels": rng.integers(1, 8, (bs, 4)).astype(np.int32),
            "label_lengths": np.full((bs,), 4, np.int32)}


def eval_batches(seed):
    """Two eval batches of B, the last with 11 valid rows."""
    out = []
    for i, valid in enumerate((B, 11)):
        b = tiny_batch(seed + i)
        texts = ["".join(ALPHABET[c - 1] for c in row) for row in b["labels"][:valid]]
        out.append((b, valid, texts))
    return out


def one_process_state(cfg=None):
    return create_train_state(cfg or tiny_cfg(), "cpu", torch.Generator().manual_seed(SEED))


def state_file(state):
    """A state in the layout ``CheckpointManager`` saves (one process)."""
    return {"model": state.model.state_dict(), "ema": state.ema_model.state_dict(),
            "adamw": state.optimizer.state_dict()["state"], "step": state.step,
            "generator": state.generator.get_state()}


def assert_same_bits(got, want, what):
    for part in ("model", "ema"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (what, part, k)
    assert got["adamw"].keys() == want["adamw"].keys()
    for i, st in want["adamw"].items():
        for k, v in st.items():
            assert torch.equal(got["adamw"][i][k], v), (what, "adamw", i, k)
    assert got["step"] == want["step"], what
    assert torch.equal(got["generator"], want["generator"]), what


def assert_near(got, want, lr_sum, what, moments=()):
    """Weights and EMA at the bars above; with ``moments`` (the parameter
    names in order) AdamW's too, but for the stem's, whose second-pass
    gradients differ between the layouts in elements up to 6% of their
    leaf's largest (``tests/test_torch_port_memory_levers.py:STEP_RTOL``'s
    note: max-pool and ReLU switches), so that the moments of one step
    hold its weights alone."""
    for part in ("model", "ema"):
        for k, v in want[part].items():
            atol = FLIP_LRS * lr_sum if v.is_floating_point() else 0
            torch.testing.assert_close(got[part][k], v, rtol=WEIGHT_RTOL, atol=atol,
                                       msg=lambda m: f"{what} {part} {k}: {m}")
    for i, st in want["adamw"].items() if moments else ():
        if moments[i].startswith("patch_embed."):
            continue
        for k, v in st.items():
            share = 2 * GRAD_ATOL if k == "exp_avg_sq" else GRAD_ATOL
            torch.testing.assert_close(got["adamw"][i][k], v, rtol=0,
                                       atol=share * float(v.abs().max()),
                                       msg=lambda m: f"{what} adamw {i} {k}: {m}")


# --- the layout ---------------------------------------------------------------------
@pytest.mark.parametrize("name,shape,spec", [
    ("blocks.0.attn.qkv.weight", (192, 64), mesh.Shard("column", 0, 3)),
    ("blocks.0.attn.qkv.bias", (192,), mesh.Shard("column", 0, 3)),
    ("blocks.0.mlp.fc1.weight", (256, 64), mesh.Shard("column", 0)),
    ("blocks.0.mlp.fc1.bias", (256,), mesh.Shard("column", 0)),
    ("blocks.0.attn.proj.weight", (64, 64), mesh.Shard("row", 1)),
    ("blocks.0.mlp.fc2.weight", (64, 256), mesh.Shard("row", 1)),
    ("blocks.0.attn.rel_bias", (255, 2), mesh.Shard("column", 1)),
    ("blocks.0.attn.proj.bias", (64,), None), ("blocks.0.mlp.fc2.bias", (64,), None),
    ("blocks.0.norm1.weight", (64,), None), ("head.weight", (8, 64), None),
    ("patch_embed.conv1.weight", (32, 1, 3, 3), None), ("mask_token", (1, 1, 64), None)])
def test_sharding_rules_and_an_exact_round_trip(name, shape, spec):
    """JAX's name rules on the port's names (torch's [out, in] weights: a
    column shard splits dimension 0), and shard -> gather giving the tensor
    back bit for bit at M = 2 and 4."""
    t = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    assert mesh.param_sharding_rules(name, t) == spec
    if spec is None:
        return
    for size in (2, 4) if shape[spec.dim] % (4 * spec.groups) == 0 else (2,):
        parts = [mesh.shard_tensor(t, spec, m, size) for m in range(size)]
        assert all(p.shape[spec.dim] == shape[spec.dim] // size for p in parts)
        assert torch.equal(mesh.unshard_tensors(parts, spec), t)


def test_the_qkv_shard_is_head_aligned():
    """qkv's rows are [3, H, head_dim]: rank m keeps q, k and v of heads
    m * H / M ..., not a contiguous slice of the 3 * D rows."""
    h, hd, d, size = 6, 4, 24, 2
    w = torch.arange(3 * d * d, dtype=torch.float32).view(3 * d, d)
    spec = mesh.param_sharding_rules("blocks.0.attn.qkv.weight", w)
    for m in range(size):
        part = mesh.shard_tensor(w, spec, m, size).view(3, h // size, hd, d)
        heads = slice(m * h // size, (m + 1) * h // size)
        assert torch.equal(part, w.view(3, h, hd, d)[:, heads])
    table = torch.arange(7 * h, dtype=torch.float32).view(7, h)
    spec = mesh.param_sharding_rules("blocks.0.attn.rel_bias", table)
    assert torch.equal(mesh.shard_tensor(table, spec, 1, size), table[:, 3:])


@pytest.fixture
def stand_in_grid(monkeypatch):
    """A model axis of 2 in one process (rank 0 of a (1, 2) grid) whose
    collectives hand back what they are given (a sum is this rank's part,
    a gather this rank's part M times): the layout and the shapes of a
    sharded forward, not its values (those are held across two ranks in
    ``tests/test_torch_port_tensor_parallel_zoo.py``)."""
    monkeypatch.setattr(mesh, "_GRID", mesh.Grid(shape=(1, 2), data=(0, 1), model=(0, 2),
                                                 data_group=None, model_group=None))
    monkeypatch.setattr(mesh, "_all_reduce_", lambda t, op=None, group=None: t)
    monkeypatch.setattr(mesh, "_all_gather", lambda x, size, group: [x.contiguous()] * size)


@pytest.mark.parametrize("what,cfg,error", [
    ("WindowAttention1D", dict(encoder="window", depth=3), None),
    ("ConformerBlock", dict(encoder="conformer"), None),
    ("LocalBlock1D", dict(encoder="localglobal"), None),
    ("HTRSwin", dict(encoder="swin"), None),
    ("SVTR", dict(encoder="svtr"), None),
    ("SGM head", dict(encoder="conformer", sgm_kw=True), None),
    ("quant='int8'", dict(quant="int8"), None),
    ("HTREncoderDecoder", dict(model_type="encoder_decoder", ed_vocab_size=12,
                               decoder_layers=1, decoder_heads=2, depth=1), None),
    ("3 heads", dict(num_heads=3, embed_dim=96), ValueError)])
def test_what_the_model_axis_does_not_cover_raises(what, cfg, error, stand_in_grid):
    """Under a model axis of 2 (a stand-in grid), ``shard_model`` covers
    every model ``build_model`` builds: each of these shards (a sharded
    layout for each parameter the rules name) and runs one eval forward to
    finite outputs of one process's shape. What the axis does not cover is
    heads or hidden units it does not divide: that raises, naming them."""
    from htr_vt_torch.config import SGMConfig
    from htr_vt_torch.ops import quant as q8
    sgm = cfg.pop("sgm_kw", False)
    kw = dict(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2, num_heads=2,
              compute_dtype="float32")
    kw.update(cfg)
    if sgm:
        kw["sgm"] = SGMConfig(enable=True, vocab_size=12)
    model = build_model(ModelConfig(**kw), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    if error is not None:
        with pytest.raises(error, match=what.replace("(", r"\(").replace("'", ".")):
            mesh.shard_model(model)
        return
    image = torch.rand(2, 64, 128, 1, generator=torch.Generator().manual_seed(1))
    whole = {n: p.shape for n, p in model.named_parameters()}
    args = (image,)
    if kw.get("model_type") == "encoder_decoder":
        args += (torch.ones(2, 4, dtype=torch.long),)
    with torch.inference_mode():
        want = model(*args).shape
    mesh.shard_model(model)
    if kw.get("quant") == "int8":
        q8.calibrate_quant_stats(model, [image.numpy()], 1)
    with torch.inference_mode():
        out = model(*args)
    assert out.shape == want and torch.isfinite(out).all()
    sharded = 0
    for n, p in model.named_parameters():
        spec = mesh.param_sharding_rules(n, p)
        shape = list(whole[n])
        if spec is not None:
            shape[spec.dim] //= 2
            sharded += 1
        assert list(p.shape) == shape, n
    assert sharded and model.model_shards == 2


def test_rank_cols_keep_the_whole_widths_draw(monkeypatch):
    """A draw over a sharded last dimension: each model rank keeps its
    columns of the whole width's draw, which advances the generator as one
    process does."""
    draw = lambda w: torch.rand((3, w), generator=g)  # noqa: E731
    g = torch.Generator().manual_seed(1)
    whole = draw(8)
    after = torch.rand(2, generator=g)
    for m in range(2):
        monkeypatch.setattr(mesh, "model_world", lambda m=m: (m, 2))
        g = torch.Generator().manual_seed(1)
        assert torch.equal(mesh.rank_cols(draw, 4), whole[:, m * 4:(m + 1) * 4])
        assert torch.equal(torch.rand(2, generator=g), after)


# --- (1, 2) against one process -----------------------------------------------------
@pytest.fixture(scope="module")
def model_axis(tmp_path_factory):
    """One launch of two ranks at (1, 2) for every scenario of this file."""
    tmp = tmp_path_factory.mktemp("tp")
    cfg = tiny_cfg()
    ref = one_process_state(cfg)
    for batch in [tiny_batch(20 + i) for i in range(2)]:
        train_step(ref, batch)
    one_dir = os.path.join(str(tmp), "one")
    CheckpointManager(one_dir).save(ref, cer=0.5, wer=0.5, best_cer=0.5, best_wer=0.5)
    tp_cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                   mesh_shape=(1, 2)))
    fit_cfgs = [tiny_experiment(tmp, "tp_fit", total=4)]
    fit_cfgs = [dataclasses.replace(c, parallel=dataclasses.replace(
        c.parallel, mesh_shape=(1, 2))) for c in fit_cfgs]
    job = {"mesh_shape": (1, 2),
           "scenarios": {"tp": dict(cfg=config_to_dict(tp_cfg), seed=SEED,
                                    probe=tiny_batch(10),
                                    batches=[tiny_batch(30 + i) for i in range(STEPS)],
                                    val=eval_batches(40), alphabet=ALPHABET,
                                    save=os.path.join(str(tmp), "tp"), restore=one_dir),
                         "remat": dict(cfg=config_to_dict(dataclasses.replace(
                             tp_cfg, model=dataclasses.replace(tp_cfg.model,
                                                               remat="blocks"))),
                                       seed=SEED, batches=[tiny_batch(30)])},
           "fit": [config_to_dict(c) for c in fit_cfgs]}
    ranks = launch(TP_WORKER, tmp, job)
    return dict(ranks=ranks, job=job, ref=state_file(ref), tmp=str(tmp), fit_cfgs=fit_cfgs)


def test_the_grid_puts_rank_r_at_r_div_m_and_r_mod_m(model_axis):
    assert [(r["world"], r["data"], r["model"]) for r in model_axis["ranks"]] == \
        [((0, 2), (0, 1), (0, 2)), ((1, 2), (0, 1), (1, 2))]


def test_one_pass_against_one_process(model_axis):
    """The eval logits, one train pass's loss and gradients and the train
    logits after it: the replicated gradients bit-equal on both model ranks,
    the BN running statistics (the stem runs before any sharded layer, on
    a data axis of one) bit-equal to one process's."""
    r0, r1 = (r["tp"] for r in model_axis["ranks"])
    state = one_process_state()
    probe = {k: torch.as_tensor(v) for k, v in
             model_axis["job"]["scenarios"]["tp"]["probe"].items()}
    logits = eval_step(state.model, probe)["logits"]
    params = list(state.model.parameters())
    loss, _, grads = pass_loss_and_grads(state, probe, params)
    names = [n for n, _ in state.model.named_parameters()]
    for r in (r0, r1):
        torch.testing.assert_close(r["logits"], logits, rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(r["pass_loss"], float(loss.detach()), rtol=STEP_RTOL)
    for k, g in r0["replicated"].items():
        assert torch.equal(g, r1["replicated"][k]), k
    assert "blocks.0.norm1.weight" in r0["replicated"]
    assert "blocks.0.attn.qkv.weight" not in r0["replicated"]
    for n, g in zip(names, grads):
        scale = float(g.abs().max()) or 1.0
        torch.testing.assert_close(r0["grads"][n], g, rtol=0, atol=GRAD_ATOL * scale,
                                   msg=lambda m: f"{n}: {m}")
    for k, v in state.model.state_dict().items():
        if "running" in k:
            assert torch.equal(r0["stats"][k], v), k
    train_logits = state.model(probe["image"], train=True,
                               generator=state.generator)
    torch.testing.assert_close(r0["train_logits"], train_logits.detach(), rtol=0,
                               atol=LOGIT_ATOL)


def test_three_steps_and_validate_against_one_process(model_axis):
    r0, r1 = (r["tp"] for r in model_axis["ranks"])
    sc = model_axis["job"]["scenarios"]["tp"]
    state = one_process_state()
    cfg = state.cfg.optim
    lrs = [warmup_cosine_lr(i, max_lr=cfg.max_lr, warmup_iters=cfg.warmup_iters,
                            total_iters=cfg.total_iters, min_lr=cfg.min_lr)
           for i in range(STEPS)]
    want = []
    for i, batch in enumerate(sc["batches"]):
        want.append({k: float(v) for k, v in train_step(state, batch).items()})
        if i == 0:
            assert_near(r0["first"], state_file(state), lrs[0], "step 1",
                        moments=[n for n, _ in state.model.named_parameters()])
    assert r0["metrics"] == r1["metrics"]
    for key in want[0]:
        got = [m[key] for m in r0["metrics"]]
        np.testing.assert_allclose(got[0], want[0][key], rtol=STEP_RTOL, err_msg=key)
        np.testing.assert_allclose(got, [m[key] for m in want], rtol=LATER_RTOL, err_msg=key)
    assert_near(r0["last"], state_file(state), sum(lrs), "step 3")
    assert_same_bits(r1["last"], r0["last"], "the two ranks' whole states")
    val = validate(state.ema_model, iter(sc["val"]), CTCLabelConverter(ALPHABET))
    assert r0["val"] == r1["val"]
    np.testing.assert_allclose(r0["val"][0], val[0], rtol=STEP_RTOL)
    assert r0["val"][1:] == val[1:]


def test_remat_under_the_model_axis_gives_the_plain_bits(model_axis):
    """``remat="blocks"`` recomputes the sharded blocks in the backward,
    all-reduces and all: the first step's metrics and whole state equal the
    plain (1, 2) step's bit for bit, as remat does in one process
    (``tests/test_torch_port_memory_levers.py``)."""
    r0 = model_axis["ranks"][0]
    assert r0["remat"]["metrics"][0] == r0["tp"]["metrics"][0]
    assert_same_bits(r0["remat"]["first"], r0["tp"]["first"], "remat blocks at (1, 2)")


def test_checkpoints_move_between_the_layouts(model_axis):
    """A (1, 2) checkpoint holds the one-process layout and restores in one
    process; a one-process checkpoint restores at (1, 2); and a (1, 2)
    state restores into (1, 2) itself; each bit for bit."""
    r0, r1 = (r["tp"] for r in model_axis["ranks"])
    assert r0["round_trip"] and r1["round_trip"]
    assert_same_bits(r0["restored"], model_axis["ref"], "one process -> (1, 2)")
    assert_same_bits(r1["restored"], model_axis["ref"], "one process -> (1, 2), rank 1")
    back, _ = CheckpointManager(os.path.join(model_axis["tmp"], "tp")).restore(
        os.path.join(model_axis["tmp"], "tp"), one_process_state())
    assert_same_bits(state_file(back), r0["last"], "(1, 2) -> one process")


def test_fit_at_1x2_against_one_process(model_axis, tmp_path):
    """``fit`` at (1, 2): one run.log, the best CER and WER of one process
    (the loader's batches are one process's: a data axis of one)."""
    ranks = model_axis["ranks"]
    assert ranks[0]["fit"] == ranks[1]["fit"]
    cfg = model_axis["fit_cfgs"][0]
    one = loop.fit(dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, mesh_shape=None),
        train=dataclasses.replace(cfg.train, out_dir=str(tmp_path))), device="cpu")
    np.testing.assert_allclose([ranks[0]["fit"][0][k] for k in ("best_cer", "best_wer")],
                               [one[k] for k in ("best_cer", "best_wer")], rtol=1e-6)
    run = os.path.join(model_axis["tmp"], "tp_fit")
    assert sorted(os.listdir(run)).count("run.log") == 1
    assert os.path.isdir(os.path.join(run, "best_CER"))
