"""Width (spatial) sharding over the mesh's model axis
(``htr_vt_torch/parallel/mesh.py``: ``halo_extend``, ``gather_from_model``
on the width, ``shard_width``, ``rank_width``) on the CPU, in ``gloo``
ranks launched as ``tests/test_torch_port_tensor_parallel.py`` launches
them, at the tiny config of ``tests/test_parallel.py:_setup`` (embed 64,
depth 1, two heads, 64x128 px, float32, batch 16):

- the halo exchange and the token gather at M = 2 and 4: forward against
  slices of the whole tensor, backward against the whole tensor's
  accumulated cotangent and by a dot-product (adjoint) test;
- the ResNet18 stem on strips at (1, 2), forward and backward, in each
  switch set (the kernels' plain twins here) against one process: the
  outputs, the stem's gradients summed over the model group, and the BN
  running statistics, equal on every rank;
- the encoder-decoder through its width-sharded trunk at (1, 2);
- a width or a halo that the axis cannot split raising, naming the width
  and M.

The ranks' side of every width-sharded test is here (``rank_main``, the
tasks). ``train_step`` and ``eval_step`` at (1, 2) against one process are
in ``tests/test_torch_port_width_parallel_steps.py``, ``_recipes.py``,
``_van.py`` (the VAN stems), ``_swin_svtr.py`` and ``_remat.py`` (remat
"all"); int8 serving in ``_int8.py``; JAX's ``train_step`` on a
``P("data", None, "model", None)`` image in ``_jax*.py``.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from htr_vt_torch.config import (ExperimentConfig, MaskConfig, ModelConfig, OptimConfig,
                                 config_from_dict)
from htr_vt_torch.models import layers, sgm, swin
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.models.stem import ResNet18Stem
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.parallel import mesh
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import eval_step, train_step

B, STEPS, SEED = 16, 3, 7
FUSED = dict(bn_stats_impl="pallas", pool_impl="pallas")
SWITCHES = {"stock": {}, "fused": FUSED, "fully_fused": dict(FUSED, conv_impl="pallas")}
# (1, 2) against one process: the same products, the BN sums, the input
# LayerNorm's and the stem's gradients added in another order (a strip's
# partial, then the all-reduce). The collectives move values, so a forward is
# exact; HALO_RTOL: a halo's gradient is added to its owner's in float32, so
# the adjoint's two float64 sums agree to float32 rounding. The stem: its
# outputs (STEM_ATOL) and each gradient leaf (STEM_GRAD of the leaf's
# largest element) against one process, or within NOISE_TIMES the gap that
# one process shows to itself when its image moves by NOISE_ULP (a BN
# statistic one ulp off flips a ReLU mask near 0 and moves a stem leaf's
# gradient by up to 3.5e-3 of its largest element, in one process alone as
# between the layouts). The steps: the TP test's bars
# (``tests/test_torch_port_tensor_parallel.py``): LOGIT_ATOL, LATER_RTOL
# (steps 2-3), and STEP_RTOL (the first step's losses and gradient norm) at
# the port's one-step SAM bar (``test_torch_port_memory_levers.py``): the
# conformer's first gradient norm reads 2.1e-5 apart between the layouts,
# and 2.08e-5 in one process whose image moves by 1e-7; the
# weights within WEIGHT_RTOL and Adam's sign-flip bound (FLIP_LRS x the
# summed LR), the BN running statistics at STATS_TOL after one step and at
# LATER_STATS_TOL (``tests/test_torch_port_memory_levers.py:BN_STATS_TOL``)
# after three, whose forwards ran on weights apart by that bound.
HALO_RTOL = 1e-6
STEM_ATOL, STEM_GRAD = 1e-5, 1e-5
NOISE_ULP, NOISE_TIMES = 1e-7, 2.0
LOGIT_ATOL, STEP_RTOL, LATER_RTOL = 1e-5, 1e-4, 1e-3
WEIGHT_RTOL, FLIP_LRS = 1e-5, 2.01
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
LATER_STATS_TOL = dict(rtol=1e-3, atol=1e-4)
OPTIM = OptimConfig(total_iters=100)

WIDTH_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
sys.modules["torch.utils.tensorboard"] = None  # TensorFlow's import, ~20 s
sys.path[:0] = [os.environ["HTRVT_REPO"], os.path.join(os.environ["HTRVT_REPO"], "tests")]
from test_torch_port_width_parallel import rank_main
rank_main()
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


def tiny_batch(seed: int, bs: int = B, width: int = 128) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.random((bs, 64, width, 1)).astype(np.float32),
            "labels": rng.integers(1, 8, (bs, 4)).astype(np.int32),
            "label_lengths": np.full((bs,), 4, np.int32)}


# --- the ranks' side -------------------------------------------------------------
def _seeded(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def collectives_task(task):
    """``halo_extend`` at three halo widths and the token gather on this
    rank's strip of one seeded tensor, each with a seeded cotangent."""
    m, size = mesh.model_world()
    x = _seeded(task["shape"], task["seed"])
    w = x.shape[-1] // size
    strip = x[..., m * w:(m + 1) * w].contiguous(
        memory_format=torch.channels_last).requires_grad_()
    rec = {"strip": strip.detach()}
    for left, right in ((1, 1), (1, 0), (2, 1)):
        ext, lo, hi = mesh.halo_extend(strip, left, right)
        y = _seeded(ext.shape, task["seed"] + 1 + m + 10 * left + 100 * right)
        (gx,) = torch.autograd.grad((ext * y).sum(), strip)
        rec[(left, right)] = dict(ext=ext.detach(), lo=lo, hi=hi, y=y, gx=gx,
                                  channels_last=ext.is_contiguous(
                                      memory_format=torch.channels_last))
    t = strip.detach().permute(0, 2, 3, 1).requires_grad_()  # tokens [B, H, w, C]
    full = mesh.gather_from_model(t, dim=2)
    y = _seeded(full.shape, task["seed"] + 999)  # the same on every rank
    (gt,) = torch.autograd.grad((full * y).sum(), t)
    rec["gather"] = dict(t=t.detach(), full=full.detach(), y=y, gt=gt)
    return rec


def make_stem(switches, seed):
    """The tiny stem (embed 64: widths 16 / 32 / 64) with seeded convs and
    randomised BN state."""
    torch.manual_seed(seed)
    stem = ResNet18Stem(64, torch.float32, device="cpu", dataflow="plain", **switches)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in list(stem.named_parameters()) + list(stem.named_buffers()):
            if "bn" in name or "downsample.1" in name:
                u = torch.rand(t.shape, generator=g)
                t.copy_(0.5 + u if name.endswith(("weight", "running_var")) else u - 0.5)
    return stem


def stem_run(stem, x, y):
    """A train forward, the gradient of ``sum(out * y)``, an eval forward:
    (out, {name: grad}, running statistics, eval out)."""
    params = dict(stem.named_parameters())
    out = stem(x, train=True)
    grads = dict(zip(params, torch.autograd.grad((out * y).sum(), list(params.values()))))
    stats = {k: v.clone() for k, v in stem.state_dict().items() if "running" in k}
    with torch.no_grad():
        served = stem(x, train=False)
    return out.detach(), grads, stats, served


def stem_inputs(seed):
    """The image [B, 1, 64, 128] and the output's cotangent [B, 64, 1, 32]."""
    return _seeded((B, 1, 64, 128), seed).sigmoid(), _seeded((B, 64, 1, 32), seed + 1)


def stem_task(task):
    """The stem on this rank's strip: its outputs, the stem's gradients
    summed over the model group, the running statistics."""
    m, size = mesh.model_world()
    stem = make_stem(task["switches"], task["seed"])
    for mod in stem.modules():
        if hasattr(type(mod), "width_sharded"):
            mod.width_sharded = True
    x, y = stem_inputs(task["seed"])
    w, wy = x.shape[-1] // size, y.shape[-1] // size
    out, grads, stats, served = stem_run(stem, x[..., m * w:(m + 1) * w],
                                         y[..., m * wy:(m + 1) * wy])
    mesh.all_reduce_model_sum_(list(grads.values()))
    return dict(out=out, grads=grads, stats=stats, served=served)


def state_file(state):
    """The state in the one-process layout, copied."""
    adamw = mesh.gather_optimizer_state(state.model, state.optimizer)["state"]
    return {"model": {k: v.clone() for k, v in mesh.gather_state_dict(state.model).items()},
            "ema": {k: v.clone() for k, v in
                    mesh.gather_state_dict(state.ema_model).items()},
            "adamw": {i: {k: v.clone() for k, v in st.items()} for i, st in adamw.items()},
            "step": state.step, "generator": state.generator.get_state()}


@contextlib.contextmanager
def port_no_dropout(on: bool = True):
    """With ``on``, the port's dropout and drop-path as the identity (the
    standalone models' combine dropout included), as
    ``tests/test_torch_port_zoo_standalone.py:no_dropout`` makes them on
    both stacks for a comparison with JAX's draws."""
    if not on:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        for mod in (layers, swin, sgm):
            mp.setattr(mod, "dropout", lambda x, rate, train, generator: x)
        mp.setattr(layers.DropPath, "forward", lambda self, x, **k: x)
        yield


def steps_task(task):
    """``eval_step`` on a probe's strip, then ``train_step`` on this
    rank's strips of the batches (its data index's rows), from a seeded
    state or the one-process weights ``init``; dropout off with
    ``no_dropout``."""
    with port_no_dropout(task.get("no_dropout", False)):
        return _steps(task)


def _steps(task):
    cfg = config_from_dict(ExperimentConfig, task["cfg"])
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(task["seed"]),
                               tensor_parallel=task["tensor_parallel"],
                               width_parallel=True)
    if task.get("init") is not None:
        from htr_vt_torch.train.checkpoint import load_module_state
        for m in (state.model, state.ema_model):
            load_module_state(m, task["init"])
    rec = {"metrics": [], "sharded": mesh.sharded_mask(state.model) is not None}
    out = eval_step(state.model, mesh.rank_width(task["probe"]))
    rec["eval"] = {k: out[k] for k in ("logits", "loss")}
    for batch in task["batches"]:
        d, r = mesh.data_world()
        b = len(batch["image"]) // r
        mine = mesh.rank_width({k: v[d * b:(d + 1) * b] for k, v in batch.items()})
        rec["metrics"].append({k: float(v) for k, v in train_step(state, mine).items()})
        if len(rec["metrics"]) == 1:
            rec["first"] = state_file(state)
    rec["last"] = state_file(state)
    try:
        mesh.rank_width(tiny_batch(0, 2, width=132))
    except ValueError as e:
        rec["bad_width"] = str(e)
    return rec


def ed_cfg():
    """A tiny encoder-decoder behind the width-shardable trunk, masking and
    dropout off."""
    return tiny_cfg(model_type="encoder_decoder", ed_vocab_size=12, decoder_layers=1,
                    decoder_heads=2, drop_rate=0.0, drop_path_rate=0.0,
                    masking=MaskConfig(mode="none")).model


def ed_inputs(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((4, 64, 128, 1)).astype(np.float32)),
            torch.from_numpy(rng.integers(1, 12, (4, 6))),
            torch.from_numpy(rng.integers(1, 12, (4, 6))))


def ed_run(model, image, tgt_in, tgt_out):
    """The teacher-forced train forward's logits and the gradient of its
    loss, then the eval logits."""
    from htr_vt_torch.models.encoder_decoder import teacher_forcing_loss
    from htr_vt_torch.optim.sam import zeros_for_unused
    params = dict(model.named_parameters())
    logits = model(image, tgt_in, train=True)
    grads = zeros_for_unused(list(params.values()), torch.autograd.grad(
        teacher_forcing_loss(logits, tgt_out), list(params.values()), allow_unused=True))
    with torch.no_grad():
        served = model(image, tgt_in)
    return logits.detach(), dict(zip(params, grads)), served


def ed_task(task):
    """The encoder-decoder with its trunk's width sharded, on this rank's
    strip: the train forward's logits, the gradients (the stem's summed
    over the model group) and the eval logits."""
    model = build_model(ed_cfg(), device="cpu",
                        generator=torch.Generator().manual_seed(task["seed"]))
    mesh.shard_width(model)
    image, tgt_in, tgt_out = ed_inputs(task["seed"])
    logits, grads, served = ed_run(model, mesh.rank_width({"image": image})["image"],
                                   tgt_in, tgt_out)
    mask = mesh.width_sharded_mask(model)
    mesh.all_reduce_model_sum_([g for g, s in zip(grads.values(), mask) if s])
    return dict(logits=logits, grads=grads, served=served)


def int8_weights(seed: int, cfg: ModelConfig) -> dict:
    """The serving state_dict of the int8 ``cfg`` (stage 1 padded where that
    applies) made from a seeded float model of the same config."""
    float_cfg = dataclasses.replace(cfg, quant="none")
    model = build_model(float_cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    return q8.serving_arrays(cfg, model.state_dict())


def int8_run(model, calib, batch):
    """Calibrate ``model`` on ``calib``, a static ``eval_step`` of ``batch``,
    then a dynamic one (the sites cleared): the abs-maxes and each step's
    logits and loss."""
    stats = {k: v.clone() for k, v in q8.calibrate_quant_stats(model, [calib], 1).items()}
    out = {"stats": stats}
    for mode in ("static", "dynamic"):
        if mode == "dynamic":
            q8.clear_quant_stats(model)
        ev = eval_step(model, batch)
        out[mode] = {"logits": ev["logits"], "loss": float(ev["loss"])}
    return out


def int8_task(task):
    """The int8 model of ``task["cfg"]`` on ``task["weights"]``, its width
    sharded: ``int8_run`` on this rank's strips."""
    cfg = config_from_dict(ExperimentConfig, task["cfg"]).model
    model = build_model(cfg, device="cpu")
    model.load_state_dict(task["weights"])
    mesh.shard_width(model)
    strip = mesh.rank_width({"image": task["calib"]})["image"]
    return int8_run(model, strip, mesh.rank_width(task["batch"]))


TASKS = {"collectives": collectives_task, "stem": stem_task, "steps": steps_task,
         "ed": ed_task, "int8": int8_task}


def rank_main():
    """A rank of ``WIDTH_WORKER``: the job's tasks in order, saved as
    ``rank{r}.pt``."""
    mesh.maybe_initialize_distributed()
    job = torch.load(os.environ["HTRVT_JOB"], weights_only=False)
    mesh.init_mesh(job["mesh_shape"])
    out = {"world": mesh.world(), "data": mesh.data_world(), "model": mesh.model_world()}
    for name, task in job["tasks"].items():
        out[name] = TASKS[task["kind"]](task)
    torch.save(out, os.path.join(os.environ["HTRVT_OUT"], f"rank{mesh.world()[0]}.pt"))


def start_width(tmp_path, mesh_shape, tasks):
    """The ranks of ``mesh_shape`` running ``tasks``, started and not waited
    for (``test_torch_port_distributed.py:collect``)."""
    from test_torch_port_distributed import start
    job = {"mesh_shape": mesh_shape, "tasks": tasks}
    return start(WIDTH_WORKER, tmp_path, job, ranks=mesh_shape[0] * mesh_shape[1])


def launch_width(tmp_path, mesh_shape, tasks):
    """The ranks of ``mesh_shape`` running ``tasks``; their records."""
    from test_torch_port_distributed import collect
    return collect(start_width(tmp_path, mesh_shape, tasks), tmp_path)


# --- the collectives ----------------------------------------------------------------
@pytest.mark.parametrize("size", [2, 4])
def test_halo_exchange_and_token_gather(tmp_path, size):
    """Each rank's extended strip is the whole tensor's slice (nothing past
    the image's edges), channels-last; a halo's gradient lands on the rank
    that owns its columns; the token gather gives the whole width and
    slices its gradient; both pass the dot-product test."""
    shape = (2, 8, 3, 8 * size)
    ranks = launch_width(tmp_path, (1, size), {"c": dict(kind="collectives", shape=shape,
                                                          seed=SEED)})
    x = _seeded(shape, SEED).double()
    w = shape[-1] // size
    for left, right in ((1, 1), (1, 0), (2, 1)):
        acc = torch.zeros_like(x)
        lhs = rhs = 0.0
        for m, r in enumerate(ranks):
            rec = r["c"][(left, right)]
            assert (rec["lo"], rec["hi"]) == (left if m else 0, right if m < size - 1 else 0)
            assert rec["channels_last"]
            lo, hi = rec["lo"], rec["hi"]
            assert torch.equal(rec["ext"].double(), x[..., m * w - lo:(m + 1) * w + hi])
            acc[..., m * w - lo:(m + 1) * w + hi] += rec["y"].double()
            lhs += float((rec["ext"].double() * rec["y"].double()).sum())
            rhs += float((r["c"]["strip"].double() * rec["gx"].double()).sum())
        for m, r in enumerate(ranks):
            torch.testing.assert_close(r["c"][(left, right)]["gx"].double(),
                                       acc[..., m * w:(m + 1) * w], rtol=1e-6, atol=1e-6)
        assert abs(lhs - rhs) <= HALO_RTOL * max(1.0, abs(lhs)), (left, right)
    tokens = x.permute(0, 2, 3, 1)
    lhs, rhs = 0.0, 0.0
    for m, r in enumerate(ranks):
        g = r["c"]["gather"]
        assert torch.equal(g["full"].double(), tokens)
        torch.testing.assert_close(g["gt"], g["y"][:, :, m * w:(m + 1) * w], rtol=0, atol=0)
        rhs += float((g["t"].double() * g["gt"].double()).sum())
    lhs = float((tokens * ranks[0]["c"]["gather"]["y"].double()).sum())
    assert abs(lhs - rhs) <= HALO_RTOL * max(1.0, abs(lhs))


# --- the stem on strips -------------------------------------------------------------
def test_the_stem_on_strips_matches_one_process(tmp_path):
    """At (1, 2), each switch set: a rank's output is one process's columns
    of it, the stem's gradients (summed over the model group) and its eval
    output are one process's, and the BN running statistics are one
    process's on both ranks."""
    tasks = {name: dict(kind="stem", switches=sw, seed=SEED + i)
             for i, (name, sw) in enumerate(SWITCHES.items())}
    ranks = launch_width(tmp_path, (1, 2), tasks)
    for name, task in tasks.items():
        x, y = stem_inputs(task["seed"])
        out, grads, stats, served = stem_run(make_stem(task["switches"], task["seed"]), x, y)
        noisy = stem_run(make_stem(task["switches"], task["seed"]), x * (1 + NOISE_ULP), y)

        def bar(ref, noise, share):
            return max(share * float(ref.abs().max()),
                       NOISE_TIMES * float((noise - ref).abs().max()))

        w = out.shape[-1] // 2
        for m, r in enumerate(ranks):
            got = r[name]
            cols = slice(m * w, (m + 1) * w)
            torch.testing.assert_close(got["out"], out[..., cols], rtol=0,
                                       atol=bar(out, noisy[0], STEM_ATOL),
                                       msg=lambda s: f"{name} out: {s}")
            torch.testing.assert_close(got["served"], served[..., cols], rtol=0,
                                       atol=STEM_ATOL, msg=lambda s: f"{name} eval: {s}")
            for k, g in grads.items():
                torch.testing.assert_close(got["grads"][k], g, rtol=0,
                                           atol=bar(g, noisy[1][k], STEM_GRAD),
                                           msg=lambda s: f"{name} grad {k}: {s}")
            for k, v in stats.items():
                torch.testing.assert_close(got["stats"][k], v, **STATS_TOL,
                                           msg=lambda s: f"{name} {k}: {s}")
                assert torch.equal(got["stats"][k], ranks[0][name]["stats"][k])


def test_the_encoder_decoder_trunk_on_strips_matches_one_process(tmp_path):
    """At (1, 2), the encoder-decoder through its width-sharded trunk: the
    teacher-forced logits and eval logits are one process's on both ranks,
    and the gradients too (the stem's summed over the model group)."""
    ranks = launch_width(tmp_path, (1, 2), {"ed": dict(kind="ed", seed=SEED)})
    model = build_model(ed_cfg(), device="cpu",
                        generator=torch.Generator().manual_seed(SEED))
    logits, grads, served = ed_run(model, *ed_inputs(SEED))
    for r in ranks:
        torch.testing.assert_close(r["ed"]["logits"], logits, rtol=0, atol=LOGIT_ATOL)
        torch.testing.assert_close(r["ed"]["served"], served, rtol=0, atol=LOGIT_ATOL)
        for k, g in grads.items():
            torch.testing.assert_close(r["ed"]["grads"][k], g, rtol=0,
                                       atol=STEM_GRAD * float(g.abs().max()) + 1e-12,
                                       msg=lambda m: f"{k}: {m}")


# --- what the axis cannot split -----------------------------------------------------
def test_a_width_that_does_not_split_raises():
    """``check_width``: a width that is not a multiple of 4 x M raises,
    naming the width and M; one that is passes."""
    with pytest.raises(ValueError, match="130 px .* axis of 2"):
        mesh.check_width(130, 2)
    with pytest.raises(ValueError, match="136 px .* axis of 4"):
        mesh.check_width(136, 4)
    mesh.check_width(128, 4)
    mesh.check_width(128, 2, halo=9)


@pytest.mark.parametrize("stem,size,width", [("van", 4, 128), ("van2", 2, 64)])
def test_a_halo_wider_than_a_strip_raises(monkeypatch, stem, size, width):
    """A VAN stem's dilated 7x7 reads 9 neighbour columns of the
    quarter-width map: ``shard_width`` refuses a configured width whose
    strips there are narrower (128 px over 4 ranks: 8 columns; 64 px over
    2: 8), naming the width, M and the halo, before it marks anything; the
    forward refuses such an image at a width that passes. The ResNet18
    stem's halo is 1, so the same widths shard."""
    monkeypatch.setattr(mesh, "model_world", lambda: (0, size))
    cfg = dataclasses.replace(tiny_cfg(stem=stem).model, img_size=(64, width))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert mesh.width_halo(model) == 9
    with pytest.raises(ValueError, match=f"{width} px over a model axis of {size} .* "
                                         "halo of 9 columns"):
        mesh.shard_width(model)
    assert model.width_shards == 1 and not model.patch_embed.hmix.width_sharded
    model.cfg = dataclasses.replace(cfg, img_size=(64, 4 * size * 9))
    mesh.shard_width(model)
    assert model.width_shards == size and model.patch_embed.van0.lka.width_sharded
    with pytest.raises(ValueError, match="halo of 9 columns"):
        model(torch.zeros((1, 64, width // size, 1)))
    flagship = build_model(dataclasses.replace(tiny_cfg().model, img_size=(64, width)),
                           device="cpu")
    assert mesh.width_halo(flagship) == 1
    mesh.shard_width(flagship)
    assert flagship.width_shards == size
