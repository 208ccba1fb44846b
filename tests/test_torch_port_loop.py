"""The port's training loop and what it stands on, on the CPU: the loader
(batch for batch against JAX's, augmentation on), the copied meters,
logging, renderer and augmentation, ``CheckpointManager`` on ``torch.save``
(as tests/test_checkpoint.py holds JAX's), the optax -> AdamW state
conversion (a JAX ``TrainState`` and its converted port state take the
same next step), and ``fit``: its artifacts, exact resume, the non-finite
stop and the two weight-loading flags. Tiny configs, as
tests/test_train_loop.py: embed 64, depth 1, 64x128 px, bs 8, 6 steps.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import DataConfig as JDataConfig
from htr_vt_tpu.data import augment as jaugment
from htr_vt_tpu.data import loader as jloader
from htr_vt_tpu.data import synthetic as jsynthetic
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.optim.sam import make_base_optimizer
from htr_vt_tpu.optim.schedule import warmup_cosine_lr as jax_lr
from htr_vt_tpu.train.state import TrainState as JaxTrainState
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_tpu.utils import logging as jlogging
from htr_vt_tpu.utils import meters as jmeters
from htr_vt_torch.config import (DataConfig, ExperimentConfig, MaskConfig, ModelConfig,
                                 OptimConfig, TrainConfig)
from htr_vt_torch.data import augment as taugment
from htr_vt_torch.data import loader as tloader
from htr_vt_torch.data import synthetic as tsynthetic
from htr_vt_torch.models import masking
from htr_vt_torch.train import loop
from htr_vt_torch.train.checkpoint import CheckpointManager, load_module_state
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils import convert
from htr_vt_torch.utils import logging as tlogging
from htr_vt_torch.utils import meters as tmeters
from test_torch_port_model import port_config
from test_torch_port_train import CFG as TRAIN_CFG
from test_torch_port_train import (OPTIM, TINY, _batch, _check_trajectory, _keep,
                                   _leaves)


def tiny_experiment(out_dir, exp_name="loop", total=6, resume=None, **train):
    """tests/test_train_loop.py's tiny run: SYNTH, embed 64, depth 1, 64x128
    px, bs 8, an eval and a checkpoint at the end."""
    return ExperimentConfig(
        model=ModelConfig(nb_cls=30, img_size=(64, 128), embed_dim=64, depth=1,
                          num_heads=2, compute_dtype="float32",
                          masking=MaskConfig(mode="span", ratio=0.2, max_span_length=2)),
        optim=OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=total,
                          weight_decay=0.01),
        data=DataConfig(dataset="SYNTH", img_size=(64, 128), train_bs=8, val_bs=8,
                        num_workers=2, synth_train_size=32, synth_eval_size=8),
        train=TrainConfig(out_dir=str(out_dir), exp_name=exp_name, seed=7,
                          total_iters=total, eval_iters=total, print_iters=3,
                          resume=resume, **train))


def _checkpoints(run_dir):
    """{step: rolling checkpoint directory} of a run."""
    out = {}
    for path in glob.glob(os.path.join(run_dir, "checkpoint_*")):
        with open(os.path.join(path, "meta.json")) as f:
            out[json.load(f)["step"]] = path
    return out


def _assert_same_state(a, b, what):
    """Two state files' model, EMA, AdamW and generator, bit for bit."""
    for key in ("model", "ema_model"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (what, key, k)
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (what, i, k)
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])


# --- the loader, against JAX's -----------------------------------------------------
def _data_cfgs():
    kw = dict(dataset="SYNTH", img_size=(64, 128), train_bs=8, val_bs=8, num_workers=2,
              synth_train_size=24, synth_eval_size=11)
    return JDataConfig(**kw), DataConfig(**kw)


def _loader(mod, cfg, start_batch=0):
    ds = mod.build_dataset(cfg, "train")
    conv = mod.make_converter(cfg, ds)
    return mod.TrainLoader(ds, conv, 8, 16, augment=cfg.augment, seed=3, num_threads=2,
                           start_batch=start_batch), ds, conv


def test_train_loader_and_eval_batches_equal_jax_batch_for_batch():
    """SYNTH with augmentation on: batches 0-4 (they cross the 24-line
    epoch), a loader started at batch 2, and the eval batches (the last one
    padded) equal JAX's bit for bit."""
    jcfg, tcfg = _data_cfgs()
    assert tcfg.augment.enable
    runs = {}
    for name, mod, cfg in (("jax", jloader, jcfg), ("port", tloader, tcfg)):
        it, ds, conv = _loader(mod, cfg)
        late, _, _ = _loader(mod, cfg, start_batch=2)
        runs[name] = ([next(it) for _ in range(5)], [next(late) for _ in range(3)],
                      list(mod.eval_batches(mod.build_dataset(cfg, "val"), conv, 8, 16)),
                      conv.character)
        it.close()
        late.close()
    (jb, jlate, jeval, jchars), (tb, tlate, teval, tchars) = runs["jax"], runs["port"]
    assert jchars == tchars
    for want, got in zip(jb + jlate, tb + tlate):
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(tb[2:], tlate):  # start_batch resumes the stream
        np.testing.assert_array_equal(a["image"], b["image"])
    assert len(jeval) == len(teval) == 2
    for (wb, wv, wt), (gb, gv, gt) in zip(jeval, teval):
        assert (wv, wt) == (gv, gt)
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_device_prefetch_passes_cpu_batches_through():
    batches = [{"image": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = list(tloader.device_prefetch(iter(batches), "cpu"))
    assert [b["image"][0, 0] for b in got] == list(range(5))


@pytest.mark.parametrize("sampling", ["epoch", "iid"])
def test_batch_sample_ids_equal_jax(sampling):
    for b in range(6):
        np.testing.assert_array_equal(
            tloader.batch_sample_ids(13, b, 5, sampling, 8, 0, 8),
            jloader.batch_sample_ids(13, b, 5, sampling, 8, 0, 8))
    assert tloader.choose_max_label_len(["ab", "x" * 30], 128) == \
        jloader.choose_max_label_len(["ab", "x" * 30], 128)


# --- the copied modules ---------------------------------------------------------------
def test_synthetic_copy_renders_as_the_jax_one():
    for trim in (False, True):
        t = tsynthetic.SyntheticLineDataset(6, seed=4, trim_to_canvas=trim, width=256)
        j = jsynthetic.SyntheticLineDataset(6, seed=4, trim_to_canvas=trim, width=256)
        assert t.labels == j.labels and t.alphabet == j.alphabet
        for i in range(len(t)):
            np.testing.assert_array_equal(t[i][0], j[i][0])
    assert tsynthetic.selftest_workload_mix([512, 1024], n=200) == \
        jsynthetic.selftest_workload_mix([512, 1024], n=200)


AUGMENTS = {
    "dilation": lambda m, img, rng: m.dilation(img, (2, 3)),
    "erosion": lambda m, img, rng: m.erosion(img, (3, 2)),
    "random_projective": lambda m, img, rng: m.random_projective(img, 8.0, rng),
    "elastic_distortion": lambda m, img, rng: m.elastic_distortion(img, rng),
    "sign_flipping": lambda m, img, rng: m.sign_flipping(img),
    "dpi_adjusting": lambda m, img, rng: m.dpi_adjusting(img, 0.8),
    "gaussian_noise": lambda m, img, rng: m.gaussian_noise(img, rng),
    "sharpen": lambda m, img, rng: m.sharpen(img),
    "zoom_ratio": lambda m, img, rng: m.zoom_ratio(img, 0.7, 0.9),
    "tightening": lambda m, img, rng: m.tightening(img),
    "color_jitter_gray": lambda m, img, rng: m.color_jitter_gray(img, rng),
}


@pytest.mark.parametrize("name", sorted(AUGMENTS))
def test_augment_copy_transforms_as_the_jax_one(name):
    img = tsynthetic.render_line("the quick fox", 64, 256, np.random.default_rng(1))
    got = AUGMENTS[name](taugment, img.copy(), np.random.default_rng(2))
    want = AUGMENTS[name](jaugment, img.copy(), np.random.default_rng(2))
    np.testing.assert_array_equal(got, want)


def test_meters_and_step_timer_copies_match_jax():
    values = [np.arange(6.0), [1.5], 2.0]
    got, want = tmeters.Averager(), jmeters.Averager()
    dgot, dwant = tmeters.DistributedMetric("m"), jmeters.DistributedMetric("m")
    for v in values:
        got.add(v)
        want.add(v)
        dgot.update(np.sum(v))
        dwant.update(np.sum(v))
    assert (got.val(), got.n_count, dgot.avg) == (want.val(), want.n_count, dwant.avg)
    t = tlogging.StepTimer()
    t.close_window(0, 0)
    assert t.rate == jlogging.StepTimer().rate == 0.0
    t.close_window(4, 8)
    assert t.rate > 0.0


def test_maybe_profile_writes_a_trace_over_its_window(tmp_path):
    x = torch.randn(64, 64)
    for step in range(4):
        tlogging.maybe_profile(str(tmp_path), step, start_step=1, num_steps=2)
        x = x @ x.T / 64
    assert os.listdir(tmp_path) == ["trace_step1.json"]
    tlogging.maybe_profile(None, 1, start_step=1)  # off: nothing happens


# --- CheckpointManager (tests/test_checkpoint.py's cases) -------------------------------
def _state(seed=0, step=0):
    cfg = ExperimentConfig(
        model=ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1,
                          num_heads=2, compute_dtype="float32"),
        optim=OptimConfig(total_iters=10))
    state = create_train_state(cfg, "cpu", torch.Generator().manual_seed(seed))
    state.step = step
    return state


def _payload(state):
    return {"model": state.model.state_dict(), "ema_model": state.ema_model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "step": state.step,
            "generator": state.generator.get_state()}


def test_checkpoint_round_trip_is_exact(tmp_path):
    state = _state(seed=1, step=7)
    train_step(state, _batch(3))  # AdamW moments, a moved generator
    state.step = 7
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state, cer=0.25, wer=0.5, best_cer=0.25, best_wer=0.5)
    restored, meta = mgr.restore(str(tmp_path), _state(seed=2))
    assert restored.step == 7 and meta["cer"] == 0.25 and meta["step"] == 7
    _assert_same_state(_payload(restored), _payload(state), "restored")


def test_best_copies_and_cleanup(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    cers = [0.9, 0.5, 0.7, 0.4]
    for step, cer in enumerate(cers, 1):
        state.step = step
        best = min(cers[:step])
        mgr.save(state, cer=cer, wer=cer, best_cer=best, best_wer=best)
    names = sorted(os.listdir(str(tmp_path)))
    assert len([n for n in names if n.startswith("checkpoint_")]) == 2  # keep=2
    assert "best_CER" in names and "best_WER" in names
    _, meta = mgr.restore(os.path.join(str(tmp_path), "best_CER"), _state(3))
    assert meta["cer"] == 0.4 and meta["step"] == 4


def test_restore_parses_filename_convention(tmp_path):
    state = _state(step=5)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(state, cer=0.1234, wer=0.5678, best_cer=0.1234, best_wer=0.5678)
    assert os.path.basename(path) == "checkpoint_0.1234_0.5678_5"
    os.remove(os.path.join(path, "meta.json"))  # force filename fallback
    _, meta = mgr.restore(path, _state(4))
    assert meta == {"cer": 0.1234, "wer": 0.5678, "step": 5}


def test_restoring_a_strict_subset_raises_naming_the_sgm_item():
    state = _state()
    sd = dict(state.model.state_dict(), **{"sgm_head.weight": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="item 10"):
        load_module_state(state.model, sd)
    del sd["head.weight"], sd["sgm_head.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_module_state(state.model, sd)


# --- optax -> AdamW -------------------------------------------------------------------
@pytest.fixture(scope="module")
def converted_step():
    """A JAX TrainState after 2 ``jit_train_step`` steps, then one more step
    on it and on the port state converted from it, from the same batch and
    keep masks (masks A and B in pass 1 and pass 2 of every step)."""
    from test_torch_port_model import tiny_jax_weights
    params, stats = tiny_jax_weights(TINY, seed=5)
    masks = [_keep(20), _keep(21)]
    batches = [_batch(30 + i) for i in range(3)]
    calls = []

    def jax_mask(*args, **kwargs):
        calls.append(len(calls))
        return jnp.asarray(masks[(len(calls) - 1) % 2])

    orig = jmasking.build_keep_mask
    jmasking.build_keep_mask = jax_mask
    try:
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=make_base_optimizer(OPTIM).init(params),
            ema_params=jax.tree.map(jnp.copy, params),
            ema_batch_stats=jax.tree.map(jnp.copy, stats), rng=jax.random.PRNGKey(0))
        step_fn = jit_train_step(JaxHTRVT(TINY), TRAIN_CFG, donate=False)
        for b in batches[:2]:
            state, _ = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        before = jax.tree.map(np.asarray, state)
        state, _ = step_fn(state, {k: jnp.asarray(v) for k, v in batches[2].items()})
    finally:
        jmasking.build_keep_mask = orig
    after = jax.tree.map(np.asarray, state)

    port = create_train_state(port_config(TRAIN_CFG), "cpu", torch.Generator().manual_seed(0))
    port.step = convert.load_jax_train_state(port.model, port.ema_model, before,
                                             port.optimizer)
    assert port.step == 2
    loaded = convert.optax_moments(port.optimizer, port.model)
    port_masks = iter(torch.from_numpy(m) for m in masks)
    orig = masking.build_keep_mask
    masking.build_keep_mask = lambda *a, **k: next(port_masks)
    try:
        train_step(port, batches[2])
    finally:
        masking.build_keep_mask = orig
    return before, after, loaded, port


def test_optax_state_converts_exactly(converted_step):
    before, _, loaded, _ = converted_step
    adam = before.opt_state[0]
    assert int(loaded["count"]) == int(adam.count) == 2
    for key in ("mu", "nu"):
        got, want = _leaves(loaded[key]), _leaves(getattr(adam, key))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(key, k))


def test_converted_state_takes_the_same_next_step_as_jax(converted_step):
    """After the one step from the converted state: the LR the port set
    equals optax's schedule at count 2 (rtol 1e-6, JAX's float32 cosine);
    parameters and EMA at tests/test_torch_port_train.py's trajectory bar
    (1% of the LR summed over three steps; the key third of each qkv bias
    within 3 x that sum); AdamW's step 3 in every parameter as optax's
    count; the moments within 1e-3 of themselves plus 1e-4 of the leaf's
    largest (mu moves by a tenth and nu by a hundredth of this step's
    gradient, whose float32 noise about zero is the leaf's own)."""
    _, after, _, port = converted_step
    lr = port.optimizer.param_groups[0]["lr"]
    np.testing.assert_allclose(lr, float(jax_lr(2, max_lr=OPTIM.max_lr,
                                                 warmup_iters=OPTIM.warmup_iters,
                                                 total_iters=OPTIM.total_iters,
                                                 min_lr=OPTIM.min_lr)), rtol=1e-6)
    for model, tree in ((port.model, after.params), (port.ema_model, after.ema_params)):
        _check_trajectory(_leaves(convert.model_to_jax_tree(model)[0]), _leaves(tree),
                          "converted")
    moments = convert.optax_moments(port.optimizer, port.model)
    adam = after.opt_state[0]
    assert int(moments["count"]) == int(adam.count) == 3
    for key in ("mu", "nu"):
        got, want = _leaves(moments[key]), _leaves(getattr(adam, key))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-3,
                                       atol=1e-4 * np.abs(w).max(), err_msg=(key, k))


def test_conversion_refuses_counts_that_differ_from_the_step(converted_step):
    before, _, _, _ = converted_step
    port = create_train_state(port_config(TRAIN_CFG), "cpu", torch.Generator())
    with pytest.raises(ValueError, match="differ from step"):
        convert.load_optax_state(port.optimizer, port.model, before.opt_state,
                                 before.batch_stats, 5)


# --- fit ---------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """"train 6" and "train 3, resume (auto), train 3" on the same config."""
    out = tmp_path_factory.mktemp("fit")
    full = loop.fit(tiny_experiment(out, "full"), device="cpu")
    first = tiny_experiment(out, "split")
    loop.fit(dataclasses.replace(first, train=dataclasses.replace(
        first.train, total_iters=3, eval_iters=3)), device="cpu")
    loop.fit(tiny_experiment(out, "split", resume="auto"), device="cpu")
    return out, full


def test_fit_writes_artifacts(runs):
    out, result = runs
    assert np.isfinite(result["best_cer"]) and np.isfinite(result["best_wer"])
    run_dir = os.path.join(str(out), "full")
    for name in ("run.log", "metrics.jsonl", "best_CER", "best_WER"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    ckpts = _checkpoints(run_dir)
    assert list(ckpts) == [6]
    with open(os.path.join(ckpts[6], "meta.json")) as f:
        meta = json.load(f)
    assert meta["config"]["model"]["nb_cls"] == 29  # 28 SYNTH characters + blank
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        keys = set().union(*(json.loads(line).keys() for line in f))
    assert {"train/loss", "train/imgs_per_sec", "val/CER", "val/WER"} <= keys
    with open(os.path.join(run_dir, "run.log")) as f:
        log = f.read()
    assert "Iter : 6" in log and "Val. loss" in log


def test_resume_is_stream_and_trajectory_exact(runs):
    """"train 6" == "train 3, resume, train 3" bit for bit: model, EMA,
    AdamW, step and generator of the final checkpoints."""
    out, _ = runs
    split = _checkpoints(os.path.join(str(out), "split"))
    assert sorted(split) == [3, 6]
    with open(os.path.join(str(out), "split", "run.log")) as f:
        assert "resumed at step 3" in f.read()
    mgr = CheckpointManager(str(out))
    full_state, _ = mgr.read(_checkpoints(os.path.join(str(out), "full"))[6])
    split_state, _ = mgr.read(split[6])
    _assert_same_state(split_state, full_state, "resumed")


def test_non_finite_losses_stop_with_an_emergency_checkpoint(tmp_path, monkeypatch):
    def nan_step(state, batch):
        metrics = train_step(state, batch)
        return dict(metrics, loss=torch.tensor(float("nan")))

    monkeypatch.setattr(loop, "train_step", nan_step)
    with pytest.raises(FloatingPointError, match="3 non-finite losses"):
        loop.fit(tiny_experiment(tmp_path, "nan"), device="cpu")
    ckpts = _checkpoints(os.path.join(str(tmp_path), "nan"))
    assert list(ckpts) == [3]
    with open(os.path.join(ckpts[3], "meta.json")) as f:
        meta = json.load(f)
    assert meta["emergency"] and meta["cer"] == 999.0


def test_load_model_and_encoder_only(runs, tmp_path):
    """--load-model starts from a checkpoint's weights with a fresh step
    and optimizer; --load-encoder-only keeps the fresh head."""
    out, _ = runs
    src = _checkpoints(os.path.join(str(out), "full"))[6]
    mgr = CheckpointManager(str(out))
    saved, _ = mgr.read(src)
    for encoder_only in (False, True):
        name = f"ft{int(encoder_only)}"
        cfg = tiny_experiment(tmp_path, name, total=1, load_model=src,
                              load_encoder_only=encoder_only)
        captured = {}

        def capture(state, batch):
            captured.setdefault("model", {k: v.clone() for k, v in
                                          state.model.state_dict().items()})
            captured.setdefault("step", state.step)
            return train_step(state, batch)

        orig = loop.train_step
        loop.train_step = capture
        try:
            loop.fit(cfg, device="cpu")
        finally:
            loop.train_step = orig
        assert captured["step"] == 0
        fresh = create_train_state(  # nb_cls fitted to the 28 SYNTH characters
            dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, nb_cls=29)),
            "cpu", torch.Generator().manual_seed(cfg.train.seed))
        fresh_sd = fresh.model.state_dict()
        for k, v in captured["model"].items():
            want = fresh_sd[k] if encoder_only and k.startswith("head.") else saved["model"][k]
            assert torch.equal(v, want), (name, k)
        with open(os.path.join(str(tmp_path), name, "run.log")) as f:
            assert f"loaded {'encoder' if encoder_only else 'model'} weights" in f.read()


def test_fit_refuses_more_than_one_process(tmp_path, monkeypatch):
    cfg = tiny_experiment(tmp_path)
    with pytest.raises(NotImplementedError, match="item 12"):
        loop.fit(dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, mesh_shape=(2,))), device="cpu")
    monkeypatch.setenv("HTRVT_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="item 12"):
        loop.fit(cfg, device="cpu")
