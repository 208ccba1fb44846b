"""The memory levers (``cfg.remat``, ``cfg.train.grad_accum``) against the
JAX package, on the CPU at the tiny float32 config of
``tests/test_remat_accum.py`` (64x64 px, embed 32, depth 2, two heads).
Weights are a JAX init with every norm and BN state randomised, crossed
into the port through ``utils/convert.py``; batches are numpy draws.

Both levers are re-schedulings of the same step, as in JAX: the port's
remat step gives its plain step's bits (dropout on too, which needs the
generator replayed in the recompute), and ``grad_accum`` on a batch of two
equal halves gives the unaccumulated step's update. Against JAX: one SAM
step with the same lever, held to the one-step bars of the port's SAM
tests (``STEP_RTOL``, Adam's sign-flip bound). The conformer and
macaron recipes, ``grad_accum`` 2 / 4 and the tri-masked SGM trainer are in
``test_torch_port_memory_levers_{blocks,accum,sgm}.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig,
                               OptimConfig, TrainConfig)
from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
from htr_vt_tpu.optim.sam import make_base_optimizer
from htr_vt_tpu.train.state import TrainState as JaxTrainState
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_torch.models import remat
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import micro_batches, train_step
from htr_vt_torch.utils.convert import load_jax_train_state, model_to_jax_tree
from test_torch_port_model import _randomise, port_config
from test_torch_port_zoo import _leaves

# One SAM step against JAX, the bars of tests/test_torch_port_train.py and
# tests/test_torch_port_sgm.py: losses and the gradient norm within 1e-4
# (float32 sums in other orders; measured up to 7.6e-5 for the gradient
# norm); every updated parameter within Adam's sign-flip bound, 2 x the LR
# (an element whose gradient is within float32 noise may move either way:
# AdamW's first step moves each element by about the LR), and every element
# outside the stem whose JAX gradient stands clear of that noise (its first
# moment at least 1e-4 of its leaf's largest) within 2% of the LR. The
# stem's elements are held to the sign-flip bound alone: at this config its
# gradients differ between the stacks in the sign of elements up to 1.6% of
# their leaf's largest (measured; the gradient norm still agrees to 7.6e-5),
# as tests/test_torch_port_sgm.py found for JAX's jitted stem gradient. The
# bias of a convolution that feeds a train-mode BatchNorm (macaron's
# depthwise conv) has an exact gradient of zero, so both stacks give it
# rounding noise: held to the sign-flip bound alone
# (tests/test_torch_port_zoo_sam.py:ZERO_GRADIENT). JAX's own remat bar
# (rtol 2e-5, atol 2e-6, remat against its plain step) is held here
# tighter, as bit-equality of the port's remat step to its plain step.
STEP_RTOL = 1e-4
STEADY_SHARE, STEADY_LR = 1e-4, 0.02
# Two ranks against JAX's one process: the BN sums and the gradient are
# added in yet another order (per rank, then across ranks; per microbatch
# under grad_accum), which the stem amplifies, so elements up to 3.7e-4 of
# their leaf's largest gradient were read flipping sign (two ranks x accum
# 2 on the permuted batch; the losses and gradient norm still agree to
# 7.4e-5 and 1.7e-5): held to 2% of the LR from 1e-3 of the leaf's largest.
RANKS_STEADY_SHARE = 1e-3
ZERO_GRADIENT = ("dwconv/bias",)
# BN running statistics after one SAM step: the bar of the port's other
# one-step tests (tests/test_torch_port_sgm.py, test_torch_port_ed.py). The
# second pass's statistics are taken at w + e(w), whose perturbation follows
# the gradient's float32 noise (read up to 7.7e-5, the loss_second gap
# 7.4e-5, at the permuted-batch accumulation case, one process or two).
BN_STATS_TOL = dict(rtol=1e-3, atol=1e-4)
# A first LR large against float32 rounding of the weights
# (tests/test_torch_port_sgm.py:OPTIM): lr(0) = 1e-3 / 3.
OPTIM = OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=12)


def tiny_cfg(train: TrainConfig = None, **model_kw) -> ExperimentConfig:
    """``tests/test_remat_accum.py:_tiny_cfg`` (JAX's dataclasses), with
    ``OPTIM``."""
    model = ModelConfig(nb_cls=10, img_size=(64, 64), embed_dim=32, depth=2,
                        num_heads=2, compute_dtype="float32",
                        masking=MaskConfig(mode="none"), **model_kw)
    return ExperimentConfig(model=model, optim=OPTIM,
                            train=train or TrainConfig(total_iters=100))


def tiny_batch(seed: int, bs: int, nb_cls: int = 10, w: int = 64) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.random((bs, 64, w, 1), dtype=np.float32),
            "labels": rng.integers(1, nb_cls, (bs, 5)).astype(np.int32),
            "label_lengths": np.full((bs,), 5, np.int32)}


def jax_init(cfg: ExperimentConfig, seed: int, batch: dict) -> JaxTrainState:
    """A JAX ``TrainState`` at ``cfg``: the port's seeded init crossed into
    JAX's tree (``model_to_jax_tree``; no JAX init to compile) with every
    norm and BN state randomised, fresh AdamW, the EMA equal to the
    weights. ``batch`` is unused: the shapes come from ``cfg``."""
    model = create_train_state(port_config(cfg), "cpu",
                               torch.Generator().manual_seed(seed)).model
    params, stats = model_to_jax_tree(model)
    rng = np.random.default_rng(seed + 100)
    params, stats = _randomise(params, rng), _randomise(stats, rng)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=make_base_optimizer(cfg.optim).init(params),
                         ema_params=params, ema_batch_stats=stats,
                         rng=jax.random.PRNGKey(seed + 1))


def jax_step(cfg: ExperimentConfig, init, batch: dict):
    """JAX's jitted SAM step: (metrics as floats, the new state)."""
    state, m = jit_train_step(jax_build_model(cfg.model), cfg, donate=False)(
        init, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}, state


def port_state(cfg: ExperimentConfig, init):
    port = create_train_state(port_config(cfg), "cpu", torch.Generator().manual_seed(0))
    load_jax_train_state(port.model, port.ema_model, init)
    return port


def port_step(cfg: ExperimentConfig, init, batch: dict, steps: int = 1):
    """The port's SAM steps from JAX's state: (last metrics, the state)."""
    port = port_state(cfg, init)
    for _ in range(steps):
        m = {k: float(v) for k, v in train_step(port, batch).items()}
    return m, port


def jax_adam_mu(opt_state):
    """The first Adam moment of an optax chain state."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu"):
            return node.mu
        if isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("no Adam state")


def check_against_jax(got, port, want, state, stats_tol=BN_STATS_TOL,
                      keys=("loss", "loss_second", "grad_norm"), steady_share=STEADY_SHARE):
    """Losses, gradient norm, the updated parameters and the BN running
    statistics of one step against JAX's (the bars above; ``steady_share``
    the share of a leaf's largest gradient from which its elements are held
    to 2% of the LR)."""
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=STEP_RTOL, err_msg=key)
    cfg = port.cfg.optim
    lr = warmup_cosine_lr(0, max_lr=cfg.max_lr, warmup_iters=cfg.warmup_iters,
                          total_iters=cfg.total_iters, min_lr=cfg.min_lr)
    got_p, got_s = model_to_jax_tree(port.model)
    want_p = _leaves(jax.tree.map(np.asarray, state.params))
    want_s = _leaves(jax.tree.map(np.asarray, state.batch_stats))
    mu = _leaves(jax.tree.map(np.asarray, jax_adam_mu(state.opt_state)))
    got_p, got_s = _leaves(got_p), _leaves(got_s)
    assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
    for k, w in want_p.items():
        gap = np.abs(got_p[k] - w)
        assert gap.max() < 2.01 * lr, (k, gap.max() / lr)
        if k.startswith("stem/") or k.endswith(ZERO_GRADIENT):
            continue
        g = np.abs(mu[k])
        steady = g >= steady_share * g.max()
        assert (gap[steady] < STEADY_LR * lr).all(), (k, gap[steady].max() / lr)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, **stats_tol, err_msg=k)


def assert_same_state(a, b, what):
    """Model, EMA (parameters and BN running statistics), AdamW and the
    generator, bit for bit."""
    for name in ("model", "ema_model"):
        for (k, x), y in zip(getattr(a, name).state_dict().items(),
                             getattr(b, name).state_dict().values()):
            assert torch.equal(x, y), (what, name, k)
    for x, y in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in x:
            assert torch.equal(x[k], y[k]), (what, "adamw", k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state()), what


def seeded_steps(cfg, batches):
    """The port alone: a state seeded by the generator, a step a batch."""
    port = create_train_state(port_config(cfg), "cpu", torch.Generator().manual_seed(3))
    return [{k: float(v) for k, v in train_step(port, b).items()} for b in batches], port


# --- remat ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["blocks", "all"])
def test_remat_step_matches_jax_and_the_plain_step(mode):
    """The vit recipe: JAX's step at the same remat, and the port's own
    plain step bit for bit."""
    cfg = tiny_cfg(remat=mode)
    batch = tiny_batch(0, 4)
    init = jax_init(cfg, 0, batch)
    want, state = jax_step(cfg, init, batch)
    got, port = port_step(cfg, init, batch)
    check_against_jax(got, port, want, state)
    plain, plain_port = port_step(tiny_cfg(), init, batch)
    assert got == plain
    assert_same_state(port, plain_port, mode)


@pytest.mark.parametrize("mode", ["blocks", "all"])
def test_remat_replays_the_dropout_generator(mode, monkeypatch):
    """Dropout 0.1, drop-path 0.1 and random masking, all drawn from the
    state's generator: two remat steps give the plain steps' bits. Without
    the replay (the recompute drawing afresh) they do not, which is what
    this test sees."""
    cfg = dataclasses.replace(tiny_cfg(), model=dataclasses.replace(
        tiny_cfg().model, drop_rate=0.1, drop_path_rate=0.1,
        masking=MaskConfig(mode="random", ratio=0.3)))
    rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=mode))
    batches = [tiny_batch(1, 4), tiny_batch(2, 4)]
    plain, plain_port = seeded_steps(cfg, batches)
    got, port = seeded_steps(rcfg, batches)
    assert got == plain
    assert_same_state(port, plain_port, mode)

    run = remat.run
    monkeypatch.setattr(remat, "run", lambda fn, *a, replay=None, **kw: run(fn, *a, **kw))
    unreplayed, _ = seeded_steps(rcfg, batches)
    assert unreplayed != plain


def test_remat_builds_every_model_class():
    """remat reaches HTRVT and, through its trunk, the encoder-decoder; Swin
    and SVTR take it and ignore it, as JAX's do."""
    from htr_vt_torch.models.htr_vt import build_model
    for kw in (dict(encoder="swin"), dict(encoder="svtr"), dict(stem="van"),
               dict(model_type="encoder_decoder", ed_vocab_size=10)):
        cfg = dataclasses.replace(tiny_cfg().model, remat="all", **kw)
        assert build_model(port_config(cfg), device="cpu") is not None


# --- grad_accum -------------------------------------------------------------------
def test_grad_accum_on_duplicated_halves_matches_the_plain_step():
    """On a batch of two equal halves each microbatch's BN statistics are
    the whole batch's, so accumulating over 2 gives the unaccumulated
    update (JAX's test, tests/test_remat_accum.py:80-94: its optimizer and
    bars); the running statistics, which advance once a microbatch, are
    left out."""
    half = tiny_batch(2, 2)
    batch = {k: np.concatenate([v, v]) for k, v in half.items()}
    cfg = dataclasses.replace(tiny_cfg(), optim=OptimConfig(total_iters=100))
    init = jax_init(cfg, 0, batch)
    base, base_port = port_step(cfg, init, batch)
    acc, acc_port = port_step(dataclasses.replace(
        cfg, train=TrainConfig(total_iters=100, grad_accum=2)), init, batch)
    np.testing.assert_allclose(acc["loss"], base["loss"], rtol=1e-5)
    np.testing.assert_allclose(acc["grad_norm"], base["grad_norm"], rtol=1e-4)
    for (k, p0), p1 in zip(base_port.model.named_parameters(), acc_port.model.parameters()):
        np.testing.assert_allclose(p1.detach().numpy(), p0.detach().numpy(),
                                   rtol=5e-5, atol=5e-6, err_msg=k)


def test_grad_accum_rejects_an_indivisible_batch():
    init = jax_init(tiny_cfg(), 0, tiny_batch(3, 4))
    with pytest.raises(ValueError, match="divisible"):
        port_step(tiny_cfg(TrainConfig(total_iters=100, grad_accum=3)), init,
                  tiny_batch(3, 4))


def test_micro_batches_cut_every_key_in_order():
    batch = {"image": torch.arange(8.0).view(8, 1), "labels": torch.arange(16).view(8, 2),
             "sgm_tgt": torch.arange(8), "ed_input": torch.arange(24).view(8, 3)}
    parts = micro_batches(batch, 4)
    assert len(parts) == 4
    for k, v in batch.items():
        assert torch.equal(torch.cat([p[k] for p in parts]), v), k
        assert all(p[k].shape[0] == 2 for p in parts)
