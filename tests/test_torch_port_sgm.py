"""The SGM head and the tri-masked MMS trainer against JAX, on the CPU at a
tiny float32 config: the copied vocabulary and context windows; the head's
loss and gradient; two tri-masked SAM steps of the ``model_sgm_mms_conv``
recipe (conformer, SGM on, its warmup gate closed at step 0 and open at
step 1) against ``htr_vt_tpu.train.step.train_step`` from the same weights,
batch and keep masks, dropout patched out on both sides. The head alone
and ``cli/train.py --encoder conformer --tri-masked --sgm-enable`` end to
end are in ``test_torch_port_sgm_head.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import (ExperimentConfig, MaskConfig, ModelConfig,
                               OptimConfig, SGMConfig, TrainConfig)
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models import sgm as jsgm
from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
from htr_vt_tpu.models.variants import apply_variant_preset as jax_preset
from htr_vt_tpu.optim.sam import make_base_optimizer
from htr_vt_tpu.text.converter import CTCLabelConverter as JaxConverter
from htr_vt_tpu.train import step as jstep
from htr_vt_tpu.train.state import create_train_state as jax_create_train_state
from htr_vt_torch.models import masking, sgm
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import TRI_MASK_MODES, train_step
from htr_vt_torch.utils.convert import (load_jax_module, load_jax_train_state,
                                        model_to_jax_tree)
from test_torch_port_model import _randomise, port_config
from test_torch_port_zoo import _leaves, no_dropout

ALPHABET = "abcdefg"  # 7 characters + blank = nb_cls 8
B, N, LMAX, SUB = 4, 32, 6, 3
SGM = SGMConfig(enable=True, sgm_lambda=0.7, ctc_lambda=0.2, sub_len=SUB, warmup_iters=1,
                char_emb_dim=16, vocab_size=len(ALPHABET) + 1 + 4)
TINY = jax_preset(ModelConfig(
    encoder="conformer", nb_cls=len(ALPHABET) + 1, img_size=(64, 128), embed_dim=64,
    depth=2, num_heads=2, compute_dtype="float32",
    masking=MaskConfig(mode="random", ratio=0.3), sgm=SGM))
OPTIM = OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=12)
CFG = ExperimentConfig(model=TINY, optim=OPTIM, train=TrainConfig(tri_masked=True))
# Losses and gradient norms: float32 sums in other orders (the bar of
# tests/test_torch_port_train.py).
STEP_RTOL = 1e-4
BN_STATS_TOL = dict(rtol=1e-3, atol=1e-4)
# The head alone, float32 on both sides.
HEAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _texts(rng, n):
    return ["".join(rng.choice(list(ALPHABET), rng.integers(1, LMAX + 1))) for _ in range(n)]


def _sgm_arrays(texts):
    vocab = sgm.SGMVocab(CTCLabelConverter(list(ALPHABET)))
    return sgm.make_context_arrays(texts, vocab, LMAX, SUB)


# --- one tri-masked SAM step with SGM, its gate closed and open ----------------
def _batch(seed):
    rng = np.random.default_rng(seed)
    texts = _texts(rng, B)
    labels = np.zeros((B, LMAX), np.int32)
    for i, t in enumerate(texts):
        labels[i, :len(t)] = [ALPHABET.index(c) + 1 for c in t]
    return {"image": rng.random((B, 64, 128, 1), dtype=np.float32), "labels": labels,
            "label_lengths": np.array([len(t) for t in texts], np.int32),
            **_sgm_arrays(texts)}


GATES = {"closed": 1, "open": 0}  # sgm.warmup_iters: the gate at step 0


@pytest.fixture(scope="module")
def sgm_steps():
    """From the same weights, batch and keep masks (one fixed mask per
    mode), one tri-masked SAM step on both stacks with the SGM gate closed
    (warmup_iters 1) and open (0); JAX's pass-1 CTC and SGM terms from
    ``_forward_loss``, which the gate does not enter (it weighs the terms
    in the total only), so they are computed once for both. JAX runs
    eagerly: at this config XLA's jitted CPU gradient of the stem differs
    from JAX's own eager one by up to 3.5e-2 of its largest element, where
    the port's matches the eager one within 2e-5; the encoder's and head's
    gradients agree either way."""
    rng = np.random.default_rng(2)
    masks = {mode: (rng.random((B, N, 1)) > ratio).astype(np.float32)
             for mode, ratio in TRI_MASK_MODES}
    batch = _batch(30)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    sample = {k: v[:1] for k, v in batch.items() if k.startswith("sgm_")}
    init = jax_create_train_state(CFG, jax_build_model(TINY), jax.random.PRNGKey(4),
                                  np.zeros((1, 64, 128, 1), np.float32), sgm_sample=sample)
    params = _randomise(jax.tree.map(np.asarray, init.params), rng)
    stats = _randomise(jax.tree.map(np.asarray, init.batch_stats), rng)
    init = init.replace(params=params, batch_stats=stats,
                        opt_state=make_base_optimizer(OPTIM).init(params),
                        ema_params=params, ema_batch_stats=stats)
    out = {}
    with no_dropout(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmasking, "build_keep_mask",
                   lambda *a, mode=None, ratio=None: jnp.asarray(masks[mode]))
        mp.setattr(masking, "build_keep_mask",
                   lambda *a, mode=None, ratio=None: torch.from_numpy(masks[mode]))
        ctc = sgm_loss = 0.0
        bs = stats
        for mode, ratio in TRI_MASK_MODES:
            _, aux = jstep._forward_loss(jax_build_model(TINY), CFG, params, bs, jbatch,
                                         jax.random.PRNGKey(0), mode, ratio, init.step)
            bs = aux["batch_stats"]
            ctc, sgm_loss = ctc + aux["loss_ctc"], sgm_loss + aux["loss_sgm"]
        for gate, warmup in GATES.items():
            cfg = dataclasses.replace(CFG, model=dataclasses.replace(
                TINY, sgm=dataclasses.replace(SGM, warmup_iters=warmup)))
            model = jax_build_model(cfg.model)
            state, m = jstep.train_step(model, cfg, init, jbatch)
            jax_metrics = {**{k: float(v) for k, v in m.items()},
                           "loss_ctc": float(ctc / 3), "loss_sgm": float(sgm_loss / 3)}
            port = create_train_state(port_config(cfg), "cpu",
                                      torch.Generator().manual_seed(0))
            load_jax_train_state(port.model, port.ema_model, init)
            port_metrics = {k: float(v) for k, v in train_step(port, batch).items()}
            out[gate] = (jax_metrics, state, port_metrics, port)
    return out, params


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


def _check_step(got, want, mu, what):
    """After one step. Adam's first step moves each element by lr * g /
    (|g| + eps), about the LR in the direction of its gradient's sign, so
    an element whose gradient is within float32 noise (under 1e-4 of its
    leaf's largest: the stacks' sums in other orders differ by about 1e-5
    of it) may move either way: those elements, and every element of the
    stem, whose JAX gradient is not stable at this config (the fixture's
    docstring), are held to Adam's sign-flip bound, 2 x the LR. Every
    other element within 2% of the LR (tests/test_torch_port_train.py
    holds three steps to 1% of their summed LR, 5.7 times the first
    step's). ``mu``: JAX's first Adam moment, 0.1 x its gradient."""
    lr = warmup_cosine_lr(0, max_lr=OPTIM.max_lr, warmup_iters=OPTIM.warmup_iters,
                          total_iters=OPTIM.total_iters, min_lr=OPTIM.min_lr)
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        gap = np.abs(got[k] - w)
        assert gap.max() < 2.01 * lr, (what, k, gap.max() / lr)
        if k.startswith("stem/") or k not in mu:
            continue
        g = np.abs(mu[k])
        steady = g >= 1e-4 * g.max()
        assert (gap[steady] < 0.02 * lr).all(), (what, k, gap[steady].max() / lr)


@pytest.mark.parametrize("gate", list(GATES))
def test_tri_masked_sgm_step_matches_jax(sgm_steps, gate):
    """loss (the mean of three forwards' ctc_lambda * CTC + gate *
    sgm_lambda * SGM), loss_second and grad_norm against JAX's
    ``train_step``; loss_ctc and loss_sgm against the mean of JAX's three
    pass-1 ``_forward_loss`` terms; the gate read at step 0."""
    jax_metrics, _, port_metrics, port = sgm_steps[0][gate]
    assert port.step == 1
    for key in ("loss", "loss_second", "grad_norm", "loss_ctc", "loss_sgm"):
        np.testing.assert_allclose(port_metrics[key], jax_metrics[key], rtol=STEP_RTOL,
                                   err_msg=key)
    weight = SGM.sgm_lambda if gate == "open" else 0.0
    np.testing.assert_allclose(port_metrics["loss"], SGM.ctc_lambda * port_metrics["loss_ctc"]
                               + weight * port_metrics["loss_sgm"], rtol=1e-6)
    assert port_metrics["loss_sgm"] > 0


@pytest.mark.parametrize("gate", list(GATES))
def test_tri_masked_sgm_step_updates_params_ema_and_bn_stats_as_jax(sgm_steps, gate):
    """Every parameter (the SGM head's too) and its EMA within the step's
    bars, and the BN statistics, moved by six forwards in order, within
    the train-step BN bar. With the gate closed the SGM head's gradient is
    zero, so AdamW only decays it."""
    (_, state, _, port), params = sgm_steps[0][gate], sgm_steps[1]
    mu = _leaves(jax.tree.map(np.asarray, jax_adam_mu(state.opt_state)))
    for module, want_p, want_s, what in (
            (port.model, state.params, state.batch_stats, "params"),
            (port.ema_model, state.ema_params, state.ema_batch_stats, "EMA")):
        got_p, got_s = model_to_jax_tree(module)
        assert "sgm_head" in got_p
        _check_step(_leaves(got_p), _leaves(jax.tree.map(np.asarray, want_p)), mu,
                    what)
        want_s = _leaves(jax.tree.map(np.asarray, want_s))
        for k, g in _leaves(got_s).items():
            np.testing.assert_allclose(g, want_s[k], **BN_STATS_TOL, err_msg=k)
    if gate == "closed":
        lr = warmup_cosine_lr(0, max_lr=OPTIM.max_lr, warmup_iters=OPTIM.warmup_iters,
                              total_iters=OPTIM.total_iters, min_lr=OPTIM.min_lr)
        got = _leaves(model_to_jax_tree(port.model)[0])
        for k, w in _leaves(params).items():
            if k.startswith("sgm_head/"):
                np.testing.assert_allclose(got[k], w * (1 - lr * OPTIM.weight_decay),
                                           rtol=1e-6, atol=1e-9, err_msg=k)
