"""One tri-masked SGM SAM step of each of the zoo's last CTC models, as
their reference recipes (``model_sgm_mms_attach_van``, ``_van_2``,
``model_sgm_mms_swin``, ``_svtr``) train them, against JAX's jitted
``train_step`` on the CPU: van and van2 here, Swin and SVTR in
``test_torch_port_zoo_sam_swin.py`` and ``_svtr.py`` (each model's JAX
compile takes 40-85 s, so one file holds one or two); at the tiny float32 sizes of
``tests/test_torch_port_zoo_standalone.py``, the SGM head on the combined
(Swin, SVTR) or normed (VAN) features with its gate open, the same
weights, batch and keep masks (one fixed mask a mode), dropout patched to
the identity on both stacks inside the test. Held at the bars of
``tests/test_torch_port_sgm.py``: losses and the gradient norm to 1e-4,
every parameter and its EMA to 2% of the LR (Adam's sign-flip bound where
JAX's gradient is under float32 noise, and on the stem), the BN statistics
moved by six forwards. The bias of a convolution that feeds a train-mode
BatchNorm has an exact gradient of zero (the BN removes any shift), so
both stacks give it rounding noise: those leaves are held to the
sign-flip bound alone.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import ExperimentConfig, TrainConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.optim.sam import make_base_optimizer
from htr_vt_tpu.train import step as jstep
from htr_vt_tpu.train.state import create_train_state as jax_create_train_state
from htr_vt_torch.models import masking
from htr_vt_torch.optim.sam import make_base_optimizer as port_optimizer
from htr_vt_torch.train.state import TrainState
from htr_vt_torch.train.step import TRI_MASK_MODES, train_step
from htr_vt_torch.utils.convert import load_jax_train_state, model_to_jax_tree
from test_torch_port_model import _randomise, port_config
from test_torch_port_sgm import OPTIM, SGM, _batch, _check_step, jax_adam_mu
from test_torch_port_zoo import _leaves
from test_torch_port_zoo_standalone import (jax_model, model_config, no_dropout, port_model,
                                            tokens_of)

B = 4  # test_torch_port_sgm._batch's rows
ZERO_GRADIENT = ("embed_conv1/bias", "embed_conv2/bias", "stem/van0/proj2/bias",
                 "stem/van1/proj2/bias")
STEP_RTOL = 1e-4
BN_STATS_TOL = dict(rtol=1e-3, atol=1e-4)


def _port_state(name, cfg):
    model = port_model(name, cfg.model)
    ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(cfg=port_config(cfg), model=model, ema_model=ema,
                      optimizer=port_optimizer(model.parameters(), port_config(cfg.optim)),
                      generator=torch.Generator().manual_seed(0))


def run_sam_step(name):
    """(name, JAX's metrics, the port's, JAX's state after the step, the
    port's TrainState)."""
    cfg = ExperimentConfig(model=model_config(name, nb_cls=8, sgm=dataclasses.replace(
        SGM, warmup_iters=0)), optim=OPTIM, train=TrainConfig(tri_masked=True))
    rng = np.random.default_rng(2)
    n = tokens_of(name, 128)
    masks = {mode: (rng.random((B, n, 1)) > ratio).astype(np.float32)
             for mode, ratio in TRI_MASK_MODES}
    batch = _batch(30)
    model = jax_model(name, cfg.model)
    sample = {k: v[:1] for k, v in batch.items() if k.startswith("sgm_")}
    init = jax_create_train_state(cfg, model, jax.random.PRNGKey(4),
                                  np.zeros((1, 64, 128, 1), np.float32), sgm_sample=sample)
    params = _randomise(jax.tree.map(np.asarray, init.params), rng)
    stats = _randomise(jax.tree.map(np.asarray, init.batch_stats), rng)
    init = init.replace(params=params, batch_stats=stats,
                        opt_state=make_base_optimizer(OPTIM).init(params),
                        ema_params=params, ema_batch_stats=stats)
    with no_dropout(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmasking, "build_keep_mask",
                   lambda *a, mode=None, ratio=None: jnp.asarray(masks[mode]))
        mp.setattr(masking, "build_keep_mask",
                   lambda *a, mode=None, ratio=None: torch.from_numpy(masks[mode]))
        state, m = jax.jit(lambda s, b: jstep.train_step(model, cfg, s, b))(
            init, {k: jnp.asarray(v) for k, v in batch.items()})
        port = _port_state(name, cfg)
        load_jax_train_state(port.model, port.ema_model, init)
        got = {k: float(v) for k, v in train_step(port, batch).items()}
    return name, {k: float(v) for k, v in m.items()}, got, state, port


def check_losses(sam_step):
    """loss (the mean of three forwards' ctc_lambda * CTC + sgm_lambda *
    SGM), loss_second and grad_norm."""
    name, want, got, _, port = sam_step
    assert port.step == 1 and got["loss_sgm"] > 0
    for key in ("loss", "loss_second", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=STEP_RTOL,
                                   err_msg=f"{name} {key}")


def check_updates(sam_step):
    """Every parameter and its EMA at the one-step bars, the BN statistics
    at the BN bar."""
    name, _, _, state, port = sam_step
    mu = {k: v for k, v in _leaves(jax.tree.map(np.asarray, jax_adam_mu(
        state.opt_state))).items() if k not in ZERO_GRADIENT}
    for module, want_p, want_s, what in (
            (port.model, state.params, state.batch_stats, "params"),
            (port.ema_model, state.ema_params, state.ema_batch_stats, "EMA")):
        got_p, got_s = model_to_jax_tree(module)
        assert "sgm_head" in got_p
        _check_step(_leaves(got_p), _leaves(jax.tree.map(np.asarray, want_p)), mu,
                    f"{name} {what}")
        want_s = _leaves(jax.tree.map(np.asarray, want_s))
        for k, g in _leaves(got_s).items():
            np.testing.assert_allclose(g, want_s[k], **BN_STATS_TOL, err_msg=f"{name} {k}")


@pytest.fixture(scope="module", params=("van", "van2"))
def sam_step(request):
    return run_sam_step(request.param)


def test_tri_masked_sgm_step_loss_matches_jax(sam_step):
    check_losses(sam_step)


def test_tri_masked_sgm_step_updates_params_ema_and_bn_stats_as_jax(sam_step):
    check_updates(sam_step)
