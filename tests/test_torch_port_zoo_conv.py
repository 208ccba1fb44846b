"""The port's convolutional recipes (macaron, macaron_2, conformer,
squeezeformer) against the JAX recipes, on the CPU at the tiny float32
config of ``tests/test_torch_port_zoo.py``, with its weights, inputs and
bars: eval logits, and the train-mode forward (injected keep mask, the
macaron mixers' token BatchNorm on batch statistics) with dropout patched
out. Then their modules alone: the mixer BN's running statistics through
six train forwards (one tri-masked SAM step), the conv module, the SE gate
and the token down/upsampling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.models import conv_blocks as jconv
from htr_vt_torch.models import conv_blocks
from htr_vt_torch.utils.convert import load_jax_module
from test_torch_port_zoo import (BN_STATS_TOL, MODULE_TOL, check_eval, check_train,
                                 no_dropout)

CONV_RECIPES = ("macaron", "macaron_2", "conformer", "squeezeformer")


@pytest.mark.parametrize("encoder", CONV_RECIPES)
def test_recipe_eval_logits_match_jax(encoder):
    check_eval(encoder)


@pytest.mark.parametrize("encoder", CONV_RECIPES)
def test_recipe_train_forward_matches_jax(encoder):
    check_train(encoder)


def _mixer_pair(seed=0):
    x = np.random.default_rng(seed).standard_normal((4, 32, 64)).astype(np.float32)
    jmod = jconv.ConvLocalMixer1D(kernel_size=7, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed), x))
    tmod = conv_blocks.ConvLocalMixer1D(64, torch.float32, 7)
    load_jax_module(tmod, variables["params"], variables["batch_stats"])
    return jmod, variables, tmod


def test_mixer_batch_norm_moves_its_statistics_as_jax_does():
    """Six train forwards in a row, as a tri-masked SAM step runs (three
    forwards a pass): the same outputs each time and the same running mean
    and biased running variance (flax momentum 0.9) after each."""
    jmod, variables, tmod = _mixer_pair()
    params, stats = variables["params"], variables["batch_stats"]
    apply = jax.jit(lambda p, s, x: jmod.apply({"params": p, "batch_stats": s}, x,
                                               deterministic=True, train=True,
                                               mutable=["batch_stats"]))
    rng = np.random.default_rng(9)
    for _ in range(6):
        x = (2.0 * rng.standard_normal((4, 32, 64)) + 0.5).astype(np.float32)
        want, mutated = apply(params, stats, x)
        stats = mutated["batch_stats"]
        with no_dropout(), torch.no_grad():  # JAX: deterministic, BN in train
            got = tmod(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
        np.testing.assert_allclose(tmod.bn.running_mean.numpy(),
                                   np.asarray(stats["bn"]["mean"]), **BN_STATS_TOL)
        np.testing.assert_allclose(tmod.bn.running_var.numpy(),
                                   np.asarray(stats["bn"]["var"]), **BN_STATS_TOL)
    # eval reads them
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = jmod.apply({"params": params, "batch_stats": stats}, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("kernel", [3, 4])
def test_conv_module_matches_jax(kernel):
    """GLU, the depthwise conv (``[k, 1, C]`` flax kernel into torch's
    ``[C, 1, k]``, flax's SAME padding at an even k too) and GroupNorm(1)."""
    x = np.random.default_rng(kernel).standard_normal((2, 32, 64)).astype(np.float32)
    jmod = jconv.ConvModule(kernel_size=kernel, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), x)["params"])
    tmod = conv_blocks.ConvModule(64, torch.float32, kernel)
    load_jax_module(tmod, params)
    assert tmod.dw.weight.shape == (32, 1, kernel)
    with no_dropout(), torch.no_grad():
        got = tmod(torch.from_numpy(x), train=True)
        want = jmod.apply({"params": params}, x, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_squeeze_excite_and_token_resampling_match_jax():
    x = np.random.default_rng(4).standard_normal((2, 32, 64)).astype(np.float32)
    jmod = jconv.SqueezeExcite1D(dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(2), x)["params"])
    tmod = conv_blocks.SqueezeExcite1D(64, torch.float32)
    load_jax_module(tmod, params)
    assert tmod.fc1.out_features == 16
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).numpy(),
                                   np.asarray(jmod.apply({"params": params}, x)),
                                   **MODULE_TOL)
    t = torch.from_numpy(x)
    down = conv_blocks.downsample_tokens(t)
    np.testing.assert_allclose(down.numpy(), np.asarray(jconv.downsample_tokens(x)),
                               rtol=1e-6, atol=1e-7)
    for target in (32, 31):
        np.testing.assert_array_equal(
            conv_blocks.upsample_tokens(down, target).numpy(),
            np.asarray(jconv.upsample_tokens(jnp.asarray(down.numpy()), target)))


def test_squeezeformer_drop_path_rates_follow_the_jax_split():
    """linspace(0, 0.1, depth) over the two stages (stage 2 takes the tail)."""
    enc = conv_blocks.SqueezeFormerEncoder(64, 2, torch.float32, depth=5)
    rates = [getattr(enc, n).dp.rate for n in enc.stage1 + enc.stage2]
    np.testing.assert_allclose(rates, np.linspace(0.0, 0.1, 5), rtol=0, atol=0)
