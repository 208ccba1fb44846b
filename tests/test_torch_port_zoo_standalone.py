"""The zoo's last models against the JAX package, on the CPU at tiny float32
sizes (64x128 px): HTRSwin (``d_model`` 48, two heads, depths (2, 1, 2) so
that stage 0 has a shifted 2-D block), SVTR ``tiny`` and the VAN stems van
and van2 behind the baseline blocks (embed 64, depth 1, two heads).

Weights come from a JAX init with every norm, BN state and relative-bias
table randomised and cross into the port through ``utils/convert.py``;
inputs are numpy draws from a seed. Per model: the eval logits, at 128 and
at 256 px through one model (the per-grid tables); the train-mode forward
and the moved BN statistics with an injected keep mask, dropout patched to
the identity on both stacks inside the test; the conversion round trip
(JAX tree -> port -> JAX tree, ``strict=True``); the init statistics
against JAX's. Then Swin's window partition, cyclic shift, shift mask and
relative-bias gather, one block against JAX's with a non-symmetric table,
and the generalised ResNet18 stem. One tri-masked SGM SAM step of each
model is in ``tests/test_torch_port_zoo_sam.py``.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from htr_vt_tpu.config import MaskConfig, ModelConfig
from htr_vt_tpu.models import layers as jlayers
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models import stem as jstem
from htr_vt_tpu.models import svtr as jsvtr
from htr_vt_tpu.models import swin as jswin
from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
from htr_vt_tpu.models.variants import apply_variant_preset as jax_preset
from htr_vt_torch.models import layers, sgm, stem, svtr, swin
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.utils.convert import load_jax_module, load_jax_params, model_to_jax_tree
from test_torch_port_model import _randomise, port_config
from test_torch_port_zoo import _leaves, _randomise_tables

TINY = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1, num_heads=2,
                   compute_dtype="float32", masking=MaskConfig(mode="random", ratio=0.3))
MODELS = ("swin", "svtr", "van", "van2")
SWIN_KW = dict(d_model=48, stage_depths=(2, 1, 2), stage_heads=(2, 2, 2))
B = 2
WIDTHS = (128, 256)
# Eval logits: float32 on both sides, sums in other orders.
EVAL_TOL = dict(rtol=1e-5, atol=1e-5)
# Train mode: the train-BN bar of tests/test_torch_port_zoo.py (batch
# statistics over B x H x W in another order).
TRAIN_TOL = dict(rtol=1e-3, atol=5e-4)
BN_STATS_TOL = dict(rtol=1e-5, atol=1e-5)
# One module on both sides in float32.
MODULE_TOL = dict(rtol=1e-5, atol=1e-6)
# Init statistics: each leaf's standard deviation (pooled over INIT_SEEDS
# inits on each side) within 10% of JAX's, its mean within 10% of JAX's
# deviation; where a leaf is too small for a sample to resolve 10% (n
# values on each side: the two estimates' spread is about 1 / sqrt(n) of
# the deviation), within five times that spread.
INIT_SEEDS = 4
INIT_STD_REL = 0.1


def model_config(name, **kw):
    return jax_preset(dataclasses.replace(TINY, encoder=name, **kw))


def jax_model(name, cfg):
    """The JAX module: Swin at the tiny size, the others as build_model
    makes them."""
    if name == "swin":
        return jswin.HTRSwin(cfg, **SWIN_KW)
    return jax_build_model(cfg)


def port_model(name, cfg, device="cpu", generator=None):
    """The port's module at the same size, built from the JAX config."""
    cfg = port_config(cfg)
    if name == "swin":
        return swin.HTRSwin(cfg, device=device, generator=generator, **SWIN_KW)
    return build_model(cfg, device=device, generator=generator)


def tokens_of(name, width):
    """The token count the masking sees at 64 x ``width`` px."""
    return {"swin": 4 * width // 4, "svtr": 16 * width // 4}.get(name, width // 4)


@functools.lru_cache(maxsize=None)
def model_weights(name):
    """(cfg, params, batch_stats) of a randomised JAX model."""
    cfg = model_config(name)
    v = jax.jit(lambda k: jax_model(name, cfg).init(
        k, jnp.zeros((1, 64, 128, 1)), train=False))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(11)
    params = _randomise_tables(_randomise(v["params"], rng), rng)
    return cfg, params, _randomise(v["batch_stats"], rng)


def loaded_model(name):
    cfg, params, stats = model_weights(name)
    model = port_model(name, cfg)
    load_jax_params(model, params, stats)
    return model


@contextlib.contextmanager
def no_dropout():
    """Dropout and drop-path as the identity on both stacks, the standalone
    models' combine dropout included."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlayers.DropPath, "__call__", lambda self, x, *a, **k: x)
        for mod in (layers, swin, sgm):
            mp.setattr(mod, "dropout", lambda x, rate, train, generator: x)
        mp.setattr(layers.DropPath, "forward", lambda self, x, **k: x)
        yield


@pytest.mark.parametrize("name", MODELS)
def test_eval_logits_match_jax_at_two_widths(name):
    """One port model serves 128 and 256 px (its grid tables made per
    width) as the JAX module does on the same weights; float32."""
    cfg, params, stats = model_weights(name)
    model = loaded_model(name)
    apply = jax.jit(lambda p, s, x: jax_model(name, cfg).apply(
        {"params": p, "batch_stats": s}, x, train=False))
    for i, width in enumerate(WIDTHS):
        x = np.random.default_rng(5 + i).random((B, 64, width, 1), dtype=np.float32)
        with torch.inference_mode():
            got = model(torch.from_numpy(x))
        want = apply(params, stats, x)
        assert got.shape == want.shape == (B, width // 4, cfg.nb_cls)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EVAL_TOL,
                                   err_msg=f"{name} at {width} px")


@pytest.mark.parametrize("name", MODELS)
def test_train_forward_and_bn_statistics_match_jax(name):
    """The train-mode forward from the same weights and keep mask, dropout
    off: logits, the SGM-free features, and every moved BN statistic."""
    cfg, params, stats = model_weights(name)
    rng = np.random.default_rng(6)
    x = rng.random((B, 64, 128, 1), dtype=np.float32)
    keep = (rng.random((B, tokens_of(name, 128), 1)) > 0.3).astype(np.float32)
    with no_dropout(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmasking, "build_keep_mask", lambda *a, **k: jnp.asarray(keep))
        want, mutated = jax.jit(lambda p, s, x: jax_model(name, cfg).apply(
            {"params": p, "batch_stats": s}, x, train=True, use_masking=True,
            mutable=["batch_stats"],
            rngs={"mask": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}))(
            params, stats, x)
        model = loaded_model(name)
        got = model(torch.from_numpy(x), train=True, keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TRAIN_TOL)
    got_s = _leaves(model_to_jax_tree(model)[1])
    want_s = _leaves(mutated["batch_stats"])
    assert got_s.keys() == want_s.keys() and got_s
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, **BN_STATS_TOL, err_msg=k)


@pytest.mark.parametrize("name", MODELS + ("encoder_decoder",))
def test_conversion_round_trips_strictly(name):
    """JAX tree -> port (``load_state_dict(strict=True)``) -> JAX tree gives
    every leaf back bit for bit, under the JAX module names."""
    if name == "encoder_decoder":
        from test_torch_port_ed import ed_weights
        _, _, params, stats, model = ed_weights()
    else:
        _, params, stats = model_weights(name)
        model = loaded_model(name)
    got_p, got_s = model_to_jax_tree(model)
    for what, (g, w) in (("params", (got_p, params)), ("batch_stats", (got_s, stats))):
        g, w = _leaves(g), _leaves(w)
        assert g.keys() == w.keys(), what
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _init_leaves(name, seed):
    """(JAX init leaves, the port's init leaves under JAX names) at ``seed``."""
    if name == "encoder_decoder":
        from test_torch_port_ed import _init, ed_config
        cfg = ed_config()
        v = _init(cfg, seed)
        model = build_model(port_config(cfg), device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    else:
        cfg = model_config(name)
        v = jax.jit(lambda k: jax_model(name, cfg).init(
            k, jnp.zeros((1, 64, 128, 1)), train=False))(jax.random.PRNGKey(seed))
        model = port_model(name, cfg, generator=torch.Generator().manual_seed(seed))
    return _leaves(v["params"]), _leaves(model_to_jax_tree(model)[0])


@pytest.mark.parametrize("name", MODELS + ("encoder_decoder",))
def test_init_statistics_match_jax(name):
    """Each parameter leaf of a fresh port model (``generator`` given) is
    drawn as JAX's init draws it: constants equal; random leaves with their
    standard deviation within 10% of JAX's and their mean within 10% of
    that deviation (``INIT_STD_REL``, widened for small leaves), each pooled
    over four seeds on each side."""
    draws = [_init_leaves(name, seed) for seed in range(INIT_SEEDS)]
    want_keys = draws[0][0].keys()
    assert draws[0][1].keys() == want_keys
    for k in want_keys:
        want = np.concatenate([w[k].ravel() for w, _ in draws])
        got = np.concatenate([g[k].ravel() for _, g in draws])
        if want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        bar = max(INIT_STD_REL, 5.0 / np.sqrt(want.size))
        assert abs(got.std() / want.std() - 1.0) < bar, (k, got.std(), want.std())
        assert abs(got.mean() - want.mean()) < bar * want.std(), (k, got.mean(), want.mean())


# --- Swin's windows, shifts and bias, one block ---------------------------------
@pytest.mark.parametrize("hw,window", [((8, 16), (4, 8)), ((4, 24), (2, 8)), ((2, 16), (1, 8))])
def test_swin_tables_are_the_jax_ones(hw, window):
    (h, w), (wh, ww) = hw, window
    np.testing.assert_array_equal(swin._rel_bias_index(wh, ww),
                                  jswin._rel_bias_index(wh, ww))
    for shift in ((0, 0), (wh // 2, ww // 2), (0, ww // 2)):
        got, want = swin._shift_mask(h, w, wh, ww, *shift), jswin._shift_mask(
            h, w, wh, ww, *shift)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_matches_jax_with_a_non_symmetric_bias_table(shifted):
    """One SwinBlock2D on an (8, 16) grid of (4, 8) windows, shifted by (2,
    4) or not, with a random bias table (no symmetry between rows, columns
    or directions): the roll, the batch-major window order, the per-image
    mask broadcast over the batch and the ``2 ww - 1`` row stride of the
    bias index all show in the output."""
    h, w, c, heads = 8, 16, 32, 2
    shift = (2, 4) if shifted else (0, 0)
    x = np.random.default_rng(7).standard_normal((3, h * w, c)).astype(np.float32)
    jmod = jswin.SwinBlock2D(num_heads=heads, input_hw=(h, w), window=(4, 8),
                             shift=shift, mlp_ratio=2.0, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(0), x)["params"])
    params = _randomise(params, np.random.default_rng(8))
    params["rel_bias"] = np.random.default_rng(9).standard_normal(
        params["rel_bias"].shape).astype(np.float32)
    want = jmod.apply({"params": params}, x)
    tmod = swin.SwinBlock2D(c, heads, (4, 8), shift, 2.0, torch.float32)
    load_jax_module(tmod, params)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(x), (h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    # the same block with the table's rows and columns swapped is another
    # function: the index's row stride is 2 ww - 1
    flipped = dict(params, rel_bias=params["rel_bias"][::-1].copy())
    load_jax_module(tmod, flipped)
    with torch.inference_mode():
        assert not torch.allclose(tmod(torch.from_numpy(x), (h, w)), got, atol=1e-3)


def test_svtr_local_mask_is_the_jax_one():
    for hw in ((16, 32), (8, 32), (4, 64)):
        np.testing.assert_array_equal(svtr.local_neighborhood_mask(*hw),
                                      jsvtr.local_neighborhood_mask(*hw))


# --- the generalised ResNet18 stem ----------------------------------------------
PLANS = {"default": {}, "swin": dict(widths=[16, 32], stage_strides=((2, 2), (2, 2)),
                                     final_maxpool=False),
         "van2": dict(widths=[16, 32, 64], stage_strides=((2, 1), (2, 2), (1, 2)),
                      final_maxpool=False)}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("train", [False, True])
def test_resnet_stem_plans_match_jax(plan, train):
    """The flagship plan, Swin / van's two stages and van2's three, eval and
    train (batch statistics, the plain dataflow): outputs and the moved
    statistics against JAX's ResNet18Stem."""
    kw = PLANS[plan]
    x = np.random.default_rng(12).random((2, 64, 128, 1), dtype=np.float32)
    jmod = jstem.ResNet18Stem(embed_dim=64, dtype=jnp.float32, **kw)
    v = jmod.init(jax.random.PRNGKey(1), x)
    rng = np.random.default_rng(13)
    params, stats = _randomise(v["params"], rng), _randomise(v["batch_stats"], rng)
    want, mutated = jmod.apply({"params": params, "batch_stats": stats}, x, train=train,
                               mutable=["batch_stats"])
    tmod = stem.ResNet18Stem(64, torch.float32, **kw)
    load_jax_module(tmod, params, stats)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2), train=train)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               **(TRAIN_TOL if train else EVAL_TOL))
    if train:
        got_s = _leaves(model_to_jax_tree(tmod)[1])
        for k, w in _leaves(mutated["batch_stats"]).items():
            np.testing.assert_allclose(got_s[k], w, **BN_STATS_TOL, err_msg=k)


def test_default_stem_keeps_its_keys_and_logits():
    """The generalisation leaves the flagship stem as it was: the reference
    state_dict keys in their order, and the same weights give the same
    logits bit for bit whether the plan is given or defaulted."""
    cfg = port_config(TINY)
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    keys = list(a.patch_embed.state_dict())
    assert keys[:6] == ["conv1.weight", "bn1.weight", "bn1.bias", "bn1.running_mean",
                        "bn1.running_var", "layer1.0.conv1.weight"]
    assert [k for k in keys if "downsample" in k][0] == "layer1.0.downsample.0.weight"
    assert {k.split(".")[0] for k in keys} == {"conv1", "bn1", "layer1", "layer2", "layer3"}
    explicit = stem.ResNet18Stem(64, torch.float32, widths=[16, 32, 64],
                                 stage_strides=stem.ResNet18Stem.STAGE_STRIDES,
                                 final_maxpool=True)
    assert list(explicit.state_dict()) == keys
    explicit.load_state_dict(a.patch_embed.state_dict(), strict=True)
    x = torch.rand(2, 1, 64, 128, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        assert torch.equal(explicit(x), a.patch_embed(x))
