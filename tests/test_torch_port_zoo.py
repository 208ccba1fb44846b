"""The port's block-recipe zoo against the JAX recipes, on the CPU at a tiny
float32 config (64x128 px, embed 64, depth 2, two heads: 32 tokens).

Weights come from a JAX init with every norm, BN state and relative-bias
table randomised and cross into the port through ``utils/convert.py``;
inputs are numpy draws from a seed. Per recipe: the eval logits, and the
train-mode forward (injected keep mask, batch-statistic BN) with dropout and
drop-path patched to the identity on both sides, inside the test only:
their rates are fixed in the JAX recipes' code and the two random streams
differ, so dropout itself is held by its keep rate and scale. This file
holds the attention recipes; ``test_torch_port_zoo_conv.py`` the
convolutional ones. Then the window attentions, the pooled-global
attention and the recipes' refusals module by module.
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
from htr_vt_tpu.models import localglobal as jlocalglobal
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models import vit as jvit
from htr_vt_tpu.models.htr_vt import build_model as jax_build_model
from htr_vt_tpu.models.variants import apply_variant_preset as jax_preset
from htr_vt_torch.cli import args as targs
from htr_vt_torch.models import conv_blocks, layers, localglobal, sgm, vit
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.models.variants import VARIANT_PRESETS, apply_variant_preset
from htr_vt_torch.utils.convert import load_jax_module, load_jax_params, model_to_jax_tree
from test_torch_port_model import _randomise, port_config

TINY = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2, num_heads=2,
                   compute_dtype="float32",
                   masking=MaskConfig(mode="random", ratio=0.3))
B, N = 2, 32
# Eval logits: float32 on both sides, the stem's and blocks' sums in other
# orders (measured up to 3.7e-6 over the eight recipes).
EVAL_TOL = dict(rtol=1e-5, atol=1e-5)
# Train mode: the train-BN bar of tests/test_torch_port_train.py (batch
# statistics over B x H x W in another order).
TRAIN_TOL = dict(rtol=1e-3, atol=5e-4)
BN_STATS_TOL = dict(rtol=1e-5, atol=1e-5)
# One module on both sides in float32: a few ulps of its sums.
MODULE_TOL = dict(rtol=1e-5, atol=1e-6)
ATTENTION_RECIPES = ("vit", "window", "localglobal", "lgp", "lgp_svtr")


def recipe_config(encoder, **kw):
    return jax_preset(dataclasses.replace(TINY, encoder=encoder, **kw))


def _randomise_tables(tree, rng):
    """Relative-bias tables and gates drawn away from their inits (the
    global window tables start at zero)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise_tables(v, rng)
        elif k in ("rel_bias", "alpha"):
            out[k] = (np.asarray(v) + 0.1 * rng.standard_normal(np.shape(v))).astype(
                np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def recipe_weights(encoder):
    """(cfg, params, batch_stats) of a randomised JAX model of the recipe."""
    cfg = recipe_config(encoder)
    h, w = cfg.img_size
    v = jax.jit(lambda k: jax_build_model(cfg).init(
        k, jnp.zeros((1, h, w, 1)), train=False))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(11)
    params = _randomise_tables(_randomise(v["params"], rng), rng)
    return cfg, params, _randomise(v["batch_stats"], rng)


def port_model(cfg, params, stats):
    model = build_model(port_config(cfg), device="cpu")
    load_jax_params(model, params, stats)
    return model


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@contextlib.contextmanager
def no_dropout():
    """Dropout and drop-path as the identity on both stacks (the JAX
    modules' ``__call__`` and the port's ``dropout`` / ``DropPath``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jlayers.DropPath, "__call__", lambda self, x, *a, **k: x)
        for mod in (layers, vit, localglobal, conv_blocks, sgm):
            mp.setattr(mod, "dropout", lambda x, rate, train, generator: x)
        mp.setattr(layers.DropPath, "forward", lambda self, x, **k: x)
        yield


def check_eval(encoder):
    cfg, params, stats = recipe_weights(encoder)
    x = np.random.default_rng(5).random((B, 64, 128, 1), dtype=np.float32)
    want = jax.jit(lambda p, s, x: jax_build_model(cfg).apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x)
    model = port_model(cfg, params, stats)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EVAL_TOL)
    # and back: the port's weights are the JAX tree it was given
    got_p, got_s = model_to_jax_tree(model)
    for name, (g, w) in (("params", (got_p, params)), ("batch_stats", (got_s, stats))):
        g, w = _leaves(g), _leaves(w)
        assert g.keys() == w.keys(), name
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def check_train(encoder):
    """The train-mode forward from the same weights and keep mask, dropout
    off: logits and the moved BN statistics (stem and token BNs)."""
    cfg, params, stats = recipe_weights(encoder)
    rng = np.random.default_rng(6)
    x = rng.random((B, 64, 128, 1), dtype=np.float32)
    keep = (rng.random((B, N, 1)) > 0.3).astype(np.float32)
    with no_dropout(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmasking, "build_keep_mask", lambda *a, **k: jnp.asarray(keep))
        want, mutated = jax.jit(lambda p, s, x: jax_build_model(cfg).apply(
            {"params": p, "batch_stats": s}, x, train=True, use_masking=True,
            mask_mode="random", mask_ratio=0.3, mutable=["batch_stats"],
            rngs={"mask": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}))(
            params, stats, x)
        model = port_model(cfg, params, stats)
        got = model(torch.from_numpy(x), train=True, keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TRAIN_TOL)
    got_s = _leaves(model_to_jax_tree(model)[1])
    want_s = _leaves(mutated["batch_stats"])
    assert got_s.keys() == want_s.keys()
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, **BN_STATS_TOL, err_msg=k)


@pytest.mark.parametrize("encoder", ATTENTION_RECIPES)
def test_recipe_eval_logits_match_jax(encoder):
    check_eval(encoder)


@pytest.mark.parametrize("encoder", ATTENTION_RECIPES)
def test_recipe_train_forward_matches_jax(encoder):
    check_train(encoder)


# --- the windowed attentions, module by module -----------------------------
def _jax_module(module, x, seed=0, **apply_kw):
    variables = module.init(jax.random.PRNGKey(seed), x)
    params = _randomise_tables(jax.tree.map(np.asarray, variables["params"]),
                               np.random.default_rng(seed))
    out = module.apply({"params": params}, x, **apply_kw)
    return params, np.asarray(out)


@pytest.mark.parametrize("n,w,shift,wrap", [
    (128, 11, False, True),   # lgp_svtr at the flagship width: padded keys
    (40, 16, True, True),     # shifted and padded, the reference's wrap
    (40, 16, True, False),    # the Swin-style segment mask
    (32, 16, True, True)])    # the tiny window recipe's shifted block
def test_window_attention_matches_jax(n, w, shift, wrap):
    x = np.random.default_rng(n + w).standard_normal((2, n, 64)).astype(np.float32)
    jmod = jvit.WindowAttention1D(num_heads=2, window_size=w, shift=shift,
                                  wrap_shift=wrap, dtype=jnp.float32)
    params, want = _jax_module(jmod, jnp.asarray(x))
    tmod = vit.WindowAttention1D(64, 2, w, shift, True, torch.float32, wrap_shift=wrap)
    load_jax_module(tmod, params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


def test_global_rel_bias_matches_jax_and_raises_past_its_table():
    """The window recipe's global blocks: a full-sequence bias table of
    2 * num_tokens - 1 rows; a longer sequence raises, as in JAX."""
    x = np.random.default_rng(1).standard_normal((2, 24, 64)).astype(np.float32)
    jmod = jvit.Attention(num_heads=2, rel_bias_len=32, dtype=jnp.float32)
    params, want = _jax_module(jmod, jnp.asarray(x))
    tmod = vit.Attention(64, 2, True, torch.float32, rel_bias_len=32)
    load_jax_module(tmod, params)
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).numpy(), want, **MODULE_TOL)
        with pytest.raises(ValueError, match="exceeds rel_bias_len"):
            tmod(torch.zeros((1, 33, 64)))
    with pytest.raises(ValueError, match="exceeds rel_bias_len"):
        jmod.apply({"params": params}, jnp.zeros((1, 33, 64)))
    # depth 3: two window blocks and a global one, whose table holds the
    # 32 tokens of 128 px; 256 px gives 64
    model = build_model(port_config(recipe_config("window", depth=3)), device="cpu")
    assert model.blocks[2].attn.rel_bias.shape == (2 * N - 1, 2)
    with pytest.raises(ValueError, match="exceeds rel_bias_len"), torch.no_grad():
        model(torch.zeros((1, 64, 256, 1)))


@pytest.mark.parametrize("n,w,shift", [(32, 12, 0), (32, 12, 6), (128, 12, 6), (30, 7, 3)])
def test_plain_window_attention_matches_jax(n, w, shift):
    """localglobal's windows: unmasked zero padding, an unmasked roll."""
    x = np.random.default_rng(n * w).standard_normal((2, n, 64)).astype(np.float32)
    jmod = jlocalglobal.PlainWindowMHSA(num_heads=2, window_size=w, shift=shift,
                                        dtype=jnp.float32)
    params, want = _jax_module(jmod, jnp.asarray(x))
    tmod = localglobal.PlainWindowMHSA(64, 2, w, torch.float32, shift=shift)
    load_jax_module(tmod, params)
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).numpy(), want, **MODULE_TOL)


@pytest.mark.parametrize("n,g", [(32, 64), (32, 8), (32, 12), (128, 64), (100, 64)])
def test_pooled_global_attention_matches_jax(n, g):
    """Average-pool where g divides N, linear resize where it does not."""
    x = np.random.default_rng(n + g).standard_normal((2, n, 64)).astype(np.float32)
    jmod = jlocalglobal.PooledGlobalMHSA(num_heads=2, g_tokens=g, dtype=jnp.float32)
    params, want = _jax_module(jmod, jnp.asarray(x))
    tmod = localglobal.PooledGlobalMHSA(64, 2, torch.float32, g_tokens=g)
    load_jax_module(tmod, params)
    with torch.no_grad():
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).numpy(), want, **MODULE_TOL)


@pytest.mark.parametrize("n,t", [(32, 12), (12, 32), (100, 64), (7, 7), (5, 1)])
def test_linear_resize_tokens_matches_jax(n, t):
    x = np.random.default_rng(n).standard_normal((2, n, 3)).astype(np.float32)
    want = jlocalglobal.linear_resize_tokens(jnp.asarray(x), t)
    got = localglobal.linear_resize_tokens(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_stem_input_takes_channel_stride_one_from_any_image_view(monkeypatch):
    """The stem hands conv1 a [B, 1, H, W] input whose channel stride is 1
    (channels-last), whatever view the image is: with no input LayerNorm
    (the conformer presets) a numpy image's new axis arrives with stride 0,
    and cuDNN would then write conv1's output NCHW, which the fused kernels
    refuse on the card."""
    from htr_vt_torch.models import stem
    seen = []
    real = stem._conv

    def spy(conv, x, *args):
        seen.append(x.stride())
        return real(conv, x, *args)

    monkeypatch.setattr(stem, "_conv", spy)
    model = build_model(port_config(recipe_config("conformer")), device="cpu")
    image = np.random.default_rng(0).random((2, 64, 128), dtype=np.float32)[..., None]
    for x in (torch.from_numpy(image), torch.from_numpy(np.ascontiguousarray(image))):
        seen.clear()
        with torch.no_grad():
            model(x)
        assert seen[0][1] == 1, seen[0]


# --- dropout, presets, the recipes' entry points ----------------------------
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_dropout_keeps_its_rate_and_scales_by_its_inverse(rate):
    """The rates the recipes fix in code: each element (dropout) or sample
    (drop-path) kept with probability 1 - rate, within 5 standard errors
    over 200k draws, and scaled by exactly 1 / (1 - rate)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.full((200_000, 1), 3.0)
    for y in (layers.dropout(x, rate, True, gen),
              layers.DropPath(rate)(x, train=True, generator=gen)):
        kept = y != 0
        share = kept.float().mean().item()
        assert abs(share - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / x.numel())
        assert torch.equal(y[kept], torch.full_like(y[kept], 3.0) / (1 - rate))
        assert torch.equal(layers.dropout(x, rate, False, gen), x)


def test_presets_are_the_jax_presets():
    from htr_vt_tpu.models import variants as jvariants
    assert VARIANT_PRESETS == jvariants.VARIANT_PRESETS
    for name in VARIANT_PRESETS:
        cfg = dataclasses.replace(port_config(TINY), encoder=name)
        assert dataclasses.asdict(apply_variant_preset(cfg)) == dataclasses.asdict(
            port_config(jvariants.apply_variant_preset(dataclasses.replace(
                TINY, encoder=name))))


@pytest.mark.parametrize("encoder", [
    "window", "macaron", "macaron_2", "localglobal", "lgp", "lgp_svtr", "conformer",
    "squeezeformer"])
def test_every_recipe_builds_through_the_train_cli(encoder):
    """``cli/train.py --encoder X`` parses to the JAX config and builds the
    recipe; the block names are the JAX model's top-level modules."""
    argv = ["SYNTH", "--encoder", encoder, "--embed-dim", "64", "--depth", "2",
            "--num-heads", "2", "--img-size", "128", "64", "--compute-dtype", "float32"]
    cfg = targs.args_to_config(targs.build_parser("t").parse_args(argv))
    model = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    jparams = jax.eval_shape(lambda: jax_build_model(cfg.model).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 1)), train=False))["params"]
    assert set(model.block_names) == set(jparams) - {"stem", "mask_token", "norm", "head"}
    with torch.no_grad():
        out = model(torch.rand((2, 64, 128, 1)))
    assert out.shape == (2, 32, cfg.model.nb_cls) and torch.isfinite(out).all()


@pytest.mark.parametrize("override", [dict(encoder="swin"), dict(encoder="svtr"),
                                      dict(encoder="van"), dict(encoder="van2"),
                                      dict(model_type="encoder_decoder")])
def test_build_model_still_refuses_what_waits(override):
    """The zoo's last models build (their JAX checks live in
    ``test_torch_port_zoo_standalone.py`` and ``test_torch_port_ed.py``),
    at ``quant="int8"`` too, as JAX builds them (int8 reaches only the
    ResNet18 stem and the vit / conformer / squeezeformer linears); nothing
    waits on any of them now: remat builds too (HTRVT and the
    encoder-decoder's trunk wrap their blocks; Swin and SVTR ignore it, as
    JAX's do)."""
    cfg = port_config(jax_preset(dataclasses.replace(TINY, ed_vocab_size=10, **override)))
    assert build_model(cfg, device="cpu") is not None
    assert build_model(dataclasses.replace(cfg, quant="int8"), device="cpu") is not None
    model = build_model(dataclasses.replace(cfg, remat="blocks"), device="cpu")
    assert model.cfg.remat == "blocks"
