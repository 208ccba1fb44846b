"""The PyTorch port's flagship model vs the JAX reference, module by module.

Weights come from a JAX init with every norm and BN state randomised (so
eval BatchNorm is no identity) and cross into the port through
``htr_vt_torch.utils.convert``; inputs are numpy draws from a seed. On the
CPU at a tiny config, in float32 and, for the cast placements of the
flagship's compute dtype, in bfloat16.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import ModelConfig
from htr_vt_tpu.models import layers as jlayers
from htr_vt_tpu.models import stem as jstem
from htr_vt_tpu.models import vit as jvit
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_torch.models import layers as tlayers
from htr_vt_torch.models.htr_vt import HTRVT, build_model
from htr_vt_torch.utils.convert import load_jax_params

TINY = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2,
                   num_heads=2, compute_dtype="float32")
# f32 on both sides, summed in different orders (XLA vs ATen): a few ulps
# per op through convs of fan-in <= 9*64 and 2 attention blocks.
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)
# The logits bar tests/test_reference_variant_parity.py:145 pins.
LOGITS_TOL = dict(rtol=1e-4, atol=2e-4)
BF16 = dataclasses.replace(TINY, compute_dtype="bfloat16")
# bf16 logits vs the JAX bf16 model, max and mean |dlogits|. Measured 0.0345
# and 0.0081: a handful of 1-ulp rounding flips (one conv1 output in 130k
# summed in another order) that cascade through the stem. For scale, JAX
# bf16 vs JAX f32 on these inputs: 0.078 and 0.0135. A misplaced stem
# epilogue cast lands at mean 0.0164; misplaced casts in the ViT blocks
# hide in the cascade noise here and are caught bit for bit by the module
# tests below.
BF16_LOGITS_MAX, BF16_LOGITS_MEAN = 0.05, 0.012
BLOCK_CASES = [(1, 0, (2, 1), True), (2, 0, (2, 2), True), (1, 1, (1, 1), False),
               (3, 1, (1, 1), False)]


def _randomise(tree, rng):
    """BN/LN scale ~ 1 +- 0.2, biases and BN means ~ 0 +- 0.1, BN variances
    in [0.5, 1.5]; every other leaf (kernels, mask token) as initialised."""
    draw = {"scale": lambda s: 1.0 + 0.2 * rng.standard_normal(s),
            "bias": lambda s: 0.1 * rng.standard_normal(s),
            "mean": lambda s: 0.1 * rng.standard_normal(s),
            "var": lambda s: rng.uniform(0.5, 1.5, s)}
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng)
        elif k in draw:
            out[k] = draw[k](v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def tiny_jax_weights(cfg=TINY, seed=0):
    """(params, batch_stats) numpy trees of a JAX ``HTRVT`` at ``cfg``."""
    h, w = cfg.img_size
    v = jax.jit(lambda k: JaxHTRVT(cfg).init(
        k, jnp.zeros((1, h, w, 1)), train=False))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return _randomise(v["params"], rng), _randomise(v["batch_stats"], rng)


def tiny_port_model(params, stats, cfg=TINY) -> HTRVT:
    model = build_model(cfg)
    load_jax_params(model, params, stats)
    return model.eval()


@pytest.fixture(scope="module")
def weights():
    params, stats = tiny_jax_weights()
    return params, stats, tiny_port_model(params, stats)


@pytest.fixture(scope="module")
def weights16(weights):
    params, stats, _ = weights
    return params, stats, tiny_port_model(params, stats, BF16)


def strict_jit(fn):
    """``jax.jit`` that rounds every bfloat16 result to bfloat16, as the
    program says. XLA's CPU backend otherwise allows "excess precision": a
    bf16 conv whose result is cast straight to float32 for the BN epilogue
    keeps its unrounded float32 value, where cuDNN and ATen round."""
    def run(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    return run


@contextlib.contextmanager
def jax_gelu_in_float32():
    """Evaluate the JAX ``Mlp``'s exact GELU in float32, rounded once.

    In bf16 the reference rounds between the five ops of its GELU; the
    port's ``F.gelu`` rounds once, as XLA does by default. With the GELU
    aligned, the rest of an Mlp or a Block is held bit for bit."""
    orig = jlayers.nn.gelu
    jlayers.nn.gelu = lambda x, approximate=True: orig(
        x.astype(jnp.float32), approximate=approximate).astype(x.dtype)
    try:
        yield
    finally:
        jlayers.nn.gelu = orig


def _bf16(x):
    """float32 numpy rounded to bfloat16, as (jax array, torch tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


def test_global_layer_norm_matches_jax():
    x = np.random.default_rng(0).normal(3.0, 2.0, (3, 5, 7, 2)).astype(np.float32)
    want = np.asarray(jlayers.global_layer_norm(jnp.asarray(x)))
    got = tlayers.global_layer_norm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim,grid", [(64, (16, 2)), (768, (16, 8))])
def test_sincos_pos_embed_matches_jax(dim, grid):
    np.testing.assert_array_equal(tlayers.sincos_pos_embed_2d(dim, grid),
                                  jlayers.sincos_pos_embed_2d(dim, grid))


def test_mlp_attention_block_match_jax(weights):
    params, _, model = weights
    x = np.random.default_rng(1).standard_normal((2, 32, 64)).astype(np.float32)
    p = params["block0"]
    f32 = jnp.float32
    cases = [
        (jlayers.Mlp(hidden_dim=256, dtype=f32), p["mlp"], model.blocks[0].mlp),
        (jvit.Attention(num_heads=2, dtype=f32), p["attn"], model.blocks[0].attn),
        (jvit.Block(num_heads=2, dtype=f32), p, model.blocks[0]),
    ]
    for jmod, jparams, tmod in cases:
        want = np.asarray(jax.jit(jmod.apply)({"params": jparams}, jnp.asarray(x)))
        with torch.inference_mode():
            got = tmod(_t(x)).numpy()
        np.testing.assert_allclose(got, want, **MODULE_TOL,
                                   err_msg=type(tmod).__name__)


def _basic_block_case(weights, stage, block, strides, proj, dtype):
    """(JAX apply fn, its variables, the port's block, input x [2,8,12,cin])."""
    params, stats, model = weights
    name = f"stage{stage}_block{block + 1}"
    widths = (16, 32, 64)
    cin = widths[stage - 1] if block else (16, 16, 32)[stage - 1]
    x = np.random.default_rng(2).standard_normal((2, 8, 12, cin)).astype(np.float32)
    jmod = jstem.BasicBlock(widths[stage - 1], strides, use_projection=proj,
                            dtype=dtype)
    tmod = getattr(model.patch_embed, f"layer{stage}")[block]
    assert (tmod.downsample is not None) == proj and tmod.stride == strides
    variables = {"params": params["stem"][name],
                 "batch_stats": stats["stem"][name]}
    return (lambda v, x: jmod.apply(v, x, train=False)), variables, tmod, x


@pytest.mark.parametrize("stage,block,strides,proj", BLOCK_CASES)
def test_basic_block_matches_jax(weights, stage, block, strides, proj):
    fn, variables, tmod, x = _basic_block_case(weights, stage, block, strides,
                                               proj, jnp.float32)
    want = np.asarray(jax.jit(fn)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, **MODULE_TOL)


@pytest.mark.parametrize("stage,block,strides,proj", BLOCK_CASES)
def test_bf16_basic_block_matches_jax_bitwise(weights16, stage, block, strides,
                                              proj):
    """bf16 convs, the float32 BN epilogues and their casts back to bf16."""
    fn, variables, tmod, x = _basic_block_case(weights16, stage, block, strides,
                                               proj, jnp.bfloat16)
    xj, xt = _bf16(x)
    want = np.asarray(strict_jit(fn)(variables, xj).astype(jnp.float32))
    with torch.inference_mode():
        got = tmod(xt.permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got.float()), want)


@pytest.mark.parametrize("module", ["attn", "mlp", "block"])
def test_bf16_vit_modules_match_jax_bitwise(weights16, module):
    """Attention: bf16 qkv, bias added after the rounded product, float32
    logits and softmax, the weights cast to bf16 before ``. v``. Block: the
    float32 LayerNorms and the residual stream in bf16."""
    params, _, model = weights16
    bf = jnp.bfloat16
    jmod, jparams, tmod = {
        "attn": (jvit.Attention(num_heads=2, dtype=bf), params["block0"]["attn"],
                 model.blocks[0].attn),
        "mlp": (jlayers.Mlp(hidden_dim=256, dtype=bf), params["block0"]["mlp"],
                model.blocks[0].mlp),
        "block": (jvit.Block(num_heads=2, dtype=bf), params["block0"],
                  model.blocks[0]),
    }[module]
    xj, xt = _bf16(np.random.default_rng(1).standard_normal((2, 32, 64)))
    with jax_gelu_in_float32():
        want = np.asarray(strict_jit(jmod.apply)({"params": jparams}, xj)
                          .astype(jnp.float32))
    with torch.inference_mode():
        got = tmod(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_resnet18_stem_matches_jax(weights):
    params, stats, model = weights
    x = np.random.default_rng(3).standard_normal((2, 64, 128, 1)).astype(np.float32)
    jmod = jstem.ResNet18Stem(embed_dim=64, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        {"params": params["stem"], "batch_stats": stats["stem"]},
        jnp.asarray(x)))
    with torch.inference_mode():
        got = _nhwc(model.patch_embed(_nchw(x)))
    assert got.shape == (2, 1, 32, 64)
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_htrvt_logits_match_jax(weights):
    params, stats, model = weights
    x = np.random.default_rng(4).random((3, 64, 128, 1), dtype=np.float32)
    want = np.asarray(jax.jit(lambda v, x: JaxHTRVT(TINY).apply(
        v, x, train=False))({"params": params, "batch_stats": stats},
                            jnp.asarray(x)))
    with torch.inference_mode():
        got = model(_t(x)).numpy()
    assert got.shape == (3, 32, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **LOGITS_TOL)


def test_bf16_htrvt_logits_match_jax(weights16):
    params, stats, model = weights16
    x = np.random.default_rng(4).random((3, 64, 128, 1), dtype=np.float32)
    variables = {"params": params, "batch_stats": stats}
    want, want32 = (np.asarray(strict_jit(lambda v, x: JaxHTRVT(cfg).apply(
        v, x, train=False))(variables, jnp.asarray(x))) for cfg in (BF16, TINY))
    with torch.inference_mode():
        got = model(_t(x)).numpy()
    assert got.shape == (3, 32, 8) and got.dtype == np.float32
    err = np.abs(got - want)
    assert err.max() <= BF16_LOGITS_MAX and err.mean() <= BF16_LOGITS_MEAN, \
        (err.max(), err.mean())
    # the bound lies below the bf16-vs-f32 gap, so it sees a dtype error
    assert np.abs(want32 - want).mean() > BF16_LOGITS_MEAN
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_seeded_init_follows_the_jax_schemes():
    cfg = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=192, depth=1,
                      num_heads=2, compute_dtype="float32")
    a = build_model(cfg, generator=torch.Generator().manual_seed(7))
    b = build_model(cfg, generator=torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    # variance_scaling(2, fan_out, normal): std sqrt(2 / (3*3*192))
    w = a.patch_embed.layer3[1].conv2.weight
    assert abs(w.std().item() / np.sqrt(2.0 / (9 * 192)) - 1.0) < 0.02
    # xavier-uniform: bound sqrt(6 / (fan_in + fan_out))
    fc1 = a.blocks[0].mlp.fc1.weight
    assert fc1.abs().max().item() <= np.sqrt(6.0 / (192 + 768))
    assert abs(a.mask_token.std().item() / 0.02 - 1.0) < 0.15
    assert not a.pos_embed.requires_grad and "pos_embed" not in a.state_dict()


@pytest.mark.parametrize("override", [dict(encoder="window"),
                                      dict(model_type="encoder_decoder"),
                                      dict(stem="van"), dict(quant="int8")])
def test_build_model_rejects_unported_recipes(override):
    import dataclasses
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dataclasses.replace(TINY, **override))
