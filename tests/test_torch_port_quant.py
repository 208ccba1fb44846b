"""int8 (A8W8) serving of the port against the JAX package on the CPU: the
quantizers, the int8 conv and dot (``htr_vt_torch/ops/quant.py``; on the
CPU the conv is Q1's plain twin), the stage-1 pad, calibration, and the
tiny models of ``tests/test_quant.py`` with JAX-initialised weights
carried over by ``utils/convert.py``. The int8-paying stem, the padded
flagship and the CLIs are in ``tests/test_torch_port_quant_stem.py``; Q1
itself is held to its twin on the card (``tests/test_torch_port_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu.config import MaskConfig, ModelConfig
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.ops import quant as jq
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import quant as q8
from htr_vt_torch.utils.convert import load_jax_params, model_quant_stats, model_to_jax_tree
from test_torch_port_model import port_config

TINY = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2, num_heads=2,
                   compute_dtype="float32", masking=MaskConfig(mode="none"))
# JAX's own bars (tests/test_quant.py): calibration is the float model to
# 2e-5; int8 logits within a relative L2 of 0.15 of float.
CALIB_TOL = dict(rtol=2e-5, atol=2e-5)
INT8_REL = 0.15
QUICK_CALIB_REL = 0.05
# The port's int8 logits against JAX's at the tiny float32 models, relative
# L2 (and every frame's argmax equal). Both run the same integer products,
# but the float32 around them (LayerNorm, attention, the GELU, XLA's rsqrt in
# the folded BatchNorms) sums and rounds in other orders, so an activation a
# few ulps from a rounding half takes the other int8 code on one side.
# Measured, dynamic / static: ViT exact GELU 5.1e-3 / 8.8e-4, quick GELU
# 5.5e-3 / 1.2e-6, conformer 5.9e-3 / 8.5e-3, squeezeformer 3.7e-7 / 3.7e-7.
# The bar is 2.3x the largest.
PORT_REL = 2e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


# --- quantizers --------------------------------------------------------------------
def test_quantizers_match_jax_bit_for_bit():
    """Per-tensor dynamic, per-channel (a conv's HWIO kernel against the
    port's OIHW weight, a linear's [K, N] kernel against its [N, K]) and
    static: the same codes and scales, ties rounding half to even."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 33)).astype(np.float32)
    x[0, 0, :4] = [0.5, 1.5, -2.5, 127.0]  # ties at a unit scale: below
    q, s = q8.quantize_tensor(_t(x))
    jq_, js = jq._quantize_tensor(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    assert s.item() == float(js)
    amax = np.float32(127.0)  # scale 1: the ties stay ties
    q, s = q8.quantize_static(_t(x[:1]), torch.tensor(amax))
    jq_, js = jq._quantize_static(jnp.asarray(x[:1]), jnp.asarray(amax))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    assert q[0, 0, :3].tolist() == [0, 2, -2] and s.item() == float(js)
    k = rng.standard_normal((3, 3, 24, 40)).astype(np.float32)
    k[..., 5] = 0.0  # a zero channel takes the floor scale
    q, s = q8.quantize_channels(_t(k).permute(3, 2, 0, 1))
    jq_, js = jq._quantize_channels(jnp.asarray(k))
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    wq_t, sw = q8.linear_weight(_t(k[0, 0]).t().contiguous())
    jq_, js = jq._quantize_channels(jnp.asarray(k[0, 0]))
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(js))


def test_s32_to_bf16_rounds_through_float32_as_xla():
    """Accumulators past 2^24 reach bf16 through float32, rounding twice, in
    XLA's convert and in the port's dequant: 2^26 + 2^18 + 1 rounds to
    2^26 + 2^18 in float32, a bf16 tie that goes to even (2^26), where one
    rounding would give 2^26 + 2^19."""
    acc = np.array([2**26 + 2**18 + 1, 2**26 + 2**18 - 1, -(2**25 + 2**17 + 1),
                    2**24 + 3], np.int32)
    want = np.asarray(jnp.asarray(acc).astype(jnp.bfloat16).astype(jnp.float32))
    got = q8.dequantize(_t(acc).view(1, -1, 1, 1), torch.ones(4), torch.bfloat16)
    np.testing.assert_array_equal(got.float().flatten().numpy(), want)
    assert want[0] == 2**26 and want[2] == -(2**25)


# --- the int8 conv and dot ----------------------------------------------------------
GEOMETRIES = [(3, (1, 1), 1), (3, (2, 1), 1), (3, (2, 2), 1), (1, (2, 1), 0), (1, (2, 2), 0)]


@pytest.mark.parametrize("k,stride,pad", GEOMETRIES,
                         ids=["3x3s1", "3x3s21", "3x3s22", "1x1s21", "1x1s22"])
def test_conv_int8_matches_jax(k, stride, pad):
    """At every geometry of the int8 stem, on small channels: the s32
    accumulator of an s8 input bit-equal to XLA's s8 conv, and
    ``conv_int8_bf16`` (pre-quantized input), ``conv_int8`` (static) and
    the dynamic path bit-equal to JAX's."""
    rng = np.random.default_rng(k + stride[0] + 3 * stride[1])
    xq = rng.integers(-127, 128, (2, 7, 9, 16)).astype(np.int8)
    x = rng.standard_normal((2, 7, 9, 16)).astype(np.float32)
    w = (rng.standard_normal((k, k, 16, 24)) * 0.1).astype(np.float32)
    sx = np.float32(0.0173)
    padding = ((pad, pad), (pad, pad))
    wt = _t(w).permute(3, 2, 0, 1)
    wq, _, sw = q8.conv_weight(wt)
    jwq, jsw = jq._quantize_channels(jnp.asarray(w))
    acc = jax.lax.conv_general_dilated(jnp.asarray(xq), jwq, stride, padding,
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    got = q8.conv_s8_reference(_nchw(xq), wq, stride, pad)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(acc))
    cases = [
        (q8.conv_int8_bf16(None, wt, stride, pad, xq=_nchw(xq), sx=torch.tensor(sx)),
         jq.conv_int8_bf16(None, jnp.asarray(w), stride, padding, xq=jnp.asarray(xq),
                           sx=jnp.asarray(sx))),
        (q8.conv_int8(_nchw(x), wt, stride, pad, amax=torch.tensor(2.5)),
         jq.conv_int8(jnp.asarray(x), jnp.asarray(w), stride, padding,
                      amax=jnp.asarray(np.float32(2.5)))),
        (q8.conv_int8(_nchw(x), wt, stride, pad),
         jq.conv_int8(jnp.asarray(x), jnp.asarray(w), stride, padding))]
    for got, want in cases:
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("dequant", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dot_int8_matches_jax(dequant):
    """``dot_int8`` of a linear's float32 weight, static and dynamic: the
    s32 product of ``torch._int_mm`` and the dequantized output bit-equal
    to JAX's."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 10, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.1).astype(np.float32)
    jdt = jnp.float32 if dequant == torch.float32 else jnp.bfloat16
    wq_t, sw = q8.linear_weight(_t(w).t().contiguous())
    xq, _ = q8.quantize_tensor(_t(x))
    jxq, _ = jq._quantize_tensor(jnp.asarray(x))
    jwq, _ = jq._quantize_channels(jnp.asarray(w))
    want_acc = jax.lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    got_acc = q8.int_mm(xq.reshape(-1, 48), wq_t).reshape(3, 10, 40)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    for amax in (None, np.float32(1.75)):
        got = q8.dot_int8(_t(x), wq_t, sw, None if amax is None else torch.tensor(amax),
                          dequant)
        want = jq.dot_int8(jnp.asarray(x), jnp.asarray(w),
                           None if amax is None else jnp.asarray(amax), jdt)
        assert got.dtype == dequant
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_pad_stage1_tree_matches_jax_leaf_for_leaf():
    """The 192 -> 256 pad of a flagship tree, in the port's state_dict and
    through JAX's ``pad_stage1_tree`` on the converted tree: every leaf
    equal; the padded state_dict loads strictly into the int8 model; a
    second pad changes nothing; ``serving_arrays`` pads only where
    ``_stage1_pad_applies`` (the flagship, not embed 64 or 1024)."""
    from htr_vt_tpu.models.htr_vt import _stage1_pad_applies
    flag = port_config(ModelConfig(nb_cls=8, img_size=(64, 64), depth=1, quant="int8"))
    model = build_model(dataclasses.replace(flag, quant="none"), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    padded = q8.serving_arrays(flag, sd)
    assert padded["patch_embed.layer1.0.conv1.weight"].shape == (256, 192, 3, 3)
    assert padded["patch_embed.layer2.0.conv1.weight"].shape == (384, 256, 3, 3)
    params, stats = model_to_jax_tree(model)
    jp, js = jq.pad_stage1_tree(params, stats, 256)
    qmodel = build_model(flag, device="cpu")
    qmodel.load_state_dict(padded, strict=True)
    got_p, got_s = model_to_jax_tree(qmodel)
    for got, want in ((got_p, jp), (got_s, js)):
        flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_got:
            np.testing.assert_array_equal(leaf, np.asarray(flat_want[path]), err_msg=str(path))
    again = q8.pad_stage1_tree(padded, 256)
    assert all(torch.equal(again[k], v) for k, v in padded.items())
    for cfg in (flag, dataclasses.replace(flag, embed_dim=64),
                dataclasses.replace(flag, embed_dim=1024),
                dataclasses.replace(flag, quant="none"),
                dataclasses.replace(flag, quant_stage1_pad=0)):
        assert q8.stage1_pad_applies(cfg) == _stage1_pad_applies(cfg)
    assert q8.serving_arrays(dataclasses.replace(flag, embed_dim=64), sd) is sd


# --- the tiny models -----------------------------------------------------------------
def _jax_vars(cfg, img, seed=0):
    model = JaxHTRVT(cfg)
    key = jax.random.PRNGKey(seed)
    v = model.init({"params": key, "mask": key, "dropout": key}, jnp.asarray(img),
                   train=False)
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = float(np.asarray(v))
    return out


def _check_model(cfg, img, variables):
    """Float, dynamic, calibrate and static int8 against JAX on one set of
    weights; returns the port's int8 model (calibrated)."""
    jf, jqm = JaxHTRVT(dataclasses.replace(cfg, quant="none")), JaxHTRVT(cfg)
    x = jnp.asarray(img)
    yf = np.asarray(jax.jit(lambda v, x: jf.apply(v, x, train=False))(variables, x))
    run = jax.jit(lambda v, x: jqm.apply(v, x, train=False))
    yd = np.asarray(run(variables, x))
    ycal, mut = jax.jit(lambda v, x: jqm.apply(v, x, train=False,
                                               mutable=["quant_stats"]))(variables, x)
    stats = jax.tree.map(np.asarray, mut["quant_stats"])
    ys = np.asarray(run({**variables, "quant_stats": stats}, x))
    model = build_model(port_config(cfg), device="cpu")
    load_jax_params(model, variables["params"], variables["batch_stats"])
    xt = _t(img)
    with torch.inference_mode():
        got_d = model(xt).numpy()
        with q8.calibrating():
            got_cal = model(xt).numpy()
        got_s = model(xt).numpy()
    if cfg.quant_gelu == "exact":  # calibration is float (quick GELU aside)
        np.testing.assert_allclose(ycal, yf, **CALIB_TOL)
    else:
        assert _rel(ycal, yf) < QUICK_CALIB_REL
    np.testing.assert_allclose(got_cal, ycal, **CALIB_TOL)
    got_stats, want_stats = _flat(model_quant_stats(model)), _flat(stats)
    assert got_stats.keys() == want_stats.keys()
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k], v, rtol=1e-5, err_msg=k)
    for got, want in ((got_d, yd), (got_s, ys)):
        assert _rel(want, yf) < INT8_REL and _rel(got, yf) < INT8_REL
        assert not np.allclose(got, yf)  # int8 really ran
        assert _rel(got, want) < PORT_REL, _rel(got, want)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the port's abs-maxes through the JAX tree and back give its bits; a
    # port model given JAX's collection runs the static path near JAX's
    for tree, want, exact in ((model_quant_stats(model), got_s, True), (stats, ys, False)):
        other = build_model(port_config(cfg), device="cpu")
        load_jax_params(other, variables["params"], variables["batch_stats"], tree)
        with torch.inference_mode():
            got = other(xt).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(got, want) < PORT_REL
    return model


@pytest.mark.parametrize("gelu", ["exact", "quick"])
def test_tiny_vit_int8_matches_jax(gelu):
    """``tests/test_quant.py``'s tiny ViT (embed 64, depth 2, float32; at
    these widths only the linears are int8): dynamic, calibrate and static
    against JAX's, with exact and quick GELU; the calibrated abs-maxes as
    JAX's ``quant_stats`` leaf for leaf and back."""
    cfg = dataclasses.replace(TINY, quant="int8", quant_gelu=gelu)
    img = np.random.default_rng(5).random((2, 64, 128, 1), dtype=np.float32)
    model = _check_model(cfg, img, _jax_vars(TINY, img))
    assert len(q8.quant_sites(model)) == 4 * TINY.depth


def test_int8_train_mode_is_the_float_model():
    """The training trace of an int8 config is the float model's
    (``htr_vt.py:119-123``): train-mode logits and parameter gradients equal
    the float model's bit for bit on the same weights, calibrated or not."""
    cfg = dataclasses.replace(TINY, quant="int8")
    fmodel = build_model(port_config(TINY), device="cpu",
                         generator=torch.Generator().manual_seed(1))
    qmodel = build_model(port_config(cfg), device="cpu")
    qmodel.load_state_dict(fmodel.state_dict(), strict=True)
    img = _t(np.random.default_rng(6).random((2, 64, 128, 1), dtype=np.float32))
    q8.calibrate_quant_stats(qmodel, [img], 1)
    grads = []
    for m in (fmodel, qmodel):
        m.zero_grad()
        out = m(img, train=True)
        (out.square().mean()).backward()
        grads.append((out.detach(), [p.grad for p in m.parameters()]))
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)  # None: the mask token


@pytest.mark.parametrize("encoder", ["conformer", "squeezeformer"])
def test_tiny_conformer_family_int8_matches_jax(encoder):
    """The conformer family int8 (``tests/test_quant.py``): attention,
    FFN and ConvModule pointwise linears int8, the depthwise conv float;
    dynamic, calibrate and static against JAX's."""
    from htr_vt_tpu.models.variants import apply_variant_preset
    base = apply_variant_preset(dataclasses.replace(TINY, encoder=encoder))
    cfg = dataclasses.replace(base, quant="int8", quant_gelu="exact")
    img = np.random.default_rng(11).random((2, 64, 128, 1), dtype=np.float32)
    model = _check_model(cfg, img, _jax_vars(base, img))
    assert len(q8.quant_sites(model)) == 8 * TINY.depth


def test_calibrate_quant_stats_running_max_and_truncation():
    """``calibrate_quant_stats`` takes the running abs-max over its batches
    (order-independent, above a single batch's), honours ``n_batches`` and
    starts from unset sites (``tests/test_quant.py``)."""
    cfg = port_config(dataclasses.replace(TINY, depth=1, quant="int8"))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    small = np.random.default_rng(7).random((2, 64, 128, 1), dtype=np.float32) * 0.1
    big = small * 10.0

    def leaves(stats):
        return np.array([float(v) for v in stats.values()])

    s_small = leaves(q8.calibrate_quant_stats(model, [small], 1))
    s_both = leaves(q8.calibrate_quant_stats(model, [small, big], 2))
    s_rev = leaves(q8.calibrate_quant_stats(model, [big, small], 2))
    assert (s_both >= s_small).all() and (s_both > s_small).any()
    np.testing.assert_array_equal(s_both, s_rev)
    np.testing.assert_array_equal(leaves(q8.calibrate_quant_stats(model, [small, big], 1)),
                                  s_small)
    q8.clear_quant_stats(model)
    assert q8.quant_stats(model) == {}
