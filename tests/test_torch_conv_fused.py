"""The conv3x3 + BN-prologue trio (K4f/K4d/K4w) and the fully fused stem vs
the JAX reference, on the CPU at tiny sizes.

``ops/conv_fused.py``'s wrappers run their plain versions here, because
their tensors lie on the CPU; the JAX side runs ``conv3x3_bn_relu`` with
its Pallas kernels (``_conv_kernel``, and through ``jax.vjp``
``_dgrad_kernel``/``_wgrad_kernel``) in interpret mode. The CUDA kernels
are held against these plain versions on the card by
tests/test_torch_port_cuda.py. Inputs are numpy draws from a seed; NHWC
arrays go to JAX and their NCHW channels-last views to the port.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htr_vt_tpu import config as jconfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models import stem as jstem
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.ops import conv_fused as jcf
from htr_vt_tpu.train.state import TrainState as JaxTrainState
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_torch.models import masking
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import conv_fused as cf
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils.convert import model_to_jax_tree
from test_torch_port_model import port_config, strict_jit
from test_torch_port_train import (BN_STATS_TOL, OPTIM, STEPS, TINY,
                                   TRAIN_LOGITS_TOL, _batch, _check_trajectory,
                                   _keep, _leaves)
from test_torch_stem_kernels import (FUSED, _nhwc, _np, _pair, _port_state,
                                     pool_interpret)

# JAX's own bar for the kernel trio (tests/test_conv_fused.py:28-29, 48-50).
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = jnp.bfloat16
FULLY_FUSED = dict(FUSED, conv_impl="pallas")


@contextlib.contextmanager
def conv_interpret():
    """Run the JAX stem's stride-1 convs through the Pallas kernels in
    interpret mode. The stem calls ``conv3x3_bn_relu`` without
    ``interpret=`` (``stem.py:265``); on the hardware a strided call takes
    ``_xla_reference``, so only stride (1, 1) gets ``interpret=True``."""
    orig = jstem.conv3x3_bn_relu

    def patched(x, kernel, scale=None, shift=None, *, strides=(1, 1), relu=True,
                interpret=False):
        return orig(x, kernel, scale, shift, strides=strides, relu=relu,
                    interpret=tuple(strides) == (1, 1))

    jstem.conv3x3_bn_relu = patched
    try:
        yield
    finally:
        jstem.conv3x3_bn_relu = orig


# --- the three plain versions against the interpret-mode Pallas kernels ------
def _conv_case(seed, dtype="float32", case="prologue", B=4, H=8, W=32, ci=16, co=24):
    """The shapes of tests/test_conv_fused.py:16-21 and a cotangent.

    ``padding``: scale 1, shift 3 (tests/test_conv_fused.py:79-89), so a pad
    applied before the prologue would leak relu(3) into the borders.
    ``ties``: x, scale and shift on coarse grids, so x * scale + shift is
    exact and often exactly 0, where the strict dgrad mask gives 0.
    ``exact`` (bf16): x and k on the bf16 grid and scale on a grid of 1/64,
    so every product is exact in float32 (XLA's CPU backend contracts the
    prologue's multiply-add into an FMA)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, ci)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, ci, co))).astype(np.float32)
    s = rng.standard_normal(ci).astype(np.float32)
    t = rng.standard_normal(ci).astype(np.float32)
    g = rng.standard_normal((B, H, W, co)).astype(np.float32)
    if case == "padding":
        s, t = np.ones(ci, np.float32), np.full(ci, 3.0, np.float32)
    elif case == "ties":
        x = np.round(x * 2) / 2
        s, t = np.round(s * 2) / 2, np.round(t * 4) / 4
    if dtype == "bfloat16":
        x, k = _np(jnp.asarray(x, BF16)), _np(jnp.asarray(k, BF16))
        s = (np.round(s * 64) / 64).astype(np.float32)
    xj, xt = _pair(x, dtype)
    gj, gt = _pair(g, dtype)
    kj = jnp.asarray(k, getattr(jnp, dtype))
    kt = torch.from_numpy(k).permute(3, 2, 0, 1).to(getattr(torch, dtype))
    return ((xj, kj, jnp.asarray(s), jnp.asarray(t), gj),
            (xt, kt, torch.from_numpy(s), torch.from_numpy(t), gt))


def _jax_conv(prologue):
    """y and the vjp (dx, dk, dscale, dshift) of the interpret-mode kernels."""
    def run(x, k, s, t, g):
        if prologue:
            y, vjp = jax.vjp(lambda *a: jcf.conv3x3_bn_relu(*a, interpret=True),
                             x, k, s, t)
            return (y,) + vjp(g)
        y, vjp = jax.vjp(lambda *a: jcf.conv3x3_bn_relu(*a, interpret=True), x, k)
        return (y,) + vjp(g) + (None, None)
    return run


def _port_conv(xt, kt, st, tt, gt, prologue):
    s, t = (st, tt) if prologue else (None, None)
    y = cf.conv3x3_bn_relu_reference(xt, kt, s, t)
    dx, ds, dt = cf.conv3x3_dgrad_reference(gt, kt, xt, s, t, prologue)
    dk = cf.conv3x3_wgrad_reference(xt, gt, s, t, prologue)
    return y, dx, dk, ds, dt


def _hwio(dk):
    return dk.detach().permute(2, 3, 1, 0).float().numpy()


def _assert_sum_close(got, want, mag):
    """A float32 sum over all B*H*W pixels (dk, dscale, dshift): JAX's
    interpret-mode kernels carry it across the batch grid and themselves
    lie up to 1.3e-4 from the float64 sum of dk at these shapes (measured),
    so on top of JAX's bar an element may differ by 1e-6 of the sum of its
    terms' magnitudes."""
    err = np.abs(got - want)
    bound = TOL["atol"] + TOL["rtol"] * np.abs(want) + 1e-6 * mag
    assert (err <= bound).all(), (err - bound).max()


def _check_sums(got, want, xt, kt, gt, st, tt, prologue):
    """dk, and with the prologue dscale and dshift (``want``: JAX's three,
    numpy), by ``_assert_sum_close``."""
    xn = cf._prologue(xt, st, tt) if prologue else xt
    mag = torch.nn.grad.conv2d_weight(xn.double().abs(), tuple(kt.shape),
                                      gt.double().abs(), padding=1)
    _assert_sum_close(_hwio(got[2]), want[0], _hwio(mag))
    if prologue:
        xf = xt.float()
        da = torch.nn.grad.conv2d_input(tuple(xt.shape), kt.float(), gt.float(),
                                        padding=1)
        da = torch.where(xf * st.view(1, -1, 1, 1) + tt.view(1, -1, 1, 1) > 0, da, 0.0)
        for g, w, term in ((got[3], want[1], da * xf), (got[4], want[2], da)):
            _assert_sum_close(g.numpy(), w, term.abs().sum((0, 2, 3)).numpy())


CASES = {"prologue": True, "plain": False, "padding": True, "ties": True}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_the_interpret_mode_kernels(case):
    """float32 at JAX's bar: y from ``_conv_kernel``, dx from
    ``_dgrad_kernel``; its dscale/dshift and dk from ``_wgrad_kernel`` with
    the sums' allowance of ``_assert_sum_close``. Without the prologue the
    port's dscale/dshift are zeros and JAX's have no counterpart."""
    prologue = CASES[case]
    (xj, kj, sj, tj, gj), (xt, kt, st, tt, gt) = _conv_case(10, case=case)
    y, dx, dk, ds, dt = jax.jit(_jax_conv(prologue))(xj, kj, sj, tj, gj)
    got = _port_conv(xt, kt, st, tt, gt, prologue)
    np.testing.assert_allclose(_nhwc(got[0]), _np(y), **TOL)
    np.testing.assert_allclose(_nhwc(got[1]), _np(dx), **TOL)
    if prologue:
        _check_sums(got, (_np(dk), _np(ds), _np(dt)), xt, kt, gt, st, tt, True)
    else:
        _check_sums(got, (_np(dk),), xt, kt, gt, st, tt, False)
        assert not got[3].any() and not got[4].any()


def test_tie_case_holds_the_strict_mask():
    """At exact zeros of x * scale + shift the dgrad mask is strict, as in
    ``_dgrad_kernel``: the port matches JAX there, and autograd through the
    reference (``conv_impl="auto"``, ``torch.maximum``'s half gradient)
    does not."""
    (xj, kj, sj, tj, gj), (xt, kt, st, tt, gt) = _conv_case(10, case="ties")
    a = xt.float() * st.view(1, -1, 1, 1) + tt.view(1, -1, 1, 1)
    ties = a == 0
    assert ties.sum() > 50
    dxj = jax.jit(_jax_conv(True))(xj, kj, sj, tj, gj)[1]
    dx = cf.conv3x3_dgrad_reference(gt, kt, xt, st, tt, True)[0]
    tie = ties.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(_nhwc(dx)[tie], 0.0)
    np.testing.assert_array_equal(_np(dxj)[tie], 0.0)
    xa = xt.clone().requires_grad_(True)
    cf.conv3x3_bn_relu_reference(xa, kt, st, tt).backward(gt)
    assert (_nhwc(xa.grad)[tie] != 0).mean() > 0.9


@pytest.mark.parametrize("prologue", [True, False])
def test_bf16_plain_versions_match_the_interpret_mode_kernels(prologue):
    """bf16 with exact products (JAX under strict_jit): every output is a
    float32 sum in another order rounded once to bf16, so y, dx and dk
    (cast to the weight dtype, ``conv_fused.py:534``) agree within one bf16
    rounding (rtol 2^-7) of the float32 sums' noise; dscale/dshift are
    float32 at JAX's bar scaled by the sums' magnitude."""
    (xj, kj, sj, tj, gj), (xt, kt, st, tt, gt) = _conv_case(11, "bfloat16")
    y, dx, dk, ds, dt = strict_jit(_jax_conv(prologue))(xj, kj, sj, tj, gj)
    got = _port_conv(xt, kt, st, tt, gt, prologue)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    bf = dict(rtol=2.0**-7, atol=1e-3)
    np.testing.assert_allclose(_nhwc(got[0]), _np(y), **bf)
    np.testing.assert_allclose(_nhwc(got[1]), _np(dx), **bf)
    np.testing.assert_allclose(_hwio(got[2].to(torch.bfloat16)), _np(dk), **bf)
    if prologue:
        np.testing.assert_allclose(got[3].numpy(), _np(ds), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got[4].numpy(), _np(dt), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("prologue", [True, False])
def test_conv_autograd_function_is_the_plain_versions(prologue):
    """``conv3x3_bn_relu`` (``ConvBNReLU``) on CPU tensors: the forward and
    the dgrad/wgrad plain versions, bit for bit; no scale means no scale or
    shift gradient."""
    _, (xt, kt, st, tt, gt) = _conv_case(12, case="ties")
    s, t = (st, tt) if prologue else (None, None)
    args = [a.clone().requires_grad_(True) if a is not None else None
            for a in (xt, kt, s, t)]
    y = cf.conv3x3_bn_relu(*args)
    assert torch.equal(y, cf.conv3x3_bn_relu_reference(xt, kt, s, t))
    y.backward(gt)
    dx, ds, dt = cf.conv3x3_dgrad_reference(gt, kt, xt, s, t, prologue)
    assert torch.equal(args[0].grad, dx)
    assert torch.equal(args[1].grad, cf.conv3x3_wgrad_reference(xt, gt, s, t, prologue))
    if prologue:
        assert torch.equal(args[2].grad, ds) and torch.equal(args[3].grad, dt)


def test_strided_conv_takes_the_stock_route():
    _, (xt, kt, st, tt, _) = _conv_case(13)
    before = cf.ConvBNReLU.grad_copies
    for s, t in ((None, None), (st, tt)):
        got = cf.conv3x3_bn_relu(xt, kt, s, t, stride=(2, 1))
        want = cf.conv3x3_bn_relu_reference(xt, kt, s, t, stride=(2, 1))
        assert got.shape == (4, 24, 4, 32) and torch.equal(got, want)
    assert cf.ConvBNReLU.grad_copies == before


def test_cpu_conv_wrappers_count_no_launch():
    _, (xt, kt, st, tt, gt) = _conv_case(14)
    counters = (cf.conv3x3_bn_relu_fwd, cf.conv3x3_bn_relu_dgrad,
                cf.conv3x3_bn_relu_wgrad)
    before = [f.launches for f in counters]
    x = xt.clone().requires_grad_(True)
    cf.conv3x3_bn_relu(x, kt, st, tt).backward(gt)
    cf.conv3x3_bn_relu_dgrad(gt, kt, xt)
    assert [f.launches for f in counters] == before


def test_conv_wrappers_reject_a_device_without_a_kernel():
    x = torch.zeros((1, 8, 4, 4), device="meta")
    k = torch.zeros((8, 8, 3, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cf.conv3x3_bn_relu_fwd(x, k)
    with pytest.raises(ValueError, match="no kernel"):
        cf.conv3x3_bn_relu_dgrad(x, k, x)
    with pytest.raises(ValueError, match="no kernel"):
        cf.conv3x3_bn_relu_wgrad(x, x)


# --- the fully fused stem in the whole model ---------------------------------
@pytest.fixture(scope="module")
def weights():
    from test_torch_port_model import tiny_jax_weights
    return tiny_jax_weights(TINY, seed=5)


SWITCHES = {"fully_fused": FULLY_FUSED, "conv_only": dict(conv_impl="pallas")}


@pytest.mark.parametrize("switches", sorted(SWITCHES))
def test_train_forward_with_the_conv_kernels_matches_jax(weights, switches,
                                                        monkeypatch):
    """conv_impl="pallas" forces the folded dataflow in train
    (``stem.py:192-194``), alone (float32 statistics, flax BN at the entry)
    and with the fused stem's two switches: train-mode logits with an injected
    keep mask, the moved BN statistics, and the eval forward after."""
    params, stats = weights
    cfg = dataclasses.replace(TINY, **SWITCHES[switches])
    batch, keep = _batch(6), _keep(7)
    monkeypatch.setattr(jmasking, "build_keep_mask",
                        lambda *a, **k: jnp.asarray(keep))
    with pool_interpret(), conv_interpret():
        want, mutated = jax.jit(lambda v, x: JaxHTRVT(cfg).apply(
            v, x, train=True, use_masking=True, mutable=["batch_stats"],
            rngs={"mask": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)}))(
            {"params": params, "batch_stats": stats}, jnp.asarray(batch["image"]))
        want_eval = jax.jit(lambda v, x: JaxHTRVT(cfg).apply(v, x, train=False))(
            {"params": params, "batch_stats": mutated["batch_stats"]},
            jnp.asarray(batch["image"]))
    model = _port_state(weights, jconfig.ExperimentConfig(model=cfg, optim=OPTIM)).model
    got = model(torch.from_numpy(batch["image"]), train=True,
                keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TRAIN_LOGITS_TOL)
    got_stats = _leaves(model_to_jax_tree(model)[1])
    want_stats = _leaves(jax.tree.map(np.asarray, mutated["batch_stats"]))
    assert got_stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, **BN_STATS_TOL, err_msg=k)
    with torch.inference_mode():
        got_eval = model(torch.from_numpy(batch["image"]))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=2e-4)


@pytest.fixture(scope="module")
def fully_fused_trajectories(weights):
    """Three SAM steps of the fully fused stem on both stacks, from the same
    weights, batches and keep masks (pass 1 and pass 2 of every step get
    masks A and B), as tests/test_torch_stem_kernels.py does for the fused
    switches."""
    params, stats = weights
    cfg = dataclasses.replace(TINY, **FULLY_FUSED)
    exp = jconfig.ExperimentConfig(model=cfg, optim=OPTIM)
    masks = [_keep(20), _keep(21)]
    batches = [_batch(30 + i) for i in range(STEPS)]
    calls = []

    def jax_mask(*args, **kwargs):
        calls.append(len(calls))
        return jnp.asarray(masks[(len(calls) - 1) % 2])

    orig = jmasking.build_keep_mask
    jmasking.build_keep_mask = jax_mask
    try:
        from htr_vt_tpu.optim.sam import make_base_optimizer
        tx = make_base_optimizer(OPTIM)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params),
            ema_params=jax.tree.map(jnp.copy, params),
            ema_batch_stats=jax.tree.map(jnp.copy, stats),
            rng=jax.random.PRNGKey(0))
        with pool_interpret(), conv_interpret():
            step_fn = jit_train_step(JaxHTRVT(cfg), exp, donate=False)
            jax_metrics = []
            for b in batches:
                state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
                jax_metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jmasking.build_keep_mask = orig
    assert len(calls) == 2  # traced once: pass 1 -> A, pass 2 -> B

    port = _port_state(weights, exp)
    port_masks = iter([torch.from_numpy(masks[i % 2]) for i in range(2 * STEPS)])
    orig = masking.build_keep_mask
    masking.build_keep_mask = lambda *a, **k: next(port_masks)
    try:
        port_metrics = [{k: float(v) for k, v in train_step(port, b).items()}
                        for b in batches]
    finally:
        masking.build_keep_mask = orig
    return jax_metrics, state, port_metrics, port


def test_fully_fused_train_steps_match_jax(fully_fused_trajectories):
    """Losses, gradient norms, parameters, BN statistics and EMA after three
    steps, under the bars of tests/test_torch_port_train.py."""
    jax_metrics, state, port_metrics, port = fully_fused_trajectories
    assert port.step == STEPS
    for key in ("loss", "loss_second", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in port_metrics],
                                   [m[key] for m in jax_metrics], rtol=1e-4,
                                   err_msg=key)
    for model, p_tree, s_tree, what in (
            (port.model, state.params, state.batch_stats, "params"),
            (port.ema_model, state.ema_params, state.ema_batch_stats, "EMA")):
        got_p, got_s = model_to_jax_tree(model)
        _check_trajectory(_leaves(got_p), _leaves(jax.tree.map(np.asarray, p_tree)),
                          what)
        want_s = _leaves(jax.tree.map(np.asarray, s_tree))
        for k, g in _leaves(got_s).items():
            np.testing.assert_allclose(g, want_s[k], rtol=1e-3, atol=1e-4, err_msg=k)


def test_build_model_routes_the_stride_1_convs_through_the_kernels(monkeypatch):
    """``build_model`` accepts conv_impl="pallas" and sends exactly the 9
    stride-1 3x3 convs of a forward to the forward kernel's wrapper: the 6
    conv2s with the prologue and the 3 second-block conv1s without. The
    strided conv1s, the projections and the entry conv stay stock."""
    model = build_model(port_config(dataclasses.replace(TINY, **FULLY_FUSED)),
                        device="cpu")
    assert all(block.conv_impl == "pallas" for layer in
               (model.patch_embed.layer1, model.patch_embed.layer2,
                model.patch_embed.layer3) for block in layer)
    calls = []
    orig = cf.conv3x3_bn_relu_fwd

    def counting(x, weight, scale=None, shift=None):
        calls.append(scale is not None)
        return orig(x, weight, scale, shift)

    monkeypatch.setattr(cf, "conv3x3_bn_relu_fwd", counting)
    image = torch.from_numpy(_batch(8)["image"])
    with torch.inference_mode():
        model(image)
    assert (len(calls), sum(calls)) == (9, 6)
    calls.clear()
    model(image, train=True, keep=torch.from_numpy(_keep(9))).sum().backward()
    assert (len(calls), sum(calls)) == (9, 6)
