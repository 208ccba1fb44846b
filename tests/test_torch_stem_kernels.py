"""The stem kernels' plain versions and the fused-stem configuration vs the
JAX reference, on the CPU at tiny sizes; and the port's independence from
the JAX package.

K2 (``ops/bn_stats.py``) and K3f/K3b (``ops/pool_fused.py``) run their
plain versions here, because their tensors lie on the CPU; the JAX side
runs its Pallas kernels in interpret mode. The CUDA kernels themselves are
held against these plain versions on the card by
tests/test_torch_port_cuda.py. Inputs are numpy draws from a seed; NHWC
arrays go to JAX and their NCHW channels-last views to the port.
"""

import ast
import contextlib
import copy
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import htr_vt_tpu.ops.pool_fused as jpf
from htr_vt_tpu import config as jconfig
from htr_vt_tpu.data import lists as jlists
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models import stem as jstem
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.ops.bn_stats import bn_stats as jax_bn_stats
from htr_vt_tpu.text import converter as jconverter
from htr_vt_tpu.text import metrics as jmetrics
from htr_vt_tpu.train.state import TrainState as JaxTrainState
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_tpu.utils import torch_convert as jtorch_convert
from htr_vt_torch import config as tconfig
from htr_vt_torch.data import lists as tlists
from htr_vt_torch.models import masking
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.models.stem import BatchNorm
from htr_vt_torch.ops import pool_fused as pf
from htr_vt_torch.ops.bn_stats import BNStats, bn_stats
from htr_vt_torch.text import converter as tconverter
from htr_vt_torch.text import metrics as tmetrics
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils import torch_convert as ttorch_convert
from htr_vt_torch.utils.convert import load_jax_train_state, model_to_jax_tree
from test_torch_port_model import BF16 as BF16_CFG
from test_torch_port_model import (BLOCK_CASES, _bf16, port_config, strict_jit,
                                   tiny_jax_weights, tiny_port_model)
from test_torch_port_train import (BN_STATS_TOL, OPTIM, STEPS, TINY,
                                   TRAIN_LOGITS_TOL, _batch, _check_trajectory,
                                   _keep, _leaves)

REPO = Path(__file__).resolve().parent.parent
BF16 = jnp.bfloat16
# K2: JAX's own bars (tests/test_bn_stats.py:21-25, 30-36): float32 sums in
# another order; atol for near-zero channel sums.
STATS_TOL = {"float32": dict(rtol=1e-5, atol=5e-3),
             "bfloat16": dict(rtol=1e-5, atol=1e-5)}
# K3 dscale/dshift: JAX's bar (tests/test_pool_fused.py:57-59).
POOL_RED_TOL = dict(rtol=1e-5, atol=1e-5)
# The JAX pool backward walks W in chunks of 128 windows (pool_fused.py:87)
# and the two columns at each seam take a read-modify-write from both
# chunks: their gradient is rounded in two parts there and in one here.
POOL_CHUNK = 128
FUSED = dict(bn_stats_impl="pallas", pool_impl="pallas")


def _pair(x, dtype):
    """numpy NHWC float32 -> (JAX array, the port's NCHW channels-last view)
    holding the same values in ``dtype``."""
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
    return xj, xt.to(getattr(torch, dtype)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@contextlib.contextmanager
def pool_interpret():
    """Run the JAX stem's Pallas pool kernels in interpret mode (the stem
    calls ``max_pool_bn_relu`` without ``interpret=``), as
    tests/test_pool_fused.py:94-121 does."""
    orig = jpf.pl.pallas_call
    jpf.pl.pallas_call = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    jpf._partitioned.cache_clear()
    try:
        yield
    finally:
        jpf.pl.pallas_call = orig
        jpf._partitioned.cache_clear()


# --- K2: per-channel sum and sum of squares ----------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 32, 16), (2, 16, 64, 24), (3, 1, 128, 48)])
def test_bn_stats_twin_matches_jax(shape, dtype):
    """The shapes of tests/test_bn_stats.py:17."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    want = jax.jit(lambda x: jax_bn_stats(x, interpret=True))(xj)
    got = bn_stats(xt)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (shape[3],)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATS_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_stats_gradient_matches_jax_grad(dtype):
    """``g_sum + 2 x g_sumsq`` in float32, cast to x's dtype. bf16: bit for
    bit (JAX under strict_jit). float32: XLA's CPU backend contracts the
    multiply-add into an FMA, one rounding the eager twin makes apart, so
    rtol 1e-6 there."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8, 32, 16)).astype(np.float32)
    cs, cq = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    xj, xt = _pair(x, dtype)

    def loss(x):
        s, q = jax_bn_stats(x, interpret=True)
        return jnp.sum(s * cs) + jnp.sum(q * cq)

    want = _np(strict_jit(jax.grad(loss))(xj))
    xt.requires_grad_(True)
    s, q = BNStats.apply(xt)
    ((s * torch.from_numpy(cs)).sum() + (q * torch.from_numpy(cq)).sum()).backward()
    assert xt.grad.dtype == xt.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_nhwc(xt.grad), want)
    else:
        np.testing.assert_allclose(_nhwc(xt.grad), want, rtol=1e-6, atol=1e-6)


# --- K3f/K3b: BN-apply + ReLU + max-pool and its backward --------------------
def _pool_case(seed, dtype, B=4, H=8, W=32, C=16, ties=False, exact=True):
    """The grid of tests/test_pool_fused.py:16-22 and a cotangent. With
    ``exact``, x on the bf16 grid and scale on a grid of 1/64, so that
    ``x * scale`` is exact in float32: XLA's CPU backend contracts the BN's
    multiply-add into an FMA, which then rounds as the port's multiply and
    add do."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2  # coarse grid: many window ties, exact zeros
    s = rng.standard_normal(C).astype(np.float32)
    t = rng.standard_normal(C).astype(np.float32)
    if ties:  # and exact zeros of x * scale + shift, the ReLU's ties
        s, t = np.round(s * 2) / 2, np.round(t * 2) / 2
    if exact:
        x = _np(jnp.asarray(x, BF16))
        s = (np.round(s * 64) / 64).astype(np.float32)
    g = rng.standard_normal((B, H // 2, W, C)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    gj, gt = _pair(g, dtype)
    return (xj, jnp.asarray(s), jnp.asarray(t), gj), (xt, torch.from_numpy(s),
                                                      torch.from_numpy(t), gt)


def _jax_pool(x, s, t, g):
    y, vjp = jax.vjp(lambda *a: jpf.max_pool_bn_relu(*a, interpret=True), x, s, t)
    return (y,) + vjp(g)


def _seams(w):
    """The input columns two chunks of the JAX pool backward share."""
    cols = np.zeros(w, bool)
    for q0 in range(POOL_CHUNK, w, POOL_CHUNK):
        cols[q0 - 1:q0 + 1] = True
    return cols


POOL_CASES = {"ties_off": dict(ties=False), "ties_on": dict(ties=True),
              "w300": dict(B=2, W=300, ties=True)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_twins_match_jax(case, dtype):
    """Forward: bit for bit (exact products, ``_pool_case``). dx: bit for
    bit under strict_jit, except at the JAX kernel's W-chunk seams, where
    JAX rounds two partial gradients and the port one whole: there within
    one ulp of the dtype at the largest |dx|. dscale/dshift: JAX's bar; in
    bf16 at W=300 plus one bf16 rounding of each seam element's gradient
    (JAX sums the two bf16 partials, the port the bf16 total)."""
    kw = POOL_CASES[case]
    (xj, sj, tj, gj), (xt, st, tt, gt) = _pool_case(1, dtype, **kw)
    y, dxj, dsj, dtj = strict_jit(_jax_pool)(xj, sj, tj, gj)
    got_y = pf.max_pool_bn_relu_reference(xt, st, tt)
    assert got_y.dtype == xt.dtype
    np.testing.assert_array_equal(_nhwc(got_y), _np(y))

    dx, ds, dt = pf.pool_bn_relu_bwd_reference(gt, xt, st, tt)
    got, want = _nhwc(dx), _np(dxj)
    seam = _seams(xt.shape[3])
    np.testing.assert_array_equal(got[:, :, ~seam], want[:, :, ~seam])
    eps = float(jnp.finfo(getattr(jnp, dtype)).eps)
    np.testing.assert_allclose(got[:, :, seam], want[:, :, seam], rtol=0,
                               atol=eps * np.abs(want).max())
    daf = _nhwc(pf.routed_grad_reference(gt, xt, st, tt))
    xf = _nhwc(xt)
    for got_r, want_r, term in ((ds, dsj, daf * xf), (dt, dtj, daf)):
        bound = 0.0
        if dtype == "bfloat16":
            bound = 2.0 ** -8 * np.abs(term[:, :, seam]).sum((0, 1, 2))
        want_r = np.asarray(want_r).ravel()
        err = np.abs(got_r.numpy() - want_r)
        assert (err <= bound + POOL_RED_TOL["atol"]
                + POOL_RED_TOL["rtol"] * np.abs(want_r)).all(), err.max()


@pytest.mark.parametrize("ties", [False, True])
def test_pool_twins_match_jax_on_general_float32_inputs(ties):
    """Without the exact products, XLA's FMA and the port's two roundings
    can give a_pre one float32 rounding apart: y, dx, dscale and dshift
    within JAX's own bars (tests/test_pool_fused.py:28-30, 57-59)."""
    (xj, sj, tj, gj), (xt, st, tt, gt) = _pool_case(2, "float32", ties=ties,
                                                    exact=False)
    want = strict_jit(_jax_pool)(xj, sj, tj, gj)
    got = (pf.max_pool_bn_relu_reference(xt, st, tt),
           *pf.pool_bn_relu_bwd_reference(gt, xt, st, tt))
    for g, w, tol in zip(got, want, (1e-6, 1e-5, 1e-5, 1e-5)):
        g = _nhwc(g) if g.dim() == 4 else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w).reshape(g.shape), rtol=tol,
                                   atol=tol)


def test_pool_autograd_function_is_the_twins():
    """``max_pool_bn_relu`` (``PoolBNReLU``) on CPU tensors: the forward
    twin, and the backward twin for x, scale and shift."""
    _, (xt, st, tt, gt) = _pool_case(3, "bfloat16", ties=True)
    args = [a.clone().requires_grad_(True) for a in (xt, st, tt)]
    y = pf.max_pool_bn_relu(*args)
    assert torch.equal(y, pf.max_pool_bn_relu_reference(xt, st, tt))
    y.backward(gt)
    for got, want in zip((a.grad for a in args),
                         pf.pool_bn_relu_bwd_reference(gt, xt, st, tt)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_autograd_takes_an_nchw_gradient_without_a_copy(dtype):
    """The stem hands ``PoolBNReLU`` a contiguous NCHW gradient (the strided
    projection's backward writes NCHW): it gives the grads of a
    channels-last one and counts no copy."""
    _, (xt, st, tt, gt) = _pool_case(5, dtype, ties=True)
    g_nchw = gt.contiguous()
    assert not g_nchw.is_contiguous(memory_format=torch.channels_last)
    assert pf.nchw_grad_ok(g_nchw) and not pf.nchw_grad_ok(gt)
    grads = []
    before = pf.PoolBNReLU.grad_copies
    for g in (gt, g_nchw):
        args = [a.clone().requires_grad_(True) for a in (xt, st, tt)]
        pf.max_pool_bn_relu(*args).backward(g)
        grads.append([a.grad for a in args])
    assert pf.PoolBNReLU.grad_copies == before
    for got, want in zip(*grads):
        assert torch.equal(got, want)


# --- FoldedBatchNorm in train mode -------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats_impl", ["pallas", "xla"])
def test_folded_batch_norm_train_matches_jax(stats_impl, dtype):
    """``BatchNorm.fold`` with batch statistics (JAX's ``FoldedBatchNorm``,
    ``stem.py:117-143``): scale, shift and the moved running statistics,
    with the sums from the K2 twin or from float32 means."""
    rng = np.random.default_rng(6)
    c = 16
    x = (1.5 * rng.standard_normal((4, 8, 12, c)) + 0.3).astype(np.float32)
    gamma = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    xj, xt = _pair(x, dtype)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": mean, "var": var}}
    jmod = jstem.FoldedBatchNorm(stats_impl=stats_impl)
    (s, t), mutated = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, xj)
    bn = BatchNorm(c)
    with torch.no_grad():
        for name, v in (("weight", gamma), ("bias", beta), ("running_mean", mean),
                        ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    got_s, got_t = bn.fold(xt, stats_impl=stats_impl)
    for got, want in ((got_s, s), (got_t, t),
                      (bn.running_mean, mutated["batch_stats"]["mean"]),
                      (bn.running_var, mutated["batch_stats"]["var"])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **BN_STATS_TOL)


@pytest.fixture(scope="module")
def weights16():
    params, stats = tiny_jax_weights(BF16_CFG)
    return params, stats, tiny_port_model(params, stats, BF16_CFG)


@pytest.mark.parametrize("stage,block,strides,proj", BLOCK_CASES)
def test_bf16_folded_train_basic_block_matches_jax(weights16, stage, block,
                                                   strides, proj):
    """The folded train dataflow's casts in bf16 (bn_stats_impl="pallas"):
    bf16 convs, the prologue cast after the float32 BN-apply and ReLU, one
    cast after the float32 epilogue. The batch statistics are float32 sums
    in another order, so an element may round one bf16 ulp apart (measured:
    99.8-100% of the elements equal); the plain dataflow's casts leave
    14-19% of them unequal."""
    params, stats, model = weights16
    name = f"stage{stage}_block{block + 1}"
    cin = (16, 32, 64)[stage - 1] if block else (16, 16, 32)[stage - 1]
    x = np.random.default_rng(2).standard_normal((4, 8, 12, cin)).astype(np.float32)
    jmod = jstem.BasicBlock((16, 32, 64)[stage - 1], strides, use_projection=proj,
                            dtype=BF16, bn_stats_impl="pallas")
    variables = {"params": params["stem"][name],
                 "batch_stats": stats["stem"][name]}
    xj, xt = _bf16(x)
    want, mutated = strict_jit(lambda v, x: jmod.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, xj)
    want = _np(want)
    tmod = copy.deepcopy(getattr(model.patch_embed, f"layer{stage}")[block])
    tmod.bn_stats_impl = "pallas"
    with torch.no_grad():
        got = tmod(xt.permute(0, 3, 1, 2), train=True)
    assert got.dtype == torch.bfloat16
    got = _nhwc(got)
    assert (got == want).mean() >= 0.99, (got == want).mean()
    np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=2.0**-6)
    sd = tmod.state_dict()
    for k, w in _leaves(jax.tree.map(np.asarray, mutated["batch_stats"])).items():
        bn, stat = k.split("/")
        port_bn = {"bn1": "bn1", "bn2": "bn2", "proj_bn": "downsample.1"}[bn]
        port_stat = {"mean": "running_mean", "var": "running_var"}[stat]
        np.testing.assert_allclose(sd[f"{port_bn}.{port_stat}"].numpy(), w,
                                   **BN_STATS_TOL, err_msg=k)


# --- the whole model ---------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    """Tiny JAX weights (the stem switches do not change the tree)."""
    return tiny_jax_weights(TINY, seed=5)


def _port_state(weights, cfg):
    params, stats = weights
    state = create_train_state(port_config(cfg), "cpu",
                               torch.Generator().manual_seed(0))
    jax_like = JaxTrainState(step=0, params=params, batch_stats=stats,
                             opt_state=None, ema_params=params,
                             ema_batch_stats=stats, rng=None)
    load_jax_train_state(state.model, state.ema_model, jax_like)
    return state


STEM_SWITCHES = {"fused": FUSED, "pool_only": dict(pool_impl="pallas"),
                 "stats_only": dict(bn_stats_impl="pallas"),
                 "folded_stock_stats": dict(conv_dataflow="folded")}


@pytest.mark.parametrize("switches", sorted(STEM_SWITCHES))
def test_train_forward_with_stem_kernels_matches_jax(weights, switches,
                                                     monkeypatch):
    """The three entry branches (``stem.py:408-426``) and the dataflow rule
    (``stem.py:192-194``: bn_stats_impl="pallas" forces ``folded``,
    pool_impl="pallas" alone does not; conv_dataflow="folded" takes it with
    the stock statistics): train-mode logits with an injected keep mask,
    the moved BN statistics, and the eval forward after."""
    params, stats = weights
    cfg = dataclasses.replace(TINY, **STEM_SWITCHES[switches])
    batch, keep = _batch(6), _keep(7)
    monkeypatch.setattr(jmasking, "build_keep_mask",
                        lambda *a, **k: jnp.asarray(keep))
    variables = {"params": params, "batch_stats": stats}
    with pool_interpret():
        want, mutated = jax.jit(lambda v, x: JaxHTRVT(cfg).apply(
            v, x, train=True, use_masking=True, mutable=["batch_stats"],
            rngs={"mask": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(1)}))(
            variables, jnp.asarray(batch["image"]))
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
def fused_trajectories(weights):
    """Three SAM steps with both stem kernels on, on both stacks, from the
    same weights, batches and keep masks (pass 1 and pass 2 of every step
    get masks A and B), as tests/test_torch_port_train.py does for the stock
    stem."""
    params, stats = weights
    cfg = dataclasses.replace(TINY, **FUSED)
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
        with pool_interpret():
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


def test_fused_train_steps_match_jax(fused_trajectories):
    """Losses, gradient norms, parameters, BN statistics and EMA after three
    steps, under the bars of tests/test_torch_port_train.py."""
    jax_metrics, state, port_metrics, port = fused_trajectories
    assert port.step == STEPS
    for key in ("loss", "loss_second", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in port_metrics],
                                   [m[key] for m in jax_metrics], rtol=1e-4,
                                   err_msg=key)
    got_p, got_s = model_to_jax_tree(port.model)
    _check_trajectory(_leaves(got_p), _leaves(jax.tree.map(np.asarray, state.params)),
                      "params")
    want_s = _leaves(jax.tree.map(np.asarray, state.batch_stats))
    for k, g in _leaves(got_s).items():
        np.testing.assert_allclose(g, want_s[k], rtol=1e-3, atol=1e-4, err_msg=k)
    ema_p, ema_s = model_to_jax_tree(port.ema_model)
    _check_trajectory(_leaves(ema_p),
                      _leaves(jax.tree.map(np.asarray, state.ema_params)), "EMA")
    want_s = _leaves(jax.tree.map(np.asarray, state.ema_batch_stats))
    for k, g in _leaves(ema_s).items():
        np.testing.assert_allclose(g, want_s[k], rtol=1e-3, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_logits_with_the_pool_kernel_equal_the_stock_path(weights, dtype):
    """In eval, pool_impl="pallas" (the K3f twin over the running
    statistics) gives the stock path's logits bit for bit."""
    params, stats = weights
    cfg = dataclasses.replace(TINY, compute_dtype=dtype)
    models = []
    for impl in ("auto", "pallas"):
        m = build_model(port_config(dataclasses.replace(cfg, pool_impl=impl)),
                        device="cpu")
        load_jax_train_state(m, m, JaxTrainState(
            step=0, params=params, batch_stats=stats, opt_state=None,
            ema_params=params, ema_batch_stats=stats, rng=None))
        models.append(m)
    image = torch.from_numpy(_batch(9)["image"])
    with torch.inference_mode():
        stock, fused = (m(image) for m in models)
    assert torch.equal(stock, fused)


# --- the port stands alone ---------------------------------------------------
def _port_sources():
    return sorted((REPO / "htr_vt_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_the_jax_package():
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in ("htr_vt_tpu", "jax", "flax", "optax",
                                             "orbax")]
    assert not found, found


def test_port_imports_cv2_and_pil_only_inside_functions():
    """The card's machine has neither: a module that imports cv2 or PIL
    outside a function (at module level, or in a class body) would not
    import there."""
    found = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), str(path))
        inside = set()
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inside.update(id(n) for n in ast.walk(fn))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in ("cv2", "PIL") and id(node) not in inside]
    assert not found, found


def test_config_copy_matches_the_jax_config():
    for cls in ("ModelConfig", "MaskConfig", "OptimConfig", "ExperimentConfig"):
        assert dataclasses.asdict(getattr(tconfig, cls)()) == \
            dataclasses.asdict(getattr(jconfig, cls)()), cls
    for name in ("IAM", "READ", "LAM", "SYNTH"):
        assert dataclasses.asdict(tconfig.dataset_preset(name)) == \
            dataclasses.asdict(jconfig.dataset_preset(name)), name


def _random_texts(rng, n, alphabet):
    return ["".join(rng.choice(list(alphabet), rng.integers(0, 12)))
            for _ in range(n)]


def test_converter_copy_matches_the_jax_converter():
    rng = np.random.default_rng(0)
    chars = list("abcdef ghij")
    texts = _random_texts(rng, 20, chars)
    t, j = tconverter.CTCLabelConverter(chars), jconverter.CTCLabelConverter(chars)
    assert t.num_classes == j.num_classes
    for got, want in zip(t.encode(texts), j.encode(texts)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t.encode_padded(texts, 12), j.encode_padded(texts, 12)):
        np.testing.assert_array_equal(got, want)
    ids = rng.integers(0, len(chars) + 1, (6, 20)).astype(np.int32)
    assert t.decode_batch(ids) == j.decode_batch(ids)
    flat, lengths = j.encode(texts)
    assert t.decode(flat, lengths) == j.decode(flat, lengths)


def test_metrics_copy_matches_the_jax_metrics():
    rng = np.random.default_rng(1)
    alphabet = "abc de,."
    preds, refs = _random_texts(rng, 40, alphabet), _random_texts(rng, 40, alphabet)
    assert tmetrics.cer_wer(preds, refs) == jmetrics.cer_wer(preds, refs)
    for p, r in zip(preds[:10], refs[:10]):
        assert tmetrics.per_sample_cer_wer(p, r) == jmetrics.per_sample_cer_wer(p, r)


def test_torch_convert_copy_round_trips_like_the_jax_one(weights):
    params, stats = weights
    got = ttorch_convert.tree_to_reference_state_dict(params, stats)
    want = jtorch_convert.tree_to_reference_state_dict(params, stats)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    *back_t, unused_t = ttorch_convert.reference_state_dict_to_tree(got)
    *back_j, unused_j = jtorch_convert.reference_state_dict_to_tree(want)
    assert unused_t == unused_j
    for got_tree, want_tree in zip(back_t, back_j):
        got_l, want_l = _leaves(got_tree), _leaves(want_tree)
        assert got_l.keys() == want_l.keys()
        for k in want_l:
            np.testing.assert_array_equal(got_l[k], want_l[k], err_msg=k)


def test_list_reader_copy_matches_the_jax_one(tmp_path):
    root = tmp_path / "lines"
    root.mkdir()
    for name, text in (("a.png", "hello  world"), ("b.png", "Zebra\n"),
                       ("c.png", "x" * 30)):
        (root / name).write_bytes(b"")
        (root / name).with_suffix(".txt").write_text(text)
    (tmp_path / "train.ln").write_text("a.png\nb.png\nc.png\n")
    args = (str(tmp_path / "train.ln"), str(root) + "/")
    got = tlists.LineIndex.from_list_file(*args, max_label_len=20)
    want = jlists.LineIndex.from_list_file(*args, max_label_len=20)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_image_loader_copy_matches_the_jax_one(tmp_path):
    from PIL import Image

    from htr_vt_tpu.data import image as jimage
    from htr_vt_torch.data import image as timage
    rng = np.random.default_rng(3)
    for i, shape in enumerate(((40, 150), (90, 700), (64, 512))):
        path = str(tmp_path / f"line{i}.png")
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(path)
        np.testing.assert_array_equal(timage.load_line_image(path, 512, 64),
                                      jimage.load_line_image(path, 512, 64))


# --- build_model's switches and device ---------------------------------------
@pytest.mark.parametrize("switch,value", [
    ("conv_impl", "cuda"), ("pool_impl", "triton"), ("bn_stats_impl", "fast"),
    ("conv_dataflow", "fused")])
def test_build_model_rejects_unknown_stem_switches(switch, value):
    with pytest.raises(ValueError, match=switch):
        build_model(port_config(dataclasses.replace(TINY, **{switch: value})),
                    device="cpu")


def test_build_model_targets_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(port_config(TINY))
    model = build_model(port_config(dataclasses.replace(TINY, **FUSED)), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    stem = model.patch_embed
    assert (stem.pool_impl, stem.bn_stats_impl) == ("pallas", "pallas")
    assert stem.layer1[0].bn_stats_impl == "pallas"


# --- the wrappers' device routing --------------------------------------------
def test_cpu_wrappers_count_no_launch():
    _, (xt, st, tt, gt) = _pool_case(4, "float32")
    counts = lambda: (bn_stats.launches, pf.pool_bn_relu_fwd.launches,  # noqa: E731
                      pf.pool_bn_relu_bwd.launches)
    before = counts()
    bn_stats(xt)
    pf.pool_bn_relu_fwd(xt, st, tt)
    pf.pool_bn_relu_bwd(gt, xt, st, tt)
    x = xt.clone().requires_grad_(True)
    s, q = BNStats.apply(x)
    (s.sum() + q.sum() + pf.max_pool_bn_relu(x, st, tt).sum()).backward()
    assert counts() == before


def test_stem_wrappers_reject_a_device_without_a_kernel():
    x = torch.zeros((1, 8, 4, 4), device="meta")
    v = torch.zeros((8,), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bn_stats(x)
    with pytest.raises(ValueError, match="no kernel"):
        pf.pool_bn_relu_fwd(x, v, v)
    with pytest.raises(ValueError, match="no kernel"):
        pf.pool_bn_relu_bwd(torch.zeros((1, 8, 2, 4), device="meta"), x, v, v)
