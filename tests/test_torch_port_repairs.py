"""The shapes where the port's kernels once raised and JAX computes, on the
CPU: K2 (``bn_stats``) at a channel count that is not a multiple of 8, the
CTC recursions past 8192 states, K5 at head_dim 384, ``resolve_attn_impl``
at every head_dim, and the TMA-fed stem kernels (K3/K4) at stem widths
that are not multiples of 8, which their wrappers zero-pad.

Each plain twin (the kernel's CPU path) is held against the JAX function:
``bn_stats(interpret=True)``, the JAX CTC scan, and the library Pallas
flash kernel under ``pltpu.force_tpu_interpret_mode()``. The CUDA kernels
themselves are held against the same twins on the card by
tests/test_torch_port_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from htr_vt_tpu import config as jconfig
from htr_vt_tpu.config import ModelConfig
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.optim.sam import make_base_optimizer
from htr_vt_tpu.train.state import TrainState as JaxTrainState
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_tpu.models import vit as jvit
from htr_vt_tpu.ops.bn_stats import bn_stats as jax_bn_stats
from htr_vt_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from htr_vt_torch.models import masking
from htr_vt_torch.models import vit as tvit
from htr_vt_torch.ops import bn_stats as tbn
from htr_vt_torch.ops import ctc as tctc
from htr_vt_torch.ops import ctc_cuda
from htr_vt_torch.ops import flash_attn as fa
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils.convert import load_jax_train_state, model_to_jax_tree
from test_torch_conv_fused import conv_interpret
from test_torch_port_model import port_config, tiny_jax_weights
from test_torch_port_train import BN_STATS_TOL, OPTIM, TRAIN_LOGITS_TOL
from test_torch_port_train import TINY as TRAIN_TINY
from test_torch_port_train import _batch, _keep, _leaves
from test_torch_stem_kernels import STATS_TOL, _pair, pool_interpret

# float32 log-space recursions and sums in other orders (as
# tests/test_torch_port_ctc.py).
CTC_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# K5, as tests/test_torch_flash_attn.py: float32 sums in other orders; bf16
# within one bf16 ulp (or 2^-8 of the largest value) and >= 99% bit-equal.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL, BF16_ATOL_OF_MAX, BF16_MIN_EQUAL = 2.0**-7, 2.0**-8, 0.99
TINY = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=1,
                   num_heads=1, compute_dtype="float32")
# The train tests' tiny model (64x64 px, 16 tokens) at embed_dim 100: stem
# widths 25, 50 and 100, two heads of 50.
TAIL_TINY = dataclasses.replace(TRAIN_TINY, embed_dim=100)


# --- K2 at any C ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 32, 12), (3, 5, 16, 20)])
def test_bn_stats_twin_matches_jax_at_any_channel_count(shape, dtype):
    """C = 12 and 20 (NHWC shapes): the plain twin against JAX's kernel in
    interpret mode, at JAX's own bars."""
    x = np.random.default_rng(shape[3]).standard_normal(shape).astype(np.float32)
    xj, xt = _pair(x, dtype)
    want = jax.jit(lambda x: jax_bn_stats(x, interpret=True))(xj)
    got = tbn.bn_stats(xt)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (shape[3],)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATS_TOL[dtype])


@pytest.mark.parametrize("c,n,want", [
    (192, 128 * 32 * 512, (1, 24, 132)),  # the entry and stage 1: one slice
    (384, 128 * 4 * 256, (2, 24, 66)),    # stage 2: two slices of 192
    (768, 128 * 2 * 128, (3, 32, 44)),    # stage 3: three of 256
    (12, 128 * 32 * 128, (1, 2, 132)),    # a tail group of 4 channels
    (20, 7, (1, 3, 1)),                   # fewer rows than one block's slots
    (4100, 1000, (17, 31, 7))])           # more slices than blocks fill
def test_bn_stats_geometry_is_one_launch_sized_to_the_card(c, n, want):
    """K2's grid on a 132-SM card: slices of at most 32 groups of 8 channels
    that cover C, about one 1024-thread block a SM shared out over them,
    and never more blocks than the rows fill."""
    slices, groups, blocks = tbn.stats_geometry(c, n, 132)
    assert (slices, groups, blocks) == want
    assert groups <= tbn.MAX_SLICE_GROUPS and slices * groups * 8 >= c
    assert (slices - 1) * groups * 8 < c
    assert blocks == 1 or (blocks - 1) * (tbn.THREADS // groups) < n
    assert blocks == 1 or slices * blocks <= tbn.BLOCKS_PER_SM * 132


def test_bn_stats_scratch_is_reused_grown_and_bounded(monkeypatch):
    """K2's scratch: one entry a (device, stream), reused while large enough,
    grown when not, and never more than SCRATCH_STREAMS entries (the least
    recently used goes)."""
    monkeypatch.setattr(tbn, "_SCRATCH", type(tbn._SCRATCH)())
    cpu = torch.device("cpu")
    partial, tickets = tbn._scratch(cpu, 0, 64, 2)
    assert partial.numel() == 64 and tickets.tolist() == [0, 0]
    again = tbn._scratch(cpu, 0, 32, 1)
    assert again[0] is partial and again[1] is tickets
    grown = tbn._scratch(cpu, 0, 128, 3)
    assert grown[0].numel() == 128 and grown[1].numel() == 3
    for stream in range(1, tbn.SCRATCH_STREAMS + 2):
        tbn._scratch(cpu, stream, 8, 1)
    assert len(tbn._SCRATCH) == tbn.SCRATCH_STREAMS
    assert (None, 0) not in tbn._SCRATCH and (None, 1) not in tbn._SCRATCH
    assert (None, tbn.SCRATCH_STREAMS + 1) in tbn._SCRATCH


# --- the CTC recursions past 8192 states ------------------------------------------
@pytest.mark.parametrize("t,c,s", [(128, 80, 9001), (128, 80, 20001), (512, 80, 8193),
                                   (4, 40000, 193)])
def test_recursion_geometry_takes_the_strided_path_past_the_registers(t, c, s):
    """S past MAX_PER_THREAD * 32 * MAX_WARPS = 8192 (or logp rows too wide
    for two panels): the strided path, one block of up to 1024 threads a
    sample and no shared memory; at and below 8192 the register path
    stays."""
    assert ctc_cuda.recursion_geometry(t, c, s) == (ctc_cuda.STRIDED, 0, 0)
    assert ctc_cuda.recursion_geometry(t, 80, 8192)[0] == ctc_cuda.MAX_PER_THREAD


@pytest.mark.parametrize("lmax", [4500, 10000])
def test_long_label_loss_and_gradient_match_jax(lmax):
    """A tiny padded batch with one label of 4500 or 10000 characters (S =
    9001, 20001: the strided path on the card), infeasible in 32 frames,
    beside a short feasible row: the plain loss and the kernels' autograd
    route over the plain recursions against the JAX scan, loss and d
    logits; the long row's loss and gradient are exactly 0."""
    rng = np.random.default_rng(lmax)
    b, t, c = 2, 32, 12
    logits = (2.0 * rng.standard_normal((b, t, c))).astype(np.float32)
    lengths = np.array([lmax, 9], np.int32)
    labels = rng.integers(1, c, size=(b, lmax)).astype(np.int32)
    labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
    jl, jy, jn = map(jnp.asarray, (logits, labels, lengths))
    want = np.asarray(jax_ctc_loss(jl, jy, jn))
    want_grad = np.asarray(jax.grad(lambda x: jax_ctc_loss(x, jy, jn).sum())(jl))
    assert ctc_cuda.recursion_geometry(t, c, 2 * lmax + 1)[0] == ctc_cuda.STRIDED
    ty, tn = torch.from_numpy(labels), torch.from_numpy(lengths)

    def kernel_route(x, y, n):  # ctc_loss_cuda's body on CPU tensors
        z, noskip, valid, start2, endm = ctc_cuda.extended_masks(y, n)
        logp = torch.log_softmax(x, dim=-1).contiguous()
        return tctc.zero_infinity(ctc_cuda.CTCNegLogP.apply(
            logp, z, noskip, valid, start2, endm))

    for loss_fn in (tctc.ctc_loss, kernel_route):
        x = torch.from_numpy(logits).requires_grad_(True)
        loss = loss_fn(x, ty, tn)
        loss.sum().backward()
        assert loss[0].item() == 0.0 == want[0] and loss[1].item() > 0
        np.testing.assert_allclose(loss.detach().numpy(), want, **CTC_TOL)
        assert (x.grad[0] == 0).all()
        np.testing.assert_allclose(x.grad.numpy(), want_grad, **GRAD_TOL)


# --- K5 at head_dim 384 ----------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_twins_match_the_library_kernel_at_head_dim_384(dtype):
    """The plain K5f, K5dkv and K5dq at [1, 1, 256, 384] (embed 2304 over 6
    heads) against the library kernel's forward and ``jax.vjp`` in
    interpret mode."""
    d, n = 384, 256
    jdt = getattr(jnp, dtype)
    rng = np.random.default_rng(d)
    arrays = [np.asarray(jnp.asarray(rng.standard_normal((1, 1, n, d)), jdt)
                         .astype(jnp.float32)) for _ in range(4)]
    with pltpu.force_tpu_interpret_mode():
        q, k, v, do = (jnp.asarray(a, jdt) for a in arrays)
        o, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, sm_scale=d**-0.5), q, k, v)
        want = [np.asarray(x.astype(jnp.float32)) for x in (o, *vjp(do))]
    q, k, v, do = (torch.from_numpy(a.copy()).to(getattr(torch, dtype)) for a in arrays)
    o, l, m = fa.flash_attention_fwd(q, k, v, d**-0.5)
    got = (o, *fa.flash_attention_bwd_reference(q, k, v, o, l, m, do, d**-0.5))
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and tuple(g.shape) == w.shape, name
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **F32_TOL, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL,
                                   atol=BF16_ATOL_OF_MAX * np.abs(w).max(), err_msg=name)
        assert (g == w).mean() >= BF16_MIN_EQUAL, (name, (g == w).mean())


@pytest.mark.parametrize("head_dim", [64, 128, 192, 256, 384, 512, 640, 1024])
@pytest.mark.parametrize("impl,n", [("auto", 512), ("auto", 256), ("auto", 128),
                                    ("flash", 512), ("xla", 512)])
def test_resolve_attn_impl_routes_every_head_dim_as_jax(impl, n, head_dim, monkeypatch):
    """The K5 wrappers take every multiple of 128, so the port routes every
    head_dim as JAX does on a TPU, and whatever ``auto`` sends to flash is
    a head_dim the wrappers take."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")

    def decide(fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except ValueError:
            return "ValueError"

    want = decide(jvit.resolve_attn_impl, impl, n, head_dim, False)
    got = decide(tvit.resolve_attn_impl, impl, n, head_dim, False, on_cuda=True)
    assert got == want
    if got == "flash":
        assert fa.takes_head_dim(head_dim)


# --- the TMA-fed stem kernels at any width -------------------------------------
TAIL_SWITCHES = {"pool_only": dict(pool_impl="pallas"), "conv_only": dict(conv_impl="pallas"),
                 "fully_fused": dict(bn_stats_impl="pallas", pool_impl="pallas",
                                     conv_impl="pallas")}


@pytest.fixture(scope="module")
def tail_weights():
    return tiny_jax_weights(TAIL_TINY, seed=11)


@pytest.mark.parametrize("switches", sorted(TAIL_SWITCHES))
def test_pallas_stem_at_widths_off_multiples_of_8_matches_jax(tail_weights, switches):
    """embed_dim 100 gives stem widths 25, 50 and 100, which K3/K4 take
    through zero-padded copies (``ops/bn_stats.py:pad_channels``): the
    port builds the model and its train forward (injected keep mask) and
    one SAM step (masks A and B) match JAX's, whose pool and stride-1 conv
    kernels run in interpret mode, at the bars of
    tests/test_torch_port_train.py: logits TRAIN_LOGITS_TOL, moved BN
    statistics BN_STATS_TOL, losses and gradient norm rtol 1e-4, BN
    statistics after the step rtol 1e-3 atol 1e-4; parameters and EMA at
    the one-step bars of tests/test_torch_flash_attn.py: Adam's first step
    moves an element by +-lr wherever its gradient exceeds eps, so an
    element whose gradient is float32 noise about zero may land up to 2 lr
    apart: every element within 2 lr (plus 1%), and 99.8% of each leaf's
    within 1% of lr, the key third of each qkv bias (exact gradient zero)
    left out. Measured at this config: 1 to 4 elements of a stem conv
    kernel's 5,000-90,000 flip."""
    params, stats = tail_weights
    cfg = dataclasses.replace(TAIL_TINY, **TAIL_SWITCHES[switches])
    exp = jconfig.ExperimentConfig(model=cfg, optim=OPTIM)
    batch, masks = _batch(6), [_keep(20), _keep(21)]
    calls = []

    def jax_mask(*args, **kwargs):
        calls.append(len(calls))
        return jnp.asarray(masks[(len(calls) - 1) % 2])

    orig = jmasking.build_keep_mask
    jmasking.build_keep_mask = jax_mask
    try:
        with pool_interpret(), conv_interpret():
            want = jax.jit(lambda v, x: JaxHTRVT(cfg).apply(
                v, x, train=True, use_masking=True, mutable=["batch_stats"],
                rngs={"mask": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)}))(
                {"params": params, "batch_stats": stats}, jnp.asarray(batch["image"]))
            tx = make_base_optimizer(OPTIM)
            state = JaxTrainState(
                step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                opt_state=tx.init(params), ema_params=jax.tree.map(jnp.copy, params),
                ema_batch_stats=jax.tree.map(jnp.copy, stats), rng=jax.random.PRNGKey(0))
            state, jax_metrics = jit_train_step(JaxHTRVT(cfg), exp, donate=False)(
                state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        jmasking.build_keep_mask = orig
    assert len(calls) == 3  # the forward -> A; the step's two passes -> B, A

    port = _tail_state(tail_weights, exp)
    logits = port.model(torch.from_numpy(batch["image"]), train=True,
                        keep=torch.from_numpy(masks[0]))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want[0]),
                               **TRAIN_LOGITS_TOL)
    got_stats = _leaves(model_to_jax_tree(port.model)[1])
    for k, w in _leaves(jax.tree.map(np.asarray, want[1]["batch_stats"])).items():
        np.testing.assert_allclose(got_stats[k], w, **BN_STATS_TOL, err_msg=k)

    lr = warmup_cosine_lr(0, max_lr=OPTIM.max_lr, warmup_iters=OPTIM.warmup_iters,
                          total_iters=OPTIM.total_iters, min_lr=OPTIM.min_lr)
    port = _tail_state(tail_weights, exp)
    port_masks = iter([torch.from_numpy(masks[1]), torch.from_numpy(masks[0])])
    orig = masking.build_keep_mask
    masking.build_keep_mask = lambda *a, **k: next(port_masks)
    try:
        got_metrics = train_step(port, batch)
    finally:
        masking.build_keep_mask = orig
    for key in ("loss", "loss_second", "grad_norm"):
        np.testing.assert_allclose(float(got_metrics[key]), float(jax_metrics[key]),
                                   rtol=1e-4, err_msg=key)
    for model, p_tree, s_tree in ((port.model, state.params, state.batch_stats),
                                  (port.ema_model, state.ema_params,
                                   state.ema_batch_stats)):
        got_p, got_s = (_leaves(t) for t in model_to_jax_tree(model))
        want_p = _leaves(jax.tree.map(np.asarray, p_tree))
        assert got_p.keys() == want_p.keys()
        for key, w in want_p.items():
            diff = np.abs(got_p[key] - w)
            assert diff.max() < 2.01 * lr, key
            if key.endswith("attn/qkv/bias"):
                q_b, _, v_b = np.split(diff, 3)
                diff = np.concatenate([q_b, v_b])
            assert (diff < 0.01 * lr).mean() >= 0.998, (key, (diff < 0.01 * lr).mean())
        for k, w in _leaves(jax.tree.map(np.asarray, s_tree)).items():
            np.testing.assert_allclose(got_s[k], w, rtol=1e-3, atol=1e-4, err_msg=k)


def _tail_state(weights, exp):
    """A port TrainState at ``exp`` holding the JAX weights in the model and
    its EMA copy."""
    params, stats = weights
    state = create_train_state(port_config(exp), "cpu", torch.Generator().manual_seed(0))
    load_jax_train_state(state.model, state.ema_model, JaxTrainState(
        step=0, params=params, batch_stats=stats, opt_state=None, ema_params=params,
        ema_batch_stats=stats, rng=None))
    return state


@pytest.mark.parametrize("c", [12, 20, 25])
def test_zero_padded_channels_leave_the_stem_twins_unchanged(c):
    """What the K3/K4 wrappers do at C % 8 != 0, through the plain twins:
    zero channels appended to x and g, zero scale and shift, zero weight
    rows and columns change no real output, and slicing the real channels
    back out gives the unpadded result (y and dx bit for bit; the float32
    sums, where the CPU's vectorised reductions regroup over the wider
    channel axis, at JAX's bar for them, 1e-5)."""
    from htr_vt_torch.ops import conv_fused as cf
    from htr_vt_torch.ops import pool_fused as pf
    cp = tbn.padded_channels(c)
    assert cp % 8 == 0 and 0 < cp - c < 8
    gen = torch.Generator().manual_seed(c)
    x = torch.randn((2, c, 6, 9), generator=gen).bfloat16().contiguous(
        memory_format=torch.channels_last)
    scale, shift = 1 + 0.2 * torch.randn(c, generator=gen), 0.2 * torch.randn(c, generator=gen)
    k = (0.2 * torch.randn((c + 3, c, 3, 3), generator=gen)).bfloat16()
    xp, sp, tp = tbn.pad_channels(x, cp), tbn.pad_terms(scale, cp), tbn.pad_terms(shift, cp)
    assert xp.is_contiguous(memory_format=torch.channels_last) and not xp[:, c:].any()
    assert torch.equal(tbn.take_channels(xp, c), x) and not sp[c:].any()
    g = torch.randn((2, c, 3, 9), generator=gen).bfloat16()  # NCHW, as the step hands it
    gp = tbn.pad_channels(g, cp)
    want, got = (pf.max_pool_bn_relu_reference(x, scale, shift),
                 pf.max_pool_bn_relu_reference(xp, sp, tp))
    assert torch.equal(tbn.take_channels(got, c), want)
    want, got = (pf.pool_bn_relu_bwd_reference(g, x, scale, shift),
                 pf.pool_bn_relu_bwd_reference(gp, xp, sp, tp))
    assert torch.equal(tbn.take_channels(got[0], c), want[0])
    for w, gt in zip(want[1:], got[1:]):
        torch.testing.assert_close(gt[:c], w, rtol=1e-5, atol=1e-5)
        assert not gt[c:].any()
    co, cop = c + 3, tbn.padded_channels(c + 3)
    kp = cf._pad_weight(k, cop, cp)
    assert kp.shape == (cop, cp, 3, 3) and torch.equal(kp[:co, :c], k)
    gc = torch.randn((2, co, 6, 9), generator=gen).bfloat16().contiguous(
        memory_format=torch.channels_last)
    gcp = tbn.pad_channels(gc, cop)
    torch.testing.assert_close(
        tbn.take_channels(cf.conv3x3_bn_relu_reference(xp, kp, sp, tp), co),
        cf.conv3x3_bn_relu_reference(x, k, scale, shift), rtol=0, atol=0)
    want = cf.conv3x3_dgrad_reference(gc, k, x, scale, shift, True)
    got = cf.conv3x3_dgrad_reference(gcp, kp, xp, sp, tp, True)
    torch.testing.assert_close(tbn.take_channels(got[0], c), want[0], rtol=0, atol=0)
    for w, gt in zip(want[1:], got[1:]):
        torch.testing.assert_close(gt[:c], w, rtol=1e-5, atol=1e-5)
        assert not gt[c:].any()
    want = cf.conv3x3_wgrad_reference(x, gc, scale, shift, True)
    got = cf.conv3x3_wgrad_reference(xp, gcp, sp, tp, True)
    torch.testing.assert_close(got[:co, :c], want, rtol=1e-5, atol=1e-5)
    assert not got[co:].any() and not got[:, c:].any()
