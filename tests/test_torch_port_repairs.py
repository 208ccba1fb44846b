"""The shapes where the port's kernels once raised and JAX computes, on the
CPU: K2 (``bn_stats``) at a channel count that is not a multiple of 8, the
CTC recursions past 8192 states, K5 at head_dim 384, ``resolve_attn_impl``
at every head_dim, and the stem widths that ``build_model`` refuses up
front under the TMA-fed stem kernels.

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

from htr_vt_tpu.config import ModelConfig
from htr_vt_tpu.models import vit as jvit
from htr_vt_tpu.ops.bn_stats import bn_stats as jax_bn_stats
from htr_vt_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from htr_vt_torch.models import vit as tvit
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import bn_stats as tbn
from htr_vt_torch.ops import ctc as tctc
from htr_vt_torch.ops import ctc_cuda
from htr_vt_torch.ops import flash_attn as fa
from test_torch_port_model import port_config
from test_torch_stem_kernels import STATS_TOL, _pair

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


# --- the TMA-fed stem kernels' widths ----------------------------------------------
@pytest.mark.parametrize("switches", [dict(pool_impl="pallas"), dict(conv_impl="pallas"),
                                      dict(bn_stats_impl="pallas", pool_impl="pallas",
                                           conv_impl="pallas")])
def test_build_model_refuses_a_pallas_stem_whose_widths_are_not_multiples_of_8(switches):
    """embed_dim 100 gives stem widths 25, 50, 100: the K3/K4 kernels read
    channels-last rows through TMA (16-byte strides, C % 8 == 0), so
    build_model refuses the config up front, naming the limit and the
    ROADMAP item. K2 alone takes any C, and embed 96 (24, 48, 96) builds."""
    cfg = port_config(dataclasses.replace(TINY, embed_dim=100, **switches))
    with pytest.raises(ValueError, match="multiple of 8.*ROADMAP.md queue 3, fault 3"):
        build_model(cfg, device="cpu")
    build_model(port_config(dataclasses.replace(TINY, embed_dim=100,
                                                bn_stats_impl="pallas")), device="cpu")
    build_model(port_config(dataclasses.replace(TINY, embed_dim=96, **switches)),
                device="cpu")
