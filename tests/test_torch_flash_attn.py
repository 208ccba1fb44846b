"""The port's flash attention (K5) and the wide-width path vs the JAX
package, on the CPU.

The library Pallas kernel (``jax.experimental.pallas.ops.tpu.flash_attention``)
runs here in TPU interpret mode; the port's wrappers run their plain
versions on CPU tensors. JAX is put on its flash path by patching
``htr_vt_tpu.models.vit.resolve_attn_impl`` inside a test (to decide as on
a TPU), not ``jax.default_backend``, which would also reroute JAX's CTC.
Also here: ``resolve_attn_impl``'s decision table, ``attn_impl`` in
``build_model``, one model at every width, the PIL-free bucket router and
``transcribe_buckets``.
"""

import contextlib
import dataclasses
import functools
import importlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from htr_vt_tpu.config import ExperimentConfig, MaskConfig, ModelConfig, OptimConfig
from htr_vt_tpu.data import image as jimage
from htr_vt_tpu.models import layers as jlayers
from htr_vt_tpu.models import masking as jmasking
from htr_vt_tpu.models import vit as jvit
from htr_vt_tpu.models.htr_vt import HTRVT as JaxHTRVT
from htr_vt_tpu.optim.sam import make_base_optimizer
from htr_vt_tpu.train.state import TrainState as JaxTrainState
from htr_vt_tpu.train.step import jit_train_step
from htr_vt_torch.cli import serve
from htr_vt_torch.models import masking
from htr_vt_torch.models import vit as tvit
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import flash_attn as fa
from htr_vt_torch.optim.schedule import warmup_cosine_lr
from htr_vt_torch.text.converter import CTCLabelConverter
from htr_vt_torch.train.state import create_train_state
from htr_vt_torch.train.step import train_step
from htr_vt_torch.utils.convert import load_jax_train_state, model_to_jax_tree
from test_torch_port_model import (LOGITS_TOL, port_config, tiny_jax_weights,
                                   tiny_port_model)
from test_torch_port_train import _leaves

SCALE = 128**-0.5
HEAD_DIMS = [128, 256]  # the head dims the K5 kernels take (768 / 6, 1536 / 6)
# float32: the plain version and the interpret-mode kernel do the same
# float32 operations, summed in other orders (measured <= 3.6e-7).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: both round p (or ds) to bf16 before each product and the result to
# bf16 once. A float32 difference of a few ulps can carry a value across a
# bf16 rounding boundary, so an element may differ by one bf16 ulp (2^-7 of
# its value), or, where the terms cancel, by a flipped term's ulp: 2^-8 of
# the tensor's largest value. Measured: 99.3-99.9% of the elements
# bit-equal, the rest one ulp apart.
BF16_RTOL, BF16_ATOL_OF_MAX, BF16_MIN_EQUAL = 2.0**-7, 2.0**-8, 0.99
# Tiny wide configs: embed 128 over 1 head gives head_dim 128, embed 256
# over 1 head head_dim 256, the two the kernels take; 64 x 1024 px is N =
# 256 tokens, 64 x 2048 px N = 512.
TINY = ModelConfig(nb_cls=8, img_size=(64, 512), embed_dim=128, depth=2,
                   num_heads=1, compute_dtype="float32", attn_impl="flash")
TINY_256 = dataclasses.replace(TINY, embed_dim=256)
TRAIN = dataclasses.replace(TINY, img_size=(64, 1024), masking=MaskConfig(
    mode="span", ratio=0.4, max_span_length=4))
OPTIM = OptimConfig(max_lr=1e-3, warmup_iters=2, total_iters=12)
B, LMAX = 2, 12


@contextlib.contextmanager
def jax_on_the_flash_path():
    """JAX's attention decides as on a TPU (so 'auto' and 'flash' take the
    library kernel at N >= 256), and the kernel runs in interpret mode.
    Yields the list of decisions made."""
    orig = jvit.resolve_attn_impl
    decisions = []

    def on_tpu(*args, **kwargs):
        with mock.patch.object(jax, "default_backend", lambda: "tpu"):
            decisions.append(orig(*args, **kwargs))
        return decisions[-1]

    with mock.patch.object(jvit, "resolve_attn_impl", on_tpu), \
            pltpu.force_tpu_interpret_mode():
        yield decisions


# --- the plain versions against the library kernel ---------------------------
@functools.lru_cache(maxsize=None)
def library_case(n, dtype, d):
    """q, k, v, do (float32 numpy, on the dtype's grid) and the library's o,
    dq, dk, dv at [1, 2, n, d] in ``dtype``, scale d^-1/2."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    rng = np.random.default_rng(n * d // 128)
    arrays = [np.asarray(jnp.asarray(rng.standard_normal((1, 2, n, d)), jdt)
                         .astype(jnp.float32)) for _ in range(4)]
    with pltpu.force_tpu_interpret_mode():
        q, k, v, do = (jnp.asarray(a, jdt) for a in arrays)
        o, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, sm_scale=d**-0.5), q, k, v)
        grads = vjp(do)
        out = [np.asarray(t.astype(jnp.float32)) for t in (o, *grads)]
    return arrays, out


def _torch(a, dtype):
    return torch.from_numpy(a.copy()).to(getattr(torch, dtype))


def _assert_matches(got, want, dtype, what):
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                               atol=BF16_ATOL_OF_MAX * np.abs(want).max(), err_msg=what)
    assert (got == want).mean() >= BF16_MIN_EQUAL, (what, (got == want).mean())


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 512])
def test_plain_forward_matches_the_library_kernel(n, dtype, head_dim):
    (q, k, v, _), (o, *_) = library_case(n, dtype, head_dim)
    got, l, m = fa.flash_attention_reference(*(_torch(a, dtype) for a in (q, k, v)),
                                             head_dim**-0.5)
    assert got.dtype == getattr(torch, dtype) and l.shape == m.shape == (1, 2, n)
    _assert_matches(got, o, dtype, "o")


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 512])
def test_plain_backward_matches_the_library_vjp(n, dtype, head_dim):
    arrays, (_, dq, dk, dv) = library_case(n, dtype, head_dim)
    q, k, v, do = (_torch(a, dtype) for a in arrays)
    scale = head_dim**-0.5
    o, l, m = fa.flash_attention_reference(q, k, v, scale)
    got = fa.flash_attention_bwd_reference(q, k, v, o, l, m, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        assert g.dtype == q.dtype
        _assert_matches(g, w, dtype, name)


def test_autograd_runs_the_plain_backward_on_the_cpu():
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 3, 256, 128)).astype(
        np.float32)) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*leaves, SCALE)
    o.backward(do)
    o_p, l, m = fa.flash_attention_reference(q, k, v, SCALE)
    assert torch.equal(o.detach(), o_p)
    for leaf, want in zip(leaves, fa.flash_attention_bwd_reference(q, k, v, o_p, l, m,
                                                                   do, SCALE)):
        assert torch.equal(leaf.grad, want)


def test_plain_version_rejects_a_ragged_sequence():
    x = torch.zeros((1, 1, 200, 128))
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention_reference(x, x, x, SCALE)


def test_cpu_wrappers_count_no_launch_and_other_devices_raise():
    x = torch.randn((1, 1, 128, 128))
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    o, l, m = fa.flash_attention_fwd(x, x, x, SCALE)
    di = fa.attention_delta(o, x)
    fa.flash_attention_bwd_dkv(x, x, x, l, m, x, di, SCALE)
    fa.flash_attention_bwd_dq(x, x, x, l, m, x, di, SCALE)
    assert [f.launches for f in counters] == before
    meta = torch.zeros((1, 1, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_fwd(meta, meta, meta, SCALE)


# --- resolve_attn_impl: JAX's decision table, "tpu" read as "cuda" -----------
DECISIONS = [("auto", 512, 128, False), ("auto", 256, 128, False),
             ("auto", 128, 128, False), ("auto", 384, 128, False),
             ("auto", 320, 128, False), ("auto", 512, 64, False),
             ("auto", 512, 128, True), ("xla", 64, 128, False),
             ("xla", 512, 128, False), ("flash", 512, 128, False),
             ("flash", 320, 128, False), ("flash", 512, 64, False),
             ("flash", 512, 128, True), ("pallas", 128, 128, False),
             # head_dim 256 (embed 1536 over 6 heads) takes flash as 128 does
             ("auto", 512, 256, False), ("auto", 256, 256, False),
             ("auto", 128, 256, False), ("auto", 512, 256, True),
             ("flash", 256, 256, False), ("xla", 512, 256, False)]


def _decide(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except ValueError as err:
        return f"ValueError: {str(err).split(';')[0].split(' (')[0]}"


@pytest.mark.parametrize("impl,n,head_dim,fused", DECISIONS)
def test_resolve_attn_impl_follows_the_jax_table(impl, n, head_dim, fused,
                                                 monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = _decide(jvit.resolve_attn_impl, impl, n, head_dim, fused)
    got = _decide(tvit.resolve_attn_impl, impl, n, head_dim, fused, on_cuda=True)
    assert got == want


def test_resolve_attn_impl_off_the_card():
    """'auto' keeps the stock ops on a CPU tensor, as JAX does off a TPU;
    an explicit 'flash' runs the plain K5 twin there (JAX raises)."""
    for n in (128, 256, 512):
        assert tvit.resolve_attn_impl("auto", n, 128) == jvit.resolve_attn_impl(
            "auto", n, 128) == "xla"
    assert tvit.resolve_attn_impl("flash", 512, 128) == "flash"
    with pytest.raises(ValueError, match="flash"):
        jvit.resolve_attn_impl("flash", 512, 128)


def test_build_model_rejects_an_unknown_attn_impl():
    with pytest.raises(ValueError, match="attn_impl"):
        build_model(port_config(dataclasses.replace(TINY, attn_impl="pallas")),
                    device="cpu")


@pytest.mark.parametrize("impl,width,want", [("flash", 1024, "flash"),
                                             ("xla", 1024, "xla"),
                                             ("auto", 1024, "xla"),
                                             ("flash", 512, "flash")])
def test_attn_impl_reaches_every_block(impl, width, want, monkeypatch):
    """``attn_impl`` is read: every block's attention takes the function
    ``resolve_attn_impl`` names (on the CPU, 'auto' is the stock ops)."""
    calls = []
    for name in ("flash_mha", "multi_head_attention"):
        orig = getattr(tvit, name)
        monkeypatch.setattr(tvit, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    cfg = port_config(dataclasses.replace(TINY, attn_impl=impl))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model(torch.ones((1, 64, width, 1)))
    assert calls == [{"flash": "flash_mha", "xla": "multi_head_attention"}[want]] * 2


# --- one model, every width ----------------------------------------------------
@pytest.fixture(scope="module")
def wide_weights():
    with jax_on_the_flash_path():
        params, stats = tiny_jax_weights(TINY, seed=2)
    return params, stats, tiny_port_model(params, stats, TINY)


@pytest.mark.parametrize("width", [1024, 2048])
def test_wide_logits_match_jax_on_the_flash_path(wide_weights, width):
    """A model built at 512 px takes 1024- and 2048-px images through the
    flash path and meets JAX's HTRVT at that width on the library kernel."""
    params, stats, model = wide_weights
    image = np.random.default_rng(width).random((B, 64, width, 1), dtype=np.float32)
    cfg = dataclasses.replace(TINY, img_size=(64, width))
    with jax_on_the_flash_path() as decisions:
        want = jax.jit(lambda v, x: JaxHTRVT(cfg).apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(image))
        want = np.asarray(want)
    assert decisions == ["flash"] * TINY.depth
    with torch.inference_mode():
        got = model(torch.from_numpy(image))
    assert got.shape == (B, width // 4, TINY.nb_cls)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


def test_wide_logits_match_jax_on_the_flash_path_at_head_dim_256():
    """Embed 256 over one head (head_dim 256, as embed 1536 over 6 heads) at
    1024 px: the port's flash path (the plain K5 versions on the CPU) meets
    JAX's HTRVT on the library kernel."""
    with jax_on_the_flash_path():
        params, stats = tiny_jax_weights(TINY_256, seed=3)
    model = tiny_port_model(params, stats, TINY_256)
    image = np.random.default_rng(256).random((B, 64, 1024, 1), dtype=np.float32)
    cfg = dataclasses.replace(TINY_256, img_size=(64, 1024))
    with jax_on_the_flash_path() as decisions:
        want = jax.jit(lambda v, x: JaxHTRVT(cfg).apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, jnp.asarray(image))
        want = np.asarray(want)
    assert decisions == ["flash"] * TINY_256.depth
    calls = []
    with mock.patch.object(fa, "flash_attention_reference",
                           lambda *a, _o=fa.flash_attention_reference: (
                               calls.append(a[0].shape), _o(*a))[1]), \
            torch.inference_mode():
        got = model(torch.from_numpy(image))
    assert calls == [(B, 1, 256, 256)] * TINY_256.depth
    assert got.shape == (B, 256, TINY_256.nb_cls)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


def test_one_model_serves_every_width_without_new_state(wide_weights):
    """The position table follows the image's grid: the configured width's
    table is the JAX table bit for bit, the state_dict has no table and the
    same keys at every width, and a 512-px model's 2048-px logits equal
    those of a model built at 2048 px on the same weights."""
    _, _, model = wide_weights
    cfg = model.cfg
    assert torch.equal(model.pos_embed, torch.from_numpy(
        jlayers.sincos_pos_embed_2d(cfg.embed_dim, cfg.grid_size)))
    assert model.pos_table((16, 32)).shape == (512, cfg.embed_dim)
    wide = build_model(dataclasses.replace(cfg, img_size=(64, 2048)), device="cpu")
    assert list(wide.state_dict()) == list(model.state_dict())
    assert not any("pos" in key for key in model.state_dict())
    wide.load_state_dict(model.state_dict(), strict=True)
    image = torch.from_numpy(np.random.default_rng(5).random((1, 64, 2048, 1),
                                                             dtype=np.float32))
    with torch.inference_mode():
        assert torch.equal(model(image), wide.eval()(image))
        flagship = torch.from_numpy(np.random.default_rng(6).random(
            (1, 64, 512, 1), dtype=np.float32))
        assert torch.equal(model(flagship), wide(flagship))


# --- one SAM step at 1024 px ---------------------------------------------------
def _batch(seed, width):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, TRAIN.nb_cls, (B, LMAX)).astype(np.int32)
    lengths = np.array([LMAX, 5], np.int32)
    labels[np.arange(LMAX)[None] >= lengths[:, None]] = 0
    return {"image": rng.random((B, 64, width, 1), dtype=np.float32),
            "labels": labels, "label_lengths": lengths}


def _keep(seed, n):
    return (np.random.default_rng(seed).random((B, n, 1)) > 0.4).astype(np.float32)


def test_sam_step_at_1024_px_matches_jax(wide_weights):
    """One SAM + AdamW + EMA step at 64 x 1024 (N = 256) from the same
    weights, batch and injected keep masks, both stacks on the flash path:
    the losses within 1e-4, as tests/test_torch_port_train.py holds three
    steps at the flagship width. Adam's first step moves an element by lr *
    g / (|g| + eps): +-lr for any gradient above eps = 1e-8, so an element
    whose gradient is float32 noise about zero may land up to 2 lr apart:
    every element is held within 2 lr (plus 1%). Outside the stem (the ViT
    blocks, where the flash path runs, the head and the norms) 99.8% of each
    leaf's elements are within 1% of lr (measured: all but one of an MLP
    bias's 512 and 1 to 3 of a kernel's 8,192), leaving out the key third of
    each qkv bias, whose exact gradient is zero (softmax ignores a per-row
    constant), so that noise sets all of it. The stem is held to the 2 lr
    bound alone: its train-mode BN over 2 images makes its gradient noisy
    at float32 (1.3-2.4% of its elements flip sign, in JAX's own runs too). The gradient norm gets 1e-3: at this
    width the train-mode stem's gradient carries float32 noise of a few
    1e-4 in JAX itself (measured: 1469.886 from ``jax.value_and_grad`` of
    ``_forward_loss`` alone and 1469.346 inside ``jit_train_step``, both
    with the stock attention; the port gives 1469.997 either way)."""
    params, stats, _ = wide_weights
    cfg = ExperimentConfig(model=TRAIN, optim=OPTIM)
    batch = _batch(7, 1024)
    masks = [_keep(8, 256), _keep(9, 256)]
    calls = []

    def jax_mask(*args, **kwargs):
        calls.append(len(calls))
        return jnp.asarray(masks[len(calls) - 1])

    with mock.patch.object(jmasking, "build_keep_mask", jax_mask), \
            jax_on_the_flash_path() as decisions:
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=make_base_optimizer(OPTIM).init(params),
            ema_params=jax.tree.map(jnp.copy, params),
            ema_batch_stats=jax.tree.map(jnp.copy, stats), rng=jax.random.PRNGKey(0))
        state, metrics = jit_train_step(JaxHTRVT(TRAIN), cfg, donate=False)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        want = {k: float(v) for k, v in metrics.items()}
    assert decisions == ["flash"] * (2 * TRAIN.depth) and len(calls) == 2

    port = create_train_state(port_config(cfg), "cpu", torch.Generator().manual_seed(0))
    load_jax_train_state(port.model, port.ema_model, JaxTrainState(
        step=0, params=params, batch_stats=stats, opt_state=None, ema_params=params,
        ema_batch_stats=stats, rng=None))
    port_masks = iter(torch.from_numpy(m) for m in masks)
    with mock.patch.object(masking, "build_keep_mask", lambda *a, **k: next(port_masks)):
        got = {k: float(v) for k, v in train_step(port, batch).items()}
    for key, rtol in (("loss", 1e-4), ("loss_second", 1e-4), ("grad_norm", 1e-3)):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)
    lr = warmup_cosine_lr(0, max_lr=OPTIM.max_lr, warmup_iters=OPTIM.warmup_iters,
                          total_iters=OPTIM.total_iters, min_lr=OPTIM.min_lr)
    got_p, want_p = _leaves(model_to_jax_tree(port.model)[0]), _leaves(
        jax.tree.map(np.asarray, state.params))
    assert got_p.keys() == want_p.keys()
    for key, w in want_p.items():
        diff = np.abs(got_p[key] - w)
        assert diff.max() < 2.01 * lr, key
        if key.startswith("stem/"):
            continue
        if key.endswith("attn/qkv/bias"):
            q_b, _, v_b = np.split(diff, 3)
            diff = np.concatenate([q_b, v_b])
        assert (diff < 0.01 * lr).mean() >= 0.998, (key, (diff < 0.01 * lr).mean())


# --- the PIL-free bucket router and transcribe_buckets ------------------------
def test_image_module_imports_without_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.delitem(sys.modules, "htr_vt_torch.data.image")
    image = importlib.import_module("htr_vt_torch.data.image")
    widths = [64, 128, 129, 512, 513, 1024, 1500, 2048, 2049, 4000]
    assert image.assign_width_buckets(widths, [2048, 512, 1024]) == \
        jimage.assign_width_buckets(widths, [2048, 512, 1024])
    with pytest.raises(ImportError):
        image.load_line_image("any.png")


def test_route_to_buckets_rounds_like_the_jax_cli(capsys):
    widths = [100, 510, 511, 1023, 3000]
    got = serve.route_to_buckets(widths, [510, 1021, 2048], 4)
    assert got == jimage.assign_width_buckets(widths, [512, 1024, 2048])
    out = capsys.readouterr().out
    assert "width bucket 510 rounded up to 512 (widths must be multiples of 4)" in out
    assert "width bucket 1021 rounded up to 1024" in out and "2048" not in out


def test_transcribe_buckets_serves_each_bucket_in_input_order():
    cfg = port_config(dataclasses.replace(TINY, attn_impl="auto", embed_dim=64,
                                          num_heads=2, depth=1))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    converter = CTCLabelConverter(list("abcdefg"))
    widths = [300, 900, 130, 2000, 700, 5000, 512]
    rng = np.random.default_rng(2)
    lines = [rng.random((64, w, 1), dtype=np.float32) for w in widths]

    def load(i, width):  # the line cut or padded white to its bucket's width
        out = np.ones((64, width, 1), np.float32)
        w = min(width, widths[i])
        out[:, :w] = lines[i][:, :w]
        return out

    texts = serve.transcribe_buckets(model, load, widths, [512, 1024, 2048],
                                     converter, batch_size=2)
    buckets, owner = jimage.assign_width_buckets(widths, [512, 1024, 2048])
    assert owner == [0, 1, 0, 2, 1, 2, 0]
    want = [serve.transcribe(model, load(i, buckets[o])[None], converter, 2)[0]
            for i, o in enumerate(owner)]
    assert texts == want
