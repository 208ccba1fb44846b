"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from htr_vt_torch import ModelConfig
from htr_vt_torch.models.htr_vt import build_model
from htr_vt_torch.ops import ctc as tctc
from htr_vt_torch.ops import ctc_cuda
from htr_vt_torch.train.step import eval_step, train_step

SENTINEL = -1e29  # alpha entries below this are the -1e30 "unreachable" mark


def ctc_case(seed, b, t, c, lmax, lengths=None):
    """numpy logits [b, t, c] f32, labels [b, lmax] and lengths int32: row 0
    has length 0, and where lmax > t row 1 has more labels than frames (no
    alignment). Labels start with a run of three, for the no-skip states."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((b, t, c))).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, min(lmax, t) + 1, size=b)
        lengths[0] = 0
        if lmax > t:
            lengths[1] = lmax
    lengths = np.asarray(lengths, np.int32)
    labels = rng.integers(1, c, size=(b, lmax)).astype(np.int32)
    labels[:, :3] = labels[:, :1]
    labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
    return logits, labels, lengths


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# The recursion kernels' cases: the flagship's CTC shapes, the wide step's,
# the time axis at its edges (one frame; a T that 16-frame panels do not
# divide), C=6 (panels that start off a 16-byte boundary) and the state
# axis past one state a thread.
RECURSION_CASES = [
    (128, 128, 80, 96),   # the labelled eval shape, S=193
    (128, 128, 80, 8),    # the serving dummies, S=17 (all lengths 0)
    (3, 5, 6, 700),       # S=1401: two states a thread
    (2, 4, 6, 1500),      # S=3001: four states a thread
    (2, 4, 6, 3100),      # S=6201: eight states a thread
    (4, 1, 80, 96),       # T=1: one panel of one frame
    (8, 37, 80, 20),      # T=37: the last panel is cut short
    (64, 512, 80, 112),   # the 2048-px step: B=64, T=512, S=225
    (4, 37, 6, 12),       # C=6 over three panels
    (2, 40, 80, 4500)]    # S=9001: past the registers, the strided path


def _two_calls(kernel, *args):
    """The kernel's output, after holding that a second call gives the same
    bits and that each call counted one launch."""
    before = kernel.launches
    got, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, again)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,lmax", RECURSION_CASES)
def test_alpha_kernel_matches_plain(cuda, b, t, c, lmax):
    lengths = np.zeros(b, np.int32) if lmax == 8 else None
    logits, labels, lengths = ctc_case(5, b, t, c, lmax, lengths)
    logp = torch.log_softmax(torch.from_numpy(logits).to(cuda), -1)
    z, noskip, valid, start2, _ = ctc_cuda.extended_masks(
        torch.from_numpy(labels).to(cuda), torch.from_numpy(lengths).to(cuda))
    got = _two_calls(ctc_cuda.ctc_alpha, logp, z, noskip, valid, start2)
    want = ctc_cuda.ctc_alpha_reference(logp, z, noskip, valid, start2)
    finite = want > SENTINEL
    assert torch.equal(got > SENTINEL, finite)
    assert torch.equal(got[~finite], want[~finite])
    torch.testing.assert_close(got[finite], want[finite], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,lmax", RECURSION_CASES)
def test_beta_kernel_matches_plain(cuda, b, t, c, lmax):
    lengths = np.zeros(b, np.int32) if lmax == 8 else None
    logits, labels, lengths = ctc_case(9, b, t, c, lmax, lengths)
    logp = torch.log_softmax(torch.from_numpy(logits).to(cuda), -1)
    z, noskip, valid, _, endm = ctc_cuda.extended_masks(
        torch.from_numpy(labels).to(cuda), torch.from_numpy(lengths).to(cuda))
    got = _two_calls(ctc_cuda.ctc_beta, logp, z, noskip, valid, endm)
    want = ctc_cuda.ctc_beta_reference(logp, z, noskip, valid, endm)
    finite = want > SENTINEL
    assert torch.equal(got > SENTINEL, finite)
    assert torch.equal(got[~finite], want[~finite])
    torch.testing.assert_close(got[finite], want[finite], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_ctc_kernels_stage_logp_by_bulk_copies(cuda):
    """The compiled alpha and beta kernels (every states-a-thread variant)
    copy logp into shared memory by cp.async.bulk (UBLKCP) and take their
    neighbours within a warp by shuffles (SHFL); a size past the registers
    (S = 8193) takes the strided path, one launch, with the plain
    version's bits, and an empty axis raises ValueError naming the sizes,
    launching nothing."""
    import pathlib
    import shutil
    import subprocess
    from htr_vt_torch import _build
    s = ctc_cuda.MAX_PER_THREAD * 32 * ctc_cuda.MAX_WARPS + 1
    assert ctc_cuda.recursion_geometry(2, 3, s)[0] == ctc_cuda.STRIDED
    logp = torch.log_softmax(torch.randn((1, 2, 3), device=cuda), -1)
    z = torch.zeros((1, s), dtype=torch.int32, device=cuda)
    mask = torch.ones((1, s), dtype=torch.bool, device=cuda)
    before = ctc_cuda.ctc_alpha.launches
    got = ctc_cuda.ctc_alpha(logp, z, mask, mask, mask)
    assert ctc_cuda.ctc_alpha.launches == before + 1
    assert torch.equal(got, ctc_cuda.ctc_alpha_reference(logp, z, mask, mask, mask))
    with pytest.raises(ValueError, match="T=2, C=0"):
        ctc_cuda.ctc_alpha(logp[..., :0], z, mask, mask, mask)
    assert ctc_cuda.ctc_alpha.launches == before + 1
    _build.library()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(cuobjdump).exists():
        pytest.skip("no cuobjdump to read the compiled kernels")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.LIBRARY)], capture_output=True,
                          text=True, check=True).stdout
    functions = sass.split("Function : ")
    for kernel in ("ctc_alpha_kernel", "ctc_beta_kernel"):
        bodies = [f for f in functions if kernel in f.splitlines()[0]]
        assert len(bodies) == 4, kernel
        for body in bodies:
            assert "UBLKCP" in body and "SHFL" in body, kernel


@pytest.mark.cuda
def test_kernel_gradient_matches_plain(cuda):
    """d logits through the alpha and beta kernels, against (a) the same
    backward glue over the plain recursions, within rtol 1e-4 / atol 1e-5
    (only scatter_add_'s atomics sum the states of a class in another
    order), and (b) autograd through the plain loop. The glue's posterior
    exp(alpha + beta - total) is a difference of float32 numbers the size of
    the loss, so (b) allows 16 float32 ulps of the largest loss as absolute
    error. An infeasible row gets exactly zero gradient."""
    logits, labels, lengths = ctc_case(10, 16, 40, 12, 50)
    x = torch.from_numpy(logits).to(cuda)
    y, n = (torch.from_numpy(a).to(cuda) for a in (labels, lengths))
    grads, losses = [], []
    before = ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches
    for loss_fn in (ctc_cuda.ctc_loss_cuda, tctc.ctc_loss):
        xg = x.clone().requires_grad_(True)
        loss = loss_fn(xg, y, n)
        loss.sum().backward()
        grads.append(xg.grad)
        losses.append(loss.detach())
    assert (ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches) == (
        before[0] + 1, before[1] + 1)
    got, want = grads
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all() and (want[1] == 0).all()  # lengths[1] = 50 > 40

    xg = x.clone().requires_grad_(True)
    logp = torch.log_softmax(xg, -1)
    z, noskip, valid, start2, endm = ctc_cuda.extended_masks(y, n)
    lp = logp.detach().contiguous()
    alpha = ctc_cuda.ctc_alpha_reference(lp, z, noskip, valid, start2)
    total = ctc_cuda.logsumexp_masked(alpha[:, -1], endm)
    beta = ctc_cuda.ctc_beta_reference(lp, z, noskip, valid, endm)
    logp.backward(ctc_cuda.ctc_grad_logp(alpha, beta, total, z,
                                         (-total < 1e29).float(), lp.shape[-1]))
    torch.testing.assert_close(got, xg.grad, rtol=1e-4, atol=1e-5)
    atol = max(1e-5, 16 * 2.0**-24 * losses[1].abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One SAM step of a tiny f32 model (masking off, so no draws): on the
    card two alpha and two beta launches, and the CPU's losses."""
    from htr_vt_torch import ExperimentConfig, MaskConfig, OptimConfig
    from htr_vt_torch.train.state import create_train_state
    model_cfg = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2,
                            num_heads=2, compute_dtype="float32",
                            masking=MaskConfig(mode="none"))
    cfg = ExperimentConfig(model=model_cfg,
                           optim=OptimConfig(max_lr=1e-3, warmup_iters=2))
    cpu = create_train_state(cfg, "cpu", torch.Generator().manual_seed(4))
    gpu = create_train_state(cfg, cuda, torch.Generator(device=cuda).manual_seed(4))
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    gpu.ema_model.load_state_dict(cpu.ema_model.state_dict(), strict=True)
    rng = np.random.default_rng(11)
    _, labels, lengths = ctc_case(11, 4, 32, 8, 10)
    batch = {"image": rng.random((4, 64, 128, 1), dtype=np.float32),
             "labels": labels, "label_lengths": lengths}
    before = ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches
    got = train_step(gpu, batch)
    assert (ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches) == (
        before[0] + 2, before[1] + 2)
    want = train_step(cpu, batch)
    for key in ("loss", "loss_second", "grad_norm"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ctc_loss_auto_takes_the_kernel(cuda):
    logits, labels, lengths = ctc_case(6, 16, 40, 12, 50)
    args = [torch.from_numpy(a).to(cuda) for a in (logits, labels, lengths)]
    before = ctc_cuda.ctc_alpha.launches
    got = tctc.ctc_loss_auto(*args)
    assert ctc_cuda.ctc_alpha.launches == before + 1
    want = tctc.ctc_loss(*[a.cpu() for a in args])
    assert want[1] == 0 and got[1] == 0  # zero_infinity
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ctc_loss_auto_zeroes_long_infeasible_rows(cuda):
    """A padded batch whose longest labels (S = 9001 and 20001, past the
    register path) cannot be aligned in T = 128 frames: ctc_loss_auto takes
    the kernels (one alpha, one beta launch), gives those rows a zero loss
    and gradient, and the other rows the plain loss."""
    rng = np.random.default_rng(11)
    for lmax in (4500, 10000):
        b, t, c = 4, 128, 80
        logits = (2.0 * rng.standard_normal((b, t, c))).astype(np.float32)
        lengths = np.array([lmax, 30, 0, lmax - 1], np.int32)
        labels = rng.integers(1, c, size=(b, lmax)).astype(np.int32)
        labels[np.arange(lmax)[None] >= lengths[:, None]] = 0
        args = [torch.from_numpy(a).to(cuda) for a in (logits, labels, lengths)]
        x = args[0].clone().requires_grad_(True)
        before = ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches
        got = tctc.ctc_loss_auto(x, args[1], args[2])
        got.sum().backward()
        assert (ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches) == (
            before[0] + 1, before[1] + 1)
        want = tctc.ctc_loss(*[a.cpu() for a in args])
        assert got[0] == 0 and got[3] == 0 and want[0] == 0 and want[3] == 0
        assert (x.grad[[0, 3]] == 0).all() and torch.isfinite(x.grad).all()
        torch.testing.assert_close(got.detach().cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_alpha_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    logits, labels, lengths = ctc_case(7, 2, 6, 5, 3)
    logp = torch.log_softmax(torch.from_numpy(logits).to(cuda), -1)
    z, noskip, valid, start2, _ = ctc_cuda.extended_masks(
        torch.from_numpy(labels).to(cuda), torch.from_numpy(lengths).to(cuda))
    with pytest.raises(ValueError, match="int32"):
        ctc_cuda.ctc_alpha(logp, z.long(), noskip, valid, start2)
    with pytest.raises(ValueError, match="float32"):
        ctc_cuda.ctc_alpha(logp.double(), z, noskip, valid, start2)
    with pytest.raises(ValueError, match="contiguous"):
        ctc_cuda.ctc_alpha(logp.transpose(1, 2).contiguous().transpose(1, 2),
                           z, noskip, valid, start2)
    with pytest.raises(ValueError, match="one device"):
        ctc_cuda.ctc_alpha(logp, z.cpu(), noskip, valid, start2)


@pytest.mark.cuda
def test_eval_step_on_the_card_matches_the_cpu(cuda):
    """A tiny f32 model: the CUDA eval_step (cuDNN convs, the alpha kernel)
    against the CPU one (plain CTC loop) on the same weights and batch."""
    cfg = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2,
                      num_heads=2, compute_dtype="float32")
    cpu_model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    gpu_model = build_model(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    rng = np.random.default_rng(8)
    _, labels, lengths = ctc_case(8, 4, 32, 8, 10)
    batch = {"image": rng.random((4, 64, 128, 1), dtype=np.float32),
             "labels": labels, "label_lengths": lengths}
    before = ctc_cuda.ctc_alpha.launches
    got = eval_step(gpu_model, batch)
    assert ctc_cuda.ctc_alpha.launches == before + 1
    want = eval_step(cpu_model, batch)
    torch.testing.assert_close(got["logits"].cpu(), want["logits"],
                               rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(got["loss_per_sample"].cpu(),
                               want["loss_per_sample"], rtol=1e-4, atol=1e-4)


# --- the stem kernels: K2 (bn_stats), K3f/K3b (pool_bn_relu_fwd/bwd) --------
# The flagship's stem activations at bs 128 (NCHW, stored channels-last):
# the conv1 output and the stage 1, 2 and 3 block activations.
STEM_SHAPES = [(128, 192, 32, 512), (128, 192, 8, 512), (128, 384, 4, 256),
               (128, 768, 2, 128)]


def channels_last(shape, dtype, device, seed, ties=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    if ties:  # a coarse grid: window ties and exact zeros after the BN
        x = torch.round(x * 2) / 2
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_bn_stats_kernel_at_the_flagship_shapes(cuda, shape):
    """Against a float64 sum: the sum within 1e-6 of sum |x| (float32
    partial sums in another order), the sum of squares within rtol 1e-5.
    No atomics, so two calls give equal bits."""
    from htr_vt_torch.ops.bn_stats import bn_stats
    x = channels_last(shape, torch.bfloat16, cuda, seed=shape[1] + shape[2])
    before = bn_stats.launches
    s, q = bn_stats(x)
    s2, q2 = bn_stats(x)
    torch.cuda.synchronize()
    assert bn_stats.launches == before + 2
    assert s.dtype == q.dtype == torch.float32 and s.shape == (shape[1],)
    assert torch.equal(s, s2) and torch.equal(q, q2)
    xd = x.double()
    want_s, want_q = xd.sum((0, 2, 3)), xd.square().sum((0, 2, 3))
    bound = 1e-6 * xd.abs().sum((0, 2, 3))
    assert ((s.double() - want_s).abs() <= bound).all()
    torch.testing.assert_close(q.double(), want_q, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(128, 12, 32, 128), (64, 20, 8, 64), (3, 12, 5, 7),
                                   (2, 20, 1, 3)])
def test_bn_stats_kernel_at_any_channel_count(cuda, shape, dtype):
    """C = 12 and 20 (not multiples of 8: the scalar loads, and a slice
    whose last group is cut short), against float64 with the bars of the
    flagship shapes; two calls give equal bits, one launch each."""
    from htr_vt_torch.ops.bn_stats import bn_stats
    x = channels_last(shape, dtype, cuda, seed=shape[1] + shape[0])
    before = bn_stats.launches
    s, q = bn_stats(x)
    s2, q2 = bn_stats(x)
    torch.cuda.synchronize()
    assert bn_stats.launches == before + 2
    assert torch.equal(s, s2) and torch.equal(q, q2)
    xd = x.double()
    want_s, want_q = xd.sum((0, 2, 3)), xd.square().sum((0, 2, 3))
    assert ((s.double() - want_s).abs() <= 1e-6 * xd.abs().sum((0, 2, 3))).all()
    torch.testing.assert_close(q.double(), want_q, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_bn_stats_kernel_float32_and_gradient(cuda):
    from htr_vt_torch.ops.bn_stats import BNStats, bn_stats_reference
    x = channels_last((3, 24, 5, 7), torch.float32, cuda, seed=1)
    got = BNStats.apply(x.requires_grad_(True))
    want = bn_stats_reference(x.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    cs, cq = torch.randn(24, device=cuda), torch.randn(24, device=cuda)
    (got[0] * cs).sum().add((got[1] * cq).sum()).backward()
    torch.testing.assert_close(
        x.grad, (cs.view(1, -1, 1, 1) + 2 * x.detach() * cq.view(1, -1, 1, 1)),
        rtol=1e-6, atol=1e-6)


def _pool_case(shape, dtype, device, seed, ties):
    x = channels_last(shape, dtype, device, seed, ties)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    c = shape[1]
    scale = torch.randn(c, generator=gen, device=device)
    shift = torch.randn(c, generator=gen, device=device)
    if ties:
        scale, shift = torch.round(scale * 2) / 2, torch.round(shift * 2) / 2
    b, _, h, w = shape
    g = torch.randn((b, c, h // 2, w), generator=gen, device=device).to(dtype)
    return x, scale, shift, g.contiguous(memory_format=torch.channels_last)


def _hold_pool_bwd(got, g, x, scale, shift):
    """K3b's (dx, dscale, dshift) against the plain version: dx bit for
    bit; dscale/dshift, float32 sums of B*H*W terms per channel in another
    order (per-thread chains, block and partial sums vs ATen's tree),
    within 1e-5 of the sum of the terms' magnitudes."""
    from htr_vt_torch.ops import pool_fused as pf
    dx, ds, dt = got
    dx_p, ds_p, dt_p = pf.pool_bn_relu_bwd_reference(g, x, scale, shift)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dx, dx_p)
    daf = pf.routed_grad_reference(g, x, scale, shift)
    for got, want, mag in ((ds, ds_p, (daf * x.float()).abs().sum((0, 2, 3))),
                           (dt, dt_p, daf.abs().sum((0, 2, 3)))):
        assert ((got - want).abs() <= 1e-5 * mag + 1e-6).all(), \
            ((got - want).abs() / mag).max()


# K3f tiles 8 window rows x 32 columns, K3b 8 x 16, both x 128 bytes of
# channels (64 bf16, 32 float32).
@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,ties", [
    ((128, 192, 32, 512), torch.bfloat16, False),  # the flagship entry
    ((4, 16, 8, 45), torch.bfloat16, True),        # ragged W tile, ties
    ((4, 16, 8, 45), torch.float32, True),
    ((2, 8, 6, 300), torch.float32, False),
    ((3, 24, 10, 50), torch.bfloat16, True),       # W not a multiple of either strip
    ((2, 16, 6, 7), torch.bfloat16, False),        # W under both strips
    ((2, 16, 6, 7), torch.float32, True),
    ((2, 8, 4, 20), torch.bfloat16, True),         # C = 8: one partial chunk
    ((2, 40, 4, 24), torch.bfloat16, False),       # C = 40 of 64
    ((2, 40, 6, 33), torch.float32, True),         # C = 40 of 32 + 32
    ((3, 16, 2, 19), torch.bfloat16, True),        # H = 2: one window row
    ((2, 16, 2, 24), torch.float32, False),
    ((2, 24, 36, 40), torch.bfloat16, True),       # Ho = 18: three bands
    ((1, 16, 70, 20), torch.float32, False)])      # Ho = 35: five bands
def test_pool_kernels_match_plain(cuda, shape, dtype, ties):
    """K3f and K3b against their plain versions: y and dx bit for bit (the
    same roundings in the same order); dscale/dshift as
    ``_hold_pool_bwd`` holds them."""
    from htr_vt_torch.ops import pool_fused as pf
    x, scale, shift, g = _pool_case(shape, dtype, cuda, seed=shape[3], ties=ties)
    before = pf.pool_bn_relu_fwd.launches, pf.pool_bn_relu_bwd.launches
    y = pf.pool_bn_relu_fwd(x, scale, shift)
    got = pf.pool_bn_relu_bwd(g, x, scale, shift)
    torch.cuda.synchronize()
    assert (pf.pool_bn_relu_fwd.launches, pf.pool_bn_relu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, pf.max_pool_bn_relu_reference(x, scale, shift))
    _hold_pool_bwd(got, g, x, scale, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((128, 192, 32, 512), torch.bfloat16),  # the flagship entry, the step's layout
    ((2, 16, 6, 24), torch.bfloat16),
    ((2, 40, 36, 16), torch.float32),
    ((3, 8, 2, 8), torch.bfloat16)])
def test_pool_bwd_reads_an_nchw_gradient(cuda, shape, dtype):
    """g as contiguous NCHW (its own tensor map, transposed in shared
    memory) gives the channels-last g's dx, dscale and dshift bit for bit,
    and both meet the plain version."""
    from htr_vt_torch.ops import pool_fused as pf
    x, scale, shift, g = _pool_case(shape, dtype, cuda, seed=shape[2], ties=True)
    g_nchw = g.contiguous()
    assert not g_nchw.is_contiguous(memory_format=torch.channels_last)
    cl = pf.pool_bn_relu_bwd(g, x, scale, shift)
    nchw = pf.pool_bn_relu_bwd(g_nchw, x, scale, shift)
    torch.cuda.synchronize()
    for a, b in zip(cl, nchw):
        assert torch.equal(a, b)
    _hold_pool_bwd(nchw, g_nchw, x, scale, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pool_bwd_border_windows_of_relu_zeros(cuda, dtype):
    """Every window at the image border holds only ReLU zeros (x = 0 there
    and shift = 0, so a_pre is an exact 0 and dx shows the half gradient):
    the first tap in scan order that lies in the image must claim, never a
    tap past the border, which the kernel masks by its coordinates."""
    from htr_vt_torch.ops import pool_fused as pf
    shape = (2, 16, 20, 37)
    x, scale, shift, g = _pool_case(shape, dtype, cuda, seed=11, ties=True)
    x = x.clone()
    x[:, :, :3] = 0
    x[:, :, -3:] = 0
    x[:, :, :, :3] = 0
    x[:, :, :, -3:] = 0
    shift = torch.zeros_like(shift)
    y = pf.pool_bn_relu_fwd(x, scale, shift)
    got = pf.pool_bn_relu_bwd(g, x, scale, shift)
    torch.cuda.synchronize()
    assert torch.equal(y, pf.max_pool_bn_relu_reference(x, scale, shift))
    assert (got[0][:, :, 0, 0] != 0).any()  # the corner takes its windows' half gradient
    _hold_pool_bwd(got, g, x, scale, shift)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((128, 192, 32, 512), torch.bfloat16),
                                         ((3, 40, 36, 48), torch.float32)])
def test_pool_bwd_two_calls_give_equal_bits(cuda, shape, dtype):
    """No atomics: the per-block partials add in a fixed order, so two calls
    give equal dx, dscale and dshift, with g in either layout."""
    from htr_vt_torch.ops import pool_fused as pf
    x, scale, shift, g = _pool_case(shape, dtype, cuda, seed=7, ties=False)
    runs = [pf.pool_bn_relu_bwd(gg, x, scale, shift)
            for gg in (g, g, g.contiguous(), g.contiguous())]
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_pool_autograd_routes_through_both_kernels(cuda):
    from htr_vt_torch.ops import pool_fused as pf
    x, scale, shift, g = _pool_case((2, 16, 8, 40), torch.bfloat16, cuda, 3, True)
    xs = [t.clone().requires_grad_(True) for t in (x, scale, shift)]
    before = pf.pool_bn_relu_fwd.launches, pf.pool_bn_relu_bwd.launches
    pf.max_pool_bn_relu(*xs).backward(g)
    assert (pf.pool_bn_relu_fwd.launches, pf.pool_bn_relu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    dx, ds, dt = pf.pool_bn_relu_bwd_reference(g, x, scale, shift)
    assert torch.equal(xs[0].grad, dx)
    torch.testing.assert_close(xs[1].grad, ds, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xs[2].grad, dt, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_pool_autograd_copies_only_a_gradient_k3b_cannot_read(cuda):
    """``PoolBNReLU`` hands K3b a channels-last or a contiguous NCHW g as it
    comes, and copies (and counts) only a g in another layout: here NCHW
    rows of 12 bf16, 24 bytes, which K3b's tensor map cannot take."""
    from htr_vt_torch.ops import pool_fused as pf
    for w, copies in ((40, 0), (12, 1)):
        x, scale, shift, g = _pool_case((2, 16, 8, w), torch.bfloat16, cuda, 3, True)
        want = pf.pool_bn_relu_bwd_reference(g, x, scale, shift)[0]
        for gg, copied in ((g, 0), (g.contiguous(), copies)):
            xs = x.clone().requires_grad_(True)
            before = pf.PoolBNReLU.grad_copies, pf.pool_bn_relu_bwd.launches
            pf.max_pool_bn_relu(xs, scale, shift).backward(gg)
            assert (pf.PoolBNReLU.grad_copies, pf.pool_bn_relu_bwd.launches) == (
                before[0] + copied, before[1] + 1)
            assert torch.equal(xs.grad, want)


@pytest.mark.cuda
def test_stem_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from htr_vt_torch.ops import pool_fused as pf
    from htr_vt_torch.ops.bn_stats import bn_stats, bn_stats_reference
    x, scale, shift, g = _pool_case((2, 16, 8, 12), torch.bfloat16, cuda, 4, False)
    with pytest.raises(ValueError, match="channels-last"):
        bn_stats(x.contiguous())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bn_stats(x.half())
    # K2 takes any C: C = 12 is held against its plain version
    x12 = channels_last((2, 12, 8, 12), torch.bfloat16, cuda, 4)
    for got, want in zip(bn_stats(x12), bn_stats_reference(x12)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="channels-last"):
        pf.pool_bn_relu_fwd(x.contiguous(), scale, shift)
    with pytest.raises(ValueError, match="H must be even"):
        pf.pool_bn_relu_fwd(x[:, :, :7].contiguous(memory_format=torch.channels_last),
                            scale, shift)
    with pytest.raises(ValueError, match="float32"):
        pf.pool_bn_relu_fwd(x, scale.double(), shift)
    with pytest.raises(ValueError, match="one device"):
        pf.pool_bn_relu_fwd(x, scale.cpu(), shift)
    with pytest.raises(ValueError, match="g must be"):
        pf.pool_bn_relu_bwd(g.float().contiguous(memory_format=torch.channels_last),
                            x, scale, shift)
    with pytest.raises(ValueError, match="W \\* itemsize % 16"):  # 12 bf16: 24-byte rows
        pf.pool_bn_relu_bwd(g.contiguous(), x, scale, shift)
    with pytest.raises(ValueError, match="g must be channels-last"):
        pf.pool_bn_relu_bwd(g.transpose(2, 3).contiguous().transpose(2, 3), x, scale, shift)


def _fused(cfg):
    import dataclasses
    return dataclasses.replace(cfg, bn_stats_impl="pallas", pool_impl="pallas")


@pytest.mark.cuda
def test_fused_stem_train_step_on_the_card_matches_the_cpu(cuda):
    """One SAM step of a tiny f32 model with the stem kernels switched on:
    per step 32 bn_stats, 2 + 2 pool and 2 + 2 CTC launches, and the CPU's
    losses (the CPU runs the kernels' plain versions)."""
    from htr_vt_torch import ExperimentConfig, MaskConfig, OptimConfig
    from htr_vt_torch.ops import pool_fused as pf
    from htr_vt_torch.ops.bn_stats import bn_stats
    from htr_vt_torch.train.state import create_train_state
    model_cfg = _fused(ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64,
                                   depth=2, num_heads=2, compute_dtype="float32",
                                   masking=MaskConfig(mode="none")))
    cfg = ExperimentConfig(model=model_cfg,
                           optim=OptimConfig(max_lr=1e-3, warmup_iters=2))
    cpu = create_train_state(cfg, "cpu", torch.Generator().manual_seed(4))
    gpu = create_train_state(cfg, cuda, torch.Generator(device=cuda).manual_seed(4))
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    gpu.ema_model.load_state_dict(cpu.ema_model.state_dict(), strict=True)
    rng = np.random.default_rng(11)
    _, labels, lengths = ctc_case(11, 4, 32, 8, 10)
    batch = {"image": rng.random((4, 64, 128, 1), dtype=np.float32),
             "labels": labels, "label_lengths": lengths}
    counters = (bn_stats, pf.pool_bn_relu_fwd, pf.pool_bn_relu_bwd,
                ctc_cuda.ctc_alpha, ctc_cuda.ctc_beta)
    before = [f.launches for f in counters]
    got = train_step(gpu, batch)
    assert [f.launches - b for f, b in zip(counters, before)] == [32, 2, 2, 2, 2]
    want = train_step(cpu, batch)
    for key in ("loss", "loss_second", "grad_norm"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_pool_eval_logits_equal_the_stock_path(cuda):
    """Eval with pool_impl="pallas" (K3f on the running statistics) gives
    the stock path's logits bit for bit, in bf16, with one K3f launch."""
    import dataclasses
    from htr_vt_torch.ops import pool_fused as pf
    cfg = ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2,
                      num_heads=2)
    stock = build_model(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(5))
    fused = build_model(dataclasses.replace(cfg, pool_impl="pallas"), device=cuda)
    fused.load_state_dict(stock.state_dict(), strict=True)
    image = torch.rand((4, 64, 128, 1), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(6))
    before = pf.pool_bn_relu_fwd.launches
    with torch.inference_mode():
        got, want = fused(image), stock(image)
    assert pf.pool_bn_relu_fwd.launches == before + 1
    assert torch.equal(got, want)


# --- the conv3x3 + BN-prologue trio: K4f, K4d, K4w ---------------------------
# The flagship's stride-1 conv sites at bs 128: the block activations of
# stages 1, 2 and 3, C -> C.
CONV_SHAPES = [(128, 192, 8, 512), (128, 384, 4, 256), (128, 768, 2, 128)]
# Bars, each with its reason. Every output is a float32 sum in another order
# than cuDNN's or ATen's (9 * Cin products for y and dx, B*H*W for dk,
# dscale and dshift): within CONV_SUM_REL of the sum of the terms'
# magnitudes (|x| and |w| for y, ...). y and dx are then rounded once to the
# working type on each side, which can set them one unit of its last place
# apart: 2^-7 of the value in bf16, 2^-23 in float32.
CONV_SUM_REL = 1e-5
ULP_REL = {torch.bfloat16: 2.0**-7, torch.float32: 2.0**-23}


def _conv_inputs(shape, cout, dtype, device, seed, ties=False):
    """x [B, Cin, H, W] channels-last, weight [Cout, Cin, 3, 3] (He-scaled),
    folded BN terms, and g [B, Cout, H, W] channels-last."""
    b, cin, h, w = shape
    x = channels_last(shape, dtype, device, seed, ties)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    k = (torch.randn((cout, cin, 3, 3), generator=gen, device=device)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype)
    scale = 1.0 + 0.2 * torch.randn(cin, generator=gen, device=device)
    shift = 0.2 * torch.randn(cin, generator=gen, device=device)
    if ties:
        scale, shift = torch.round(scale * 2) / 2, torch.round(shift * 4) / 4
    g = torch.randn((b, cout, h, w), generator=gen, device=device).to(dtype)
    return x, k, scale, shift, g.contiguous(memory_format=torch.channels_last)


def _assert_conv_close(got, want, mag, dtype, what):
    """|got - want| <= CONV_SUM_REL * mag + ULP_REL * max(|got|, |want|)."""
    err = (got.double() - want.double()).abs()
    bound = (CONV_SUM_REL * mag.double()
             + ULP_REL[dtype] * torch.maximum(got.double().abs(), want.double().abs()))
    assert (err <= bound).all(), (what, (err / mag.double().clamp_min(1e-30)).max())


def _check_conv_trio(x, k, scale, shift, g, prologue):
    from htr_vt_torch.ops import conv_fused as cf
    dtype = x.dtype
    s, t = (scale, shift) if prologue else (None, None)
    counters = (cf.conv3x3_bn_relu_fwd, cf.conv3x3_bn_relu_dgrad,
                cf.conv3x3_bn_relu_wgrad)
    before = [f.launches for f in counters]
    runs = [(cf.conv3x3_bn_relu_fwd(x, k, s, t), cf.conv3x3_bn_relu_dgrad(g, k, x, s, t),
             cf.conv3x3_bn_relu_wgrad(x, g, s, t)) for _ in range(2)]
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 2]
    (y, (dx, ds, dt), dk), again = runs
    assert torch.equal(y, again[0]) and torch.equal(dk, again[2])
    assert all(torch.equal(a, b) for a, b in zip((dx, ds, dt), again[1]))
    assert y.is_contiguous(memory_format=torch.channels_last) and y.dtype == dtype
    assert dx.is_contiguous(memory_format=torch.channels_last) and dx.dtype == dtype
    assert dk.dtype == torch.float32 and dk.shape == k.shape
    del runs, again

    xn = cf._prologue(x, scale, shift) if prologue else x
    kf = k.float()
    mag = torch.nn.functional.conv2d(xn.float().abs(), kf.abs(), padding=1)
    _assert_conv_close(y, cf.conv3x3_bn_relu_reference(x, k, s, t), mag, dtype, "y")
    dx_p, ds_p, dt_p = cf.conv3x3_dgrad_reference(g, k, x, s, t, prologue)
    mag = torch.nn.grad.conv2d_input(tuple(x.shape), kf.abs(), g.float().abs(), padding=1)
    if prologue:
        mag = mag * scale.abs().view(1, -1, 1, 1)
    _assert_conv_close(dx, dx_p, mag, dtype, "dx")
    mag = torch.nn.grad.conv2d_weight(xn.float().abs(), tuple(k.shape), g.float().abs(),
                                      padding=1)
    _assert_conv_close(dk, cf.conv3x3_wgrad_reference(x, g, s, t, prologue), mag,
                       torch.float32, "dk")
    if prologue:
        da = torch.nn.grad.conv2d_input(tuple(x.shape), kf, g.float(), padding=1)
        xf = x.float()
        da = torch.where(xf * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1) > 0, da, 0.0)
        for got, want, term in ((ds, ds_p, da * xf), (dt, dt_p, da)):
            _assert_conv_close(got, want, term.abs().sum((0, 2, 3)) + 1e-30,
                               torch.float32, "dscale/dshift")
    else:
        assert not ds.any() and not dt.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernels_at_the_flagship_shapes(cuda, shape):
    """K4f, K4d and K4w in bf16 with the prologue against their plain
    versions (cuDNN, in bf16 for y and in float32 for the gradients), and
    two calls bit-equal."""
    _check_conv_trio(*_conv_inputs(shape, shape[1], torch.bfloat16, cuda, shape[1]),
                     prologue=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,dtype,prologue,ties", [
    ((128, 192, 8, 512), 192, torch.bfloat16, False, False),  # stage 1, bare
    ((3, 40, 5, 7), 24, torch.bfloat16, True, True),   # ragged K, N and M tiles
    ((3, 40, 5, 7), 24, torch.bfloat16, False, False),
    # K4f's tile geometry: one-row images (a two-row tile, 128 columns, W over
    # three tiles); a second row of 8-row tiles with a partial channel chunk
    # and a partial 96-channel tile; 2-row tiles two tiles wide
    ((2, 64, 1, 300), 96, torch.bfloat16, True, False),
    ((1, 136, 9, 33), 200, torch.bfloat16, True, True),
    ((2, 16, 2, 130), 8, torch.bfloat16, False, False),
    # K4w's: 8-row pixel tiles straddling each image's last row (H = 11),
    # three tiles a row (the last partial), splits ending inside an image,
    # a partial 64-channel chunk (72) and a partial 64-channel output tile
    # (88); 4-row tiles over a partial second column tile
    ((3, 72, 11, 70), 88, torch.bfloat16, True, False),
    ((3, 72, 11, 70), 88, torch.bfloat16, False, False),
    ((2, 64, 4, 96), 64, torch.bfloat16, True, True),
    # K4d's: a partial 96-channel tile of its output (Cin = 200) and a
    # partial 64-channel chunk of g (Cout = 72), exact ties on 8-row tiles
    # straddling each image's last row (H = 11)
    ((2, 200, 11, 40), 72, torch.bfloat16, True, True),
    ((2, 200, 11, 40), 72, torch.bfloat16, False, False),
    ((2, 16, 7, 9), 24, torch.float32, True, True),    # float32 (FFMA), ties
    ((2, 16, 7, 9), 24, torch.float32, False, False),
    ((1, 8, 1, 3), 8, torch.float32, True, False),     # one row: every tap pads
    ((4, 32, 16, 64), 32, torch.float32, True, False)])  # the tiny model's stage 1
def test_conv_kernels_at_odd_shapes(cuda, shape, cout, dtype, prologue, ties):
    """The same checks at shapes that leave every tile ragged, in bf16 and in
    float32 (cuDNN with TF32 off), with and without the prologue."""
    _check_conv_trio(*_conv_inputs(shape, cout, dtype, cuda, 7, ties), prologue=prologue)


# K3 and K4 at channel counts off multiples of 8: their wrappers hand the
# kernels zero-padded copies (C -> 16, 24, 32) and slice the real channels out.
@pytest.mark.cuda
@pytest.mark.parametrize("c", [12, 20, 25])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_kernels_at_channel_counts_off_multiples_of_8(cuda, c, dtype):
    """K3f and K3b (g channels-last and NCHW) at [4, C, 8, 45], and K4f,
    K4d and K4w at [3, C, 5, 33] with C -> C + 3 and C -> C, with and
    without the prologue, against their plain versions at the bars of the
    aligned cases; each call launches its kernel once."""
    from htr_vt_torch.ops import pool_fused as pf
    x, scale, shift, g = _pool_case((4, c, 8, 45), dtype, cuda, seed=c, ties=True)
    before = pf.pool_bn_relu_fwd.launches, pf.pool_bn_relu_bwd.launches
    y = pf.pool_bn_relu_fwd(x, scale, shift)
    got = pf.pool_bn_relu_bwd(g, x, scale, shift)
    nchw = pf.pool_bn_relu_bwd(g.contiguous(), x, scale, shift)
    torch.cuda.synchronize()
    assert (pf.pool_bn_relu_fwd.launches, pf.pool_bn_relu_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert y.shape == (4, c, 4, 45) and y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, pf.max_pool_bn_relu_reference(x, scale, shift))
    _hold_pool_bwd(got, g, x, scale, shift)
    assert all(torch.equal(a, b) for a, b in zip(got, nchw))
    for cout in (c + 3, c):
        for prologue in (True, False):
            _check_conv_trio(*_conv_inputs((3, c, 5, 33), cout, dtype, cuda, c),
                             prologue=prologue)


@pytest.mark.cuda
def test_conv_autograd_routes_through_the_three_kernels(cuda):
    from htr_vt_torch.ops import conv_fused as cf
    x, k, scale, shift, g = _conv_inputs((2, 16, 6, 10), 16, torch.float32, cuda, 3)
    args = [t.clone().requires_grad_(True) for t in (x, k, scale, shift)]
    counters = (cf.conv3x3_bn_relu_fwd, cf.conv3x3_bn_relu_dgrad,
                cf.conv3x3_bn_relu_wgrad)
    before = [f.launches for f in counters]
    cf.conv3x3_bn_relu(*args).backward(g)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    dx, ds, dt = cf.conv3x3_bn_relu_dgrad(g, k, x, scale, shift)
    assert torch.equal(args[0].grad, dx)
    assert torch.equal(args[1].grad, cf.conv3x3_bn_relu_wgrad(x, g, scale, shift).contiguous())
    assert torch.equal(args[2].grad, ds) and torch.equal(args[3].grad, dt)


@pytest.mark.cuda
def test_conv_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from htr_vt_torch.ops import conv_fused as cf
    x, k, scale, shift, g = _conv_inputs((2, 16, 4, 6), 16, torch.bfloat16, cuda, 4)
    with pytest.raises(ValueError, match="channels-last"):
        cf.conv3x3_bn_relu_fwd(x.contiguous(), k, scale, shift)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cf.conv3x3_bn_relu_fwd(x.half(), k.half())
    with pytest.raises(ValueError, match="weight must be"):
        cf.conv3x3_bn_relu_fwd(x, k.float(), scale, shift)
    with pytest.raises(ValueError, match="weight must be"):
        cf.conv3x3_bn_relu_fwd(x, k[:, :8].contiguous())
    with pytest.raises(ValueError, match="float32"):
        cf.conv3x3_bn_relu_fwd(x, k, scale.double(), shift)
    with pytest.raises(ValueError, match="one device"):
        cf.conv3x3_bn_relu_fwd(x, k, scale.cpu(), shift)
    with pytest.raises(ValueError, match="go together"):
        cf.conv3x3_bn_relu_fwd(x, k, scale, None)
    with pytest.raises(ValueError, match="g must be"):
        cf.conv3x3_bn_relu_dgrad(g.float().contiguous(memory_format=torch.channels_last),
                                 k, x, scale, shift)
    with pytest.raises(ValueError, match="g must be"):
        cf.conv3x3_bn_relu_wgrad(x, g[:, :, :2].contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="channels-last"):
        cf.conv3x3_bn_relu_wgrad(x, g.contiguous())


@pytest.mark.cuda
def test_fully_fused_train_step_on_the_card_matches_the_cpu(cuda):
    """One SAM step of a tiny f32 model with all three stem switches on: per
    step 18 launches each of K4f, K4d and K4w, 32 of K2, 2 each of K3f,
    K3b, alpha and beta; and the CPU's losses (the CPU runs the kernels'
    plain versions). Before it, the eval forward: 9 K4f and 1 K3f, and the
    CPU's logits."""
    import dataclasses

    from htr_vt_torch import ExperimentConfig, MaskConfig, OptimConfig
    from htr_vt_torch.ops import conv_fused as cf
    from htr_vt_torch.ops import pool_fused as pf
    from htr_vt_torch.ops.bn_stats import bn_stats
    from htr_vt_torch.train.state import create_train_state
    model_cfg = dataclasses.replace(
        _fused(ModelConfig(nb_cls=8, img_size=(64, 128), embed_dim=64, depth=2,
                           num_heads=2, compute_dtype="float32",
                           masking=MaskConfig(mode="none"))), conv_impl="pallas")
    cfg = ExperimentConfig(model=model_cfg,
                           optim=OptimConfig(max_lr=1e-3, warmup_iters=2))
    cpu = create_train_state(cfg, "cpu", torch.Generator().manual_seed(4))
    gpu = create_train_state(cfg, cuda, torch.Generator(device=cuda).manual_seed(4))
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    gpu.ema_model.load_state_dict(cpu.ema_model.state_dict(), strict=True)
    rng = np.random.default_rng(11)
    _, labels, lengths = ctc_case(11, 4, 32, 8, 10)
    batch = {"image": rng.random((4, 64, 128, 1), dtype=np.float32),
             "labels": labels, "label_lengths": lengths}
    counters = (cf.conv3x3_bn_relu_fwd, cf.conv3x3_bn_relu_dgrad,
                cf.conv3x3_bn_relu_wgrad, bn_stats, pf.pool_bn_relu_fwd,
                pf.pool_bn_relu_bwd, ctc_cuda.ctc_alpha, ctc_cuda.ctc_beta)
    before = [f.launches for f in counters]
    x = torch.from_numpy(batch["image"])
    with torch.inference_mode():  # eval first: a step moves the two apart
        got, want = gpu.model(x.to(cuda)), cpu.model(x)
    assert [f.launches - b for f, b in zip(counters, before)] == [9, 0, 0, 0, 1, 0, 0, 0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-4)
    before = [f.launches for f in counters]
    got = train_step(gpu, batch)
    assert [f.launches - b for f, b in zip(counters, before)] == [18, 18, 18, 32, 2, 2, 2, 2]
    want = train_step(cpu, batch)
    for key in ("loss", "loss_second", "grad_norm"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=1e-4)


# --- K5: flash attention forward (K5f) and backward (K5dkv, K5dq) ---------------
# Kernel vs plain version: the same operations and rounding points, float32
# sums in other orders (mma.sync or FFMA against cuBLAS). float32: within
# 1e-4 of the value plus 1e-5 of the tensor's largest. bf16: p and ds are
# rounded to bf16 before each product and the result once, so a float32
# difference of a few ulps may set an element one bf16 ulp apart (2^-7 of
# its value), or a term of a sum that cancels one ulp apart (2^-8 of the
# tensor's largest value).
FLASH_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0**-7, 2.0**-8)}


def _attn_inputs(b, h, n, dtype, device, seed, strided, d=128):
    """q, k, v [b, h, n, d] (with ``strided``, the views of a fused qkv
    projection's [b, n, 3, h, d] output, as the model makes them) and do,
    N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if strided:
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device=device).to(dtype)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
    else:
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device=device).to(dtype)
                   for _ in range(3))
    do = torch.randn((b, h, n, d), generator=gen, device=device).to(dtype)
    return q, k, v, do


def _assert_flash_close(got, want, what):
    rtol, of_max = FLASH_TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape, what
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=of_max * want.float().abs().max().item(), msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,n,strided,d", [
    (torch.bfloat16, 3, 5, 128, False, 128),   # one key block: the single-step path
    (torch.bfloat16, 3, 5, 256, True, 128),
    (torch.bfloat16, 2, 3, 512, True, 128),
    (torch.bfloat16, 1, 6, 384, False, 128),
    (torch.float32, 3, 5, 128, False, 128),
    (torch.float32, 1, 3, 256, True, 128),
    (torch.float32, 2, 1, 512, False, 128),
    # head_dim 256 (embed 1536 over 6 heads)
    (torch.bfloat16, 2, 3, 128, False, 256),
    (torch.bfloat16, 2, 3, 512, True, 256),
    (torch.bfloat16, 1, 2, 384, False, 256),
    # K5dkv's query ring: one query block, an odd count of 64-query steps'
    # pairs, strided views, at both head dims
    (torch.bfloat16, 2, 3, 384, True, 128),
    (torch.bfloat16, 1, 2, 128, True, 256),
    (torch.float32, 1, 2, 128, True, 256),
    # K5dq's key ring: two 64-key steps, six (past the ring's four), strided
    # views, and head_dim 256 at N = 512
    (torch.bfloat16, 2, 3, 128, True, 128),
    (torch.bfloat16, 1, 3, 384, True, 128),
    (torch.bfloat16, 1, 2, 512, False, 256),
    (torch.float32, 2, 1, 256, True, 256),
    # head_dim 384 and 512 (embed 2304 or 3072 over 6 heads): the FFMA
    # kernels, one key block and several, strided views
    (torch.bfloat16, 2, 3, 256, True, 384),
    (torch.bfloat16, 1, 2, 128, False, 384),
    (torch.float32, 1, 2, 256, True, 384),
    (torch.bfloat16, 1, 3, 512, True, 512),
    (torch.float32, 2, 1, 128, False, 512)])
def test_flash_kernels_match_plain(cuda, dtype, b, h, n, strided, d):
    """K5f, K5dkv and K5dq against their plain versions at odd batch and
    head counts, and two calls of each bit-equal."""
    from htr_vt_torch.ops import flash_attn as fa
    q, k, v, do = _attn_inputs(b, h, n, dtype, cuda, n + b, strided, d)
    scale = d**-0.5
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    runs = []
    for _ in range(2):
        o, l, m = fa.flash_attention_fwd(q, k, v, scale)
        di = fa.attention_delta(o, do)
        runs.append((o, l, m, *fa.flash_attention_bwd_dkv(q, k, v, l, m, do, di, scale),
                     fa.flash_attention_bwd_dq(q, k, v, l, m, do, di, scale)))
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(counters, before)] == [2, 2, 2]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    o, l, m, dk, dv, dq = runs[0]
    assert o.transpose(1, 2).is_contiguous()  # heads merge back without a copy
    o_p, l_p, m_p = fa.flash_attention_reference(q, k, v, scale)
    _assert_flash_close(o, o_p, "o")
    torch.testing.assert_close(m, m_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_p, rtol=1e-4, atol=0.0)
    # both backward kernels from the same (plain) l, m and di
    di = fa.attention_delta(o_p, do)
    dk_p, dv_p = fa.flash_attention_dkv_reference(q, k, v, l_p, m_p, do, di, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, l_p, m_p, do, di, scale)
    _assert_flash_close(dk, dk_p, "dk")
    _assert_flash_close(dv, dv_p, "dv")
    _assert_flash_close(fa.flash_attention_bwd_dq(q, k, v, l_p, m_p, do, di, scale),
                        fa.flash_attention_dq_reference(q, k, v, l_p, m_p, do, di, scale),
                        "dq")


@pytest.mark.cuda
def test_flash_gradients_match_autograd_through_the_plain_version(cuda):
    """flash_attention's gradients (K5dkv and K5dq, one launch each) against
    autograd through the plain forward, float32."""
    from htr_vt_torch.ops import flash_attn as fa
    q, k, v, do = _attn_inputs(2, 3, 256, torch.float32, cuda, 9, True)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    fa.flash_attention(*leaves, 128**-0.5).backward(do)
    assert [f.launches - c for f, c in zip(counters, before)] == [1, 1, 1]
    fa.flash_attention_reference(*plain, 128**-0.5)[0].backward(do)
    for name, got, want in zip(("dq", "dk", "dv"), leaves, plain):
        _assert_flash_close(got.grad, want.grad, name)


@pytest.mark.cuda
def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from htr_vt_torch.ops import flash_attn as fa
    q, k, v, do = _attn_inputs(1, 2, 256, torch.bfloat16, cuda, 1, False)
    o, l, m = fa.flash_attention_fwd(q, k, v, 0.1)
    di = fa.attention_delta(o, do)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_attention_fwd(q.half(), k.half(), v.half(), 0.1)
    with pytest.raises(ValueError, match="k must be"):
        fa.flash_attention_fwd(q, k.float(), v, 0.1)
    with pytest.raises(ValueError, match="one \\[B, H, N, D\\] shape"):
        fa.flash_attention_fwd(q, k[:, :1], v, 0.1)
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention_fwd(q[:, :, :200], k[:, :, :200], v[:, :, :200], 0.1)
    for d in (64, 200):
        x = torch.zeros((1, 2, 256, d), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match=f"multiple of 128 .*got head_dim {d}"):
            fa.flash_attention_fwd(x, x, x, 0.1)
    for d in (256, 384, 512):  # embed 1536, 2304, 3072 over 6 heads
        x = torch.zeros((1, 2, 256, d), dtype=torch.bfloat16, device=cuda)
        assert fa.flash_attention_fwd(x, x, x, 0.1)[0].shape == x.shape
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention_fwd(q, k.cpu(), v, 0.1)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention_bwd_dq(q, k, v, l.cpu(), m, do, di, 0.1)
    with pytest.raises(ValueError, match="l must be"):
        fa.flash_attention_bwd_dkv(q, k, v, l.double(), m, do, di, 0.1)
    with pytest.raises(ValueError, match="do must be"):
        fa.flash_attention_bwd_dkv(q, k, v, l, m, do.float(), di, 0.1)
    wide = torch.zeros((1, 2, 256, 256), dtype=torch.bfloat16, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last dim"):
        fa.flash_attention_fwd(wide, k, v, 0.1)


def _kernel_body(source, name):
    """The text of the kernel ``name`` in ``source``: from its name to the
    next ``__global__``."""
    start = source.index(f"\n{name}(")
    end = source.find("__global__", start)
    return source[start:] if end < 0 else source[start:end]


@pytest.mark.cuda
def test_k5f_and_k4f_are_wgmma_fed_by_tma(cuda):
    """Every bf16 kernel of K5 and K4 (K5f, K5dkv, K5dq, K4f, K4d, K4w) is
    built on wgmma with TMA loads: the source of its main loop calls the
    wgmma and TMA helpers and no mma.sync, the mma.sync bodies they replaced
    are gone, and the compiled library holds HGMMA (wgmma) and UTMALDG (TMA
    load) instructions in each."""
    import pathlib
    import shutil
    import subprocess
    from htr_vt_torch import _build
    helpers = (_build.CSRC / "hopper.cuh").read_text()
    assert "wgmma.mma_async" in helpers and "cp.async.bulk.tensor" in helpers
    # (source, the function holding the main loop, the kernel): K4f and K4d
    # share conv_fused.cu's conv_wgmma
    kernels = (("flash_attn.cu", "flash_fwd_wgmma", "flash_fwd_wgmma"),
               ("flash_attn.cu", "flash_dkv_wgmma", "flash_dkv_wgmma"),
               ("flash_attn.cu", "flash_dq_wgmma", "flash_dq_wgmma"),
               ("conv_fused.cu", "conv_wgmma", "conv_fwd_wgmma"),
               ("conv_fused.cu", "conv_wgmma", "conv_dgrad_wgmma"),
               ("conv_fused.cu", "wgrad_wgmma", "wgrad_wgmma"))
    for src, body_of, kernel in kernels:
        text = (_build.CSRC / src).read_text()
        assert f"\n{kernel}(" in text, kernel
        body = _kernel_body(text, body_of)
        assert "hopper::wgmma_m64n" in body and "hopper::tma_load_" in body, kernel
        assert "mma_bf16" not in body and "cp_async16" not in body, kernel
    for src, gone in (("flash_attn.cu", "flash_dkv_mma"), ("conv_fused.cu", "wgrad_mma_kernel"),
                      ("flash_attn.cu", "flash_dq_mma"), ("conv_fused.cu", "conv_mma_kernel"),
                      ("flash_attn.cu", "mma.sync"), ("conv_fused.cu", "mma.sync")):
        assert gone not in (_build.CSRC / src).read_text(), gone
    _build.library()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(cuobjdump).exists():
        pytest.skip("no cuobjdump to read the compiled kernels")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.LIBRARY)], capture_output=True,
                          text=True, check=True).stdout
    functions = sass.split("Function : ")
    for _, _, kernel in kernels:
        bodies = [f for f in functions if kernel in f.splitlines()[0]]
        assert bodies, kernel
        for body in bodies:
            assert "HGMMA" in body and "UTMALDG" in body, kernel
            assert "HMMA" not in body.replace("HGMMA", ""), kernel


@pytest.mark.cuda
def test_k3_kernels_are_fed_by_tma(cuda):
    """K3f and K3b stage their tiles by TMA (the source of each kernel calls
    the TMA helper, and the compiled library holds UTMALDG in each); the
    per-thread global loads of the kernels they replaced are gone."""
    import pathlib
    import shutil
    import subprocess
    from htr_vt_torch import _build
    text = (_build.CSRC / "pool_fused.cu").read_text()
    for kernel in ("pool_fwd_kernel", "pool_bwd_kernel"):
        body = _kernel_body(text, kernel)
        assert "hopper::mbar_wait" in body and "stem::load8" not in body, kernel
    assert "hopper::tma_load_4d" in _kernel_body(text, "pool_fwd_kernel")
    # K3b's loads (x and g, into either buffer) are issued through bwd_load
    assert "bwd_load<T, kNchw>(" in _kernel_body(text, "pool_bwd_kernel")
    loader = text[text.index("void bwd_load("):]
    assert loader[:loader.index("\n}\n")].count("hopper::tma_load_4d") == 3
    assert "window_argmax" not in text
    _build.library()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(cuobjdump).exists():
        pytest.skip("no cuobjdump to read the compiled kernels")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.LIBRARY)], capture_output=True,
                          text=True, check=True).stdout
    functions = sass.split("Function : ")
    for kernel in ("pool_fwd_kernel", "pool_bwd_kernel"):
        bodies = [f for f in functions if kernel in f.splitlines()[0]]
        assert bodies, kernel
        for body in bodies:
            assert "UTMALDG" in body, kernel


@pytest.mark.cuda
def test_wide_train_step_on_the_card_matches_the_cpu(cuda):
    """A tiny float32 model (embed 128, one head: head_dim 128) at 64 x 1024
    px, N = 256: the eval forward takes K5f once a block and gives the CPU's
    logits (the CPU runs the plain versions); one SAM step launches 4 K5f,
    4 K5dkv, 4 K5dq and 2 each of alpha and beta, and gives the CPU's
    losses."""
    from htr_vt_torch import ExperimentConfig, MaskConfig, OptimConfig
    from htr_vt_torch.ops import flash_attn as fa
    from htr_vt_torch.train.state import create_train_state
    model_cfg = ModelConfig(nb_cls=8, img_size=(64, 1024), embed_dim=128, depth=2,
                            num_heads=1, compute_dtype="float32", attn_impl="flash",
                            masking=MaskConfig(mode="none"))
    cfg = ExperimentConfig(model=model_cfg,
                           optim=OptimConfig(max_lr=1e-3, warmup_iters=2))
    cpu = create_train_state(cfg, "cpu", torch.Generator().manual_seed(4))
    gpu = create_train_state(cfg, cuda, torch.Generator(device=cuda).manual_seed(4))
    gpu.model.load_state_dict(cpu.model.state_dict(), strict=True)
    gpu.ema_model.load_state_dict(cpu.ema_model.state_dict(), strict=True)
    rng = np.random.default_rng(12)
    _, labels, lengths = ctc_case(12, 2, 256, 8, 40)
    batch = {"image": rng.random((2, 64, 1024, 1), dtype=np.float32),
             "labels": labels, "label_lengths": lengths}
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_dq, ctc_cuda.ctc_alpha, ctc_cuda.ctc_beta)
    before = [f.launches for f in counters]
    x = torch.from_numpy(batch["image"])
    with torch.inference_mode():
        got, want = gpu.model(x.to(cuda)), cpu.model(x)
    assert [f.launches - c for f, c in zip(counters, before)] == [2, 0, 0, 0, 0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=2e-4)
    before = [f.launches for f in counters]
    got = train_step(gpu, batch)
    assert [f.launches - c for f, c in zip(counters, before)] == [4, 4, 4, 2, 2]
    want = train_step(cpu, batch)
    for key in ("loss", "loss_second", "grad_norm"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=1e-3)
