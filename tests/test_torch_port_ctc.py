"""The port's CTC loss, its gradient and the alpha/beta recursions vs the
JAX reference.

On the CPU the port's plain loop (``ops/ctc.py:ctc_loss``), the plain
alpha and beta recursions (``ctc_cuda.ctc_alpha_reference``,
``ctc_beta_reference``) and the kernels' torch glue over them
(``extended_masks``, ``logsumexp_masked``, ``zero_infinity``, the
``CTCNegLogP`` backward) are held against the JAX scan and against the
Pallas kernels in interpret mode, losses and ``d logits`` both. The CUDA
kernels themselves are held against their plain versions on the card by
tests/test_torch_port_cuda.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import htr_vt_tpu.ops.ctc_pallas as cp
from htr_vt_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from htr_vt_torch.ops import ctc as tctc
from htr_vt_torch.ops import ctc_cuda
from test_torch_port_cuda import SENTINEL, ctc_case

# float32 log-space recursions over <= 40 frames, summed in other orders.
TOL = dict(rtol=1e-5, atol=1e-5)
# d logits: posteriors exp(alpha + beta - total), summed over the states of
# a class in another order than JAX's one-hot product.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@contextlib.contextmanager
def pallas_interpret():
    """Run the Pallas CTC kernels in interpret mode, as tests/test_ctc.py
    does, restoring the real pallas_call afterwards."""
    orig = cp.pl.pallas_call
    cp.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        yield
    finally:
        cp.pl.pallas_call = orig


CASES = [(0, 6, 20, 9, 6), (1, 5, 8, 7, 12), (2, 4, 30, 11, 14)]
# The time axis at its edges: one frame, and a T that the kernels' panels
# (ctc_cuda.PANEL_FRAMES frames) do not divide.
EDGE_T_CASES = [(3, 4, 1, 9, 5), (4, 3, ctc_cuda.PANEL_FRAMES + 3, 9, 6)]


@pytest.mark.parametrize("case", CASES)
def test_plain_ctc_loss_matches_jax_scan_and_pallas(case):
    logits, labels, lengths = ctc_case(*case)
    want = np.asarray(jax_ctc_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   jnp.asarray(lengths)))
    with pallas_interpret():
        pallas = np.asarray(cp.ctc_loss_pallas(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(lengths)))
    got = tctc.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(lengths)).numpy()
    assert got[0] > 0  # length-0 label: the all-blank path
    if case[4] > case[2]:
        assert got[1] == 0.0 and want[1] == 0.0  # zero_infinity
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    # ctc_loss_cuda's glue, over the plain recursion in place of the kernel
    z, noskip, valid, start2, endm = ctc_cuda.extended_masks(
        torch.from_numpy(labels), torch.from_numpy(lengths))
    alpha = ctc_cuda.ctc_alpha_reference(
        torch.log_softmax(torch.from_numpy(logits), -1), z, noskip, valid, start2)
    glue = tctc.zero_infinity(-ctc_cuda.logsumexp_masked(alpha[:, -1], endm))
    np.testing.assert_allclose(glue.numpy(), pallas, **TOL)
    mean = tctc.ctc_loss_mean(torch.from_numpy(logits), torch.from_numpy(labels),
                              torch.from_numpy(lengths)).item()
    np.testing.assert_allclose(mean, want.mean(), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_extended_masks_match_jax(case):
    _, labels, lengths = ctc_case(*case)
    want = cp._extended(jnp.asarray(labels), jnp.asarray(lengths), 0)
    got = ctc_cuda.extended_masks(torch.from_numpy(labels),
                                  torch.from_numpy(lengths))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool


@pytest.mark.parametrize("case", CASES + EDGE_T_CASES)
def test_alpha_reference_matches_pallas_alpha_cube(case):
    logits, labels, lengths = ctc_case(*case)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    z, noskip, valid, start2, _ = cp._extended(
        jnp.asarray(labels), jnp.asarray(lengths), 0)
    lp = jnp.take_along_axis(jnp.asarray(logp), z[:, None, :], axis=2)
    f32 = lambda m: m.astype(jnp.float32)  # noqa: E731
    with pallas_interpret():
        want = np.asarray(cp._run_recursion(
            cp._alpha_kernel, lp, (f32(noskip), f32(valid), f32(start2)),
            tile_b=1, reverse_time=False))
    got = ctc_cuda.ctc_alpha_reference(
        torch.from_numpy(logp), *ctc_cuda.extended_masks(
            torch.from_numpy(labels), torch.from_numpy(lengths))[:4]).numpy()
    assert got.shape == want.shape == (case[1], case[2], 2 * case[4] + 1)
    finite = want > SENTINEL
    np.testing.assert_array_equal(got > SENTINEL, finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-4)


def _lp_and_masks(case):
    """JAX's emission cube and float masks, the port's logp and bool masks."""
    logits, labels, lengths = ctc_case(*case)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    z, noskip, valid, _, endm = cp._extended(
        jnp.asarray(labels), jnp.asarray(lengths), 0)
    lp = jnp.take_along_axis(jnp.asarray(logp), z[:, None, :], axis=2)
    f32 = lambda m: m.astype(jnp.float32)  # noqa: E731
    port = ctc_cuda.extended_masks(torch.from_numpy(labels),
                                   torch.from_numpy(lengths))
    return lp, (f32(noskip), f32(valid), f32(endm)), torch.from_numpy(logp), port


# (case, time-panel length): one panel, and case 0's 20 frames in 4 panels
# of 5 by shrinking the VMEM budget as tests/test_ctc.py does.
BETA_CASES = ([(c, None) for c in CASES] + [(CASES[0], 5)]
              + [(c, None) for c in EDGE_T_CASES])


@pytest.mark.parametrize("case,panel", BETA_CASES)
def test_beta_reference_matches_pallas_beta_cube(case, panel, monkeypatch):
    lp, jmasks, logp, (z, noskip, valid, _, endm) = _lp_and_masks(case)
    s = z.shape[1]
    if panel:
        monkeypatch.setattr(cp, "_VMEM_BUDGET", 16 * panel * s)
        assert cp._panel_len(case[2], s, 1) == panel
    with pallas_interpret():
        want = np.asarray(cp._run_recursion(cp._beta_kernel, lp, jmasks,
                                            tile_b=1, reverse_time=True))
    got = ctc_cuda.ctc_beta_reference(logp, z, noskip, valid, endm).numpy()
    assert got.shape == want.shape == (case[1], case[2], s)
    finite = want > SENTINEL
    assert finite.any() and (~finite).any()
    assert ctc_cuda.recursion_geometry(case[2], case[3], s)[1] == min(
        case[2], ctc_cuda.PANEL_FRAMES)
    np.testing.assert_array_equal(got > SENTINEL, finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-4)


def _port_kernel_route_loss(logits, labels, lengths):
    """``ctc_loss_cuda``'s body on CPU tensors: the autograd Function over
    the plain alpha and beta recursions."""
    z, noskip, valid, start2, endm = ctc_cuda.extended_masks(labels, lengths)
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    return tctc.zero_infinity(ctc_cuda.CTCNegLogP.apply(
        logp, z, noskip, valid, start2, endm))


@pytest.mark.parametrize("case", CASES)
def test_ctc_gradients_match_jax_scan_and_pallas(case):
    """d logits of the summed loss: the plain loop under autograd and the
    kernels' backward glue over the plain recursions, against jax.grad of
    the scan and of the Pallas path; length-0 and infeasible rows included
    (an infeasible row has exactly zero gradient)."""
    logits, labels, lengths = ctc_case(*case)
    jl, jy, jn = map(jnp.asarray, (logits, labels, lengths))
    want = np.asarray(jax.grad(lambda x: jax_ctc_loss(x, jy, jn).sum())(jl))
    with pallas_interpret():
        pallas = np.asarray(jax.grad(
            lambda x: cp.ctc_loss_pallas(x, jy, jn).sum())(jl))
    np.testing.assert_allclose(pallas, want, **GRAD_TOL)
    ty, tn = torch.from_numpy(labels), torch.from_numpy(lengths)
    for loss_fn in (tctc.ctc_loss, _port_kernel_route_loss):
        x = torch.from_numpy(logits).requires_grad_(True)
        loss = loss_fn(x, ty, tn)
        loss.sum().backward()
        got = x.grad.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=loss_fn.__name__)
        np.testing.assert_allclose(got, pallas, **GRAD_TOL, err_msg=loss_fn.__name__)
        infeasible = loss.detach().numpy() == 0
        if case[4] > case[2]:
            assert infeasible[1] and (got[1] == 0).all()


def test_grad_glue_sums_the_states_of_a_class():
    """``ctc_grad_logp`` adds up the posteriors of every state of a class:
    all blanks, and labels that repeat."""
    b, t, c = 1, 2, 4
    z = torch.tensor([[0, 2, 0, 2, 0]], dtype=torch.int32)
    alpha = torch.log(torch.tensor([[[.1, .2, .3, .4, .5], [.5, .4, .3, .2, .1]]]))
    beta = torch.zeros_like(alpha)
    got = ctc_cuda.ctc_grad_logp(alpha, beta, torch.zeros(b), z,
                                 torch.full((b,), 2.0), c)
    want = torch.zeros((b, t, c))
    want[0, 0, 0], want[0, 0, 2] = -2 * (.1 + .3 + .5), -2 * (.2 + .4)
    want[0, 1, 0], want[0, 1, 2] = -2 * (.5 + .3 + .1), -2 * (.4 + .2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_fixed_order_class_sum_computes_the_class_sum():
    """``ctc_cuda.class_sum`` sums each class's states in a fixed order (a
    float64 one-hot product rounded to float32): the sums of a float32
    ``scatter_add_`` within float32 rounding, the float64 sums rounded
    once, and the same bits on a second call."""
    rng = np.random.default_rng(0)
    b, t, s, c = 3, 7, 9, 5
    dlp = torch.from_numpy(rng.standard_normal((b, t, s)).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, c, (b, s)).astype(np.int32))
    got = ctc_cuda.class_sum(dlp, z, c)
    assert got.dtype == torch.float32 and got.shape == (b, t, c)
    scattered = dlp.new_zeros((b, t, c)).scatter_add_(
        2, z.long()[:, None, :].expand_as(dlp), dlp)
    torch.testing.assert_close(got, scattered, rtol=1e-6, atol=1e-6)
    exact = torch.zeros((b, t, c), dtype=torch.float64).scatter_add_(
        2, z.long()[:, None, :].expand_as(dlp), dlp.double())
    assert torch.equal(got, exact.float())
    assert torch.equal(got, ctc_cuda.class_sum(dlp, z, c))


def test_cpu_tensors_never_count_a_launch():
    """On the CPU ``ctc_loss_auto`` is the plain loop and ``ctc_alpha`` the
    plain recursion; ``ctc_loss_cuda`` takes no CPU tensor."""
    logits, labels, lengths = (torch.from_numpy(a) for a in ctc_case(*CASES[0]))
    before = ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches
    torch.testing.assert_close(tctc.ctc_loss_auto(logits, labels, lengths),
                               tctc.ctc_loss(logits, labels, lengths),
                               rtol=0, atol=0)
    logp = torch.log_softmax(logits, -1)
    z, noskip, valid, start2, endm = ctc_cuda.extended_masks(labels, lengths)
    torch.testing.assert_close(ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2),
                               ctc_cuda.ctc_alpha_reference(
                                   logp, z, noskip, valid, start2),
                               rtol=0, atol=0)
    torch.testing.assert_close(ctc_cuda.ctc_beta(logp, z, noskip, valid, endm),
                               ctc_cuda.ctc_beta_reference(
                                   logp, z, noskip, valid, endm),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ctc_cuda.ctc_loss_cuda(logits, labels, lengths)
    assert (ctc_cuda.ctc_alpha.launches, ctc_cuda.ctc_beta.launches) == before


def test_alpha_rejects_a_device_without_a_kernel():
    logp = torch.zeros((1, 4, 3), device="meta")
    masks = [torch.zeros((1, 3), dtype=torch.bool, device="meta")] * 3
    with pytest.raises(ValueError, match="no kernel"):
        ctc_cuda.ctc_alpha(logp, torch.zeros((1, 3), dtype=torch.int32,
                                             device="meta"), *masks)


def test_beta_rejects_a_device_without_a_kernel():
    logp = torch.zeros((1, 4, 3), device="meta")
    masks = [torch.zeros((1, 3), dtype=torch.bool, device="meta")] * 3
    with pytest.raises(ValueError, match="no kernel"):
        ctc_cuda.ctc_beta(logp, torch.zeros((1, 3), dtype=torch.int32,
                                            device="meta"), *masks)


@pytest.mark.parametrize("t,c,s,want", [
    (128, 80, 193, (1, 16, 10464)),      # the flagship's train and eval CTC
    (512, 80, 225, (1, 16, 10480)),      # the 2048-px step
    (1, 80, 193, (1, 1, 864)),           # one frame: one panel of one frame
    (5, 6, 1401, (2, 5, 720)),           # two states a thread
    (4, 6, 6201, (8, 4, 704)),           # eight states a thread
    (128, 80, 8192, (8, 16, 10864)),     # the most states a block holds
    (128, 4000, 193, (1, 7, 224224))])   # wide logp rows: shorter panels
def test_recursion_geometry(t, c, s, want):
    """States a thread, frames a panel and shared-memory bytes of the CTC
    kernels: the fewest states a thread that 32 warps cover, and the
    longest panel up to PANEL_FRAMES (and T) whose two buffers fit beside
    the barriers and the warps' edge values."""
    per_thread, panel, smem = ctc_cuda.recursion_geometry(t, c, s)
    assert (per_thread, panel, smem) == want
    warps = -(-(-(-s // per_thread)) // 32)
    assert warps <= ctc_cuda.MAX_WARPS
    assert per_thread == 1 or per_thread // 2 * 32 * ctc_cuda.MAX_WARPS < s
    fixed = 16 + 16 * (warps + 2)
    assert smem == fixed + 8 * ctc_cuda._panel_floats(panel, c) <= ctc_cuda.SMEM_BYTES
    assert ctc_cuda._panel_floats(panel, c) >= panel * c + 6  # the aligned superset
    if panel < min(t, ctc_cuda.PANEL_FRAMES):
        assert fixed + 8 * ctc_cuda._panel_floats(panel + 1, c) > ctc_cuda.SMEM_BYTES


@pytest.mark.parametrize("t,c,s", [(0, 80, 193), (128, 0, 193), (4, 6, 0)])
def test_recursion_geometry_names_the_sizes_it_cannot_take(t, c, s):
    """Only an empty axis: every other size has a geometry, the strided
    path past the register path (tests/test_torch_port_repairs.py)."""
    with pytest.raises(ValueError, match=f"T={t}, C={c}, S={s}"):
        ctc_cuda.recursion_geometry(t, c, s)


def test_launch_refuses_a_geometry_before_building_anything():
    """A size the kernels cannot take (an empty class axis) raises
    ValueError in the wrapper, before the kernel library is loaded (this
    machine has no nvcc)."""
    s = ctc_cuda.MAX_PER_THREAD * 32 * ctc_cuda.MAX_WARPS + 1
    logp = torch.zeros((1, 2, 0))
    mask = torch.zeros((1, s), dtype=torch.bool)
    with pytest.raises(ValueError, match=f"T=2, C=0, S={s}"):
        ctc_cuda._launch("ctc_alpha", logp, torch.zeros((1, s), dtype=torch.int32),
                         (("noskip", mask), ("valid", mask), ("start2", mask)))


@pytest.mark.parametrize("kernel", ["ctc_alpha", "ctc_beta"])
def test_recursion_frame_loop_reads_no_device_memory(kernel):
    """The frame loop of each CTC kernel reads logp only from the panels
    that thread 0 stages by cp.async.bulk, the per-state inputs not at all
    (they are loaded into registers before it), exchanges the warps' edges
    through shared memory and holds one barrier a frame."""
    from htr_vt_torch import _build
    text = (_build.CSRC / f"{kernel}.cu").read_text()
    body = text[text.index(f"{kernel}_kernel("):]
    body = body[:body.index("\n}\n")]
    loop = body[body.index("\n  for (int t = 1;" if kernel == "ctc_alpha"
                           else "\n  for (int m = 1;"):]
    assert "panels.next(" in loop and "_sync(0xffffffffu" in loop
    for name in ("logp[", "lp[", "z[", "zb[", "noskip[", "valid[", "start2[", "endm["):
        assert name not in loop, name
    assert loop.count("__syncthreads()") == 1
    header = (_build.CSRC / "ctc_recursion.cuh").read_text()
    copy = header[header.index("void copy_panel("):]
    assert "hopper::bulk_load(" in copy[:copy.index("\n}\n")]
