"""The port's CTC loss and alpha recursion vs the JAX reference.

On the CPU the port's plain loop (``ops/ctc.py:ctc_loss``), the plain
alpha recursion (``ctc_cuda.ctc_alpha_reference``) and the kernel's torch
glue over it (``extended_masks``, ``logsumexp_masked``, ``zero_infinity``)
are held against the JAX scan and against the Pallas kernels in interpret
mode. The CUDA kernel itself is held against its plain version on the card
by tests/test_torch_port_cuda.py.
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


@pytest.mark.parametrize("case", CASES)
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


def test_cpu_tensors_never_count_a_launch():
    """On the CPU ``ctc_loss_auto`` is the plain loop and ``ctc_alpha`` the
    plain recursion; ``ctc_loss_cuda`` takes no CPU tensor."""
    logits, labels, lengths = (torch.from_numpy(a) for a in ctc_case(*CASES[0]))
    before = ctc_cuda.ctc_alpha.launches
    torch.testing.assert_close(tctc.ctc_loss_auto(logits, labels, lengths),
                               tctc.ctc_loss(logits, labels, lengths),
                               rtol=0, atol=0)
    logp = torch.log_softmax(logits, -1)
    masks = ctc_cuda.extended_masks(labels, lengths)[:4]
    torch.testing.assert_close(ctc_cuda.ctc_alpha(logp, *masks),
                               ctc_cuda.ctc_alpha_reference(logp, *masks),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ctc_cuda.ctc_loss_cuda(logits, labels, lengths)
    assert ctc_cuda.ctc_alpha.launches == before


def test_alpha_rejects_a_device_without_a_kernel():
    logp = torch.zeros((1, 4, 3), device="meta")
    masks = [torch.zeros((1, 3), dtype=torch.bool, device="meta")] * 3
    with pytest.raises(ValueError, match="no kernel"):
        ctc_cuda.ctc_alpha(logp, torch.zeros((1, 3), dtype=torch.int32,
                                             device="meta"), *masks)
