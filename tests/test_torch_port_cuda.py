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


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,lmax", [
    (128, 128, 80, 96),   # the labelled eval shape, S=193
    (128, 128, 80, 8),    # the serving dummies, S=17 (all lengths 0)
    (3, 5, 6, 700),       # S=1401: threads stride over S
    (2, 4, 6, 3100)])     # S=6201: over 48 KB of shared memory
def test_alpha_kernel_matches_plain(cuda, b, t, c, lmax):
    lengths = np.zeros(b, np.int32) if lmax == 8 else None
    logits, labels, lengths = ctc_case(5, b, t, c, lmax, lengths)
    logp = torch.log_softmax(torch.from_numpy(logits).to(cuda), -1)
    z, noskip, valid, start2, _ = ctc_cuda.extended_masks(
        torch.from_numpy(labels).to(cuda), torch.from_numpy(lengths).to(cuda))
    before = ctc_cuda.ctc_alpha.launches
    got = ctc_cuda.ctc_alpha(logp, z, noskip, valid, start2)
    torch.cuda.synchronize()
    assert ctc_cuda.ctc_alpha.launches == before + 1
    want = ctc_cuda.ctc_alpha_reference(logp, z, noskip, valid, start2)
    finite = want > SENTINEL
    assert torch.equal(got > SENTINEL, finite)
    assert torch.equal(got[~finite], want[~finite])
    torch.testing.assert_close(got[finite], want[finite], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,lmax", [
    (128, 128, 80, 96),   # the train-step shape, S=193
    (128, 128, 80, 8),    # the serving dummies, S=17 (all lengths 0)
    (3, 5, 6, 700),       # S=1401: threads stride over S
    (2, 4, 6, 3100)])     # S=6201: over 48 KB of shared memory
def test_beta_kernel_matches_plain(cuda, b, t, c, lmax):
    lengths = np.zeros(b, np.int32) if lmax == 8 else None
    logits, labels, lengths = ctc_case(9, b, t, c, lmax, lengths)
    logp = torch.log_softmax(torch.from_numpy(logits).to(cuda), -1)
    z, noskip, valid, _, endm = ctc_cuda.extended_masks(
        torch.from_numpy(labels).to(cuda), torch.from_numpy(lengths).to(cuda))
    before = ctc_cuda.ctc_beta.launches
    got = ctc_cuda.ctc_beta(logp, z, noskip, valid, endm)
    torch.cuda.synchronize()
    assert ctc_cuda.ctc_beta.launches == before + 1
    want = ctc_cuda.ctc_beta_reference(logp, z, noskip, valid, endm)
    finite = want > SENTINEL
    assert torch.equal(got > SENTINEL, finite)
    assert torch.equal(got[~finite], want[~finite])
    torch.testing.assert_close(got[finite], want[finite], rtol=1e-5, atol=1e-4)


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
    cpu_model = build_model(cfg, generator=torch.Generator().manual_seed(3))
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
