"""Differentiable CTC loss through the hand-written CUDA recursions (port of
``htr_vt_tpu/ops/ctc_pallas.py``).

    logp   = log_softmax(logits)                          (torch autograd)
    alpha  = ctc_alpha(logp, z, noskip, valid, start2)    (csrc/ctc_alpha.cu)
    loss   = -logsumexp(alpha[:, -1] under endm)          (torch)
  backward, in ``CTCNegLogP``:
    beta   = ctc_beta(logp, z, noskip, valid, endm)       (csrc/ctc_beta.cu)
    dlogp  = ctc_grad_logp(alpha, beta, total, z, g, C)   (torch)

The kernels gather ``logp[b, t, z[b, s]]`` themselves, from time panels of
logp rows staged in shared memory, so the [B, T, S] emission cube is never
built; ``recursion_geometry`` sizes the panels, or past 8192 states (or
logp rows too wide for two panels) picks the kernels' strided path, so every
S that JAX computes runs on the card. ``ctc_alpha`` and
``ctc_beta`` launch their kernel for a CUDA tensor and run their plain version
(``ctc_alpha_reference``, ``ctc_beta_reference``) for a CPU tensor; nothing
else decides, and a failed build or launch raises. ``ctc_loss_cuda`` takes
CUDA tensors only: the CPU loss is the plain ``ops/ctc.py:ctc_loss``, which
``ctc_loss_auto`` chooses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from htr_vt_torch.ops.ctc import NEG, logaddexp3, zero_infinity

# A state whose log posterior lies below this gets no gradient
# (``ctc_pallas.py:270``).
LOG_GAMMA_CUT = -80.0

# The recursion kernels' geometry (``csrc/ctc_recursion.cuh``): one block a
# sample of at most MAX_WARPS warps, each thread holding a power of two of
# consecutive states, up to MAX_PER_THREAD; shared memory holds two
# mbarriers, two edge values a warp (and two NEG slots) for two frames and
# two time panels of PANEL_FRAMES logp rows (fewer where they do not fit),
# within what a block may use on an H100. Past that (S > 8192, or logp rows
# too wide for two panels) the kernels take their strided path: one block
# of up to STRIDED_THREADS threads a sample striding over the states,
# ``recursion_geometry`` giving STRIDED states a thread.
MAX_WARPS = 32
MAX_PER_THREAD = 8
PANEL_FRAMES = 16
SMEM_BYTES = 232448
STRIDED = 0
STRIDED_THREADS = 1024


def extended_masks(labels: torch.Tensor, label_lengths: torch.Tensor,
                   blank: int = 0) -> Tuple[torch.Tensor, ...]:
    """Extended-label states and masks (``ctc_pallas.py:130-141``): z [B, S]
    int32 (blank, l1, blank, l2, ..., blank) and the bool masks noskip,
    valid, start2 and endm [B, S]."""
    b, lmax = labels.shape
    s = 2 * lmax + 1
    lengths = label_lengths.to(torch.int32)[:, None]
    z = torch.full((b, s), blank, dtype=torch.int32, device=labels.device)
    z[:, 1::2] = labels.to(torch.int32)
    same2 = torch.cat([torch.ones_like(z[:, :2], dtype=torch.bool),
                       z[:, 2:] == z[:, :-2]], dim=1)
    noskip = same2 | (z == blank)
    sidx = torch.arange(s, device=labels.device, dtype=torch.int32)[None, :]
    valid = sidx < 2 * lengths + 1
    start2 = (sidx == 0) | ((sidx == 1) & (lengths > 0))
    end = 2 * lengths
    endm = (sidx == end) | ((sidx == end - 1) & (lengths > 0))
    return z, noskip, valid, start2, endm


def _emissions(logp: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    b, t, _ = logp.shape
    return torch.gather(logp, 2, z.long()[:, None, :].expand(b, t, z.shape[1]))


def ctc_alpha_reference(logp: torch.Tensor, z: torch.Tensor,
                        noskip: torch.Tensor, valid: torch.Tensor,
                        start2: torch.Tensor) -> torch.Tensor:
    """Plain version of the alpha kernel: the same inputs, the full
    [B, T, S] float32 alpha cube out (``_alpha_kernel``,
    ``ctc_pallas.py:55-85``)."""
    b, t, _ = logp.shape
    lp = _emissions(logp, z)
    alpha = torch.empty_like(lp)
    row = torch.where(start2 & valid, lp[:, 0], NEG)
    alpha[:, 0] = row
    for i in range(1, t):
        a1 = torch.cat([row.new_full((b, 1), NEG), row[:, :-1]], dim=1)
        a2 = torch.cat([row.new_full((b, 2), NEG), row[:, :-2]], dim=1)
        a2 = torch.where(noskip, NEG, a2)
        new = (logaddexp3(row, a1, a2) + lp[:, i]).clamp_min(NEG)
        row = torch.where(valid, new, NEG)
        alpha[:, i] = row
    return alpha


def ctc_beta_reference(logp: torch.Tensor, z: torch.Tensor,
                       noskip: torch.Tensor, valid: torch.Tensor,
                       endm: torch.Tensor) -> torch.Tensor:
    """Plain version of the beta kernel: the same inputs, the full
    [B, T, S] float32 beta cube out, leaving out each frame's own emission
    (``_beta_kernel``, ``ctc_pallas.py:88-127``). A skip out of state s
    lands in s+2 and is allowed iff ``noskip[s+2]`` is false."""
    b, t, _ = logp.shape
    lp = _emissions(logp, z)
    beta = torch.empty_like(lp)
    row = torch.where(endm & valid, 0.0, NEG).to(lp.dtype)
    beta[:, t - 1] = row
    for i in range(t - 2, -1, -1):
        term = row + lp[:, i + 1]
        b1 = torch.cat([term[:, 1:], term.new_full((b, 1), NEG)], dim=1)
        b2 = torch.where(noskip, NEG, term)
        b2 = torch.cat([b2[:, 2:], term.new_full((b, 2), NEG)], dim=1)
        row = torch.where(valid, logaddexp3(term, b1, b2), NEG)
        beta[:, i] = row
    return beta


def _panel_floats(panel: int, c: int) -> int:
    """Floats of one panel buffer: the rows and the slack of their 16-byte
    aligned superset, rounded to 16 bytes."""
    return (panel * c + 8 + 3) // 4 * 4


def recursion_geometry(t: int, c: int, s: int) -> Tuple[int, int, int]:
    """(states a thread, frames a panel, shared-memory bytes) of the alpha
    and beta kernels at T=t, C=c, S=s. The register path: the fewest states
    a thread that MAX_WARPS warps cover, and the longest panel up to
    PANEL_FRAMES (and T) whose two buffers fit beside the barriers and the
    warps' edges. Where no such geometry exists (S past MAX_PER_THREAD * 32
    * MAX_WARPS, or two rows of C floats past the shared memory), the
    strided path: (STRIDED, 0, 0). Raises ValueError naming the sizes only
    for an empty axis."""
    if t < 1 or c < 1 or s < 1:
        raise ValueError(f"CTC recursion kernels: T={t}, C={c}, S={s} has an "
                         "empty axis")
    per_thread = 1
    while per_thread * 32 * MAX_WARPS < s and per_thread < MAX_PER_THREAD:
        per_thread *= 2
    warps = -(-(-(-s // per_thread)) // 32)
    fixed = 16 + 16 * (warps + 2)
    panel = min(PANEL_FRAMES, t)
    while panel > 0 and fixed + 8 * _panel_floats(panel, c) > SMEM_BYTES:
        panel -= 1
    if per_thread * 32 * MAX_WARPS < s or panel < 1:
        return STRIDED, 0, 0
    return per_thread, panel, fixed + 8 * _panel_floats(panel, c)


def _check(fn: str, name: str, x: torch.Tensor, dtype: torch.dtype,
           shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _launch(fn: str, logp: torch.Tensor, z: torch.Tensor,
            masks: Tuple[Tuple[str, torch.Tensor], ...]) -> torch.Tensor:
    """Check the inputs of a recursion kernel, launch ``htrvt_<fn>`` on the
    current stream and return its [B, T, S] float32 output."""
    b, t, c = logp.shape
    s = z.shape[1]
    _check(fn, "logp", logp, torch.float32, (b, t, c))
    _check(fn, "z", z, torch.int32, (b, s))
    for name, m in masks:
        _check(fn, name, m, torch.bool, (b, s))
    for x in (z, *(m for _, m in masks)):
        if x.device != logp.device:
            raise ValueError(f"{fn}: all inputs must be on one device")
    if t < 1 or s < 1:
        raise ValueError(f"{fn}: empty time or state axis (T={t}, S={s})")
    per_thread, panel, _ = recursion_geometry(t, c, s)
    from htr_vt_torch._build import check_launch, library
    out = torch.empty((b, t, s), dtype=torch.float32, device=logp.device)
    with torch.cuda.device(logp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(library(), f"htrvt_{fn}")(
            logp.data_ptr(), z.data_ptr(), *(m.data_ptr() for _, m in masks),
            out.data_ptr(), b, t, c, s, panel, per_thread, stream)
    check_launch(fn, err)
    return out


def ctc_alpha(logp: torch.Tensor, z: torch.Tensor, noskip: torch.Tensor,
              valid: torch.Tensor, start2: torch.Tensor) -> torch.Tensor:
    """CTC alpha recursion: logp [B, T, C] float32 (log-softmax output), z
    [B, S] int32 with values in [0, C), bool masks [B, S] -> alpha [B, T, S]
    float32.

    CUDA tensors launch ``csrc/ctc_alpha.cu`` on the current stream and add
    one to ``ctc_alpha.launches``; CPU tensors run ``ctc_alpha_reference``.
    Any other device raises."""
    if logp.device.type == "cpu":
        return ctc_alpha_reference(logp, z, noskip, valid, start2)
    if logp.device.type != "cuda":
        raise ValueError(f"ctc_alpha: no kernel for device {logp.device}")
    alpha = _launch("ctc_alpha", logp, z, (("noskip", noskip), ("valid", valid),
                                           ("start2", start2)))
    ctc_alpha.launches += 1
    return alpha


ctc_alpha.launches = 0  # kernel launches; the CPU path never counts


def ctc_beta(logp: torch.Tensor, z: torch.Tensor, noskip: torch.Tensor,
             valid: torch.Tensor, endm: torch.Tensor) -> torch.Tensor:
    """CTC beta recursion, each frame's own emission left out: the inputs of
    ``ctc_alpha`` with the final-state mask ``endm`` in place of ``start2``
    -> beta [B, T, S] float32.

    CUDA tensors launch ``csrc/ctc_beta.cu`` on the current stream and add
    one to ``ctc_beta.launches``; CPU tensors run ``ctc_beta_reference``.
    Any other device raises."""
    if logp.device.type == "cpu":
        return ctc_beta_reference(logp, z, noskip, valid, endm)
    if logp.device.type != "cuda":
        raise ValueError(f"ctc_beta: no kernel for device {logp.device}")
    beta = _launch("ctc_beta", logp, z, (("noskip", noskip), ("valid", valid),
                                         ("endm", endm)))
    ctc_beta.launches += 1
    return beta


ctc_beta.launches = 0  # kernel launches; the CPU path never counts


def logsumexp_masked(a_last: torch.Tensor, endm: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the final states (``ctc_pallas.py:245-248``)."""
    masked = torch.where(endm, a_last, NEG)
    m = masked.max(dim=1).values
    return m + torch.log(torch.exp(masked - m[:, None]).sum(dim=1))


def ctc_grad_logp(alpha: torch.Tensor, beta: torch.Tensor, total: torch.Tensor,
                  z: torch.Tensor, g: torch.Tensor, num_classes: int
                  ) -> torch.Tensor:
    """d(-total)/d logp [B, T, C] scaled by the upstream gradient g [B]
    (``_ctc_bwd``, ``ctc_pallas.py:262-272``, and the transpose of the
    gather at :289-295).

    The state posterior is ``alpha + beta - total`` (beta leaves out its own
    frame's emission, so no extra ``lp``), clamped at 0 before the exp and
    cut below -80. States that share a class (every blank, repeated labels)
    sum into it (``class_sum``)."""
    log_gamma = alpha + beta - total[:, None, None]
    dlp = -torch.exp(torch.clamp_max(log_gamma, 0.0)) * g[:, None, None]
    dlp = torch.where(log_gamma > LOG_GAMMA_CUT, dlp, 0.0)
    return class_sum(dlp, z, num_classes)


def class_sum(dlp: torch.Tensor, z: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-state gradients dlp [B, T, S] summed into the classes z [B, S]
    names -> [B, T, C]. On the card ``scatter_add_`` sums a class's states
    with atomics, in no fixed order: a few float32 ulps apart from run to
    run. It is the one op that keeps two default-mode ``fit`` runs of the
    same steps apart on the card (``chip_smoke.py``'s fit phase swaps in a
    fixed-order sum and gets equal bits); a fixed-order sum here is queued
    in ROADMAP.md."""
    b, t, _ = dlp.shape
    dlogp = dlp.new_zeros((b, t, num_classes))
    return dlogp.scatter_add_(2, z.long()[:, None, :].expand_as(dlp), dlp)


class CTCNegLogP(torch.autograd.Function):
    """-log p(label | logp) per sample [B] over the alpha kernel, with the
    beta kernel in its backward (``_ctc_neglogp``, ``ctc_pallas.py:239-275``).
    Differentiable in ``logp`` only; the log-softmax before it stays with
    autograd."""

    @staticmethod
    def forward(ctx, logp, z, noskip, valid, start2, endm):
        alpha = ctc_alpha(logp, z, noskip, valid, start2)
        total = logsumexp_masked(alpha[:, -1], endm)
        ctx.save_for_backward(logp, z, noskip, valid, endm, alpha, total)
        return -total

    @staticmethod
    def backward(ctx, g):
        logp, z, noskip, valid, endm, alpha, total = ctx.saved_tensors
        beta = ctc_beta(logp, z, noskip, valid, endm)
        dlogp = ctc_grad_logp(alpha, beta, total, z, g, logp.shape[-1])
        return dlogp, None, None, None, None, None


def ctc_loss_cuda(logits: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-sample CTC loss over the alpha and beta kernels
    (``ctc_loss_pallas``, ``ctc_pallas.py:278-304``): [B] float32, zero loss
    and zero gradient for infeasible samples. CUDA tensors only."""
    if not logits.is_cuda:
        raise ValueError(f"ctc_loss_cuda: needs a CUDA tensor, got "
                         f"{logits.device} (ctc_loss_auto sends CPU tensors "
                         "to the plain ctc_loss)")
    logits = logits.float()
    z, noskip, valid, start2, endm = extended_masks(labels, label_lengths, blank)
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    return zero_infinity(CTCNegLogP.apply(logp, z, noskip, valid, start2, endm))
