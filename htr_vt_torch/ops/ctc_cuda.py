"""CTC loss through the hand-written CUDA alpha kernel (port of
``htr_vt_tpu/ops/ctc_pallas.py``, forward only).

    logp   = log_softmax(logits)                          (torch)
    alpha  = ctc_alpha(logp, z, noskip, valid, start2)    (csrc/ctc_alpha.cu)
    loss   = -logsumexp(alpha[:, -1] under endm)          (torch)

The kernel gathers ``logp[b, t, z[b, s]]`` itself, so the [B, T, S]
emission cube is never built. ``ctc_alpha`` launches the kernel for a CUDA
tensor and runs ``ctc_alpha_reference``, the plain version of the same
recursion, for a CPU tensor; nothing else decides, and a failed build or
launch raises. ``ctc_loss_cuda`` takes CUDA tensors only: the CPU loss is
the plain ``ops/ctc.py:ctc_loss``, which ``ctc_loss_auto`` chooses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from htr_vt_torch.ops.ctc import NEG, logaddexp3, zero_infinity


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


def ctc_alpha_reference(logp: torch.Tensor, z: torch.Tensor,
                        noskip: torch.Tensor, valid: torch.Tensor,
                        start2: torch.Tensor) -> torch.Tensor:
    """Plain version of the alpha kernel: the same inputs, the full
    [B, T, S] float32 alpha cube out (``_alpha_kernel``,
    ``ctc_pallas.py:55-85``)."""
    b, t, _ = logp.shape
    lp = torch.gather(logp, 2, z.long()[:, None, :].expand(b, t, z.shape[1]))
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


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"ctc_alpha: {name} must be {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"ctc_alpha: {name} must be contiguous")


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
    b, t, c = logp.shape
    s = z.shape[1]
    _check("logp", logp, torch.float32, (b, t, c))
    _check("z", z, torch.int32, (b, s))
    for name, m in (("noskip", noskip), ("valid", valid), ("start2", start2)):
        _check(name, m, torch.bool, (b, s))
    for x in (z, noskip, valid, start2):
        if x.device != logp.device:
            raise ValueError("ctc_alpha: all inputs must be on one device")
    if t < 1 or s < 1:
        raise ValueError(f"ctc_alpha: empty time or state axis (T={t}, S={s})")
    from htr_vt_torch._build import library
    lib = library()
    alpha = torch.empty((b, t, s), dtype=torch.float32, device=logp.device)
    with torch.cuda.device(logp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.htrvt_ctc_alpha(
            logp.data_ptr(), z.data_ptr(), noskip.data_ptr(), valid.data_ptr(),
            start2.data_ptr(), alpha.data_ptr(), b, t, c, s, stream)
    if err != 0:
        raise RuntimeError(f"ctc_alpha kernel launch failed: CUDA error {err} "
                           f"({lib.htrvt_cuda_error_string(err).decode()})")
    ctc_alpha.launches += 1
    return alpha


ctc_alpha.launches = 0  # kernel launches; the CPU path never counts


def logsumexp_masked(a_last: torch.Tensor, endm: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over the final states (``ctc_pallas.py:245-248``)."""
    masked = torch.where(endm, a_last, NEG)
    m = masked.max(dim=1).values
    return m + torch.log(torch.exp(masked - m[:, None]).sum(dim=1))


def ctc_loss_cuda(logits: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-sample CTC loss over the alpha kernel (``ctc_loss_pallas``,
    ``ctc_pallas.py:278-304``, forward): [B] float32, zero for infeasible
    samples. CUDA tensors only."""
    if not logits.is_cuda:
        raise ValueError(f"ctc_loss_cuda: needs a CUDA tensor, got "
                         f"{logits.device} (ctc_loss_auto sends CPU tensors "
                         "to the plain ctc_loss)")
    logits = logits.float()
    z, noskip, valid, start2, endm = extended_masks(labels, label_lengths, blank)
    logp = torch.log_softmax(logits, dim=-1).contiguous()
    alpha = ctc_alpha(logp, z, noskip, valid, start2)
    return zero_infinity(-logsumexp_masked(alpha[:, -1], endm))
