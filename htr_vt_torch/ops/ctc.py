"""CTC loss, plain PyTorch (port of ``htr_vt_tpu/ops/ctc.py``).

Semantics of ``torch.nn.CTCLoss(reduction='none', zero_infinity=True)``:
blank 0, the per-sample total negative log-likelihood, and zero loss for a
label that no alignment over the T frames can produce. The recursion runs
in log space with a -1e30 sentinel in place of -inf.

``ctc_loss_auto`` routes by device alone: a CUDA tensor goes to the
hand-written alpha kernel (``ops/ctc_cuda.py``), a CPU tensor to the plain
loop below.
"""

from __future__ import annotations

import torch

NEG = -1e30
INFEASIBLE_THRESHOLD = 1e29  # a loss beyond this means "no feasible alignment"


def logaddexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))
    return out.clamp_min(NEG)


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    pad = x.new_full(x.shape[:-1] + (k,), NEG)
    return torch.cat([pad, x[..., :-k]], dim=-1)


def zero_infinity(loss: torch.Tensor) -> torch.Tensor:
    return torch.where(loss < INFEASIBLE_THRESHOLD, loss, torch.zeros_like(loss))


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood (``ctc.py:46-121``), a Python
    loop over the T frames; every sample uses all T frames.

    logits [B, T, C] raw scores; labels [B, Lmax] (values in [1, C); padding
    past ``label_lengths`` is ignored); label_lengths [B]. Returns [B]
    float32, zero for infeasible samples."""
    logits = logits.float()
    b, t, _ = logits.shape
    s = 2 * labels.shape[1] + 1
    labels = labels.long()
    label_lengths = label_lengths.long()
    logp = torch.log_softmax(logits, dim=-1)

    z = torch.full((b, s), blank, dtype=torch.long, device=logits.device)
    z[:, 1::2] = labels
    same_as_two_back = torch.cat(
        [torch.ones_like(z[:, :2], dtype=torch.bool), z[:, 2:] == z[:, :-2]], dim=1)
    no_skip = same_as_two_back | (z == blank)
    valid = (torch.arange(s, device=z.device)[None, :]
             < (2 * label_lengths + 1)[:, None])
    lp = torch.gather(logp, 2, z[:, None, :].expand(b, t, s))  # [B, T, S]

    alpha = torch.full((b, s), NEG, device=logits.device)
    alpha[:, 0] = lp[:, 0, 0]
    alpha[:, 1] = torch.where(label_lengths > 0, lp[:, 0, 1],
                              torch.full_like(lp[:, 0, 1], NEG))
    alpha = torch.where(valid, alpha, NEG)
    for i in range(1, t):
        a1 = _shift_right(alpha, 1)
        a2 = torch.where(no_skip, NEG, _shift_right(alpha, 2))
        new = logaddexp3(alpha, a1, a2) + lp[:, i]
        alpha = torch.where(valid, new, NEG).clamp_min(NEG)

    end = 2 * label_lengths  # the final blank state
    a_last_blank = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_last_label = torch.where(
        label_lengths > 0,
        torch.gather(alpha, 1, (end - 1).clamp_min(0)[:, None])[:, 0],
        torch.full_like(a_last_blank, NEG))
    return zero_infinity(-torch.logaddexp(a_last_blank, a_last_label))


def ctc_loss_mean(logits: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Batch-mean CTC loss, the quantity the reference trains on."""
    return ctc_loss(logits, labels, label_lengths, blank).mean()


def ctc_loss_auto(logits: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Per-sample CTC loss: the CUDA alpha kernel for a CUDA tensor, the
    plain loop for a CPU tensor. Nothing else decides, and a CUDA tensor
    never falls back to the plain version."""
    if logits.is_cuda:
        from htr_vt_torch.ops.ctc_cuda import ctc_loss_cuda
        return ctc_loss_cuda(logits, labels, label_lengths, blank)
    return ctc_loss(logits, labels, label_lengths, blank)
