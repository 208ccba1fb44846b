"""Greedy CTC decoding on the device (port of ``htr_vt_tpu/ops/decode.py``).

Only [B, T] ids leave the device; the strings are assembled on the host by
``htr_vt_tpu.text.converter.CTCLabelConverter``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def greedy_ids(logits: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, T] int32 argmax ids (first maximum on ties)."""
    return logits.argmax(dim=-1).to(torch.int32)


def collapse_ids(ids: torch.Tensor, blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """CTC collapse: drop repeats, then blanks, and left-compact with a
    stable sort. Returns (collapsed [B, T] zero-padded, lengths [B] int32)."""
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev)
    lengths = keep.sum(dim=1).to(torch.int32)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    compacted = torch.gather(torch.where(keep, ids, torch.zeros_like(ids)), 1, order)
    return compacted, lengths
