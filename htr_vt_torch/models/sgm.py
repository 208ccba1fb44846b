"""Semantic Guidance Module, the training-only auxiliary loss (port of
``htr_vt_tpu/models/sgm.py``).

For each character of the label a left and a right window of ``sub_len``
context characters is embedded, mean-pooled, given a learned direction
token and used as a query that cross-attends over the visual tokens; a
classifier predicts the centre character, and the cross-entropy of both
directions is averaged over the label's characters. The train loss becomes
``ctc_lambda * CTC + sgm_lambda * SGM`` (``train/step.py``).

``SGMVocab`` and ``make_context_arrays`` are copied whole from the JAX
module (``tests/test_torch_port_sgm.py`` holds the copy to it); the windows
are built on the host with fixed [B, Lmax, S] shapes.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.models.layers import dense, dropout
from htr_vt_torch.text.converter import CTCLabelConverter

SGM_DROP = 0.1  # fixed in the JAX head (sgm.py:95), not in the config
SGM_NORM_EPS = 1e-6  # flax LayerNorm's default


class SGMVocab:
    """Character vocab for SGM targets: the codec's symbols (including the
    blank placeholder at 0, as the reference does) plus
    <pad>/<eos>/<bos_left>/<bos_right> control tokens (sgm_head.py:7-22)."""

    def __init__(self, converter: CTCLabelConverter):
        base = list(converter.character)
        self.stoi = {ch: i for i, ch in enumerate(base)}
        for tok in ("<pad>", "<eos>", "<bos_left>", "<bos_right>"):
            self.stoi.setdefault(tok, len(self.stoi))
        self.itos = [""] * len(self.stoi)
        for k, v in self.stoi.items():
            self.itos[v] = k
        self.pad = self.stoi["<pad>"]
        self.eos = self.stoi["<eos>"]
        self.bos_l = self.stoi["<bos_left>"]
        self.bos_r = self.stoi["<bos_right>"]

    @property
    def size(self) -> int:
        return len(self.stoi)


def make_context_arrays(texts: Sequence[str], vocab: SGMVocab, max_len: int,
                        sub_len: int = 5) -> Dict[str, np.ndarray]:
    """Vectorized window construction.

    Returns fixed-shape arrays:
      sgm_left / sgm_right: int32 [B, max_len, sub_len]
      sgm_tgt: int32 [B, max_len]; sgm_mask: float32 [B, max_len].
    Left window of position i is the sub_len characters before i (bos_left
    padded); right window is the sub_len after (eos padded).
    """
    b = len(texts)
    s = sub_len
    ids = np.full((b, max_len), vocab.pad, np.int32)
    mask = np.zeros((b, max_len), np.float32)
    for bi, t in enumerate(texts):
        t = t[:max_len]
        ids[bi, :len(t)] = [vocab.stoi[ch] for ch in t]
        mask[bi, :len(t)] = 1.0

    lengths = mask.sum(1).astype(np.int32)  # [B]
    pos = np.arange(max_len)[None, :, None]           # [1, L, 1]
    off = np.arange(1, s + 1)[None, None, :]          # [1, 1, S]
    # left: positions i-S .. i-1 (stored oldest-first like the reference)
    lidx = pos - (s + 1 - off)                        # i-S ... i-1
    left = np.where(lidx >= 0,
                    ids[np.arange(b)[:, None, None], np.clip(lidx, 0, max_len - 1)],
                    vocab.bos_l)
    # right: positions i+1 .. i+S
    ridx = pos + off
    right_valid = ridx < lengths[:, None, None]
    right = np.where(right_valid,
                     ids[np.arange(b)[:, None, None], np.clip(ridx, 0, max_len - 1)],
                     vocab.eos)
    return {"sgm_left": left.astype(np.int32), "sgm_right": right.astype(np.int32),
            "sgm_tgt": ids, "sgm_mask": mask}


class SGMHead(nn.Module):
    """Cross-attention character predictor (``sgm.py:89-138``). The two
    products with the visual tokens take compute-dtype operands with
    float32 results; the softmax, log-softmax, norms and the classifier run
    in float32."""

    def __init__(self, d_vis: int, vocab_size: int, dtype: torch.dtype,
                 char_emb_dim: int = 256, drop_rate: float = SGM_DROP, device=None):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.char_emb = nn.Embedding(vocab_size, char_emb_dim, device=device)
        self.dir_left = nn.Parameter(torch.zeros(1, 1, char_emb_dim, device=device))
        self.dir_right = nn.Parameter(torch.zeros(1, 1, char_emb_dim, device=device))
        self.txt_proj = nn.Linear(char_emb_dim, d_vis, device=device)
        self.q_norm = nn.LayerNorm(d_vis, eps=SGM_NORM_EPS, device=device)
        self.kv_norm = nn.LayerNorm(d_vis, eps=SGM_NORM_EPS, device=device)
        self.classifier = nn.Linear(d_vis, vocab_size, device=device)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        """normal(0.02) embeddings and normal(1) direction tokens; the
        linears keep the model's xavier-uniform."""
        self.char_emb.weight.normal_(0.0, 0.02, generator=generator)
        self.dir_left.normal_(0.0, 1.0, generator=generator)
        self.dir_right.normal_(0.0, 1.0, generator=generator)

    def forward(self, vis_tokens: torch.Tensor, left: torch.Tensor,
                right: torch.Tensor, tgt: torch.Tensor, mask: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """vis_tokens [B, N, D] float32; left, right [B, L, S] and tgt [B, L]
        int; mask [B, L] float32 -> the scalar loss."""
        scale = vis_tokens.shape[-1] ** 0.5
        kv = self.kv_norm(vis_tokens.float()).to(self.dtype)  # K = V

        def query(ctx, direction):
            e = self.char_emb(ctx.long()).mean(dim=2) + direction
            return self.q_norm(dense(self.txt_proj, e, self.dtype).float())

        def attend(q):
            kvf = kv.float()
            logits = torch.matmul(q.to(self.dtype).float(), kvf.transpose(1, 2))
            a = torch.softmax(logits / scale, dim=-1)
            out = torch.matmul(a.to(self.dtype).float(), kvf)
            return dropout(out, self.drop_rate, train, generator)

        def ce(q):
            lp = F.log_softmax(self.classifier(attend(q)), dim=-1)
            return -torch.gather(lp, -1, tgt.long()[..., None])[..., 0]

        mask = mask.float()
        loss = (ce(query(left, self.dir_left)) + ce(query(right, self.dir_right))) * mask
        return loss.sum() / (2.0 * torch.clamp_min(mask.sum(), 1.0))
