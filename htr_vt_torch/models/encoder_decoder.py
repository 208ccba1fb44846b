"""The autoregressive encoder-decoder recognizer (port of
``htr_vt_tpu/models/encoder_decoder.py``).

- encoder: the ``HTRVT`` trunk with the config's stem switches, whose
  normed features [B, N, D] are the memory;
- decoder: ``decoder_layers`` pre-norm blocks of causal self-attention,
  cross-attention over ``norm_mem(memory)`` and an MLP, over learned
  character embeddings plus a 1-D sin-cos table of ``max_seq_len`` rows;
- training: teacher-forced cross-entropy with label smoothing, pad masked;
- generation: greedy, nucleus or beam search over ``max_len`` positions,
  each one cached decode step: the cross-attention K, V are prefilled once
  and the self-attention caches [layers, B, H, max_len, hd] are written in
  place at the step's position.

JAX scans the positions (``lax.scan``); here they are a Python loop of
eager steps on preallocated caches, with JAX's semantics kept: the
repetition penalty counts every id of the [B, max_len + 1] token buffer
(pads and ``<sos>`` too), finished rows emit 0, beam search starts with
beam 0 alone live, extends a finished beam only with pad at no cost,
carries each surviving beam's caches with it and applies no repetition
penalty. Nucleus sampling draws from an explicit ``torch.Generator``.

Over a model axis the trunk's blocks are sharded as ``HTRVT``'s; a decoder
block keeps its heads' rows of ``self_qkv`` and its MLP units (JAX's rules
shard ``self_qkv``, ``mlp/fc1`` and ``mlp/fc2``), gathers the heads'
outputs for the replicated ``self_proj`` and runs the cross-attention
whole. Its self-attention caches hold this rank's heads, [layers, B, H /
M, max_len, hd]; the logits are the same on every rank, so every rank
picks the same ids and reorders its caches with the same beams.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from htr_vt_torch.config import ModelConfig
from htr_vt_torch.models.htr_vt import HTRVT
from htr_vt_torch.models.layers import Mlp, dense, jax_init_, sincos_pos_embed_1d
from htr_vt_torch.models.vit import MASKED_LOGIT, multi_head_attention, split_heads
from htr_vt_torch.parallel.mesh import copy_to_model, gather_from_model

KV = Tuple[torch.Tensor, torch.Tensor]


class DecoderBlock(nn.Module):
    """Causal self-attention, cross-attention over the normed memory, MLP;
    pre-norm, float32 LayerNorms, the residual stream in the compute dtype
    (``encoder_decoder.py:38-127``). Sharded over a model axis
    (``model_shards`` = M > 1): ``copy_to_model``, this rank's H / M heads
    of ``self_qkv``, the causal attention over them, the heads gathered
    (``gather_from_model``), the replicated ``self_proj``; the
    cross-attention replicated; the MLP as ``layers.py:Mlp``."""

    # The model axis's size once ``parallel/mesh.py:shard_model`` has split
    # the self-attention's heads.
    model_shards = 1

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 mlp_ratio: float = 4.0, drop: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.self_qkv = nn.Linear(dim, 3 * dim, device=device)
        self.self_proj = nn.Linear(dim, dim, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.cross_q = nn.Linear(dim, dim, device=device)
        self.norm_mem = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.cross_kv = nn.Linear(dim, 2 * dim, device=device)
        self.cross_proj = nn.Linear(dim, dim, device=device)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop_rate=drop, device=device)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return split_heads(t, self.num_heads)

    def _scale(self, c: int) -> float:
        return (c // self.num_heads) ** -0.5

    def _self_qkv(self, y: torch.Tensor):
        """This rank's heads of the self-attention's q, k and v."""
        if self.model_shards > 1:
            y = copy_to_model(y)
        return (split_heads(u, self.num_heads // self.model_shards)
                for u in dense(self.self_qkv, y, self.dtype).chunk(3, -1))

    def _self_out(self, y: torch.Tensor) -> torch.Tensor:
        """``self_proj`` of every head's output."""
        if self.model_shards > 1:
            y = gather_from_model(y)
        return dense(self.self_proj, y, self.dtype)

    def _cross_and_mlp(self, x: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor,
                       train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
        dt = self.dtype
        y = self.norm2(x.float()).to(dt)
        q = self._heads(dense(self.cross_q, y, dt))
        y = multi_head_attention(q, mem_k, mem_v, self._scale(x.shape[-1]), dt)
        x = x + dense(self.cross_proj, y, dt)
        y = self.norm3(x.float()).to(dt)
        return x + self.mlp(y, train=train, generator=generator)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced: x [B, T, C] under a causal mask, memory [B, N, C]."""
        dt = self.dtype
        t = x.shape[1]
        q, k, v = self._self_qkv(self.norm1(x.float()).to(dt))
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        y = multi_head_attention(q, k, v, self._scale(x.shape[-1]), dt, mask=causal)
        x = x + self._self_out(y)
        return self._cross_and_mlp(x, *self.prefill_cross_kv(memory), train, generator)

    def prefill_cross_kv(self, memory: torch.Tensor) -> KV:
        """The cross-attention K, V [B, H, N, hd], computed once a sequence."""
        k, v = dense(self.cross_kv, self.norm_mem(memory.float()).to(self.dtype),
                     self.dtype).chunk(2, -1)
        return self._heads(k), self._heads(v)

    def decode_step(self, x_t: torch.Tensor, pos: int, self_k: torch.Tensor,
                    self_v: torch.Tensor, mem_k: torch.Tensor, mem_v: torch.Tensor
                    ) -> torch.Tensor:
        """One cached position: x_t [B, 1, C]; self_k / self_v [B, H, L, hd]
        caches (this rank's H / M heads over a model axis), written in place
        at ``pos``; the keys at positions <= pos attended. Returns y_t [B,
        1, C]."""
        dt = self.dtype
        q, k, v = self._self_qkv(self.norm1(x_t.float()).to(dt))
        self_k[:, :, pos] = k[:, :, 0].to(self_k.dtype)
        self_v[:, :, pos] = v[:, :, 0].to(self_v.dtype)
        valid = torch.arange(self_k.shape[2], device=x_t.device) <= pos
        y = multi_head_attention(q, self_k, self_v, self._scale(x_t.shape[-1]), dt,
                                 mask=valid)
        x_t = x_t + self._self_out(y)
        return self._cross_and_mlp(x_t, mem_k, mem_v, False, None)


class HTREncoderDecoder(nn.Module):
    """The ``HTRVT`` trunk (``encoder``) and a transformer decoder
    (``embed``, ``dec{i}``, ``final_norm``, ``lm_head``), the JAX module
    names (``encoder_decoder.py:130-198``). ``vocab_size`` counts the ED
    tokenizer's four specials (the trainer sets ``cfg.ed_vocab_size`` from
    it)."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, decoder_layers: int = 6,
                 decoder_heads: int = 8, max_seq_len: int = 256, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        self.dtype = dtype
        self.vocab_size = vocab_size
        self.decoder_layers = decoder_layers
        self.decoder_heads = decoder_heads
        self.max_seq_len = max_seq_len
        d = cfg.embed_dim
        self.encoder = HTRVT(cfg, device=device)
        self.embed = nn.Embedding(vocab_size, d, device=device)
        for i in range(decoder_layers):
            setattr(self, f"dec{i}", DecoderBlock(d, decoder_heads, dtype, device=device))
        self.final_norm = nn.LayerNorm(d, eps=1e-6, device=device)
        self.lm_head = nn.Linear(d, vocab_size, device=device)
        self._pos_tables: Dict[torch.device, torch.Tensor] = {}
        if generator is not None:
            jax_init_(self, generator)

    @torch.no_grad()
    def reset_jax_init(self, generator: torch.Generator) -> None:
        """normal(0.02) character embeddings."""
        self.embed.weight.normal_(0.0, 0.02, generator=generator)

    @property
    def blocks(self) -> List[DecoderBlock]:
        return [getattr(self, f"dec{i}") for i in range(self.decoder_layers)]

    def pos_table(self, device) -> torch.Tensor:
        """The float32 [max_seq_len, D] sin-cos table, once per device."""
        if device not in self._pos_tables:
            self._pos_tables[device] = torch.from_numpy(
                sincos_pos_embed_1d(self.cfg.embed_dim, self.max_seq_len)).to(device)
        return self._pos_tables[device]

    def encode(self, image: torch.Tensor, *, train: bool = False,
               keep: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               mask_mode: Optional[str] = None,
               mask_ratio: Optional[float] = None) -> torch.Tensor:
        """The trunk's normed features [B, N, D] float32."""
        _, feats = self.encoder(image, train=train, keep=keep, generator=generator,
                                mask_mode=mask_mode, mask_ratio=mask_ratio,
                                return_features=True)
        return feats

    def _embed(self, tokens: torch.Tensor, start: int) -> torch.Tensor:
        t = tokens.shape[1]
        if start + t > self.max_seq_len:
            raise ValueError(f"position {start + t - 1} past max_seq_len {self.max_seq_len}")
        pos = self.pos_table(tokens.device)[start:start + t].to(self.dtype)
        return self.embed(tokens.long()).to(self.dtype) + pos

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.lm_head, self.final_norm(x.float()), torch.float32)

    def decode_logits(self, memory: torch.Tensor, tgt_input: torch.Tensor, *,
                      train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher forcing: [B, L] ids -> [B, L, V] float32 logits."""
        x = self._embed(tgt_input, 0)
        for block in self.blocks:
            x = block(x, memory, train=train, generator=generator)
        return self._logits(x)

    def forward(self, image: torch.Tensor, tgt_input: torch.Tensor, *,
                train: bool = False, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_mode: Optional[str] = None,
                mask_ratio: Optional[float] = None) -> torch.Tensor:
        """Encode, then decode ``tgt_input`` teacher-forced. ``train``: the
        trunk's batch-statistic BN, masking (or the injected ``keep``) and
        dropout, drawing from ``generator``."""
        memory = self.encode(image, train=train, keep=keep, generator=generator,
                             mask_mode=mask_mode, mask_ratio=mask_ratio)
        return self.decode_logits(memory, tgt_input, train=train, generator=generator)

    def prefill(self, memory: torch.Tensor) -> List[KV]:
        """Cross-attention K, V for every decoder layer."""
        return [blk.prefill_cross_kv(memory) for blk in self.blocks]

    def new_caches(self, batch: int, max_len: int, device) -> Tuple[torch.Tensor, ...]:
        """Zeroed self-attention K and V caches [layers, B, H, max_len, hd]:
        this rank's H / M heads over a model axis."""
        heads = self.decoder_heads // getattr(self, "model_shards", 1)
        shape = (self.decoder_layers, batch, heads, max_len,
                 self.cfg.embed_dim // self.decoder_heads)
        return (torch.zeros(shape, dtype=self.dtype, device=device),
                torch.zeros(shape, dtype=self.dtype, device=device))

    def decode_one(self, token: torch.Tensor, pos: int, mem_kvs: List[KV],
                   self_ks: torch.Tensor, self_vs: torch.Tensor) -> torch.Tensor:
        """One cached decode step: token [B] ids at position ``pos``; the
        caches [layers, B, H, L, hd] are written in place. Returns the
        logits [B, V] float32."""
        x = self._embed(token[:, None], pos)
        for i, blk in enumerate(self.blocks):
            x = blk.decode_step(x, pos, self_ks[i], self_vs[i], *mem_kvs[i])
        return self._logits(x)[:, 0]


def teacher_forcing_loss(logits: torch.Tensor, tgt_output: torch.Tensor,
                         pad_id: int = 0, label_smoothing: float = 0.1) -> torch.Tensor:
    """Mean label-smoothed cross-entropy over the non-pad positions
    (``encoder_decoder.py:201-215``)."""
    v = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(tgt_output.long(), v).float()
    smooth = onehot * (1.0 - label_smoothing) + label_smoothing / v
    ce = -(smooth * logp).sum(-1)
    mask = (tgt_output != pad_id).float()
    return (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def apply_repetition_penalty(logits: torch.Tensor, tokens: torch.Tensor,
                        penalty: float) -> torch.Tensor:
    """Divide (positive) or multiply (negative) the logits of every id that
    appears anywhere in the token buffer ``tokens`` [B, L + 1], pads and
    ``<sos>`` included (``encoder_decoder.py:259-264``)."""
    seen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, tokens.long(), True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def nucleus_filter(logits: torch.Tensor, temperature: float, top_p: float
                   ) -> torch.Tensor:
    """The tempered logits with every logit below the nucleus cut at -1e9
    (``encoder_decoder.py:268-276``): the cut is the sorted logit at
    ``cutoff_idx``, the count of sorted probabilities whose running sum is
    under ``top_p``."""
    scaled = logits / max(temperature, 1e-6)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, 1, cutoff_idx)
    return torch.where(scaled < cutoff, MASKED_LOGIT, scaled)


def nucleus_sample(logits: torch.Tensor, temperature: float, top_p: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """One id a row, drawn from ``generator`` by the softmax of
    ``nucleus_filter``'s logits (JAX's ``jax.random.categorical``)."""
    probs = torch.softmax(nucleus_filter(logits, temperature, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(model: HTREncoderDecoder, image: Optional[torch.Tensor], *,
             method: str = "greedy", max_len: int = 128, sos_id: int = 1,
             eos_id: int = 2, temperature: float = 0.7, top_p: float = 0.9,
             repetition_penalty: float = 1.3,
             generator: Optional[torch.Generator] = None, beam_size: int = 5,
             memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Autoregressive generation on the model's current weights (eval
    BN): [B, max_len] int32 ids, whatever follows a row's first ``<eos>``
    being garbage (the tokenizer stops there). ``memory``: the image's
    encoding when the caller has it (``image`` is then not read).
    ``method``: ``greedy``, ``nucleus`` (drawing from ``generator``) or
    ``beam_search`` (``encoder_decoder.py:218-338``)."""
    if memory is None:
        memory = model.encode(image)
    if method == "beam_search":
        return _beam_generate(model, memory, max_len, sos_id, eos_id, beam_size)
    if method not in ("greedy", "nucleus"):
        raise ValueError(f"unknown generation method {method!r}")
    b, device = memory.shape[0], memory.device
    tokens = torch.zeros(b, max_len + 1, dtype=torch.long, device=device)
    tokens[:, 0] = sos_id
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    mem_kvs = model.prefill(memory)
    ks, vs = model.new_caches(b, max_len, device)
    for t in range(max_len):
        logit = model.decode_one(tokens[:, t], t, mem_kvs, ks, vs)
        logit = apply_repetition_penalty(logit, tokens, repetition_penalty)
        if method == "greedy":
            nxt = logit.argmax(-1)
        else:
            nxt = nucleus_sample(logit, temperature, top_p, generator)
        nxt = torch.where(finished, 0, nxt)
        tokens[:, t + 1] = nxt
        finished |= nxt == eos_id
    return tokens[:, 1:].int()


def _beam_generate(model: HTREncoderDecoder, memory: torch.Tensor, max_len: int,
                   sos_id: int, eos_id: int, beam_size: int) -> torch.Tensor:
    """Beam search as a [B * K] batch of cached decode steps; each step
    reorders the self-attention caches with the surviving beams
    (``encoder_decoder.py:294-338``)."""
    b, device, k = memory.shape[0], memory.device, beam_size
    mem_kvs = model.prefill(memory.repeat_interleave(k, dim=0))
    tokens = torch.zeros(b * k, max_len + 1, dtype=torch.long, device=device)
    tokens[:, 0] = sos_id
    scores = torch.tensor([0.0] + [MASKED_LOGIT] * (k - 1), device=device).repeat(b)
    finished = torch.zeros(b * k, dtype=torch.bool, device=device)
    ks, vs = model.new_caches(b * k, max_len, device)
    base = torch.arange(b, device=device)[:, None] * k
    for t in range(max_len):
        logp = F.log_softmax(model.decode_one(tokens[:, t], t, mem_kvs, ks, vs).float(),
                             dim=-1)
        v = logp.shape[-1]
        pad_only = torch.full((v,), MASKED_LOGIT, device=device)
        pad_only[0] = 0.0
        logp = torch.where(finished[:, None], pad_only, logp)
        top_scores, top_idx = torch.topk((scores[:, None] + logp).reshape(b, k * v), k)
        flat = (top_idx // v + base).reshape(-1)
        tok = (top_idx % v).reshape(-1)
        tokens = tokens[flat]
        tokens[:, t + 1] = tok
        finished = finished[flat] | (tok == eos_id)
        ks, vs = ks[:, flat], vs[:, flat]
        scores = top_scores.reshape(-1)
    best = scores.reshape(b, k).argmax(1) + base[:, 0]
    return tokens[best, 1:].int()
